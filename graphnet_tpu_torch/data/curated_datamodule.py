"""Curated datasets (counterpart of
``graphnet_tpu/data/curated_datamodule.py``).

A ``CuratedDataset`` is a datamodule whose dataset arguments, features,
truth and selections its subclass declares; a hosted one downloads its
files on first use.  Where ``dataset_dir`` holds files already they are
used as they are; otherwise the download is tried, and without a network
it raises a clear error.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from graphnet_tpu_torch.data.datamodule import GraphNeTDataModule
from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset


class CuratedDataset(GraphNeTDataModule):
    """A dataset with a declared schema and provenance.

    A subclass sets ``_pulsemaps``, ``_truth_table``, ``_event_truth``,
    ``_features``, ``_experiment``, ``_citation`` and the like, and
    implements ``_prepare_args``.  ``features`` and ``truth`` (default:
    all declared) choose among the declared ones.
    """

    _pulsemaps: List[str] = []
    _truth_table: str = "truth"
    _event_truth: List[str] = []
    _pulse_truth: Optional[List[str]] = None
    _features: List[str] = []
    _experiment: str = ""
    _creator: str = ""
    _comments: str = ""
    _citation: Optional[str] = None
    _available_backends: List[str] = ["sqlite"]

    def __init__(
        self,
        graph_definition,
        download_dir: str,
        backend: str = "sqlite",
        features: Optional[List[str]] = None,
        truth: Optional[List[str]] = None,
        **datamodule_kwargs: Any,
    ) -> None:
        assert backend in self._available_backends, (
            f"backend {backend!r} not in {self._available_backends}")
        self._graph_definition = graph_definition
        self._download_dir = download_dir
        self._backend = backend
        self.prepare_data()

        features = features or list(self._features)
        truth = truth or list(self._event_truth)
        assert set(features) <= set(self._features), (
            f"unknown features {set(features) - set(self._features)}")
        assert set(truth) <= set(self._event_truth)

        dataset_args, selection, test_selection = self._prepare_args(
            backend=backend, features=features, truth=truth)
        dataset_ref = SQLiteDataset if backend == "sqlite" else ParquetDataset
        super().__init__(
            dataset_reference=dataset_ref,
            dataset_args=dataset_args,
            selection=selection,
            test_selection=test_selection,
            **datamodule_kwargs,
        )

    @property
    def dataset_dir(self) -> str:
        return os.path.join(self._download_dir, type(self).__name__)

    def prepare_data(self) -> None:
        """Fetch the dataset unless ``dataset_dir`` holds files."""
        if os.path.isdir(self.dataset_dir) and os.listdir(self.dataset_dir):
            return
        self._download()

    def _download(self) -> None:
        raise RuntimeError(
            f"{type(self).__name__} files not found in "
            f"{self.dataset_dir} and this environment has no network "
            "access for download. Place the files there manually."
        )

    def _prepare_args(
        self, backend: str, features: List[str], truth: List[str]
    ) -> Tuple[Dict[str, Any], Optional[list], Optional[list]]:
        raise NotImplementedError

    def description(self) -> None:
        """Print the dataset's schema and provenance."""
        print(
            f"{type(self).__name__} ({self._experiment})\n"
            f"  pulsemaps: {self._pulsemaps}\n"
            f"  truth table: {self._truth_table}\n"
            f"  features: {self._features}\n"
            f"  event truth: {self._event_truth}\n"
            f"  creator: {self._creator}\n"
            f"  comments: {self._comments}\n"
            f"  citation: {self._citation}"
        )

    @property
    def pulsemaps(self) -> List[str]:
        return self._pulsemaps

    @property
    def truth_table(self) -> str:
        return self._truth_table

    @property
    def event_truth(self) -> List[str]:
        return self._event_truth

    @property
    def features(self) -> List[str]:
        return self._features

    @property
    def experiment(self) -> str:
        return self._experiment

    @property
    def citation(self) -> Optional[str]:
        return self._citation


class ERDAHostedDataset(CuratedDataset):
    """A dataset hosted on the ERDA service: its backend's sharelink hash
    names one ``.tar.gz`` under ``_mirror``, which is downloaded with
    ``urllib`` (a ``file://`` mirror works too) and extracted into
    ``dataset_dir`` with :mod:`tarfile`'s ``data`` filter (no path
    traversal)."""

    _mirror = "https://sid.erda.dk/share_redirect"
    _file_hashes: Dict[str, str] = {}

    def _download(self) -> None:
        import shutil
        import tarfile
        import urllib.error
        import urllib.request

        file_hash = self._file_hashes[self._backend]
        url = f"{self._mirror}/{file_hash}"
        os.makedirs(self.dataset_dir, exist_ok=True)
        archive = os.path.join(self.dataset_dir, file_hash + ".tar.gz")
        try:
            with urllib.request.urlopen(url) as r, open(archive, "wb") as f:
                shutil.copyfileobj(r, f)
        except (urllib.error.URLError, OSError) as e:
            raise RuntimeError(
                f"{type(self).__name__}: could not download {url} "
                f"(no network egress?). Place the extracted files in "
                f"{self.dataset_dir} manually."
            ) from e
        try:
            with tarfile.open(archive, "r:gz") as tf:
                tf.extractall(self.dataset_dir, filter="data")
        finally:
            os.remove(archive)
