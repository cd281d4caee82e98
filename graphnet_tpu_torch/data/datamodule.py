"""Train / validation / test datasets and their loaders from one dataset
configuration (counterpart of ``graphnet_tpu/data/datamodule.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Type

import numpy as np

from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.dataset import Dataset


class GraphNeTDataModule:
    """Split a dataset into train and validation (and test) sets and build
    their DataLoaders.

    With no ``selection``, every event of the dataset is split at random
    by ``train_val_split`` (default 0.9 / 0.1), seeded by
    ``split_seed``, as the JAX package does.  The train loader shuffles
    by default; the validation and test loaders never do.
    """

    def __init__(
        self,
        dataset_reference: Type[Dataset],
        dataset_args: Dict[str, Any],
        selection: Optional[List[int]] = None,
        test_selection: Optional[List[int]] = None,
        train_val_split: Optional[List[float]] = None,
        split_seed: int = 42,
        train_dataloader_kwargs: Optional[Dict[str, Any]] = None,
        validation_dataloader_kwargs: Optional[Dict[str, Any]] = None,
        test_dataloader_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self._dataset_cls = dataset_reference
        self._dataset_args = dict(dataset_args)
        self._train_val_split = train_val_split or [0.9, 0.1]
        self._split_seed = split_seed
        self._train_dl_kwargs = dict(train_dataloader_kwargs or {})
        self._val_dl_kwargs = dict(validation_dataloader_kwargs or {})
        self._test_dl_kwargs = dict(test_dataloader_kwargs or {})
        self._train_dl_kwargs.setdefault("shuffle", True)
        self._val_dl_kwargs["shuffle"] = False
        self._test_dl_kwargs["shuffle"] = False

        if selection is None:
            probe = self._dataset_cls(**self._dataset_args)
            selection = list(probe._indices)
        if test_selection is not None:
            held = set(test_selection)
            selection = [s for s in selection if s not in held]
        train_sel, val_sel = self._split(selection)
        self._train_dataset = self._dataset_cls(
            **self._dataset_args, selection=train_sel
        )
        self._val_dataset = self._dataset_cls(
            **self._dataset_args, selection=val_sel
        )
        self._test_dataset = (
            self._dataset_cls(
                **self._dataset_args, selection=list(test_selection)
            )
            if test_selection is not None
            else None
        )

    def _split(self, selection: List[int]):
        rng = np.random.default_rng(self._split_seed)
        order = rng.permutation(len(selection))
        n_val = int(round(self._train_val_split[1] * len(selection)))
        val_idx = set(order[:n_val].tolist())
        train = [s for i, s in enumerate(selection) if i not in val_idx]
        val = [s for i, s in enumerate(selection) if i in val_idx]
        return train, val

    @property
    def train_dataset(self) -> Dataset:
        return self._train_dataset

    @property
    def val_dataset(self) -> Dataset:
        return self._val_dataset

    @property
    def test_dataset(self) -> Optional[Dataset]:
        return self._test_dataset

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self._train_dataset, **self._train_dl_kwargs)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self._val_dataset, **self._val_dl_kwargs)

    def test_dataloader(self) -> DataLoader:
        if self._test_dataset is None:
            raise ValueError("no test selection given")
        return DataLoader(self._test_dataset, **self._test_dl_kwargs)
