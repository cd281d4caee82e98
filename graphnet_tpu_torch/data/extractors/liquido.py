"""LiquidO h5 extractors (counterpart of
``graphnet_tpu/data/extractors/liquido.py``).  h5py and pandas are
imported inside the call."""

from __future__ import annotations

from typing import List

from graphnet_tpu_torch.data.extractors.extractor import Extractor


class H5Extractor(Extractor):
    """A named 2D dataset of a LiquidO h5 file as a DataFrame with
    ``column_names``, or None where the file lacks it."""

    def __init__(self, extractor_name: str, column_names: List[str]):
        super().__init__(extractor_name=extractor_name)
        self._table = extractor_name
        self._column_names = column_names

    def __call__(self, file_path: str):
        import h5py
        import pandas as pd

        with h5py.File(file_path, "r") as f:
            if self._table not in f.keys():
                return None
            array = f[self._table][:]
            assert array.shape[1] == len(self._column_names), (
                f"{self._table} has {array.shape[1]} columns but "
                f"{len(self._column_names)} names were given"
            )
            return pd.DataFrame(array, columns=self._column_names)


class H5HitExtractor(H5Extractor):
    """The ``HitData`` dataset."""

    def __init__(self) -> None:
        super().__init__(
            extractor_name="HitData",
            column_names=[
                "event_no",
                "sipmID",
                "sipm_x",
                "sipm_y",
                "sipm_z",
                "t",
                "var",
            ],
        )


class H5TruthExtractor(H5Extractor):
    """The ``TruthData`` dataset."""

    def __init__(self) -> None:
        super().__init__(
            extractor_name="TruthData",
            column_names=[
                "event_no",
                "vertex_x",
                "vertex_y",
                "vertex_z",
                "zenith",
                "azimuth",
                "interaction_time",
                "energy",
                "pid",
            ],
        )
