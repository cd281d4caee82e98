"""Extractor of the package's own chunked Parquet format (counterpart of
``graphnet_tpu/data/extractors/internal.py``)."""

from __future__ import annotations

import os

from graphnet_tpu_torch.data.extractors.extractor import Extractor


class ParquetExtractor(Extractor):
    """A table of a chunked Parquet directory
    (``<table>/<table>_<chunk>.parquet``): the file as a DataFrame when
    it belongs to the table, else None."""

    def __init__(self, extractor_name: str):
        super().__init__(extractor_name=extractor_name)
        self._table = extractor_name

    def __call__(self, file_path: str):
        import pandas as pd

        base = os.path.basename(file_path)
        if (
            self._table not in file_path.split("/")
            and not base.startswith(self._table + "_")
        ):
            return None
        df = pd.read_parquet(file_path)
        # a table indexed by the event id gets it back as a column, which
        # the SQLite writer expects
        if df.index.name is not None:
            df = df.reset_index()
        return df
