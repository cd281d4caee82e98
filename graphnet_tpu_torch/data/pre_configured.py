"""Pre-configured converters (counterpart of
``graphnet_tpu/data/pre_configured.py``).

Only ``ParquetToSQLiteConverter`` is ported.  The JAX package's IceTray
converters (``I3ToSQLiteConverter``, ``I3ToParquetConverter``) wait for
the port of its IceTray reader and extractors.
"""

from __future__ import annotations

from typing import List

from graphnet_tpu_torch.data.dataconverter import DataConverter
from graphnet_tpu_torch.data.extractors.internal import ParquetExtractor
from graphnet_tpu_torch.data.readers.internal_parquet_reader import (
    ParquetReader,
)
from graphnet_tpu_torch.data.writers.sqlite_writer import SQLiteWriter


class ParquetToSQLiteConverter(DataConverter):
    """The package's chunked Parquet format to SQLite: ``run`` converts
    each chunk file of ``tables`` and merges the outputs into
    ``<sqlite_path>/merged/merged.db``."""

    def __init__(
        self,
        parquet_path: str,
        sqlite_path: str,
        tables: List[str],
        num_workers: int = 1,
        index_column: str = "event_no",
    ):
        super().__init__(
            file_reader=ParquetReader(),
            save_method=SQLiteWriter(),
            outdir=sqlite_path,
            extractors=[ParquetExtractor(t) for t in tables],
            index_column=index_column,
            num_workers=num_workers,
        )
        self._parquet_path = parquet_path

    def run(self) -> None:
        self(self._parquet_path)
        self.merge_files()
