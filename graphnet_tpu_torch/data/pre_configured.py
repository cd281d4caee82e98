"""Pre-configured converters (counterpart of
``graphnet_tpu/data/pre_configured.py``).

``ParquetToSQLiteConverter`` and the IceTray converters,
``I3ToSQLiteConverter`` and ``I3ToParquetConverter``: these build their
pipeline anywhere, and need IceTray only to read ``.i3`` files.
"""

from __future__ import annotations

from typing import List, Optional

from graphnet_tpu_torch.data.dataconverter import DataConverter
from graphnet_tpu_torch.data.extractors.internal import ParquetExtractor
from graphnet_tpu_torch.data.readers.internal_parquet_reader import (
    ParquetReader,
)
from graphnet_tpu_torch.data.writers.parquet_writer import ParquetWriter
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


class _I3Converter(DataConverter):
    """The I3 converters' pipeline: an ``I3Reader`` (``gcd_rescue``,
    ``i3_filters``) with ``extractors``, into ``_writer_cls``."""

    _writer_cls: type

    def __init__(
        self,
        gcd_rescue: str,
        extractors: list,
        outdir: str,
        index_column: str = "event_no",
        num_workers: int = 1,
        i3_filters: Optional[list] = None,
    ):
        from graphnet_tpu_torch.data.readers.i3reader import I3Reader

        super().__init__(
            file_reader=I3Reader(gcd_rescue=gcd_rescue, i3_filters=i3_filters),
            save_method=self._writer_cls(),
            outdir=outdir,
            extractors=extractors,
            index_column=index_column,
            num_workers=num_workers,
        )


class I3ToSQLiteConverter(_I3Converter):
    """I3 files to SQLite databases, one an input file."""

    _writer_cls = SQLiteWriter


class I3ToParquetConverter(_I3Converter):
    """I3 files to the chunked Parquet format."""

    _writer_cls = ParquetWriter
