"""Reader of the package's own chunked Parquet format (counterpart of
``graphnet_tpu/data/readers/internal_parquet_reader.py``)."""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Union

from graphnet_tpu_torch.data.extractors.internal import ParquetExtractor
from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader


class ParquetReader(GraphNeTFileReader):
    """Chunked Parquet directories (``<table>/<table>_<chunk>.parquet``).
    Returns ``{table: DataFrame}`` for the tables a file belongs to."""

    _accepted_file_extensions = [".parquet"]
    _accepted_extractors = [ParquetExtractor]

    def __call__(self, file_path: str) -> Dict:
        outputs = {}
        for extractor in self._extractors:
            output = extractor(file_path)
            if output is not None:
                outputs[extractor.name] = output
        return outputs

    def find_files(self, path: Union[str, List[str]]) -> List[str]:
        """Every chunk file of every table under ``path``, sorted."""
        if isinstance(path, str):
            path = [path]
        files: List[str] = []
        for p in path:
            files.extend(glob(os.path.join(p, "*", "*.parquet")))
        return sorted(files)
