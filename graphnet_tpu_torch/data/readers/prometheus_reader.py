"""Prometheus Parquet reader (counterpart of
``graphnet_tpu/data/readers/prometheus_reader.py``).  pandas is imported
inside the call."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

from graphnet_tpu_torch.data.extractors.prometheus import PrometheusExtractor
from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader


class PrometheusReader(GraphNeTFileReader):
    """Prometheus simulation files: one row an event, a column a table of
    nested values.  Returns one ``{table: {column: values}}`` an event."""

    _accepted_file_extensions = [".parquet"]
    _accepted_extractors = [PrometheusExtractor]

    def __call__(self, file_path: str) -> List[Dict]:
        import pandas as pd

        outputs = []
        file = pd.read_parquet(file_path)
        for k in range(len(file)):
            extracted_event = {}
            for extractor in self._extractors:
                if extractor._table in file.columns:
                    extracted_event[extractor.name] = extractor(
                        file[extractor._table][k])
            outputs.append(extracted_event)
        return outputs

    def find_files(self, path: Union[str, List[str]]) -> List[str]:
        """Every ``.parquet`` file under ``path`` (one or a list of
        directories), sorted."""
        if isinstance(path, str):
            path = [path]
        files: List[str] = []
        for p in path:
            files.extend(f.absolute().as_posix()
                         for f in Path(p).rglob("*.parquet"))
        return sorted(files)
