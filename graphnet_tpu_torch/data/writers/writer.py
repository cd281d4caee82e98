"""Writer base class (counterpart of
``graphnet_tpu/data/writers/writer.py``)."""

from __future__ import annotations

import os
from typing import List

from graphnet_tpu_torch.utils.logging import Logger


class GraphNeTWriter(Logger):
    """Saves the interim ``{table: DataFrame}`` format to disk.

    A subclass implements ``_save_file`` and ``merge_files`` and sets
    ``_file_extension`` and ``_merge_dataframes`` (whether it takes one
    DataFrame a table or a list of them, one an event).
    """

    _file_extension: str = ""
    _merge_dataframes: bool = True

    @property
    def file_extension(self) -> str:
        return self._file_extension

    @property
    def expects_merged_dataframes(self) -> bool:
        return self._merge_dataframes

    def _save_file(self, data, output_file_path: str, n_events: int) -> None:
        raise NotImplementedError

    def merge_files(self, files: List[str], output_dir: str, **kwargs) -> None:
        raise NotImplementedError

    def __call__(self, data, file_name: str, output_dir: str,
                 n_events: int) -> None:
        os.makedirs(output_dir, exist_ok=True)
        output_file_path = os.path.join(output_dir, file_name) + self.file_extension
        self._save_file(data=data, output_file_path=output_file_path,
                        n_events=n_events)
