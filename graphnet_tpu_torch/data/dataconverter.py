"""DataConverter: raw files to an intermediate format (counterpart of
``graphnet_tpu/data/dataconverter.py``).

Reader, extractors and writer over a directory of raw files, in the main
process or in a pool of spawned worker processes that share a locked
global event counter, so that every event gets a unique ``event_no``
across workers.  pandas is imported inside the calls.
"""

from __future__ import annotations

import multiprocessing
import os
from glob import glob
from typing import Any, Dict, List, Optional, Union

import numpy as np

from graphnet_tpu_torch.data.extractors.extractor import Extractor
from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader
from graphnet_tpu_torch.data.writers.writer import GraphNeTWriter
from graphnet_tpu_torch.utils.logging import Logger

# the pool's shared event counter, set in each worker by its initializer
global_index = None


def init_global_index(index) -> None:
    global global_index
    global_index = index


class DataConverter(Logger):
    """``file_reader`` with ``extractors``, then ``save_method`` into
    ``outdir``: one output an input file, in ``num_workers`` processes."""

    def __init__(
        self,
        file_reader: GraphNeTFileReader,
        save_method: GraphNeTWriter,
        outdir: str,
        extractors: Union[Extractor, List[Extractor]],
        index_column: str = "event_no",
        num_workers: int = 1,
    ) -> None:
        super().__init__()
        self._file_reader = file_reader
        self._save_method = save_method
        self._num_workers = num_workers
        self._index_column = index_column
        self._index = 0
        self._output_dir = outdir
        self._output_files: List[str] = []
        self._extension = save_method.file_extension
        if not isinstance(extractors, list):
            extractors = [extractors]
        self._file_reader.set_extractors(extractors=extractors)

    def __call__(self, input_dir: Union[str, List[str]]) -> None:
        input_files = self._file_reader.find_files(path=input_dir)
        self._launch_jobs(input_files)
        self._output_files = [
            os.path.join(self._output_dir,
                         self._create_file_name(f) + self._extension)
            for f in input_files
        ]

    def _launch_jobs(self, input_files: List[str]) -> None:
        map_fn, pool = self._get_map_function(len(input_files))
        for _ in map_fn(self._process_file, input_files):
            self.debug("processed file")
        if pool is not None:
            (index,) = pool._initargs  # type: ignore
            self._index += index.value
            pool.close()
            pool.join()

    def _get_map_function(self, nb_files: int):
        n_workers = min(self._num_workers, nb_files)
        if n_workers > 1:
            self.info(f"Starting pool of {n_workers} workers for "
                      f"{nb_files} files")
            # spawned, not forked: this process runs threads (torch's)
            ctx = multiprocessing.get_context("spawn")
            index = ctx.Value("i", 0)
            pool = ctx.Pool(processes=n_workers, initializer=init_global_index,
                            initargs=(index,))
            return pool.imap, pool
        self.info(f"Processing {nb_files} files in main thread")
        return map, None

    def _process_file(self, file_path: str) -> None:
        data = self._file_reader(file_path=file_path)
        if isinstance(data, list):
            n_events = len(data)
            dataframes = self._assign_event_no(data)
        elif isinstance(data, dict):
            # tables that carry the index column already (LiquidO h5)
            counts = []
            for key, df in data.items():
                assert self._index_column in df.columns, (
                    f"{key} lacks {self._index_column}")
                counts.append(df[self._index_column].nunique())
            dataframes = data
            n_events = min(counts) if counts else 0
        else:
            raise TypeError(f"Unexpected reader output {type(data)}")
        self._save_method(data=dataframes,
                          file_name=self._create_file_name(file_path),
                          n_events=n_events, output_dir=self._output_dir)

    def _create_file_name(self, input_file_path) -> str:
        # an IceTray reader gives I3FileSet(i3_file, gcd_file), not a path
        input_file_path = getattr(input_file_path, "i3_file", input_file_path)
        file_name = os.path.basename(input_file_path)
        for ext in self._file_reader.accepted_file_extensions:
            if file_name.endswith(ext):
                file_name = file_name[: -len(ext)]
                break
        return file_name.replace(".i3", "")

    def _assign_event_no(self, data: List[Dict]) -> Dict[str, Any]:
        """Each event's tables with its ``event_no`` as a column: one
        DataFrame a table (merged over the events) or a list of them,
        as the writer expects.  An empty table of an event is left
        out."""
        import pandas as pd

        event_nos = self._request_event_nos(len(data))
        dataframe_dict: Dict[str, List] = {}
        for k, event in enumerate(data):
            for name, table in event.items():
                n_rows = self._count_rows(table)
                if n_rows > 0:
                    table = dict(table)
                    table[self._index_column] = np.repeat(
                        event_nos[k], n_rows).tolist()
                    df = pd.DataFrame(table,
                                      index=[0] if n_rows == 1 else None)
                    dataframe_dict.setdefault(name, []).append(df)
        if self._save_method.expects_merged_dataframes:
            return {k: pd.concat(v, axis=0).reset_index(drop=True)
                    for k, v in dataframe_dict.items()}
        return dataframe_dict

    @staticmethod
    def _count_rows(table: Dict[str, Any]) -> int:
        lengths = {len(v) if isinstance(v, (list, np.ndarray)) else 1
                   for v in table.values()}
        if not lengths:
            return 0
        assert len(lengths) == 1, f"columns have differing lengths: {lengths}"
        return lengths.pop()

    def _request_event_nos(self, n_ids: int) -> List[int]:
        """``n_ids`` new event ids: from the pool's shared counter in a
        worker, else from this converter's."""
        if global_index is not None:
            with global_index.get_lock():
                start = global_index.value
                global_index.value += n_ids
        else:
            start = self._index
            self._index += n_ids
        return list(range(start, start + n_ids))

    def merge_files(self, files: Optional[Union[List[str], str]] = None,
                    **kwargs: Any) -> None:
        """The writer's ``merge_files`` into ``<outdir>/merged``: of
        ``files``, or of every output of ``outdir`` (a writer may write
        several files an input).  A single file is not merged."""
        if files is None:
            files_to_merge = sorted(glob(os.path.join(
                self._output_dir, f"*{self._extension}")))
        elif isinstance(files, str):
            self.info(f"Got a single file {files}; merging skipped.")
            return
        else:
            files_to_merge = files
        merge_path = os.path.join(self._output_dir, "merged")
        self.info(f"Merging files to {merge_path}")
        self._save_method.merge_files(files=files_to_merge,
                                      output_dir=merge_path, **kwargs)
