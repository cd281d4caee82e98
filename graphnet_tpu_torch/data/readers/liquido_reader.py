"""LiquidO h5 reader (counterpart of
``graphnet_tpu/data/readers/liquido_reader.py``)."""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Union

from graphnet_tpu_torch.data.extractors.liquido import H5Extractor
from graphnet_tpu_torch.data.readers.reader import GraphNeTFileReader


class LiquidOReader(GraphNeTFileReader):
    """LiquidO h5 files.  Returns ``{table: DataFrame}`` a file; the
    tables carry their own ``event_no`` column."""

    _accepted_file_extensions = [".h5"]
    _accepted_extractors = [H5Extractor]

    def __call__(self, file_path: str) -> Dict:
        outputs = {}
        for extractor in self._extractors:
            output = extractor(file_path)
            if output is not None:
                outputs[extractor.name] = output
        return outputs

    def find_files(self, path: Union[str, List[str]]) -> List[str]:
        """The ``.h5`` files directly in ``path`` (one or a list of
        directories), sorted."""
        if isinstance(path, str):
            path = [path]
        files: List[str] = []
        for p in path:
            files.extend(glob(os.path.join(p, "*.h5")))
        return sorted(files)
