"""Reader base class (counterpart of
``graphnet_tpu/data/readers/reader.py``)."""

from __future__ import annotations

from typing import List, Union

from graphnet_tpu_torch.data.extractors.extractor import Extractor
from graphnet_tpu_torch.utils.logging import Logger


class GraphNeTFileReader(Logger):
    """Finds raw files and applies its extractors to each.

    A subclass sets ``_accepted_file_extensions`` and
    ``_accepted_extractors`` and implements ``__call__`` and
    ``find_files``.
    """

    _accepted_file_extensions: List[str] = []
    _accepted_extractors: List[type] = []

    @property
    def accepted_file_extensions(self) -> List[str]:
        return self._accepted_file_extensions

    @property
    def accepted_extractors(self) -> List[type]:
        return self._accepted_extractors

    @property
    def extractor_names(self) -> List[str]:
        return [e.name for e in self._extractors]

    def set_extractors(self, extractors) -> None:
        if not isinstance(extractors, list):
            extractors = [extractors]
        self._validate_extractors(extractors)
        self._extractors = extractors

    def _validate_extractors(self, extractors: List[Extractor]) -> None:
        for extractor in extractors:
            if not any(isinstance(extractor, ok)
                       for ok in self._accepted_extractors):
                raise TypeError(
                    f"{type(extractor).__name__} is not supported by "
                    f"{type(self).__name__} (accepted: "
                    f"{[c.__name__ for c in self._accepted_extractors]})"
                )

    def __call__(self, file_path: str):
        raise NotImplementedError

    def find_files(self, path: Union[str, List[str]]) -> List[str]:
        raise NotImplementedError
