"""Extractor base class and ``CombinedExtractor`` (counterpart of
``graphnet_tpu/data/extractors/extractor.py``)."""

from __future__ import annotations

from typing import Any

from graphnet_tpu_torch.utils.logging import Logger


class Extractor(Logger):
    """Maps raw per-event or per-file data to ``{column: values}``.  The
    extractor's name becomes the table's name in the intermediate
    format."""

    def __init__(self, extractor_name: str):
        super().__init__()
        self._extractor_name = extractor_name

    @property
    def name(self) -> str:
        return self._extractor_name

    def __call__(self, data: Any):
        raise NotImplementedError


class CombinedExtractor(Extractor):
    """Several extractors' columns in one table.  They must all give
    columns of one level (all per event or all per pulse); ``set_gcd`` is
    passed on to those that take it (the IceTray extractors)."""

    def __init__(self, extractors: list, extractor_name: str):
        super().__init__(extractor_name=extractor_name)
        self._extractors = list(extractors)

    def set_gcd(self, i3_file: str, gcd_file: Any = None) -> None:
        for extractor in self._extractors:
            if hasattr(extractor, "set_gcd"):
                extractor.set_gcd(i3_file, gcd_file)

    def __call__(self, data: Any):
        output: dict = {}
        for extractor in self._extractors:
            output.update(extractor(data))
        return output
