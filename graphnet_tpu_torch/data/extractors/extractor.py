"""Extractor base class (counterpart of
``graphnet_tpu/data/extractors/extractor.py``; its ``CombinedExtractor``,
which only the IceTray extractors use, is not ported yet)."""

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
