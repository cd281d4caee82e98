"""Samplers (counterpart of ``graphnet_tpu/data/samplers.py``).

``RandomChunkSampler`` shuffles the chunk order but keeps the rows of a
chunk together, so the ParquetDataset's chunk cache stays warm.
``LenMatchBatchSampler`` is in ``graphnet_tpu_torch.data.dataloader``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class RandomChunkSampler:
    """Yield indices chunk-by-chunk, random chunk order, random order
    within each chunk."""

    def __init__(
        self,
        chunk_sizes: Sequence[int],
        seed: Optional[int] = None,
    ):
        self._chunk_sizes = list(chunk_sizes)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return int(sum(self._chunk_sizes))

    def __iter__(self) -> Iterator[int]:
        cum = np.concatenate([[0], np.cumsum(self._chunk_sizes)])
        for c in self._rng.permutation(len(self._chunk_sizes)):
            start, stop = int(cum[c]), int(cum[c + 1])
            for i in self._rng.permutation(stop - start):
                yield start + int(i)
