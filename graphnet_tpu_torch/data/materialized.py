"""A batch store on disk: pack the padded batches once, replay them in
every later run (counterpart of ``graphnet_tpu/data/materialized.py``).

* :func:`materialize` runs the whole host pipeline (SQL queries, graph
  building, padding) once and streams every batch to a directory of
  contiguous binary files, one group a batch signature.
* :class:`MaterializedLoader` replays them from ``np.memmap`` views,
  reshuffled each epoch: no SQL, no graph building, no padding.

The store's format is the JAX package's, byte for byte (version 1): a
directory ``gNNN`` a group, one ``leaf_NNN.bin`` a tensor in the order of
``EventBatch.tensors()``, and ``meta.json`` (indent 1), written last
through ``os.replace``, so that a store without it is not a store.  A
store the JAX package wrote from its DataLoader holds the packed label
blocks ``packed_f`` / ``packed_i`` / ``packed_nl`` and their
``label_spec``: the reader splits them into label dicts as the JAX
package's ``EventBatch.unpack`` does.  A store the port writes holds
``labels/<key>`` leaves, which the JAX reader takes as they are.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from graphnet_tpu_torch.batch import EventBatch, StackedBatches, stack_batches
from graphnet_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_VERSION = 1
_META = "meta.json"
_PACKED = ("packed_f", "packed_i", "packed_nl")


def _tuplify(x):
    """JSON gives lists where the label spec had tuples."""
    if isinstance(x, list):
        return tuple(_tuplify(i) for i in x)
    return x


def _batch_leaves(batch: EventBatch) -> Dict[str, np.ndarray]:
    """The batch's tensors as named, contiguous host arrays."""
    return {name: np.ascontiguousarray(t.detach().cpu().numpy())
            for name, t in batch.tensors().items()}


class _GroupWriter:
    def __init__(self, root: str, gi: int, leaves: Dict[str, np.ndarray]):
        self.dir = os.path.join(root, f"g{gi:03d}")
        os.makedirs(self.dir, exist_ok=True)
        self.n = 0
        self.meta = {
            "dir": os.path.basename(self.dir),
            "label_spec": None,
            "leaves": [
                {"name": name, "file": f"leaf_{i:03d}.bin",
                 "dtype": str(a.dtype), "shape": list(a.shape)}
                for i, (name, a) in enumerate(leaves.items())
            ],
        }
        self._fh = [open(os.path.join(self.dir, m["file"]), "wb")
                    for m in self.meta["leaves"]]

    def append(self, leaves: Dict[str, np.ndarray]) -> None:
        for fh, m in zip(self._fh, self.meta["leaves"]):
            fh.write(leaves[m["name"]].tobytes())
        self.n += 1

    def close(self) -> dict:
        for fh in self._fh:
            fh.close()
        self.meta["n"] = self.n
        return self.meta


def materialize(loader, path: str, overwrite: bool = False) -> dict:
    """Pack every batch of ``loader`` into a store at ``path`` (a
    StackedBatches as its k batches); returns the metadata, which is
    also ``meta.json``.  An existing store raises unless ``overwrite``:
    its ``meta.json`` is removed before any leaf file is rewritten."""
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        if not overwrite:
            raise FileExistsError(
                f"{meta_path} exists; pass overwrite=True to repack")
        os.remove(meta_path)
    os.makedirs(path, exist_ok=True)
    writers: Dict[tuple, _GroupWriter] = {}
    n_batches = 0
    for item in loader:
        parts = item.unstack() if isinstance(item, StackedBatches) else [item]
        for batch in parts:
            leaves = _batch_leaves(batch)
            key = batch.signature()
            w = writers.get(key)
            if w is None:
                w = writers[key] = _GroupWriter(path, len(writers), leaves)
            w.append(leaves)
            n_batches += 1
    if n_batches == 0:
        raise ValueError("loader yielded no batches; nothing to pack")
    meta = {
        "version": _VERSION,
        "n_batches": n_batches,
        "groups": [w.close() for w in writers.values()],
    }
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, meta_path)  # meta.json appearing = the pack is whole
    return meta


def _unpack(leaves: Dict[str, torch.Tensor], label_spec) -> Dict[str, torch.Tensor]:
    """Label dicts from the JAX package's packed blocks (the slicing of
    its ``EventBatch.unpack``), as ``labels/<k>`` / ``node_labels/<k>``."""
    fspec, ispec, nspec = label_spec
    out = {k: v for k, v in leaves.items() if k not in _PACKED}
    o = 0
    for k, w, scalar in fspec:
        col = leaves["packed_f"][:, o:o + w]
        out[f"labels/{k}"] = (col[:, 0] if scalar else col).contiguous()
        o += w
    o = 0
    for k, w, scalar, isbool in ispec:
        col = leaves["packed_i"][:, o:o + w]
        if isbool:
            col = col.to(torch.bool)
        out[f"labels/{k}"] = (col[:, 0] if scalar else col).contiguous()
        o += w
    for i, k in enumerate(nspec):
        out[f"node_labels/{k}"] = leaves["packed_nl"][..., i].contiguous()
    return out


class _Group:
    def __init__(self, root: str, meta: dict, pin: bool):
        self.n = meta["n"]
        self.label_spec = _tuplify(meta["label_spec"])
        self.pin = pin
        self.maps: Dict[str, np.memmap] = {}
        self.dtypes: Dict[str, torch.dtype] = {}
        for m in meta["leaves"]:
            dtype = np.dtype(m["dtype"])
            self.maps[m["name"]] = np.memmap(
                os.path.join(root, meta["dir"], m["file"]), dtype=dtype,
                mode="r", shape=(self.n, *m["shape"]))
            self.dtypes[m["name"]] = torch.from_numpy(np.zeros(0, dtype)).dtype

    def batch(self, i: int) -> EventBatch:
        """Batch ``i`` copied out of the store into (pinned) host memory:
        a tensor never aliases the store's file."""
        leaves = {}
        for name, mm in self.maps.items():
            t = torch.empty(mm.shape[1:], dtype=self.dtypes[name],
                            pin_memory=self.pin)
            t.numpy()[...] = mm[i]
            leaves[name] = t
        if self.label_spec is not None:
            leaves = _unpack(leaves, self.label_spec)
        return EventBatch.from_tensors(leaves)


class MaterializedLoader:
    """Replay a store written by :func:`materialize`.

    Batches are read from ``np.memmap`` views (repeat epochs come from
    the page cache) into pinned host memory and copied to ``device``;
    the order is reshuffled each epoch from ``seed + epoch``.  It fits
    wherever a DataLoader does (``Trainer.fit``, the prefetching
    wrappers).

    Several processes: pass ``process_index`` / ``process_count``, and
    each reads a disjoint, shape-aligned shard.  At step t every process
    serves a batch of the same shape group, from its own slice of that
    group's shared permutation, each group cut to a multiple of
    ``process_count`` batches so that the processes take equal step
    counts.  Permutations and schedule come from ``seed + epoch``, so
    the processes agree without talking.

    Args:
        path: a directory written by :func:`materialize`.
        shuffle: a new batch order each epoch.
        seed: shuffle seed (the epoch is added).
        device: where the batches go (the GPU unless ``"cpu"``).
        to_device: False yields host batches and copies nothing.
        process_index / process_count: this process's shard (None:
            everything).
        stack_k: > 1 stacks runs of ``stack_k`` consecutive batches of
            one group on the host and copies each stack at once, as a
            :class:`~graphnet_tpu_torch.batch.StackedBatches` (for
            ``Trainer(steps_per_dispatch=k)``); runs cut short by a group
            change come singly.  Only with ``to_device``.
    """

    def __init__(self, path: str, shuffle: bool = True, seed: int = 0,
                 device: DeviceLike = "cuda", to_device: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 stack_k: int = 0):
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("version") != _VERSION:
            raise ValueError(
                f"unsupported store version {meta.get('version')!r}")
        self.path = path
        self.shuffle = shuffle
        self.seed = seed
        self.device = resolve_device(device)
        self.to_device = to_device
        self.stack_k = int(stack_k)
        pin = self.device.type == "cuda"
        self._groups = [_Group(path, g, pin) for g in meta["groups"]]
        self._index: List[Tuple[int, int]] = [
            (gi, i) for gi, g in enumerate(self._groups) for i in range(g.n)]
        self._epoch = 0
        if (process_index is None) != (process_count is None):
            raise ValueError("pass process_index and process_count together")
        if process_count is not None:
            if not 0 <= process_index < process_count:
                raise ValueError(
                    f"process_index {process_index} out of range for "
                    f"process_count {process_count}")
            if not any(g.n >= process_count for g in self._groups):
                raise ValueError(
                    f"no shape group has >= {process_count} batches; "
                    "nothing can be sharded in lockstep")
            dropped = sum(g.n % process_count for g in self._groups)
            if dropped:
                logger.warning(
                    "shape-aligned sharding over %d processes drops %d/%d "
                    "batches (per-group remainders); repack with batch "
                    "counts divisible by process_count to serve everything",
                    process_count, dropped, len(self._index))
        self.process_index = process_index
        self.process_count = process_count

    @classmethod
    def from_loader(cls, loader, path: str, **kwargs) -> "MaterializedLoader":
        """Open ``path``, packing it from ``loader`` first if absent."""
        if not os.path.exists(os.path.join(path, _META)):
            materialize(loader, path)
        return cls(path, **kwargs)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle to ``epoch``: ``Trainer.fit`` calls it at each
        epoch's start, so a resumed run replays the batch order of an
        unbroken one."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        if self.process_count is not None:
            return sum(g.n // self.process_count for g in self._groups)
        return len(self._index)

    def _epoch_order(self) -> List[Tuple[int, int]]:
        """(group, batch) sequence of this epoch, the same on every
        process."""
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.process_count is None:
            order = np.arange(len(self._index))
            if self.shuffle:
                order = rng.permutation(order)
            return [self._index[j] for j in order]
        mine: List[Iterator[int]] = []
        schedule: List[int] = []
        for gi, g in enumerate(self._groups):
            order = np.arange(g.n)
            if self.shuffle:
                order = rng.permutation(order)
            per = g.n // self.process_count
            lo = self.process_index * per
            mine.append(iter(order[lo:lo + per].tolist()))
            schedule.extend([gi] * per)
        sched = np.asarray(schedule, dtype=np.int64)
        if self.shuffle:
            sched = rng.permutation(sched)
        return [(int(gi), next(mine[gi])) for gi in sched]

    def _put(self, batch):
        return batch.to(self.device)

    def __iter__(self) -> Iterator:
        order = self._epoch_order()
        self._epoch += 1
        if self.stack_k > 1 and self.to_device:
            yield from self._iter_stacked(order)
            return
        for gi, i in order:
            batch = self._groups[gi].batch(i)
            yield self._put(batch) if self.to_device else batch

    def _iter_stacked(self, order) -> Iterator:
        """Runs of ``stack_k`` consecutive batches of one group, stacked
        on the host and copied at once; shorter runs (at a group change
        or the end) singly.  Never reorders, so the shard schedule of
        several processes stays in lockstep."""

        def flush(group):
            if len(group) == self.stack_k:
                yield self._put(stack_batches(group))
            else:
                for b in group:
                    yield self._put(b)

        group: List[EventBatch] = []
        last_gi = None
        for gi, i in order:
            if last_gi is not None and (
                    gi != last_gi or len(group) == self.stack_k):
                yield from flush(group)
                group = []
            group.append(self._groups[gi].batch(i))
            last_gi = gi
        if group:
            yield from flush(group)
