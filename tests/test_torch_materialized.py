"""The port's batch store and replaying loaders against the JAX
package's on the CPU: the store's files byte for byte, stores written by
either package replayed by the other bit for bit, the epoch orders,
``stack_k`` grouping and process shards of ``MaterializedLoader``, the
``CachingLoader``'s orders, and the prefetching wrappers' contract."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.batch import StackedBatches as JaxStackedBatches
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu.data.constants import FEATURES as JAX_FEATURES
from graphnet_tpu.data.constants import TRUTH as JAX_TRUTH
from graphnet_tpu.data.dataloader import DataLoader as JaxDataLoader
from graphnet_tpu.data.materialized import MaterializedLoader as JaxMaterializedLoader
from graphnet_tpu.data.materialized import materialize as jax_materialize
from graphnet_tpu.data.prefetch import CachingLoader as JaxCachingLoader
from graphnet_tpu.data.sqlite_dataset import SQLiteDataset as JaxSQLiteDataset
from graphnet_tpu.models.detector.prometheus import Prometheus as JaxPrometheus
from graphnet_tpu.models.graphs import KNNGraph as JaxKNNGraph
from graphnet_tpu_torch.batch import StackedBatches, make_batch
from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH
from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.materialized import MaterializedLoader, materialize
from graphnet_tpu_torch.data.prefetch import (
    CachingLoader,
    EpochPipeline,
    PrefetchingLoader,
)
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
from graphnet_tpu_torch.models.detector.prometheus import Prometheus
from graphnet_tpu_torch.models.graphs import KNNGraph

torch.set_num_threads(2)

# (B, L) of each batch: three shape groups of 5, 7 and 2 batches
SHAPES = [(4, 16)] * 5 + [(3, 32)] * 7 + [(2, 64)] * 2
ORDER = np.random.default_rng(0).permutation(len(SHAPES))


def _batches():
    """The same batches for both packages (numpy from a seed), tagged by
    an ``id`` label, with node labels, and edges, an edge mask and event
    weights on the 64-long group."""
    rng = np.random.default_rng(1)
    port, jax_batches = [], []
    for i in ORDER:
        B, L = SHAPES[i]
        events = [rng.standard_normal((int(rng.integers(1, L + 1)), 5))
                  .astype(np.float32) for _ in range(B)]
        labels = {"id": np.full(B, i, np.int32),
                  "energy": rng.standard_normal(B).astype(np.float32)}
        nodes = [{"t": rng.standard_normal(len(e)).astype(np.float32)}
                 for e in events]
        b = make_batch(events, labels=labels, node_labels=nodes, length=L)
        jb = jax_make_batch(events, labels=labels, node_labels=nodes, length=L)
        if L == 64:
            extra = dict(edges=np.zeros((B, L, 3), np.int32),
                         edge_mask=np.ones((B, L, 3), bool),
                         event_weight=np.full((B,), 1.5, np.float32))
            b = replace(b, **{k: torch.from_numpy(v) for k, v in extra.items()})
            jb = jb.replace(**extra)
        port.append(b)
        jax_batches.append(jb)
    return port, jax_batches


class ListLoader:
    def __init__(self, batches):
        self.batches, self.iterations = batches, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        self.iterations += 1
        return iter(self.batches)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_store_is_the_jax_format_byte_for_byte(tmp_path):
    """The same batches packed by both packages: every file, meta.json
    included, the same bytes."""
    port, jax_batches = _batches()
    meta = materialize(ListLoader(port), str(tmp_path / "port"))
    jax_meta = jax_materialize(ListLoader(jax_batches), str(tmp_path / "jax"))
    assert meta == json.loads(json.dumps(jax_meta))
    got, exp = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(exp) and "meta.json" in got
    assert all(got[k] == exp[k] for k in exp)


def _port_tensors(b):
    return {k: v.numpy() for k, v in b.tensors().items()}


def _jax_tensors(b):
    """A JAX batch's arrays under the port's names (unpacked)."""
    b = b.unpacked()
    out = {"x": b.x, "mask": b.mask, "n_pulses": b.n_pulses}
    out.update({f"labels/{k}": b.labels[k] for k in sorted(b.labels)})
    out.update({f"node_labels/{k}": b.node_labels[k]
                for k in sorted(b.node_labels)})
    for name in ("edges", "edge_mask", "event_weight"):
        if getattr(b, name) is not None:
            out[name] = getattr(b, name)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same(port_batch, jax_batch):
    got, exp = _port_tensors(port_batch), _jax_tensors(jax_batch)
    assert list(got) == list(exp)
    for k in exp:
        assert got[k].dtype == exp[k].dtype, k
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)


def _loaders():
    kw = dict(pulsemaps="total", truth_table="mc_truth")
    jax_ds = JaxSQLiteDataset(EXAMPLE_SQLITE_DATA,
                              JaxKNNGraph(detector=JaxPrometheus()),
                              features=JAX_FEATURES.PROMETHEUS,
                              truth=JAX_TRUTH.PROMETHEUS, **kw)
    ds = SQLiteDataset(EXAMPLE_SQLITE_DATA, KNNGraph(detector=Prometheus()),
                       features=FEATURES.PROMETHEUS, truth=TRUTH.PROMETHEUS,
                       **kw)
    return (JaxDataLoader(jax_ds, batch_size=8, shuffle=True, seed=4),
            DataLoader(ds, batch_size=8, shuffle=True, seed=4))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_replay_across_the_packages(tmp_path, writer):
    """A store the JAX package packed from its DataLoader (packed labels
    and a ``label_spec``) replayed by the port, and a store the port
    packed (``labels/<k>`` leaves) replayed by the JAX package: each
    batch bit for bit the other reader's, in the same order."""
    jax_loader, loader = _loaders()
    path = str(tmp_path / "store")
    if writer == "jax":
        jax_materialize(jax_loader, path)
    else:
        materialize(loader, path)
    got = list(MaterializedLoader(path, shuffle=True, seed=2, device="cpu"))
    exp = list(JaxMaterializedLoader(path, shuffle=True, seed=2,
                                     to_device=False))
    assert len(got) == len(exp) == 7
    for g, e in zip(got, exp):
        _assert_same(g, e)
    if writer == "jax":
        assert exp[0].label_spec is not None and not exp[0].labels
    # the store's batches are the loader's, grouped by shape
    batches = list(loader)
    groups = {}
    for b in batches:
        groups.setdefault(b.signature(), []).append(b)
    flat = [b for g in groups.values() for b in g]
    replay = list(MaterializedLoader(path, shuffle=False, device="cpu",
                                     to_device=False))
    for a, b in zip(replay, flat):
        assert all(torch.equal(x, y) for x, y in zip(
            a.tensors().values(), b.tensors().values()))


def _ids(item):
    if isinstance(item, (StackedBatches, JaxStackedBatches)):
        return ("stack", tuple(int(v) for v in
                               np.asarray(item.batches.labels["id"])[:, 0]))
    return int(np.asarray(item.labels["id"])[0])


@pytest.mark.parametrize("options", [
    dict(shuffle=False),
    dict(shuffle=True, seed=5),
    dict(shuffle=True, seed=2, stack_k=3),
    dict(shuffle=False, stack_k=2),
    dict(shuffle=True, seed=11, process_count=2),
    dict(shuffle=True, seed=11, process_count=3),
    dict(shuffle=False, process_count=4),
], ids=["ordered", "shuffled", "stack_k_3", "ordered_stack_k_2",
        "shards_2", "shards_3", "ordered_shards_4"])
def test_materialized_orders_match_jax(tmp_path, options):
    """Three epochs (then ``set_epoch(7)``) of each configuration: the
    same batches in the same order, the same stacks, and for each of the
    processes of a shard the same shape-aligned share and ``len()``."""
    port, _ = _batches()
    path = str(tmp_path / "store")
    materialize(ListLoader(port), path)
    options = dict(options)
    count = options.pop("process_count", None)
    for index in range(count or 1):
        shard = dict(process_index=index, process_count=count) if count else {}
        ml = MaterializedLoader(path, device="cpu", **shard, **options)
        jml = JaxMaterializedLoader(path, **shard, **options)
        assert len(ml) == len(jml)
        for epoch in range(4):
            if epoch == 3:
                ml.set_epoch(7)
                jml.set_epoch(7)
            got, exp = [_ids(b) for b in ml], [_ids(b) for b in jml]
            assert got == exp, (index, epoch)
        if options.get("stack_k"):
            assert any(isinstance(g, tuple) for g in got)


def test_caching_loader_orders_match_jax():
    """The cold epoch in the loader's order (``set_epoch`` ignored while
    cold), then the replay permutations from ``seed + epoch``, both
    stores; the device store yields the same tensors each epoch."""
    port, jax_batches = _batches()
    for store in ("device", "host"):
        cl = CachingLoader(ListLoader(port), seed=3, store=store, device="cpu")
        jcl = JaxCachingLoader(ListLoader(jax_batches), seed=3, store=store)
        seen = []
        for epoch in (0, 1, 2, 5):
            cl.set_epoch(epoch)
            jcl.set_epoch(epoch)
            got = list(cl)
            assert [_ids(b) for b in got] == [_ids(b) for b in jcl]
            seen.append({_ids(b): b.x for b in got})
        assert [_ids(b) for b in port] == list(seen[0])
        assert len(cl) == len(port) and cl.loader.iterations == 1
        if store == "device":
            assert all(seen[2][i] is seen[1][i] for i in seen[1])
    with pytest.raises(ValueError):
        CachingLoader(ListLoader(port), store="disk", device="cpu")


def test_prefetching_wrappers():
    """``PrefetchingLoader`` yields every batch in order, forwards
    ``set_epoch`` and raises the loader's error in the consumer;
    ``EpochPipeline`` streams the epochs from ``start_epoch`` (calling
    ``set_epoch``), raises a producer's error, and ``close`` mid-epoch
    ends its thread."""
    port, _ = _batches()

    class Epochs(ListLoader):
        def __init__(self, batches, fail_at=None):
            super().__init__(batches)
            self.epochs, self.fail_at = [], fail_at

        def set_epoch(self, epoch):
            self.epochs.append(epoch)

        def __iter__(self):
            for i, b in enumerate(super().__iter__()):
                if i == self.fail_at:
                    raise RuntimeError("boom")
                yield b

    loader = Epochs(port)
    pf = PrefetchingLoader(loader, prefetch=2, device="cpu")
    assert [_ids(b) for b in pf] == [_ids(b) for b in port] and len(pf) == 14
    pf.set_epoch(3)
    assert loader.epochs == [3]
    with pytest.raises(RuntimeError, match="boom"):
        list(PrefetchingLoader(Epochs(port, fail_at=4), device="cpu"))

    loader = Epochs(port)
    with EpochPipeline(loader, 4, prefetch=3, device="cpu",
                       start_epoch=1) as pipe:
        epochs = [[_ids(b) for b in pipe.epoch()] for _ in range(3)]
    assert loader.epochs == [1, 2, 3]
    assert all(e == [_ids(b) for b in port] for e in epochs)
    pipe = EpochPipeline(Epochs(port, fail_at=2), 2, device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        list(pipe.epoch())
    pipe.close()
    pipe = EpochPipeline(Epochs(port), 50, prefetch=1, device="cpu")
    next(pipe.epoch())
    pipe.close()
    assert not pipe._thread.is_alive()


def test_materialize_guards(tmp_path):
    """No silent overwrite; a repack removes ``meta.json`` first; an
    empty loader and another store version raise; ``from_loader`` packs
    once; host batches are copies, not views of the store's file."""
    port, _ = _batches()
    path = str(tmp_path / "store")
    src = ListLoader(port)
    ml = MaterializedLoader.from_loader(src, path, shuffle=False,
                                        device="cpu", to_device=False)
    MaterializedLoader.from_loader(src, path, device="cpu")
    assert src.iterations == 1
    with pytest.raises(FileExistsError):
        materialize(src, path)

    def failing():
        yield port[0]
        assert not os.path.exists(os.path.join(path, "meta.json"))
        raise RuntimeError("crash mid-repack")

    with pytest.raises(RuntimeError):
        materialize(failing(), path, overwrite=True)
    with pytest.raises(FileNotFoundError):
        MaterializedLoader(path, device="cpu")
    materialize(src, path, overwrite=True)
    with pytest.raises(ValueError, match="no batches"):
        materialize(iter(()), str(tmp_path / "empty"))
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    first = next(iter(ml))
    stored = first.x.clone()
    first.x.add_(1.0)  # a copy: the store is unchanged
    assert torch.equal(next(iter(MaterializedLoader(
        path, shuffle=False, device="cpu"))).x, stored)
    meta["version"] = 2
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="version"):
        MaterializedLoader(path, device="cpu")
