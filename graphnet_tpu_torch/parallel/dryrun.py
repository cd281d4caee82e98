"""One training step of each layout across processes (the counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m graphnet_tpu_torch.parallel.dryrun --nproc 2 --device cuda

spawns ``--nproc`` processes (one a device; several on one card share it
over gloo, as NCCL refuses two ranks on one device) and runs, through
``Trainer(mesh=..., param_sharding=...)``, one full training step of:

  * ``dp``: ``StandardModel(DynEdge(nb_inputs=4))`` at the full width
    (``((128, 256), (336, 256) x 3)``, post ``(336, 256)``, k = 8) with
    the JAX dry run's energy and direction tasks, DDP over ``data``,
    B = 4 events a process, L = 64;
  * ``graph``: the same on a ``(data, graph)`` mesh, each event's nodes
    split over ``graph``, ``--graph-shape`` (B = 4 a data slice, L =
    128 by default); then ``graph_long``, one event a data slice of
    ``--long-l`` nodes (12288), past 8192 (row 1's rounds kernel);
  * ``fsdp``: the DP step under FSDP2;
  * ``tp``: ``StandardModel(DynEdgeTITO(nb_inputs=4))`` on a ``(data,
    model)`` mesh with the attention and feed-forward layers sharded
    over ``model``, B = 2 a data slice, L = 32.

The models, tasks and batch generator are the JAX dry run's; the shapes
are not all its (it takes B = 2 a device and L = 32 for DP and TP, L =
16 and 512 a graph process for the graph steps).  DP and FSDP take B = 4
a process and L = 64 (TP keeps the JAX shape); ``graph_long`` takes L =
12288 to reach row 1's rounds kernel; ``graph`` takes B = 4, L = 128
because at B = 2, L = 64 (``--graph-shape 2,64``) the H100 held one
gradient only to 1.6e-3 of its largest entry: there one edge's second
pre-activation lies within fp32 rounding of 0 (1.2e-6 in fp64), and
row 3 sets that gate one way on the one-process step's inputs and the
other way on the node shard's, whose self term cuBLAS rounds apart
(``PERF.md``; ``--audit-kernels`` shows it).

Rank 0 also runs each step in one process (no mesh) on the same global
batch and weights, and checks: every loss finite, the layout's loss (the
mean of the processes' losses) within ``LOSS_RTOL`` of the
single-process loss (``GRAPH_LOSS_RTOL`` on a graph axis), each
parameter's gradient within ``GRAD_TOL`` of its largest one, FSDP's loss
equal to DP's within ``LOSS_RTOL``, and on a graph axis the input kNN
graph of each process's rows equal to the unsharded event's, bit for
bit (latent graphs that differ are counted).  The parameters after the
step are reported (entries beyond ``PARAM_RTOL`` / ``PARAM_ATOL``), not
checked: at full width the random model's gradients are large (losses
~1e6 at L = 12288), and Adam moves an entry whose gradient is rounding
noise around 0 by up to the learning rate either way.  Each process
counts its kernel launches (rows 1-3, 5a-c) and the bytes and calls of
its collectives (``CollectiveTape``: DDP's gradient all-reduce, node
sharding's all-gathers) in the step, then times a
second step (no recording, host clock, after a device
synchronisation).  ``--audit-kernels`` holds every call of rows 2 and 3
in both steps against its plain version on the CPU and, for row 3,
names the node whose ``da`` differs most with the smallest
pre-activations of its edges.  One JSON line a layout; the last line
``{"ok": true|false}``.

The CPU tests run the same workers at narrow widths
(``--width narrow``).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

LOSS_RTOL = 1e-5
GRAPH_LOSS_RTOL = 1e-4
# of each parameter's largest gradient, as chip_smoke's train phase: a
# gate that rounding opens on one side only moves one edge's share of a
# gradient (on the card a node shard's matrix products round apart from
# the whole event's; see the module docstring)
GRAD_TOL = 1e-3
# the graph layout's events a data slice and nodes an event
GRAPH_SHAPE = (4, 128)
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-5
LAYOUTS = ("dp", "graph", "graph_long", "fsdp", "tp")
NARROW = dict(dynedge_layer_sizes=((32, 64), (64, 64)),
              post_processing_layer_sizes=(64, 32), readout_layer_sizes=(16,))
NARROW_TITO = dict(dyntrans_layer_sizes=((16, 16), (16, 16)), n_head=4,
                   post_processing_layer_sizes=(24, 16),
                   readout_layer_sizes=(16, 8))


def example_batch(B: int, L: int, seed: int = 0, D: int = 4):
    """The JAX dry run's batch (``__graft_entry__._example_batch``): events
    of 5 to L - 1 normal pulses, an energy and a unit direction each."""
    from graphnet_tpu_torch.batch import make_batch

    rng = np.random.default_rng(seed)
    events = [rng.standard_normal((int(rng.integers(5, L)), D)).astype(np.float32)
              for _ in range(B)]
    labels = {
        "total_energy": np.abs(rng.standard_normal(B).astype(np.float32)
                               * 100.0 + 200.0),
        "direction": rng.standard_normal((B, 3)).astype(np.float32),
    }
    labels["direction"] /= np.linalg.norm(labels["direction"], axis=1,
                                          keepdims=True)
    return make_batch(events, labels=labels, length=L)


def build_model(kind: str, device, width: str = "full", seed: int = 0):
    """The JAX dry run's model (``__graft_entry__._model``): DynEdge (or
    DynEdgeTITO) with a log10 energy head under LogCosh and a direction
    head under the von Mises-Fisher loss; ``width="narrow"`` for tests."""
    import torch

    from graphnet_tpu_torch.models.gnn.dynedge import DynEdge
    from graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito import DynEdgeTITO
    from graphnet_tpu_torch.models.standard_model import StandardModel
    from graphnet_tpu_torch.models.task.reconstruction import (
        DirectionReconstructionWithKappa,
        EnergyReconstruction,
    )
    from graphnet_tpu_torch.training.loss_functions import (
        LogCoshLoss,
        VonMisesFisher3DLoss,
    )

    narrow = width == "narrow"
    if kind == "dynedge":
        backbone = DynEdge(nb_inputs=4, **(NARROW if narrow else {}))
    else:
        backbone = DynEdgeTITO(nb_inputs=4, **(NARROW_TITO if narrow else {}))
    hidden = backbone.nb_outputs
    return StandardModel(
        backbone,
        [EnergyReconstruction(hidden_size=hidden, loss_function=LogCoshLoss(),
                              target_labels=("total_energy",),
                              transform_prediction_and_target=torch.log10),
         DirectionReconstructionWithKappa(
             hidden_size=hidden, loss_function=VonMisesFisher3DLoss(),
             target_labels=("direction",))],
        seed=seed, device=device)


def layout_spec(layout: str, nproc: int, long_l: int,
                graph_shape: Tuple[int, int] = GRAPH_SHAPE) -> Dict:
    """Mesh, sharding, model and batch of one layout for ``nproc``
    processes (the shapes of the module's docstring; ``graph_shape``:
    the graph layout's events a data slice and nodes an event)."""
    pair = 2 if nproc % 2 == 0 else 1
    if layout == "dp":
        return dict(axes=("data", "model"), shape=(nproc, 1), sharding="replicated",
                    kind="dynedge", B=4 * nproc, L=64)
    if layout in ("graph", "graph_long"):
        n_data = nproc // pair
        L = graph_shape[1] if layout == "graph" else long_l
        B = (graph_shape[0] if layout == "graph" else 1) * n_data
        return dict(axes=("data", "graph"), shape=(n_data, pair),
                    sharding="replicated", kind="dynedge", B=B, L=L)
    if layout == "fsdp":
        return dict(axes=("data", "model"), shape=(nproc, 1), sharding="fsdp",
                    kind="dynedge", B=4 * nproc, L=64)
    if layout in ("tp", "fsdp+tp"):
        return dict(axes=("data", "model"), shape=(nproc // pair, pair),
                    sharding=layout, kind="tito", B=2 * (nproc // pair), L=32)
    raise ValueError(layout)


def _counters():
    from graphnet_tpu_torch.ops import flash_attention_cuda as fa
    from graphnet_tpu_torch.ops.edgeconv_cuda import fused_edgeconv, fused_edgeconv_bwd
    from graphnet_tpu_torch.ops.knn_cuda import knn_graph_cuda

    return {"knn": knn_graph_cuda, "edgeconv": fused_edgeconv,
            "edgeconv_bwd": fused_edgeconv_bwd,
            "flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv}


class GraphTape:
    """Records each kNN graph the model builds (``layers.knn_graph``:
    the whole event's, sharded or not)."""

    def __init__(self):
        from graphnet_tpu_torch.models.components import layers
        from graphnet_tpu_torch.models.gnn import dynedge

        self.modules, self.graphs = (layers, dynedge), []

    def __enter__(self):
        self.saved = [m.knn_graph for m in self.modules]
        for m, fn in zip(self.modules, self.saved):
            m.knn_graph = self._wrap(fn)
        return self

    def _wrap(self, fn):
        def knn(coords, mask, k, exclude_self=True):
            out = fn(coords, mask, k=k, exclude_self=exclude_self)
            self.graphs.append(tuple(t.detach().cpu() for t in out))
            return out
        return knn

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            m.knn_graph = fn


class KernelAudit:
    """Holds each call of rows 2 and 3 in a step against its plain
    version on the CPU, on the same inputs (``--audit-kernels``): for
    each call, each output's largest error over its largest entry; for
    row 3 also the node whose ``da`` differs most and, in fp64 from the
    same inputs, the smallest ``|z|`` and ``|pre2|`` over its edges (a
    gate whose pre-activation lies within fp32 rounding of 0 closes on
    one side of the two arithmetics and opens on the other)."""

    def __init__(self):
        from graphnet_tpu_torch.ops import edgeconv_cuda

        self.ec, self.errors = edgeconv_cuda, {"edgeconv": [], "edgeconv_bwd": []}

    def __enter__(self):
        ec = self.ec
        self.saved = fwd, bwd = ec.edgeconv_fwd_op, ec.edgeconv_bwd_op

        def audited(name, op, plain):
            def call(*args):
                outs = op(*args)
                cpu = [a.cpu() if hasattr(a, "cpu") else a for a in args]
                refs = plain(*cpu)
                if not isinstance(outs, tuple):
                    outs, refs = (outs,), (refs,)
                diffs = [(o.cpu().float() - r.float()).abs()
                         for o, r in zip(outs, refs)]
                entry = dict(errors=[
                    float(d.max()) / max(float(r.abs().max()), 1e-30)
                    for d, r in zip(diffs, refs)])
                if name == "edgeconv_bwd":
                    entry.update(_near_zero_gates(cpu, diffs[0]))
                self.errors[name].append(entry)
                return outs if len(outs) > 1 else outs[0]
            return call

        ec.edgeconv_fwd_op = audited("edgeconv", fwd, ec.fused_edgeconv_plain)
        ec.edgeconv_bwd_op = audited("edgeconv_bwd", bwd,
                                     ec.fused_edgeconv_bwd_plain)
        return self

    def __exit__(self, *exc):
        self.ec.edgeconv_fwd_op, self.ec.edgeconv_bwd_op = self.saved


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "broadcast")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def collective_bytes(op: str, args, kwargs) -> int:
    """The bytes one call of ``op`` hands the group: an all-reduce's or a
    broadcast's tensor, an all-gather's whole gathered output, a
    reduce-scatter's whole input (the sizes the ring formulas of
    ``parallel/scaling_model.py`` take)."""
    def arg(i, name):
        return args[i] if len(args) > i else kwargs[name]

    if op in ("all_reduce", "broadcast"):
        return _nbytes(arg(0, "tensor"))
    if op == "all_gather":
        return sum(_nbytes(t) for t in arg(0, "tensor_list"))
    if op == "all_gather_into_tensor":
        return _nbytes(arg(0, "output_tensor"))
    if op == "reduce_scatter":
        return sum(_nbytes(t) for t in arg(1, "input_list"))
    return _nbytes(arg(1, "input"))  # reduce_scatter_tensor


class CollectiveTape:
    """Counts the bytes and calls of each collective of a step in this
    process: ``torch.distributed``'s collectives, wrapped while the tape
    is on (node sharding's all-gathers, all-reduces and reduce-scatter,
    tensor parallelism's all-reduces), and DDP's gradient buckets,
    read as ``ddp_grad`` by :meth:`count_ddp` from the reducer itself
    (it all-reduces each bucket once a step; no comm hook is put in its
    way, so a later step runs DDP's own reducer).  FSDP2's
    all-gather and reduce-scatter are counted where its version calls
    these functions (torch 2.11 on CUDA tensors does, one of each a
    step; torch 2.13 over gloo on the CPU calls neither)."""

    def __init__(self):
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self._on = False

    def _wrap(self, op, fn):
        def call(*args, **kwargs):
            if self._on:
                self.bytes[op] = self.bytes.get(op, 0) + collective_bytes(
                    op, args, kwargs)
                self.calls[op] = self.calls.get(op, 0) + 1
            return fn(*args, **kwargs)
        return call

    def __enter__(self):
        import torch.distributed as dist

        self.saved = {op: getattr(dist, op) for op in COLLECTIVES}
        for op, fn in self.saved.items():
            setattr(dist, op, self._wrap(op, fn))
        self._on = True
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        self._on = False
        for op, fn in self.saved.items():
            setattr(dist, op, fn)

    def count_ddp(self, ddp):
        """Records one step of ``ddp``'s gradient all-reduce: the bytes
        of its reducer's buckets and one call a bucket."""
        buckets = [b.buffer() for b in ddp.reducer._get_zeros_like_grad_buckets()]
        self.bytes["ddp_grad"] = sum(b.numel() * b.element_size() for b in buckets)
        self.calls["ddp_grad"] = len(buckets)


def _near_zero_gates(args, da_diff) -> Dict:
    """Of row 3's call ``args`` (CPU tensors): the node whose ``da``
    differs most, and the smallest ``|z|`` and ``|pre2|`` over its valid
    edges, in fp64."""
    from graphnet_tpu_torch.ops.edgeconv_cuda import _act

    a, b, idx, em, w2, b2, _, _, slope = args
    ev, i = divmod(int(da_diff.amax(-1).argmax()), a.shape[1])
    z = a[ev, i].double() + b[ev].double()[idx[ev, i].long()]
    pre2 = _act(z, slope) @ w2.double() + b2.double()
    valid = em[ev, i]
    if not bool(valid.any()):
        return dict(worst_node=[ev, i], min_abs_z=None, min_abs_pre2=None)
    return dict(worst_node=[ev, i], min_abs_z=float(z[valid].abs().min()),
                min_abs_pre2=float(pre2[valid].abs().min()))


def run_layout(layout: str, device, width: str, long_l: int,
               out_dir: Optional[str], graph_shape=GRAPH_SHAPE,
               audit_kernels: bool = False):
    """One layout's step in this process (all processes call it);
    returns rank 0's report (None elsewhere)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from graphnet_tpu_torch.training.trainer import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    spec = layout_spec(layout, world, long_l, graph_shape)
    graph = spec["axes"][1] == "graph"
    mesh = init_device_mesh(device.type, spec["shape"], mesh_dim_names=spec["axes"])
    batch = example_batch(spec["B"], spec["L"], seed=3 if layout == "graph_long" else 0)
    model = build_model(spec["kind"], device, width)
    # FSDP2 shards leaves of 2^10 elements and more, as the JAX dry run
    trainer = Trainer(model, mesh=mesh, param_sharding=spec["sharding"],
                      fsdp_min_size=2**10)
    comms = CollectiveTape()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rounds0 = counters["knn"].launches_rounds
    audit = KernelAudit() if audit_kernels else contextlib.nullcontext()
    with GraphTape() as tape, audit, comms:
        loss = trainer.train_step(batch)
    if isinstance(trainer._forward, torch.nn.parallel.DistributedDataParallel):
        comms.count_ddp(trainer._forward)
    launches = {n: c.launches for n, c in counters.items()}
    launches["knn_rounds"] = counters["knn"].launches_rounds - rounds0
    grads = {k: v.detach().clone() for k, v in trainer._full_state(
        {n: p.grad for n, p in model.named_parameters()}).items()}
    params = {k: v.detach().clone() for k, v in trainer._full_state().items()}
    mean_loss = float(trainer._mean_over_processes(loss))
    # a second step, timed without the tapes
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    trainer.train_step(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    n_data = spec["shape"][0]
    per = spec["B"] // n_data
    first = mesh.get_local_rank("data") * per
    reports = [None] * world
    dist.all_gather_object(reports, dict(
        rank=rank, local_loss=float(loss), launches=launches, first=first,
        collective_bytes=comms.bytes, collective_calls=comms.calls,
        audit=audit.errors if audit_kernels else None,
        seconds=round(seconds, 4), graphs=[tuple(t.numpy() for t in g)
                                           for g in tape.graphs]))
    if out_dir is not None and rank == 0:
        torch.save({"loss": mean_loss, "params": {k: v.cpu() for k, v in params.items()},
                    "grads": {k: v.cpu() for k, v in grads.items()}},
                   os.path.join(out_dir, f"{layout}.pt"))
    dist.barrier()
    if rank != 0:
        return None
    # the same step in this process alone
    ref_model = build_model(spec["kind"], device, width)
    ref = Trainer(ref_model)
    ref_audit = KernelAudit() if audit_kernels else contextlib.nullcontext()
    with GraphTape() as ref_tape, ref_audit:
        ref_loss = float(ref.train_step(batch))
    rtol = GRAPH_LOSS_RTOL if graph else LOSS_RTOL
    ref_state = ref_model.state_dict()
    params_off, params_max = 0, 0.0
    for name, v in params.items():
        e = ref_state[name].detach().float()
        diff = (v.float() - e).abs()
        params_off += int((diff > PARAM_ATOL + PARAM_RTOL * e.abs()).sum())
        params_max = max(params_max, float(diff.max()))
    ref_grads = {n: p.grad for n, p in ref_model.named_parameters()}
    grad_err, grad_worst = grad_error(grads, ref_grads)
    report = dict(
        layout=layout, ranks=world, backend=dist.get_backend(),
        mesh=dict(zip(spec["axes"], spec["shape"])),
        sharding=spec["sharding"], model=spec["kind"], width=width,
        B=spec["B"], L=spec["L"], loss=mean_loss, loss_single_process=ref_loss,
        loss_rel_err=abs(mean_loss - ref_loss) / max(abs(ref_loss), 1e-30),
        loss_rtol=rtol, grad_err_of_max=grad_err, grad_worst=grad_worst,
        grad_tol=GRAD_TOL,
        params_entries_beyond_tol=params_off,
        params_max_abs_diff=params_max,
        launches_per_rank=[r["launches"] for r in reports],
        n_params=sum(p.numel() for p in ref_model.parameters()),
        collective_bytes_per_rank=[r["collective_bytes"] for r in reports],
        collective_calls_per_rank=[r["collective_calls"] for r in reports],
        second_step_seconds_per_rank=[r["seconds"] for r in reports])
    report["finite"] = bool(np.isfinite(mean_loss)
                            and all(np.isfinite(r["local_loss"]) for r in reports))
    report["loss_ok"] = report["loss_rel_err"] <= rtol
    if graph:
        report.update(graph_check(reports, ref_tape.graphs))
    if audit_kernels:
        report["kernel_audit_per_rank"] = [r["audit"] for r in reports]
        report["kernel_audit_one_process"] = ref_audit.errors
    report["ok"] = bool(report["finite"] and report["loss_ok"]
                        and grad_err <= GRAD_TOL
                        and report.get("input_graph_equal", True))
    return report


def grad_error(grads, exp_grads) -> Tuple[float, Optional[str]]:
    """The largest ``|got - exp|`` of a parameter's gradient over that
    parameter's largest ``|exp|``, and the parameter."""
    worst, name = 0.0, None
    for n, e in exp_grads.items():
        e = e.detach().float().cpu()
        err = float((grads[n].detach().float().cpu() - e).abs().max()) / max(
            float(e.abs().max()), 1e-30)
        if err > worst:
            worst, name = err, n
    return worst, name


def graph_check(reports, ref_graphs) -> Dict:
    """Each process's first (input) kNN graph against the unsharded
    event's, bit for bit, and the latent graphs' differing rows."""
    equal, flips = True, 0
    for r in reports:
        for layer, (g, ref) in enumerate(zip(r["graphs"], ref_graphs)):
            # whole gathered events of this process's data slice
            events = slice(r["first"], r["first"] + g[0].shape[0])
            ref_idx, ref_em = (t.numpy()[events] for t in ref)
            same = (np.array_equal(g[1], ref_em)
                    and np.array_equal(np.where(g[1], g[0], 0),
                                       np.where(ref_em, ref_idx, 0)))
            if layer == 0:
                equal = equal and same
            elif not same:
                flips += int((np.where(g[1], g[0], -1)
                              != np.where(ref_em, ref_idx, -1)).any(-1).sum())
    return {"input_graph_equal": equal, "latent_rows_differing": flips,
            "graph_calls_per_rank": [len(r["graphs"]) for r in reports]}


def worker(args) -> int:
    import torch
    import torch.distributed as dist

    from graphnet_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(args.threads)
    if args.device == "cuda":
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", args.rank % n_cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if args.nproc == 1:  # a mesh needs a process group, even of one
        dist.init_process_group(
            args.backend, init_method=args.init, world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=args.timeout))
    else:
        init_distributed(args.init, args.nproc, args.rank, device=device,
                         backend=args.backend, timeout_s=args.timeout)
    reports = []
    for layout in args.layouts.split(","):
        report = run_layout(layout, device, args.width, args.long_l, args.out,
                            args.graph_shape, args.audit_kernels)
        if report is not None:
            reports.append(report)
            print(json.dumps(report), flush=True)
    if args.rank == 0 and args.report:
        with open(args.report, "w") as f:
            json.dump(reports, f)
    dist.destroy_process_group()
    return 0


def backend_for(device: str, nproc: int) -> str:
    """NCCL with a card a process; gloo on the CPU and where several
    processes share a card.  NCCL refuses two ranks on one device; gloo
    carries every collective the layouts use on CUDA tensors there
    (c10d's all-reduce, broadcast, all-gather and reduce-scatter, DDP and
    the FSDP2 step, values checked), but not ``DTensor.full_tensor``,
    which ends the process, so the Trainer never calls it
    (``tools/collectives_probe.py`` on the H100 host, torch 2.11)."""
    if device == "cpu":
        return "gloo"
    import torch

    return "nccl" if torch.cuda.device_count() >= nproc else "gloo"


def launch(nproc: int, device: str, layouts: str, width: str = "full",
           long_l: int = 12288, timeout: float = 900.0, threads: int = 2,
           out: Optional[str] = None,
           graph_shape: Tuple[int, int] = GRAPH_SHAPE,
           audit_kernels: bool = False) -> List[Dict]:
    """Spawn the ``nproc`` worker processes (on :func:`backend_for`'s
    backend) for ``layouts`` (comma-separated), wait for them (killing
    all at ``timeout`` seconds) and return rank 0's reports."""
    backend = backend_for(device, nproc)
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    init = f"file://{os.path.join(tmp, 'store')}"
    report = os.path.join(tmp, "report.json")
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "graphnet_tpu_torch.parallel.dryrun", "--worker",
           "--nproc", str(nproc), "--device", device, "--layouts", layouts,
           "--width", width, "--long-l", str(long_l), "--init", init,
           "--backend", backend, "--threads", str(threads), "--report", report,
           "--timeout", str(timeout),
           "--graph-shape", ",".join(map(str, graph_shape))]
    if out is not None:
        cmd += ["--out", out]
    if audit_kernels:
        cmd += ["--audit-kernels"]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(nproc)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"dry run did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
    with open(report) as f:
        return json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--layouts", default=",".join(LAYOUTS))
    parser.add_argument("--width", default="full", choices=("full", "narrow"))
    parser.add_argument("--long-l", type=int, default=12288)
    parser.add_argument("--graph-shape", default=GRAPH_SHAPE,
                        type=lambda v: tuple(int(n) for n in v.split(",")),
                        help="the graph layout's events a data slice and "
                        "nodes an event, 'B,L' (default 4,128)")
    parser.add_argument("--audit-kernels", action="store_true",
                        help="every call of rows 2 and 3 in each process's "
                        "step and in the one-process step against its plain "
                        "version on the CPU")
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("--threads", type=int, default=2)
    parser.add_argument("--out", default=None,
                        help="directory for rank 0's losses, gradients and "
                        "parameters after each step (<layout>.pt)")
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--init", default=None)
    parser.add_argument("--backend", default=None)
    parser.add_argument("--report", default=None)
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args)
    reports = launch(args.nproc, args.device, args.layouts, args.width,
                     args.long_l, args.timeout, args.threads, args.out,
                     args.graph_shape, args.audit_kernels)
    for r in reports:
        print(json.dumps(r))
    ok = all(r["ok"] for r in reports)
    by = {r["layout"]: r for r in reports}
    if "dp" in by and "fsdp" in by:
        fsdp_eq = abs(by["fsdp"]["loss"] - by["dp"]["loss"]) <= LOSS_RTOL * max(
            1.0, abs(by["dp"]["loss"]))
        ok = ok and fsdp_eq
        print(json.dumps({"fsdp_equals_dp": fsdp_eq}))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
