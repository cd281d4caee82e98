"""Set-up, window and check of one cell.

A ``train`` mix drives the port's ``DataLoader`` into ``Trainer.train_step``
(as ``Trainer.fit`` does a step); a ``reprocess`` mix sends requests from
one closed-loop client to ``DeploymentModule.__call__``.  Set-up builds
the kernels, the events, the model from the configuration's ``model.yml``
through ``load_model`` with seeded weights made on the device, the trainer
or the deployment, and warms up the shapes the window uses; a training
cell's set-up also drives the trainer through the three steps that the
check compares.  The window then runs for ``--seconds``.  With tracing, a
profiler session covers the first stretch of the window
(:data:`TRACE_SECONDS`) and the rest runs untraced.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import yaml

from harness import capture, check, spec, traffic, weights
from harness.capture import GraphRecorder
from harness.peaks import peaks_for
from harness.trace import Trace, Tracer

# the traced stretch at the start of a traced window (at most half of it)
TRACE_SECONDS = 3.0
# profiler sessions tried before a run with no device activity fails
TRACE_ATTEMPTS = 3
# training steps the check compares
CHECK_STEPS = 3
FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "adam_second_moment")


class RecordingDataset:
    """The mix's events as the DataLoader's dataset; remembers the events
    of each batch it hands out (the reference pads them anew)."""

    def __init__(self, events: List, lengths: np.ndarray):
        self._events = events
        self._lengths = lengths
        self.last: List[int] = []

    def __len__(self) -> int:
        return len(self._events)

    def __getitem__(self, i: int):
        return self._events[i]

    def event_lengths(self) -> np.ndarray:
        return self._lengths

    def get_events(self, idxs: Sequence[int]) -> List:
        self.last = list(idxs)
        return [self._events[i] for i in idxs]


@dataclass
class Record:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    kind: str
    model_cfg: Dict
    counts: object
    peaks: Dict[str, float]
    dtype: str
    setup_s: float = 0.0
    phases: Dict[str, float] = field(default_factory=dict)
    window_s: float = 0.0
    events: int = 0
    calls: int = 0
    latencies_s: List[float] = field(default_factory=list)
    # each call's events' pulse counts
    work: List[np.ndarray] = field(default_factory=list)
    # traced runs: each call's valid and total pulse slots, as the program
    # padded its batch
    slots: List[Tuple[int, int]] = field(default_factory=list)
    loader_s: float = 0.0
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    # the untraced rest of a traced window: model FLOPs issued and seconds
    flops: float = 0.0
    flops_s: float = 0.0
    trace: Optional[Trace] = None
    trace_bytes: int = 0  # the chrome trace written and deleted
    formulas: object = None


class Cell:
    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", root=spec.ROOT, faults: Sequence[str] = ()):
        import torch

        self.torch = torch
        self.root = root
        self.bench = spec.load_benchmark(root)
        self.name = name
        self.workload = spec.workload(self.bench, name)
        self.cfg = spec.config(self.workload["config"], root)
        self.mix = spec.traffic(self.workload["traffic"], root)
        self.ref = spec.module("reference", self.cfg["family"], root)
        self.seed, self.seconds, self.traced = int(seed), float(seconds), trace
        self.device = torch.device(device)
        unknown = set(faults) - set(FAULTS)
        if unknown:
            raise ValueError(f"unknown faults {sorted(unknown)}")
        self.faults = set(faults)
        self.kind = "train" if self.mix["kind"] == "train" else "serve"
        name = (torch.cuda.get_device_name(0) if self.device.type == "cuda"
                else "cpu")
        self.rec = Record(kind=self.kind, model_cfg=self.cfg["model"],
                          counts=spec.module("counts", self.cfg["family"], root),
                          peaks=peaks_for(name), dtype=str(self.cfg["dtype"]))
        self._formulas: Dict[str, object] = {}

    # ------------------------------------------------------------ set-up
    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.rec.phases[name] = time.perf_counter() - t

    def weights(self) -> Dict:
        return weights.make_weights(self.shapes, self.seed, self.device,
                                    self.ref.init_std)

    def setup(self) -> None:
        from graphnet_tpu_torch.kernels import build
        from graphnet_tpu_torch.models.graphs.graph_definition import Event
        from graphnet_tpu_torch.utils.config import load_model

        if self.device.type == "cuda":
            with self.phase("kernels"):
                build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))
        with self.phase("events"):
            self.events = traffic.make_events(self.cfg, self.mix, self.seed,
                                              self.root)
            ev = self.events
            self.event_objs = [Event(x=ev.event(i), features=ev.features,
                                     labels=ev.label_row(i))
                               for i in range(len(ev))]
        with self.phase("model"):
            fd, path = tempfile.mkstemp(suffix=".yml", prefix="portbench-model-")
            with os.fdopen(fd, "w") as f:
                yaml.safe_dump(self.cfg["model"], f, sort_keys=False)
            try:
                self.model = load_model(path, str(self.device), 0)
            finally:
                os.unlink(path)
            self.shapes = [(n, tuple(p.shape))
                           for n, p in self.model.named_parameters()]
            weights.fill_model(self.model, self.weights())
        if self.kind == "train":
            self._setup_train()
        else:
            with self.phase("warmup"):
                self._setup_serve()

    def _setup_train(self) -> None:
        import functools

        from graphnet_tpu_torch.data.dataloader import DataLoader, collate_events
        from graphnet_tpu_torch.training.trainer import Trainer

        torch, mix = self.torch, self.mix
        opt = mix["optimizer"]
        if opt["name"] != "adam":
            raise spec.SpecError(f"optimizer {opt['name']!r}")
        self.lr, self.eps = float(opt["lr"]), float(opt["eps"])
        self.dataset = RecordingDataset(self.event_objs, self.events.n)
        lo = mix["loader"]
        self.loader = DataLoader(self.dataset, batch_size=int(mix["batch_size"]),
                                 shuffle=bool(lo["shuffle"]), seed=self.seed,
                                 buckets=lo["buckets"],
                                 length_matching=bool(lo["length_matching"]))
        # a planted fault: Adam's second moment decays at 0.99, not 0.999
        betas = (check.BETAS[0], 0.99 if "adam_second_moment" in self.faults
                 else check.BETAS[1])
        self.trainer = Trainer(self.model, optimizer=functools.partial(
            torch.optim.Adam, lr=self.lr, eps=self.eps, betas=betas))
        if "state_unchanged" in self.faults or "half_batch" in self.faults:
            self._plant_train_fault()

        def epochs():
            while True:
                yield from self.loader

        self.batches = epochs()
        with self.phase("check_steps"):
            self._check_steps()
        # every length bucket of the loader at the full batch size
        with self.phase("warmup"):
            order = np.argsort(self.events.n, kind="stable")
            B = int(mix["batch_size"])
            done = set()
            for L in self.loader.buckets:
                fits = order[self.events.n[order] <= L][-B:]
                if len(fits) == B and L not in done:
                    done.add(L)
                    self.trainer.train_step(collate_events(
                        [self.event_objs[i] for i in fits],
                        buckets=self.loader.buckets))
            for _ in range(2):
                self.trainer.train_step(next(self.batches))

    def _check_steps(self) -> None:
        """The trainer's first steps from the seeded weights, through the
        window's own feed and call, and what the check compares of them;
        a plain Adam follows the program's own gradients of these steps
        (``check.FollowAdam``), and is freed before the window."""
        params = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        names = {id(p): n for n, p in params.items()}
        follow = check.FollowAdam(params, self.lr, self.eps)
        self.check_batches, self.check_graphs, losses = [], [], []
        for step in range(CHECK_STEPS):
            t = time.perf_counter()
            batch = next(self.batches)
            self.check_batches.append(list(self.dataset.last))
            with self.recorder() as rec:
                losses.append(float(self.trainer.train_step(batch)))
            if step == 0:  # builds the optimizer; the first backward
                self.rec.phases["check_steps.first"] = time.perf_counter() - t
            self.check_graphs.append(rec.calls if self.follows else None)
            follow.step({n: p.grad for n, p in params.items()})
            if step == 0:
                first = check.program_first_gradient(self.trainer, names)
                change1 = {n: float((p.detach() - start[n]).norm())
                           for n, p in params.items()}
        change = {n: float((p.detach() - start[n]).norm())
                  for n, p in params.items()}
        self.program = {"losses": losses, "grad_norms": first,
                        "change_norms": change, "change1_norms": change1,
                        **follow.gaps(params)}

    def _plant_train_fault(self) -> None:
        trainer = self.trainer
        step = trainer.train_step
        if "state_unchanged" in self.faults:
            def train_step(batch):
                with self.torch.no_grad():
                    b = batch.to(trainer.device)
                    return trainer.model.loss_from_batch(trainer.model(b), b)
        else:
            def train_step(batch):
                half = batch.batch_size // 2
                return step(batch.map(lambda t: t[:half] if t.dim() else t))
        trainer.train_step = train_step

    def _received(self, module, args) -> None:
        """Forward pre-hook on the deployed model: the received batch's
        valid pulse slots (summed on the device, read after the window), its
        slots and its padded length."""
        mask = args[0].mask
        self._fed.append((mask.sum(), mask.numel(), int(mask.shape[1])))

    def _setup_serve(self) -> None:
        from graphnet_tpu_torch.batch import bucket_for_length
        from graphnet_tpu_torch.deployment.deployment_module import DeploymentModule

        self.dm = DeploymentModule(self.model, self.model.state_dict(),
                                   device=str(self.device))
        # traced runs: each batch the module hands its model, as it padded it
        self._fed: List[Tuple[object, int, int]] = []
        if self.traced:
            self.dm.model.register_forward_pre_hook(self._received)
        if "answer_altered" in self.faults:
            call = self.dm.__call__

            class Altered:
                def __call__(_, events):
                    out = call(events)
                    out[0] = out[0] * 1.5 + 0.5
                    return out

            self.dm = Altered()
        size = int(self.mix["request_events"])
        self.requests = traffic.requests(self.events, size)
        self.request_objs = [[self.event_objs[i] for i in q] for q in self.requests]
        seen = set()
        for j, q in enumerate(self.requests):
            L = bucket_for_length(int(self.events.n[q].max()))
            if L not in seen:
                seen.add(L)
                self.dm(self.request_objs[j])
        for j in range(2):
            self.dm(self.request_objs[j])

    # ------------------------------------------------------------ window
    def run_window(self) -> None:
        torch, rec = self.torch, self.rec
        tracer = Tracer(torch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self._span_batches: Dict[str, Tuple[np.ndarray, int]] = {}
        self._answers: Dict[int, np.ndarray] = {}
        t_trace = min(TRACE_SECONDS, self.seconds / 2)
        t0 = time.perf_counter()
        if self.traced:
            tracer.start()
        seg, seg_i = t0, 0
        i = 0
        while time.perf_counter() - t0 < self.seconds:
            if tracer.on and time.perf_counter() - t0 >= t_trace:
                tracer.stop()
                seg, seg_i = time.perf_counter(), i
            self._one(i, tracer)
            i += 1
        if tracer.on:
            tracer.stop()
            seg, seg_i = time.perf_counter(), i
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec.window_s, rec.flops_s = t1 - t0, t1 - seg
        self._tally(rec, seg_i)
        if self.device.type == "cuda":
            rec.window_peak_bytes = torch.cuda.max_memory_allocated()
            rec.memory_peak_bytes = max(rec.memory_peak_bytes,
                                        rec.window_peak_bytes)
        if self.traced:
            self._read_trace(tracer, i, t_trace)

    def _one(self, i: int, tracer: Tracer, record: bool = True) -> None:
        """One step or request; ``record`` False leaves the window's counts
        alone (a traced session tried again after the window)."""
        rec = self.rec if record else Record(
            kind=self.kind, model_cfg=self.rec.model_cfg,
            counts=self.rec.counts, peaks=self.rec.peaks, dtype=self.rec.dtype)
        if self.kind == "train":
            with tracer.span(f"bench.loader#{i}"):
                t = time.perf_counter()
                batch = next(self.batches)
                rec.loader_s += time.perf_counter() - t
            n = self.events.n[self.dataset.last]
            if self.traced:
                rec.slots.append(batch_slots(batch))
            span = f"bench.step#{i}"
            with tracer.span(span):
                self.trainer.train_step(batch)
            rec.events += batch.batch_size
            L = batch.max_length
        else:
            j = i % len(self.requests)
            n = self.events.n[self.requests[j]]
            k, span = len(self._fed), f"bench.request#{i}"
            with tracer.span(span):
                t = time.perf_counter()
                out = self.dm(self.request_objs[j])
                rec.latencies_s.append(time.perf_counter() - t)
            self._answers[j] = out
            rec.events += len(n)
            fed = self._fed[k:]
            if fed:
                rec.slots.append((sum(v for v, _, _ in fed),
                                  sum(t for _, t, _ in fed)))
            L = max((b for _, _, b in fed), default=0)
        rec.work.append(n)
        if tracer.on:
            self._span_batches[span] = (n, L)
        rec.calls += 1

    def _tally(self, rec: Record, seg_i: int) -> None:
        """After the window: the valid slots counted on the device read
        back, and the model FLOPs of the calls from ``seg_i`` on (a step
        three forwards)."""
        rec.slots = [(int(v), int(t)) for v, t in rec.slots]
        steps = 3.0 if self.kind == "train" else 1.0
        rec.flops = sum(steps * rec.counts.forward_flops(rec.model_cfg, n)
                        for n in rec.work[seg_i:])

    def _read_trace(self, tracer: Tracer, i: int, seconds: float) -> None:
        """The first traced session with device activity; a session with
        none is tried again after the window, then the run fails."""
        for attempt in range(TRACE_ATTEMPTS):
            if attempt:
                tracer.start()
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    self._one(i, tracer, record=False)
                    i += 1
                tracer.stop()
            tr = tracer.read(tracer.sessions[-1][0])
            if tr.device:
                for call in tr.ops:
                    n, L = self._span_batches.get(call.span, (np.zeros(0), 1))
                    call.n, call.batch_length = n, L
                self.rec.trace = tr
                self.rec.formulas = self.formula
                self.rec.trace_bytes = tracer.written_bytes
                return
        raise RuntimeError(f"{TRACE_ATTEMPTS} profiler sessions recorded no "
                           "device activity")

    def formula(self, op: str):
        if op not in self._formulas:
            self._formulas[op] = spec.module("rooflines", op, self.root)
        return self._formulas[op]

    # ------------------------------------------------------------- check
    @property
    def follows(self) -> bool:
        """Whether the reference follows the port's kNN graphs (capture.py)."""
        return bool(getattr(self.ref.Model, "follows_graphs", False))

    def recorder(self):
        return GraphRecorder() if self.follows else contextlib.nullcontext()

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for attr in ("trainer", "model", "dm", "loader", "batches"):
            if hasattr(self, attr):
                delattr(self, attr)
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def collect(self) -> Dict[str, float]:
        """The program's side of the check, then its state freed: a
        reprocessing cell's checked requests (:meth:`check_requests`), each
        run again with its kNN graphs recorded where the reference follows
        them (``rerun_gap``: the largest difference to the window's
        answers); ``knn_mismatch`` of the recorded graphs."""
        numbers: Dict[str, float] = {}
        if self.kind == "serve":
            self.picked = self.check_requests()
            self.graphs = None
            if self.follows:
                self.graphs, gap = [], 0.0
                for j in self.picked:
                    with self.recorder() as rec:
                        again = self.dm(self.request_objs[j])
                    self.graphs.append(rec.calls)
                    gap = max(gap, float(np.max(np.abs(again - self._answers[j]))))
                numbers["rerun_gap"] = gap
        else:
            self.graphs = self.check_graphs if self.follows else None
        if self.follows:
            calls = [c for g in self.graphs for c in g]
            numbers["knn_mismatch"] = float(capture.knn_mismatch(calls, self.ref.knn))
        self.release()
        return numbers

    def check(self) -> Dict[str, float]:
        numbers = self.collect()
        w = self.weights()
        if self.kind == "train":
            ref = check.reference_steps(self.ref, self.cfg["model"], w,
                                        self.events, self.check_batches,
                                        self.lr, self.eps, self.device,
                                        graphs=self.graphs)
            numbers.update(check.compare_train(self.program, ref))
            return numbers
        ref = check.reference_answers(self.ref, self.cfg["model"], w, self.events,
                                      [self.requests[j] for j in self.picked],
                                      self.device, graphs=self.graphs)
        numbers.update(check.compare_rows([self._answers[j] for j in self.picked],
                                          ref, self.ref.Model.answer_scale))
        return numbers

    def check_requests(self) -> List[int]:
        """Requests drawn from the seed among those answered, with the one
        that holds the pool's longest event."""
        answered = sorted(self._answers)
        rng = traffic.rng_for(self.seed, 2)
        k = min(int(self.mix.get("check_requests", 8)), len(answered))
        picked = set(rng.choice(answered, k, replace=False).tolist())
        longest = int(np.argmax(self.events.n))
        holder = next(j for j, q in enumerate(self.requests) if longest in q)
        if holder in self._answers:
            picked.add(holder)
        return sorted(picked)


def batch_slots(batch) -> Tuple[int, int]:
    """A batch's valid and total pulse slots, from its mask."""
    return int(batch.mask.sum()), int(batch.mask.numel())
