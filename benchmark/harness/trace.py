"""The device trace of a traced stretch of the window, and what the
metrics read from it.

``torch.profiler`` (CPU and CUDA activities, input shapes recorded) runs
over a stretch of the window; its chrome trace, written to the temporary
directory and deleted once read, gives:

* every device activity (kernels, copies and sets, on every stream),
  whose union over the traced window is the busy time;
* the benchmark's spans (``record_function`` around each loader call,
  step and request, named ``bench.<what>#<index>``);
* every call of an operator of the port (``graphnet_tpu_torch::<op>``)
  with its input shapes and types, and the device time of the activities
  it launched: an activity belongs to the call during which its launch
  (the runtime or driver call of the same correlation id) ran on the
  call's thread, or failing that to the call of its external id.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OP_PREFIX = "graphnet_tpu_torch::"
SPAN_PREFIX = "bench."

_ELEMENT = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "bool": 1,
            "int": 4, "long int": 8, "double": 8, "unsigned char": 1}


@dataclass
class OpCall:
    name: str                       # the operator, without the namespace
    ts: float                       # microseconds
    dur: float
    tid: int
    shapes: List[List[int]]
    dtypes: List[str]
    scalars: List[str]
    device_us: float = 0.0
    span: Optional[str] = None      # the bench span it ran in

    def element_size(self, i: int) -> int:
        return _ELEMENT.get(self.dtypes[i], 4) if i < len(self.dtypes) else 4

    def scalar(self, i: int, default: float) -> float:
        try:
            return float(self.scalars[i])
        except (IndexError, ValueError):
            return default


@dataclass
class Trace:
    window: Tuple[float, float]                     # microseconds
    device: List[Tuple[float, float, str]]          # (ts, dur, name)
    spans: List[Tuple[float, float, str]]           # (ts, dur, name)
    ops: List[OpCall] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device activities, clipped to the window."""
        lo, hi = self.window
        iv = sorted((max(ts, lo), min(ts + d, hi)) for ts, d, _ in self.device
                    if ts < hi and ts + d > lo)
        out: List[Tuple[float, float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        """``[name, seconds]`` of the activities that took most time."""
        by: Dict[str, float] = {}
        lo, hi = self.window
        for ts, d, name in self.device:
            if lo <= ts < hi:
                by[name] = by.get(name, 0.0) + d * 1e-6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """``[span, seconds]`` of the longest stretches with nothing on the
        device, each named by the innermost bench span its start fell in."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at(s) or "outside spans", (e - s) * 1e-6]
                for s, e in gaps[:top]]

    def span_at(self, t: float) -> Optional[str]:
        """The shortest bench span (other than the window) holding ``t``,
        without its index."""
        best = None
        for ts, d, name in self.spans:
            if ts <= t < ts + d and name != "bench.window" and (
                    best is None or d < best[0]):
                best = (d, name)
        return None if best is None else best[1].split("#", 1)[0]


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    device, spans, ops, launches, by_ext = [], [], [], {}, {}
    raw_ops = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {})
        if cat in DEVICE_CATS:
            device.append((float(ev["ts"]), float(ev.get("dur", 0.0)),
                           ev.get("name", ""), args))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ev["tid"], float(ev["ts"]))
        elif cat == "user_annotation" and ev.get("name", "").startswith(
                SPAN_PREFIX):
            spans.append((float(ev["ts"]), float(ev.get("dur", 0.0)),
                          ev["name"]))
        elif cat == "cpu_op" and ev.get("name", "").startswith(OP_PREFIX):
            raw_ops.append(ev)
    raw_ops.sort(key=lambda e: (e["tid"], float(e["ts"]), -float(e["dur"])))
    per_tid: Dict[int, List[OpCall]] = {}
    for ev in raw_ops:
        ts, dur, tid = float(ev["ts"]), float(ev["dur"]), ev["tid"]
        calls = per_tid.setdefault(tid, [])
        if calls and ts < calls[-1].ts + calls[-1].dur:
            continue  # a record nested in a call already taken
        args = ev.get("args", {})
        call = OpCall(name=ev["name"][len(OP_PREFIX):], ts=ts, dur=dur,
                      tid=tid, shapes=args.get("Input Dims", []),
                      dtypes=args.get("Input type", []),
                      scalars=args.get("Concrete Inputs", []))
        calls.append(call)
        ops.append(call)
        if "External id" in args:
            by_ext[args["External id"]] = call
    starts = {tid: [c.ts for c in calls] for tid, calls in per_tid.items()}
    for ts, dur, name, args in device:
        call = None
        launch = launches.get(args.get("correlation"))
        if launch is not None and launch[0] in per_tid:
            tid, t = launch
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t <= per_tid[tid][i].ts + per_tid[tid][i].dur:
                call = per_tid[tid][i]
        if call is None and launch is None:
            call = by_ext.get(args.get("External id"))
        if call is not None:
            call.device_us += dur
    windows = [s for s in spans if s[2] == "bench.window"]
    if windows:
        w = windows[0]
        window = (w[0], w[0] + w[1])
    else:
        times = [d[0] for d in device] + [d[0] + d[1] for d in device]
        window = (min(times), max(times)) if times else (0.0, 0.0)
    spans_sorted = sorted(spans)
    for call in ops:
        holder = [s for s in spans_sorted
                  if s[0] <= call.ts < s[0] + s[1] and "#" in s[2]]
        if holder:
            call.span = min(holder, key=lambda s: s[1])[2]
    return Trace(window=window, device=[d[:3] for d in device],
                 spans=spans_sorted, ops=ops)


class Tracer:
    """Profiles stretches of a window; ``span(name)`` records a bench span
    while a session is on and costs nothing otherwise."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self._window = None
        self.sessions: List[Tuple[object, float]] = []
        self.written_bytes = 0  # the last chrome trace's size on disk

    @property
    def on(self) -> bool:
        return self.prof is not None

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            record_shapes=True)
        self.prof.__enter__()
        self._window = self.torch.profiler.record_function("bench.window")
        self._window.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """End the session; returns its wall seconds."""
        self.torch.cuda.synchronize()
        seconds = time.perf_counter() - self._t0
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.sessions.append((self.prof, seconds))
        self.prof = None
        return seconds

    def read(self, prof) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self.written_bytes = os.path.getsize(path)
            return parse(path)
        finally:
            os.unlink(path)
