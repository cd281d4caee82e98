"""The device idle time of a profiler trace split by the program's spans.

The port records ``graphnet.<layer>.<part>`` ranges
(``graphnet_tpu_torch/utils/tracing.py``) while a profiler session is on,
on the clock of the device activities.  :func:`idle_by_span` reads a
chrome trace as ``torch.profiler`` writes it and gives each idle instant
of the device to the innermost such span the window's thread was in;
with the idle outside every program span the parts sum to the window's
idle, whose complement is the busy time that ``idle_share`` reads.  The
idle stretches are named by the span holding their midpoint (a stretch
that starts between two calls is named by what the host did during it).

:class:`~harness.trace.Tracer` deletes its trace once parsed and
``parse`` keeps the bench spans only, so no metric reads this yet; a
run of a cell that keeps its trace can (``PERF.md`` §5, §7).
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Tuple

from harness.trace import DEVICE_CATS, Trace

PREFIX = "graphnet."
OUTSIDE = "outside spans"


def _pieces(spans: List[Tuple[float, float, str]], lo: float, hi: float
            ) -> List[Tuple[float, float, Optional[str]]]:
    """``[lo, hi)`` cut into pieces, each named by the innermost of
    ``spans`` (``(start, end, name)``, nested, one thread) open over it,
    ``None`` where none is."""
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Tuple[float, str]] = []
    t = lo

    def cut(until: float) -> None:
        nonlocal t
        if until > t:
            out.append((t, until, stack[-1][1] if stack else None))
            t = until

    clipped = [(max(s, lo), min(e, hi), n) for s, e, n in spans
               if s < hi and e > lo]
    for s, e, name in sorted(clipped, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            cut(stack[-1][0])
            stack.pop()
        cut(s)
        stack.append((e, name))
    while stack:
        cut(stack[-1][0])
        stack.pop()
    cut(hi)
    return out


def idle_by_span(trace, window: str = "bench.window", top: int = 10) -> Dict:
    """The device idle time of a ``torch.profiler`` chrome trace (a path or
    the loaded object), in µs, split by the innermost ``graphnet.*`` span
    of one host thread over each idle instant.

    ``window`` names the span whose extent and thread bound the reading.
    Returns
    ``window_us``, ``idle_us``, ``idle_by_span`` and ``idle_by_layer``
    (``graphnet.<layer>``; :data:`OUTSIDE` for idle in no program span,
    so each sums to ``idle_us``), ``host_us`` (each span name's
    ``[total µs, count]`` of the spans that start in the window) and
    ``gaps``: the ``top`` longest idle stretches, ``[name, µs]``, each
    named by the innermost span of the thread (a program span first,
    else any other, its ``#`` index cut) that holds its midpoint."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"], e.get("tid")) for e in events
             if e.get("cat") == "user_annotation"]
    wins = [m for m in marks if m[2] == window]
    if not wins:
        raise ValueError(f"no span {window!r} in the trace")
    lo, hi, _, tid = wins[0]
    mine = [m[:3] for m in marks if m[3] == tid and m[2] != window]
    program = [m for m in mine if m[2].startswith(PREFIX)]
    busy = Trace(window=(lo, hi), spans=[], device=[
        (float(e["ts"]), float(e.get("dur", 0.0)), "") for e in events
        if e.get("cat") in DEVICE_CATS]).busy_intervals()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]

    by_span: Dict[str, float] = {}
    pieces = _pieces(program, lo, hi)
    i = 0
    for s, e, name in pieces:
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            key = name or OUTSIDE
            by_span[key] = (by_span.get(key, 0.0)
                            + min(e, idle[j][1]) - max(s, idle[j][0]))
            j += 1
    by_layer: Dict[str, float] = {}
    for name, us in by_span.items():
        layer = ".".join(name.split(".")[:2]) if name != OUTSIDE else name
        by_layer[layer] = by_layer.get(layer, 0.0) + us
    host: Dict[str, List[float]] = {}
    for s, e, name in program:
        if lo <= s < hi:
            h = host.setdefault(name, [0.0, 0])
            h[0] += e - s
            h[1] += 1

    anywhere = _pieces(mine, lo, hi)
    starts = ([p[0] for p in pieces], [p[0] for p in anywhere])

    def name_at(t: float) -> str:
        for cut, ps in zip(starts, (pieces, anywhere)):
            k = bisect.bisect_right(cut, t) - 1
            if k >= 0 and ps[k][2] is not None:
                return ps[k][2].split("#", 1)[0]
        return OUTSIDE

    longest = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    return {"window_us": [lo, hi],
            "idle_us": sum(e - s for s, e in idle),
            "idle_by_span": by_span, "idle_by_layer": by_layer,
            "host_us": host,
            "gaps": [[name_at((s + e) / 2), e - s] for s, e in longest]}
