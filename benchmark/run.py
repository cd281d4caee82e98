"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``, then ``checks`` (each compared
number and its limit), which are also the last lines of standard error.
With no card, too few cards, or JAX or the JAX package loaded, it prints
no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# build and kernel caches at fixed places inside the checkout
CACHE = BENCH / "_cache"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str = "cuda", faults=()) -> int:
    """One run; ``device="cpu"`` and ``faults`` are for the benchmark's own
    tests (the CPU skips the look for a card; a fault breaks the timed path
    underneath), never for measurements."""
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    import torch

    from harness import check, spec
    from harness.cells import Cell
    from harness.isolation import forbidden_modules

    t_imports = time.perf_counter() - T0
    bench = spec.load_benchmark(ROOT)
    chips = int(spec.workload(bench, args.workload)["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"no result: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace),
                device=device, root=ROOT, faults=faults)
    rec = cell.rec
    rec.phases["imports"] = t_imports  # torch and the harness
    rec.phases["card"] = time.perf_counter() - T0 - t_imports  # the runtime's start
    cell.setup()
    rec.setup_s = time.perf_counter() - T0
    cell.run_window()
    numbers = cell.check()
    correct, shown = check.verdict(numbers, spec.limits(args.workload, ROOT))

    metrics = {}
    for m in spec.metrics_of(bench, args.workload, bool(args.trace)):
        value = spec.reader(m["name"], ROOT).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": correct, "attempted": rec.calls,
              "failed": 0, "metrics": metrics,
              "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["setup_phases_s"] = rec.phases
    if rec.trace is not None:
        result["trace_file_bytes"] = rec.trace_bytes
    result["checks"] = shown

    found = forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    others = {k: v for k, v in numbers.items() if k not in shown}
    if others:
        print(f"not compared: {others}", file=sys.stderr)
    for name, v in shown.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    if not shown:
        print(f"check none: no limits for {args.workload}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
