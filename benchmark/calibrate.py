"""Readings that the limits of ``correct`` are set from (``limits/<cell>.yml``).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--modes ...]

For each seed, one JSON line a mode with the numbers the check compares:

* ``program``: the port on the timed path, as a run checks it (a training
  cell's three set-up steps; a reprocessing cell's answers from a short
  window of ``--seconds``);
* ``control``: the reference in the program's place, computed in TF32,
  the next precision below the configuration's fp32;
* ``half_batch`` (training): the reference in the program's place with
  each step's loss over half of its batch;
* ``answer_altered`` (reprocessing): the reference's answers with one
  row altered where it is produced.

``--faults`` builds the program with faults planted in its timed path
(``harness/cells.py``'s ``FAULTS``, such as ``adam_second_moment``); its
``program`` line then reads that faulty program.

A state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by
their definition and needs no run.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

MODES = ("program", "control", "half_batch", "answer_altered")


def readings(cell: str, seed: int, modes, seconds: float = 4.0,
             device: str = "cuda", root: Path = ROOT, faults=()):
    """``{mode: numbers}`` of one seed, with diagnostics under ``detail``.
    Where the reference follows kNN graphs, the fp32 reference compared
    with the control or a fault follows that side's graphs, as it follows
    the program's in a run."""
    from harness import check
    from harness.cells import Cell

    c = Cell(cell, seed, seconds, trace=False, device=device, root=root,
             faults=faults)
    c.setup()
    if c.kind == "serve":
        c.run_window()
    program_numbers = c.collect()
    w = c.weights()
    out = {}
    args = (c.ref, c.cfg["model"], w, c.events)
    if c.kind == "train":
        steps = (c.check_batches, c.lr, c.eps, c.device)
        got = {"program": (c.program,
                           check.reference_steps(*args, *steps, graphs=c.graphs))}
        for mode in set(modes) & {"control", "half_batch"}:
            record = []
            side = check.reference_steps(*args, *steps, control=mode == "control",
                                         half_batch=mode == "half_batch",
                                         record=record)
            got[mode] = (side, check.reference_steps(*args, *steps,
                                                     graphs=record or None))
        for mode, (side, ref) in got.items():
            if mode not in modes:
                continue
            nums = check.compare_train(side, ref)
            if mode == "program":
                nums.update(program_numbers)
            grads = check.leaf_gaps(side["grad_norms"], ref["grad_norms"])
            worst = sorted(grads, key=grads.get)[-3:]
            nums["detail"] = {"losses": side["losses"], "ref_losses": ref["losses"],
                              "worst_grad_leaves": {k: [grads[k], ref["grad_norms"][k]]
                                                    for k in worst}}
            out[mode] = nums
        return out
    reqs = [c.requests[j] for j in c.picked]
    got = {}
    if "program" in modes:
        got["program"] = ([c._answers[j] for j in c.picked],
                          check.reference_answers(*args, reqs, c.device,
                                                  graphs=c.graphs))
    if "control" in modes:
        record = []
        side = check.reference_answers(*args, reqs, c.device, control=True,
                                       record=record)
        got["control"] = (side, check.reference_answers(
            *args, reqs, c.device, graphs=record or None))
    if "answer_altered" in modes:
        ref = check.reference_answers(*args, reqs, c.device)
        altered = [a.copy() for a in ref]
        altered[0][0] = altered[0][0] * 1.5 + 0.5
        got["answer_altered"] = (altered, ref)
    for mode, (answers, ref) in got.items():
        scale = c.ref.Model.answer_scale
        nums = check.compare_rows(answers, ref, scale)
        if mode == "program":
            nums.update(program_numbers)
        rows = check.row_gaps(answers, ref, scale)
        nums["detail"] = {"rows": int(len(rows)),
                          "top": [float(v) for v in sorted(rows)[-5:]],
                          "over": {f"{t:g}": int((rows > t).sum())
                                   for t in (1e-5, 1e-4, 1e-3, 1e-2)}}
        out[mode] = nums
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    modes = set(args.modes.split(","))
    faults = tuple(f for f in args.faults.split(",") if f)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for mode, nums in readings(args.workload, seed, modes, args.seconds,
                                   faults=faults).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "faults": list(faults), **nums}),
                  flush=True)
        print(f"# seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)


if __name__ == "__main__":
    main()
