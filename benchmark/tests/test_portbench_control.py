"""The check against its control and its faults, at a tiny size on the
CPU.  The control is the reference in the program's place computed in
TF32 (on the CPU its products' inputs rounded to TF32); it must come out
not correct, the program correct.  Then a whole run with the timed path
broken underneath (a step that leaves the state unchanged, half of the
batch left out, Adam's second moment decaying at the wrong rate, an
answer altered where it is produced) must come out not correct; the
wrong second moment, which leaves the first step alone, shows in
``adam_gap``, and a state left unchanged reads 1 there.  At the cells' own sizes the same readings come from
``python3 benchmark/calibrate.py`` on the card."""

import importlib.util

import pytest

import portbench_tiny as pt


def calibrate(root):
    spec = importlib.util.spec_from_file_location(
        "portbench_calibrate", root / "benchmark" / "calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", sorted(pt.TINY_CELLS))
def test_control_fails_and_program_passes(tiny_root, cell):
    cal = calibrate(tiny_root)
    limits = pt.TINY_LIMITS[cell]
    got = cal.readings(cell, 2 ** 31 + 21, {"program", "control"}, seconds=0.5,
                       device="cpu", root=tiny_root)
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items() if k in got["control"])


FAULTS = [("tiny_dynedge.train", "state_unchanged"), ("tiny_dynedge.train", "half_batch"),
          ("tiny_dynedge.train", "adam_second_moment"),
          ("tiny_deepice.train", "state_unchanged"), ("tiny_deepice.train", "half_batch"),
          ("tiny_deepice.train", "adam_second_moment"),
          ("tiny_dynedge.serve", "answer_altered"), ("tiny_deepice.serve", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault, capsys):
    rc = pt.run_main(tiny_root, ["--workload", cell, "--seed", str(2 ** 31 + 5),
                                 "--seconds", "0.5", "--trace", "0"],
                     device="cpu", faults=(fault,))
    assert rc == 0
    assert pt.last_json(capsys.readouterr().out)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_dynedge.train", "tiny_deepice.train"])
def test_adam_gap_reads_the_optimizer_alone(tiny_root, cell):
    cal = calibrate(tiny_root)
    limit = pt.TINY_LIMITS[cell]["adam_gap"]
    for fault, low, high in (("adam_second_moment", 10 * limit, 1.0),
                             ("state_unchanged", 1.0, 1.0)):
        got = cal.readings(cell, 2 ** 31 + 23, {"program"}, device="cpu",
                           root=tiny_root, faults=(fault,))["program"]
        assert low <= got["adam_gap"] <= high, (fault, got["adam_gap"])
