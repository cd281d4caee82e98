"""BENCHMARK.json against the contract's form, and the harness finding a
configuration, a traffic mix, limits and a metric added as files only."""

import json
import re

import pytest

import portbench_tiny as pt
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(pt.REPO / "BENCHMARK.json"))


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_form_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                                 "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert "setup_s" in [m["name"] for m in spec.metrics_of(BENCH, cell, False)]
        assert len(spec.metrics_of(BENCH, cell, False)) >= 2
        assert spec.metrics_of(BENCH, cell, True)


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        spec.traffic(w["traffic"])
        assert spec.limits(w["name"])
        spec.module("reference", cfg["family"])
        spec.module("counts", cfg["family"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for op in ("knn_graph", "edgeconv_fwd", "edgeconv_bwd", "edgeconv_knn_fwd",
               "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rel_fwd",
               "rel_bwd_dq", "rel_bwd_dkv"):
        assert op in spec.operators()


def test_configs_hold_the_zoo_model_files():
    import yaml

    for name, zoo in (("queso_energy", "queso/total_neutrino_energy"),
                      ("icemix_b_d32", "kaggle_icemix/B_d32")):
        frozen = spec.config(name)["model"]
        assert frozen == yaml.safe_load(open(
            pt.REPO / "configs" / "models" / "zoo" / zoo / "model.yml"))
        assert spec.config(name)["reduced"] == []


def test_a_metric_is_read_by_its_own_file_or_its_quantitys(tiny_root):
    shared = spec.reader("mfu.gnn_train", tiny_root)
    assert shared.__file__.endswith("metrics/mfu.py")
    own = tiny_root / "benchmark" / "metrics" / "mfu.gnn_train.py"
    own.write_text("def read(rec):\n    return 1.0\n")
    try:
        assert spec.reader("mfu.gnn_train", tiny_root).__file__ == str(own)
    finally:
        own.unlink()
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_quantity.train", tiny_root)


@pytest.mark.parametrize("cell", sorted(pt.TINY_CELLS))
def test_cells_added_as_files_run(tiny_root, cell, capsys):
    rc = pt.run_main(tiny_root, ["--workload", cell, "--seed", str(2 ** 31 + 11),
                                 "--seconds", "0.5", "--trace", "0"], device="cpu")
    out = capsys.readouterr()
    assert rc == 0
    res = pt.last_json(out.out)
    assert res["correct"] is True
    assert res["metrics"]["steps_done"]["value"] == res["attempted"] > 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
