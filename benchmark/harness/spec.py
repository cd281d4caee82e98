"""Find a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are ``configs/<config>.yml``, ``traffic/<mix>.yml``, ``limits/<cell>.yml``,
and through the configuration's ``family`` ``reference/<family>.py`` and
``counts/<family>.py``; each metric is read by ``metrics/<metric>.py``, or
where that file is absent by ``metrics/<quantity>.py``, the name's part
before its first dot (``mfu.train`` and ``mfu.gnn_train`` both by
``metrics/mfu.py``); each operator's least time is
``rooflines/<operator>.py``.  A later change
adds such files and entries; none of these functions needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

import yaml

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """A name that has no file, or a file that does not say what it must."""


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_yaml(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise SpecError(f"no file {path}")
    with open(path) as f:
        return yaml.safe_load(f)


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json; it has "
                    f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, root: Path = ROOT) -> Dict[str, Any]:
    cfg = load_yaml(root / "benchmark" / "configs" / f"{name}.yml")
    for key in ("family", "dtype", "max_pulses", "sensors", "columns", "labels",
                "model"):
        if key not in cfg:
            raise SpecError(f"configs/{name}.yml has no {key!r}")
    return cfg


def traffic(name: str, root: Path = ROOT) -> Dict[str, Any]:
    mix = load_yaml(root / "benchmark" / "traffic" / f"{name}.yml")
    if mix.get("kind") not in ("train", "reprocess"):
        raise SpecError(f"traffic/{name}.yml: kind must be train or reprocess")
    return mix


def limits(cell: str, root: Path = ROOT) -> Dict[str, float]:
    """The limit of each compared number of ``cell`` (``{}`` where the cell
    has no limits file yet: then nothing is compared and the run is not
    correct)."""
    path = root / "benchmark" / "limits" / f"{cell}.yml"
    if not path.is_file():
        return {}
    return {k: float(v) for k, v in (load_yaml(path).get("limits") or {}).items()}


def module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` loaded as a module of its own."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} file {path.relative_to(root)} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file
    of the quantity it names, ``metrics/<part before the first dot>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    return module("metrics", name if path.is_file() else name.split(".", 1)[0],
                  root)


def metrics_of(bench: Dict[str, Any], cell: str, trace: bool
               ) -> List[Dict[str, Any]]:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``--trace 0``, the per-layer ones with ``--trace 1``.  An entry
    with ``workloads`` is the cell's where it lists it; a per-layer entry
    without it where the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def operators(root: Path = ROOT) -> List[str]:
    """The operators that have a roofline formula file."""
    return sorted(p.stem for p in (root / "benchmark" / "rooflines").glob("*.py"))


def data_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "data" / name
