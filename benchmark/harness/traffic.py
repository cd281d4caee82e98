"""The one traffic generator: events from a mix's parameters, a
configuration's columns and ``--seed``.

Every seed gets the same multiset of event lengths (the quantiles of the
mix's length law), in its own order, and its own pulses: so seeds change
the content and the order of the work, not its amount.  An event's pulses
land on the sensors nearest a random anchor sensor, several pulses to a
sensor on average, so pulses share coordinates exactly (the first kNN has
ties).  Each column is a sensor's, a pulse's or the ice's value, mapped as
the configuration's detector standardises it.  Nothing here imports the
program: the harness wraps the arrays in the program's ``Event``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

from harness import spec

# speed of light in ice (m/ns), for arrival times from an anchor
C_ICE = 0.2213


@dataclass
class EventSet:
    """Events as one flat pulse array: event ``i`` is ``x[offsets[i]:
    offsets[i + 1]]``; ``labels`` hold one row an event."""

    x: np.ndarray            # [N, D] float32
    offsets: np.ndarray      # [E + 1] int64
    labels: Dict[str, np.ndarray]
    features: List[str]

    @property
    def n(self) -> np.ndarray:
        return np.diff(self.offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def event(self, i: int) -> np.ndarray:
        return self.x[self.offsets[i]:self.offsets[i + 1]]

    def label_row(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.labels.items()}


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of one stream of a seed (any whole number)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def lengths(law: Dict, count: int, max_pulses: int) -> np.ndarray:
    """``count`` event lengths: the law's quantiles at ``(i + 0.5) /
    count``, rounded and clipped to ``[law.min, max_pulses]``, ascending."""
    if law["law"] != "lognormal":
        raise spec.SpecError(f"unknown length law {law['law']!r}")
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / count) for i in range(count)])
    n = np.rint(law["median"] * np.exp(law["sigma"] * z))
    return np.clip(n, law["min"], max_pulses).astype(np.int64)


def sensor_table(name: str, root: Path = spec.ROOT):
    """``(columns, [rows, columns] float64)`` of ``data/<name>.csv``."""
    path = spec.data_path(f"{name}.csv", root)
    with open(path) as f:
        lines = f.read().splitlines()
    head = next(i for i, line in enumerate(lines) if not line.startswith("#"))
    cols = lines[head].split(",")
    table = np.loadtxt(lines[head + 1:], delimiter=",", ndmin=2)
    return cols, table


def ice_lengths(root: Path = spec.ROOT):
    """Interpolators of the robust-scaled scattering and absorption lengths
    over the standardised depth ``(depth - 1950) / 500``, as
    ``graphnet_tpu_torch/models/graphs/utils.py:111`` builds them; outside
    the table the end values."""
    table = np.loadtxt(spec.data_path("ice_transparency.txt", root))
    z = (table[:, 0] - 1950.0) / 500.0

    def robust(col):
        q1, q3 = np.percentile(col, [25, 75])
        return (col - np.median(col)) / (q3 - q1)

    s, a = robust(table[:, 1]), robust(table[:, 2])
    return (lambda v: np.interp(v, z, s)), (lambda v: np.interp(v, z, a))


def nearest(pos: np.ndarray, centres: np.ndarray, k: int) -> np.ndarray:
    """``[len(centres), k]`` rows of ``pos`` nearest each centre, nearest
    first (ties to the lower row), in blocks of 128 centres."""
    out = np.empty((len(centres), k), np.int64)
    for s in range(0, len(centres), 128):
        c = centres[s:s + 128]
        d2 = ((c[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        key = np.take_along_axis(d2, part, 1)
        order = np.lexsort((part, key), axis=1)
        out[s:s + 128] = np.take_along_axis(part, order, 1)
    return out


def _map(values: np.ndarray, kind: str, scale: float, offset: float):
    if kind == "affine":
        return (values + offset) / scale
    if kind == "log10":
        return np.log10(values) / scale
    if kind == "mul_offset":
        return values / scale + offset
    if kind == "identity":
        return values
    raise spec.SpecError(f"unknown column map {kind!r}")


def _labels(laws: Dict, count: int, rng: np.random.Generator):
    out = {}
    for name, law in laws.items():
        if law["law"] == "log10_uniform":
            out[name] = (10.0 ** rng.uniform(law["low"], law["high"], count)
                         ).astype(np.float32)
        elif law["law"] == "unit_vector":
            v = rng.standard_normal((count, 3))
            out[name] = (v / np.linalg.norm(v, axis=1, keepdims=True)
                         ).astype(np.float32)
        else:
            raise spec.SpecError(f"unknown label law {law['law']!r}")
    return out


def make_events(cfg: Dict, mix: Dict, seed: int,
                root: Path = spec.ROOT) -> EventSet:
    """The mix's events for one seed, in the configuration's columns."""
    count = int(mix["events"])
    p = mix["pulses"]
    n = lengths(mix["lengths"], count, int(cfg["max_pulses"]))
    rng = rng_for(seed, 1)
    n = n[rng.permutation(count)]
    cols, table = sensor_table(cfg["sensors"], root)
    pos = table[:, :3]
    # the anchors' neighbourhoods: sensors sorted by distance to each anchor
    anchors = rng.choice(len(table), int(p["anchors"]), replace=False)
    hood = int(p["neighbourhood"])
    near = nearest(pos, pos[anchors], hood)
    # each event: an anchor, its m nearest sensors, pulses spread over them
    ev_anchor = rng.integers(0, len(anchors), count)
    m = np.clip(np.ceil(n / float(p["pulses_per_sensor"])), 1, hood
                ).astype(np.int64)
    ev = np.repeat(np.arange(count), n)
    rank = np.floor(rng.random(len(ev)) * m[ev]).astype(np.int64)
    rows = near[ev_anchor[ev], rank]
    dist = np.sqrt(((pos[rows] - pos[anchors[ev_anchor[ev]]]) ** 2).sum(-1))
    pulse = {
        "time": 1.0e4 + dist / C_ICE
        + rng.exponential(float(p["time_spread_ns"]), len(ev)),
        "charge": np.exp(rng.normal(0.0, float(p["charge_log_sigma"]),
                                    len(ev))),
        "hlc": (rng.random(len(ev)) < 0.5).astype(np.float64),
    }
    pulse["not_hlc"] = 1.0 - pulse["hlc"]
    x = np.zeros((len(ev), len(cfg["columns"])), np.float32)
    names = [c[0] for c in cfg["columns"]]
    ice = None
    for j, (name, source, kind, scale, offset) in enumerate(cfg["columns"]):
        group, key = source.split(".", 1)
        if group == "sensor":
            values = table[rows, cols.index(key)]
        elif group == "pulse":
            values = pulse[key]
        elif group == "ice":
            if ice is None:
                ice = dict(zip(("scattering", "absorption"), ice_lengths(root)))
            depth = x[:, names.index(cfg["ice_depth_column"])].astype(np.float64)
            values = ice[key](depth)
        else:
            raise spec.SpecError(f"unknown column source {source!r}")
        x[:, j] = _map(np.asarray(values, np.float64), kind, float(scale),
                       float(offset))
    offsets = np.concatenate([[0], np.cumsum(n)])
    return EventSet(x=x, offsets=offsets, labels=_labels(cfg["labels"], count,
                                                         rng),
                    features=names)


def requests(events: EventSet, size: int) -> List[np.ndarray]:
    """The pool's events in order, ``size`` a request (the last request
    takes what is left)."""
    idx = np.arange(len(events))
    return [idx[s:s + size] for s in range(0, len(events), size)]

