"""The traffic generator: the same seed gives the same events; every seed
the same lengths in its own order; pulses share sensors."""

import numpy as np
import pytest

from harness import spec, traffic

CASES = [("queso_energy", "train_b128"), ("icemix_b_d32", "reprocess_r32")]


@pytest.mark.parametrize("config,mix", CASES)
def test_repeats_by_seed(config, mix):
    cfg, m = spec.config(config), dict(spec.traffic(mix), events=512)
    a = traffic.make_events(cfg, m, 2 ** 31 + 3)
    b = traffic.make_events(cfg, m, 2 ** 31 + 3)
    c = traffic.make_events(cfg, m, 2 ** 31 + 4)
    assert np.array_equal(a.x, b.x) and np.array_equal(a.offsets, b.offsets)
    for k in a.labels:
        assert np.array_equal(a.labels[k], b.labels[k])
    assert not np.array_equal(a.n, c.n)
    assert np.array_equal(np.sort(a.n), np.sort(c.n))
    assert np.isfinite(a.x).all() and a.x.shape[1] == len(cfg["columns"])
    assert a.n.min() >= m["lengths"]["min"] and a.n.max() <= cfg["max_pulses"]


def test_pulses_share_sensors():
    cfg, m = spec.config("queso_energy"), dict(spec.traffic("train_b128"), events=256)
    ev = traffic.make_events(cfg, m, 7)
    long = int(np.argmax(ev.n))
    xyz = ev.event(long)[:, :3]
    assert len(np.unique(xyz, axis=0)) < len(xyz)


def test_lengths_are_the_law_quantiles():
    law = {"law": "lognormal", "median": 48, "sigma": 1.0, "min": 2}
    n = traffic.lengths(law, 1001, 512)
    assert n[500] == 48 and n.min() == 2 and n.max() <= 512
    assert np.all(np.diff(n) >= 0)


def test_requests_cover_the_pool():
    cfg, m = spec.config("icemix_b_d32"), dict(spec.traffic("reprocess_r32"), events=100)
    ev = traffic.make_events(cfg, m, 1)
    reqs = traffic.requests(ev, 32)
    assert [len(r) for r in reqs] == [32, 32, 32, 4]
    assert np.array_equal(np.concatenate(reqs), np.arange(100))
