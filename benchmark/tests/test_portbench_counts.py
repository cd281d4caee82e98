"""FLOP counts and roofline formulas against hand counts at small shapes."""

from types import SimpleNamespace

import numpy as np
import pytest

from harness import roofline, spec

PEAKS = dict(bytes=1e12, fp32=1e13, tf32=3e13, tf32x3=1e13, bf16=1e14)


def test_dynedge_forward_flops_by_hand():
    cfg = {"arguments": {"backbone": {"__model__": {"arguments": dict(
        nb_inputs=2, nb_neighbours=2, dynedge_layer_sizes=[[3, 4]],
        post_processing_layer_sizes=[5], readout_layer_sizes=[6],
        global_pooling_schemes=["max"])}}}}
    n = np.array([3, 1])
    # d = 2 + 2 + 2 + 1 = 7; per pulse 2*2*7*3 + 2*(7+4)*5; edges 3*2 + 0
    per_pulse = 2 * 2 * 7 * 3 + 2 * 11 * 5
    per_edge = 2 * 3 * 4
    per_event = 2 * 5 * 6 + 2 * 6 * 1
    want = per_pulse * 4 + per_edge * 6 + per_event * 2
    assert spec.module("counts", "dynedge").forward_flops(cfg, n) == want


def test_deepice_forward_flops_by_hand():
    cfg = {"arguments": {"backbone": {"__model__": {"arguments": dict(
        hidden_dim=4, head_size=2, seq_length=2, mlp_ratio=2, depth=1,
        depth_rel=1, n_rel=1)}}}}
    n = np.array([3])
    fourier = (2 * 12 * 12 + 2 * 12 * 4) * 3
    block = 2 * 4 * 16 + 2 * 2 * 4 * 8
    rel_block = block * 3 + 4 * 4 * 9 + 4 * 4 * 9 + 2 * 4 * 2 * 3
    cls_block = block * 4 + 4 * 4 * 16
    want = fourier + rel_block + cls_block + 2 * 4 * 3
    assert spec.module("counts", "deepice").forward_flops(cfg, n) == want


def call(name, shapes, n, batch_length, dtypes=("float",), scalars=()):
    return SimpleNamespace(name=name, shapes=shapes, n=np.array(n),
                           batch_length=batch_length, scalars=list(scalars),
                           element_size=lambda i: 2 if dtypes[0] == "bf16" else 4,
                           scalar=lambda i, d: float(scalars[i]) if i < len(scalars) else d,
                           device_us=0.0)


def test_knn_roofline_by_hand():
    c = call("knn_graph", [[2, 4, 3], [2, 4], [], []], [4, 2], 4,
             scalars=["", "", "2", "True"])
    flops = 10 * (16 + 4)
    nbytes = 6 * (13 + 2 * 5)
    want = max(flops / PEAKS["fp32"], nbytes / PEAKS["bytes"])
    assert spec.module("rooflines", "knn_graph").least_seconds(c, PEAKS) == want


def test_edgeconv_roofline_by_hand():
    c = call("edgeconv_fwd", [[1, 4, 3], [1, 4, 3], [1, 4, 2], [1, 4, 2],
                              [3, 5], [5]], [3], 4)
    edges = 3 * 2
    flops = 2 * 3 * 5 * edges
    nbytes = 3 * (2 * 3 * 4 + 2 * 5 + 5 * 4) + 3 * 5 * 4
    want = max(flops / PEAKS["fp32"], nbytes / PEAKS["bytes"])
    assert spec.module("rooflines", "edgeconv_fwd").least_seconds(c, PEAKS) == want
    b = spec.module("rooflines", "edgeconv_bwd").least_seconds(
        call("edgeconv_bwd", c.shapes + [[1, 4, 5]], [3], 4), PEAKS)
    assert b >= 3 * flops / PEAKS["fp32"]


def test_flash_roofline_counts_the_cls_row():
    # the Block's attention runs over the batch's length plus the cls token
    c = call("flash_fwd", [[1, 2, 5, 4], [1, 2, 5, 4], [1, 2, 5, 4], [1, 5]], [3], 4)
    assert roofline.valid_rows(c).tolist() == [4.0]
    flops = 4 * 4 * 2 * 16
    want = max(flops / PEAKS["fp32"], (4 * 2 * (4 * 4 * 4 + 8) + 5) / PEAKS["bytes"])
    assert spec.module("rooflines", "flash_fwd").least_seconds(c, PEAKS) == want


@pytest.mark.parametrize("op", ["rel_fwd", "rel_bwd_dq", "rel_bwd_dkv",
                                "flash_bwd_dq", "flash_bwd_dkv"])
def test_attention_rooflines_grow_with_pairs(op):
    shapes = [[1, 2, 8, 4]] * 3 + [[1, 8]]
    small = spec.module("rooflines", op).least_seconds(call(op, shapes, [2], 8), PEAKS)
    big = spec.module("rooflines", op).least_seconds(call(op, shapes, [8], 8), PEAKS)
    assert 0 < small < big


def test_share_leaves_out_calls_without_device_time():
    calls = [SimpleNamespace(name="x", device_us=0.0),
             SimpleNamespace(name="x", device_us=2.0)]
    formula = SimpleNamespace(least_seconds=lambda c, p: 1e-6)
    assert roofline.share(calls, lambda name: formula, PEAKS) == pytest.approx(50.0)
    assert roofline.share(calls[:1], lambda name: formula, PEAKS) is None
