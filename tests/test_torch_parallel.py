"""The port's training across processes (``graphnet_tpu_torch/parallel``,
``Trainer(mesh=...)``) against the JAX package on the CPU.

Single-process cases hold the rules leaf by leaf against the JAX
functions through ``params_to_jax``: the FSDP specs, the tensor-parallel
specs and ``count_tp_sharded``, ``_pad_to_multiple``'s weights and
``host_local_batch_slice``.  Two-process cases (gloo, spawned by
``graphnet_tpu_torch.parallel.dryrun``) run one training step of each
layout (DP, FSDP, TP, FSDP+TP) at narrow widths and hold it against the
port's single-process step and against the JAX package's Trainer on a
2-device mesh of this process, at the tolerances of
``tests/test_multidevice.py``: loss rtol 1e-5, parameters and gradients
rtol 5e-4, atol 1e-5 (against the JAX package, ``assert_step_matches``:
first the two packages' one-device steps on the same inputs, then the
layouts themselves, each gradient also within 5e-4 of its leaf's largest
and each parameter within its gradient's difference times Adam's
first-step slope).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax

from graphnet_tpu.parallel import distributed as jax_distributed
from graphnet_tpu.parallel.mesh import fsdp_sharding as jax_fsdp_sharding
from graphnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graphnet_tpu.parallel.tensor_parallel import (
    count_tp_sharded as jax_count_tp_sharded,
)
from graphnet_tpu.parallel.tensor_parallel import (
    tensor_parallel_sharding as jax_tp_sharding,
)
from graphnet_tpu.training.trainer import Trainer as JaxTrainer
from graphnet_tpu_torch.parallel import distributed, dryrun
from graphnet_tpu_torch.parallel.mesh import fsdp_sharding, jax_dim
from graphnet_tpu_torch.parallel.tensor_parallel import (
    count_tp_sharded,
    tensor_parallel_sharding,
)
from graphnet_tpu_torch.training.trainer import Trainer
from graphnet_tpu_torch.utils.jax_params import params_to_jax
from tests.tools_torch_parallel_jax import (
    assert_step_matches,
    in_port_names,
    jax_batch,
    jax_model,
    mesh_step,
    one_device_step,
)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
RTOL, ATOL = 5e-4, 1e-5
LAYOUTS = ("dp", "fsdp", "tp", "fsdp+tp")


def _model(kind, width="narrow"):
    return dryrun.build_model(kind, "cpu", width)


def _jax_specs(specs_tree, axis):
    """``{port name: JAX dim or None}`` of a JAX NamedSharding tree."""
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            spec = tuple(value.spec)
            dims = [d for d, e in enumerate(spec) if e == axis]
            name = ".".join(path + ("weight" if key in ("kernel", "scale")
                                    else key,))
            out[name] = dims[0] if dims else None

    walk(specs_tree["params"], ())
    return out


def _port_specs_in_jax_dims(specs, params):
    return {n: None if d is None else jax_dim(n, params[n], d)
            for n, d in specs.items()}


# ------------------------------------------------------------- the rules
@pytest.mark.parametrize("kind,width", [("dynedge", "full"), ("dynedge", "narrow"),
                                        ("tito", "full")])
@pytest.mark.parametrize("n,min_size", [(2, 2**14), (4, 2**14), (8, 2**10),
                                        (3, 2**10)])
def test_fsdp_specs_match_jax(kind, width, n, min_size):
    """``fsdp_sharding``'s shard dimension of every parameter equals the
    JAX rule's on the same tree (largest divisible dimension, the first
    of equal ones, leaves under ``min_size`` replicated)."""
    model = _model(kind, width)
    params = dict(model.named_parameters())
    tree = params_to_jax(model.state_dict())
    mesh = jax_make_mesh(n, 1, devices=jax.devices()[:n])
    exp = _jax_specs(jax_fsdp_sharding(mesh, tree, "data", min_size), "data")
    got = _port_specs_in_jax_dims(
        fsdp_sharding({"data": n}, params, "data", min_size), params)
    assert got == exp
    # every narrow leaf lies under 2^14 elements
    assert any(d is not None for d in got.values()) == (
        width == "full" or min_size <= 2**10)


@pytest.mark.parametrize("width", ["full", "narrow"])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_specs_and_count_match_jax(width, n):
    """The tensor-parallel rule on DynEdgeTITO: the same leaves and
    dimensions as the JAX rule, and ``count_tp_sharded`` the same
    (qkv, out, linear1, linear2 of each block: 6 leaves a block)."""
    model = _model("tito", width)
    params = dict(model.named_parameters())
    tree = params_to_jax(model.state_dict())
    mesh = jax_make_mesh(8 // n, n, devices=jax.devices()[:8])
    exp = _jax_specs(jax_tp_sharding(mesh, tree, "model"), "model")
    got = _port_specs_in_jax_dims(
        tensor_parallel_sharding({"model": n}, params), params)
    assert got == exp
    count = count_tp_sharded(params, {"model": n})
    assert count == jax_count_tp_sharded(tree, mesh) == 6 * model.backbone.n_convs


def test_tp_rule_warns_and_replicates_like_jax():
    """A width that does not divide warns and stays replicated in both."""
    model = _model("tito", "narrow")
    params = dict(model.named_parameters())
    tree = params_to_jax(model.state_dict())
    mesh = jax_make_mesh(1, 3, devices=jax.devices()[:3])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        exp = _jax_specs(jax_tp_sharding(mesh, tree, "model"), "model")
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = _port_specs_in_jax_dims(
            tensor_parallel_sharding({"model": 3}, params), params)
    assert got == exp
    assert sorted(str(w.message) for w in tw) == sorted(str(w.message) for w in jw)
    assert tw


@pytest.mark.parametrize("sizes,n", [((13,), 4), ((3,), 8), ((16, 5), 4),
                                     ((6,), 2)])
def test_pad_to_multiple_matches_jax(sizes, n):
    """The ragged batch padding: pad events copy the last one with weight
    0, real ones carry ``B_pad / B``; after a divisible batch, ragged ones
    pad to that nominal size.  Weights and padded rows as the JAX
    Trainer's."""
    jtrainer = JaxTrainer(jax_model("dynedge"),
                          mesh=jax_make_mesh(n, 1, devices=jax.devices()[:n]))
    trainer = Trainer(_model("dynedge"))
    trainer.mesh = {"data": n, "model": 1}  # the rule reads axis sizes only
    for i, B in enumerate(sizes):
        batch = dryrun.example_batch(B, 16, seed=i)
        got = trainer._pad_to_multiple(batch)
        exp = jtrainer._pad_to_multiple(jax_batch(batch))
        assert got.batch_size == exp.batch_size
        if exp.event_weight is None:  # a batch that divides is kept
            assert got.event_weight is None and got.batch_size == B
        else:
            np.testing.assert_array_equal(got.event_weight.numpy(),
                                          np.asarray(exp.event_weight))
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(exp.x))
        np.testing.assert_array_equal(got.labels["total_energy"].numpy(),
                                      np.asarray(exp.labels["total_energy"]))


@pytest.mark.parametrize("B,n,i", [(16, 1, 0), (16, 4, 3), (12, 3, 1),
                                   (10, 4, 0)])
def test_host_local_batch_slice_matches_jax(monkeypatch, B, n, i):
    """``(start, size)`` of a process's slice of the global batch, and the
    same refusal of a batch that does not divide."""
    monkeypatch.setattr(distributed, "process_count", lambda: n)
    monkeypatch.setattr(distributed, "process_index", lambda: i)
    monkeypatch.setattr(jax_distributed.jax, "process_count", lambda: n)
    monkeypatch.setattr(jax_distributed.jax, "process_index", lambda: i)
    if B % n:
        with pytest.raises(AssertionError):
            jax_distributed.host_local_batch_slice(B)
        with pytest.raises(AssertionError):
            distributed.host_local_batch_slice(B)
        return
    assert (distributed.host_local_batch_slice(B)
            == jax_distributed.host_local_batch_slice(B))


def test_init_distributed_alone_is_a_no_op(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.init_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed(num_processes=2, process_id=0,
                                     device="cpu")


def test_trainer_refuses_what_the_jax_trainer_refuses():
    model = _model("dynedge")
    with pytest.raises(ValueError, match="requires mesh"):
        Trainer(model, param_sharding="fsdp")
    with pytest.raises(ValueError, match="unknown"):
        Trainer(model, param_sharding="zero")


def test_fit_refuses_prefetch_under_a_mesh():
    """``fit(prefetch=)`` is single-process: under a mesh it raises
    rather than run without the prefetch asked for."""
    trainer = Trainer(_model("dynedge"))
    trainer.mesh = {"data": 2, "model": 1}  # the check reads only the mesh
    with pytest.raises(NotImplementedError, match="prefetch"):
        trainer.fit([dryrun.example_batch(4, 16)], prefetch=2, max_epochs=1)


# ------------------------------------------------- two processes, gloo
@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("layouts"))
    reports = dryrun.launch(2, "cpu", ",".join(LAYOUTS), width="narrow",
                            timeout=300, threads=1, out=out)
    return {r["layout"]: r for r in reports}, out


def _step_inputs(layout):
    spec = dryrun.layout_spec(layout, 2, 0)
    batch = dryrun.example_batch(spec["B"], spec["L"], seed=0)
    return spec, batch


def _assert_close(got, exp, what):
    for name, e in exp.items():
        g = got[name].detach().numpy()
        e = e.detach().numpy() if torch.is_tensor(e) else np.asarray(e)
        np.testing.assert_allclose(g, e, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_step_matches_single_process(layouts, layout):
    """Two processes' step equals the port's one-process step on the
    same global batch: the loss (the mean of the processes' losses), the
    gradients and the parameters after the step."""
    reports, out = layouts
    report = reports[layout]
    assert report["ranks"] == 2 and report["backend"] == "gloo"
    assert report["finite"] and report["ok"]
    assert report["params_entries_beyond_tol"] == 0
    saved = torch.load(os.path.join(out, f"{layout}.pt"))
    spec, batch = _step_inputs(layout)
    model = _model(spec["kind"])
    ref = Trainer(model)
    loss = float(ref.train_step(batch))
    np.testing.assert_allclose(saved["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(report["loss_single_process"], loss, rtol=1e-6)
    _assert_close(saved["grads"], {n: p.grad for n, p in model.named_parameters()},
                  "grad")
    _assert_close(saved["params"], model.state_dict(), "param")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_step_matches_jax_mesh(layouts, layout):
    """The same step against the JAX Trainer on a 2-device mesh of the
    same layout (``param_sharding`` as the port's) from the same
    weights; first the port's one-process step against the JAX
    Trainer's one-device step on these inputs, at the same tolerance."""
    _, out = layouts
    saved = torch.load(os.path.join(out, f"{layout}.pt"))
    spec, batch = _step_inputs(layout)
    model = _model(spec["kind"])
    tree = params_to_jax(model.state_dict())
    expected = model.state_dict()

    jax_one = in_port_names(one_device_step(spec["kind"], tree, batch), expected)
    jax_layout = in_port_names(mesh_step(spec["kind"], spec, tree, batch), expected)
    ref_loss = float(Trainer(model).train_step(batch))
    assert_step_matches(
        (ref_loss, {n: p.grad for n, p in model.named_parameters()},
         model.state_dict()), jax_one, "one device", LOSS_RTOL, RTOL, ATOL)
    assert_step_matches((saved["loss"], saved["grads"], saved["params"]),
                        jax_layout, layout, LOSS_RTOL, RTOL, ATOL)


def test_fsdp_equals_dp(layouts):
    """As the JAX dry run asserts: FSDP's loss is DP's."""
    reports, _ = layouts
    np.testing.assert_allclose(reports["fsdp"]["loss"], reports["dp"]["loss"],
                               rtol=LOSS_RTOL)


def test_counted_collectives_match_the_scaling_profile(layouts):
    """DDP's gradient all-reduce, counted in each process by the dry
    run's ``CollectiveTape`` (the reducer's buckets), moves exactly the bytes that
    ``scaling_model.dynedge_headline_profile`` gives for the model's
    parameters; TP's all-reduces are counted too."""
    from graphnet_tpu_torch.parallel.scaling_model import (
        dynedge_headline_profile,
    )

    reports, _ = layouts
    dp = reports["dp"]
    profile = dynedge_headline_profile(dp["n_params"])
    assert dp["collective_bytes_per_rank"] == [
        {"ddp_grad": profile.grad_allreduce_bytes}] * 2
    assert all(c["all_reduce"] > 0
               for c in reports["tp"]["collective_calls_per_rank"])
