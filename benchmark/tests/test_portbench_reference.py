"""The plain references against the port's plain path (the CPU runs the
kernels' plain versions) at a tiny size: the same seeded weights, the
same events, the reference padding them itself."""

import numpy as np
import pytest
import torch

from harness import capture, check, spec, traffic, weights


def port_model(root, config):
    from graphnet_tpu_torch.utils.config import build, ModelConfig

    cfg = spec.config(config, root)
    model = build(ModelConfig.from_dict(cfg["model"]), seed=0, device="cpu")
    return cfg, model


@pytest.mark.parametrize("config", ["tiny_dynedge", "tiny_deepice"])
def test_reference_matches_the_port(tiny_root, config):
    from graphnet_tpu_torch.data.dataloader import collate_events
    from graphnet_tpu_torch.models.graphs.graph_definition import Event

    cfg, model = port_model(tiny_root, config)
    ref_mod = spec.module("reference", cfg["family"], tiny_root)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    w = weights.make_weights(shapes, 123, "cpu", ref_mod.init_std)
    weights.fill_model(model, w)
    mix = dict(spec.traffic("tiny_train", tiny_root), events=12)
    ev = traffic.make_events(cfg, mix, 5, tiny_root)
    idx = list(range(len(ev)))
    batch = collate_events([Event(x=ev.event(i), features=ev.features,
                                  labels=ev.label_row(i)) for i in idx])
    model.train()
    with capture.GraphRecorder() as rec:
        outs = model(batch)
        loss = model.loss_from_batch(outs, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))

    ref = ref_mod.Model(cfg["model"], {k: v.clone().requires_grad_()
                                       for k, v in w.items()})
    x, mask, n, labels = check.collate(ev, idx, "cpu")
    kw = {"graphs": rec.calls} if getattr(ref_mod.Model, "follows_graphs",
                                          False) else {}
    pred = ref.forward(x, mask, n, **kw)
    ref_loss = ref.loss(pred, labels)
    ref_grads = torch.autograd.grad(ref_loss, list(ref.w.values()))
    torch.testing.assert_close(outs[0][0], pred, rtol=1e-5, atol=1e-6)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= 1e-6 * abs(float(ref_loss.detach()))
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * float(r.abs().max()) + 1e-12)
    if kw:
        assert capture.knn_mismatch(rec.calls, ref_mod.knn) == 0


def test_weights_repeat_by_seed_and_fill_every_leaf(tiny_root):
    cfg, model = port_model(tiny_root, "tiny_deepice")
    ref_mod = spec.module("reference", "deepice", tiny_root)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    a = weights.make_weights(shapes, 2 ** 31 + 9, "cpu", ref_mod.init_std)
    b = weights.make_weights(shapes, 2 ** 31 + 9, "cpu", ref_mod.init_std)
    assert all(torch.equal(a[k], b[k]) for k in a)
    weights.fill_model(model, a)
    assert all(torch.equal(p, a[n]) for n, p in model.named_parameters())
    norm = [k for k in a if k.endswith("norm1.weight")]
    assert norm and abs(float(a[norm[0]].mean()) - 1.0) < 0.1


def test_tf32_control_rounds_products_on_the_cpu():
    a, b = torch.randn(32, 32), torch.randn(32, 32)
    with check.tf32(True):
        c = a @ b
    gap = float((c - a @ b).abs().max() / (a @ b).abs().max())
    assert 1e-5 < gap < 1e-2
    assert np.all(check.round_tf32(a).view(torch.int32).numpy() & 0x1FFF == 0)
