"""The port's config registry (``graphnet_tpu_torch/utils/config.py``)
against the JAX package's on the CPU: every model file of ``configs/``
whose classes the port has builds a port model that matches the JAX
model built from the same file; the dumped configs, ``save_model`` and
``load_saved_model`` cross between the packages; the ten transforms, the
new heads and losses match; a file naming a class the port lacks says
which.  ``tests/test_torch_zoo.py`` holds the rest of ``configs/models``:
the ``+DynEdge`` zoo files' predictions and the graph definitions."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import graphnet_tpu.models.task.classification as jcls
import graphnet_tpu.models.task.reconstruction as jrec
import graphnet_tpu.models.task.task as jtask
import graphnet_tpu.training.loss_functions as jlf
import graphnet_tpu.utils.config as jconfig
from graphnet_tpu.batch import make_batch as jax_make_batch
from graphnet_tpu_torch.batch import make_batch
from graphnet_tpu_torch.models.task import classification as tcls
from graphnet_tpu_torch.models.task import reconstruction as trec
from graphnet_tpu_torch.models.task import task as ttask
from graphnet_tpu_torch.training import loss_functions as tlf
from graphnet_tpu_torch.utils import config
from graphnet_tpu_torch.utils.jax_params import params_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "configs" / "models"
QUESO = ["SplitInIcePulses_cleaner", "neutrino_direction",
         "neutrino_vs_muon_classifier", "neutrino_zenith",
         "total_neutrino_energy", "track_vs_cascade_classifier"]
# the model files held here for predictions (the two +DynEdge zoo files'
# are in tests/test_torch_zoo.py)
BUILDABLE = (
    ["dynedge_energy_prometheus.yml", "dynedge_pid_classification.yml",
     "dynedge_track_classification_icecube86.yml",
     "dynedge_zenith_prometheus.yml", "tito_direction_prometheus.yml"]
    + [f"zoo/queso/{name}/model.yml" for name in QUESO]
    + [f"zoo/kaggle_icemix/{name}/model.yml"
       for name in ("B_d32", "B_d32_4rel", "B_d64")]
)
LENGTHS = [13, 4, 16]
L = 16


def _file_dict(name):
    with open(MODELS / name) as f:
        return yaml.safe_load(f)


def _backbone(d):
    return d["arguments"]["backbone"]["__model__"]


def _shallow(d):
    """The file's config with a DeepIce backbone cut to one block and one
    rel block (both packages build the same cut; the widths are the
    file's)."""
    d = copy.deepcopy(d)
    if _backbone(d)["class_name"] == "DeepIce":
        _backbone(d)["arguments"].update(depth=1, depth_rel=1)
    return d


def _events(d, seed):
    """Events for the file's backbone: DynEdge's and TITO's ``nb_inputs``
    normal columns, or DeepIce's six IceMix features (a 0/1 flag last)."""
    rng = np.random.default_rng(seed)
    bb = _backbone(d)
    if bb["class_name"] == "DeepIce":
        return [np.concatenate(
            [rng.standard_normal((n, 3)) * 0.5, rng.random((n, 1)) * 0.03,
             rng.random((n, 1)), rng.random((n, 1)) > 0.5], axis=1
        ).astype(np.float32) for n in LENGTHS]
    nb = bb["arguments"]["nb_inputs"]
    return [rng.standard_normal((n, nb)).astype(np.float32) for n in LENGTHS]


def _random_tree(shapes, seed):
    """Dense kernels N(0, 1/fan_in), every other leaf N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.5
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _node_level(d):
    return any(t["__model__"]["arguments"].get("node_level")
               for t in d["arguments"]["tasks"])


def _jax_preds(jmodel, params, jbatch):
    return [np.asarray(p) for p, _ in jmodel.apply(params, jbatch,
                                                   inference=True)]


def _port_preds(model, tbatch):
    with torch.no_grad():
        return [p.numpy() for p, _ in model(tbatch, inference=True)]


def _assert_preds_close(got, exp, mask, node_level):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        if node_level:  # padded nodes carry no answer
            g, e = g[mask], e[mask]
        assert np.isfinite(e).all()
        np.testing.assert_allclose(g, e, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", BUILDABLE)
def test_file_builds_and_matches_jax(name, tmp_path):
    """Built by the port's registry and by the JAX package's from the
    same file (DeepIce backbones cut to depth 1 and depth_rel 1 on both
    sides, at the file's widths), with the JAX parameters carried by
    ``params_from_jax``: the served predictions agree within rtol 2e-4
    on a batch of 3 events at L=16.  Then ``save_model`` of each package
    loads in the other (``load_saved_model``) with the same predictions."""
    d = _shallow(_file_dict(name))
    events = _events(d, seed=len(name))
    jbatch = jax_make_batch(events, length=L)
    tbatch = make_batch(events, length=L)
    mask = tbatch.mask.numpy()
    node_level = _node_level(d)

    jmodel = jconfig.build(jconfig.ModelConfig.from_dict(copy.deepcopy(d)))
    params = _random_tree(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbatch), 3)
    # heads read latents of up to ~1e2 (sum pooling): a small affine
    # kernel keeps their outputs in range (pow10 of the QUESO energy head)
    for key, head in params["params"].items():
        if key.startswith("tasks_"):
            head["affine"]["kernel"] = head["affine"]["kernel"] * 1e-2
    model = config.build(config.ModelConfig.from_dict(copy.deepcopy(d)),
                         seed=0, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    model.load_state_dict(params_from_jax(params, model.state_dict()))
    expected = _jax_preds(jmodel, params, jbatch)
    _assert_preds_close(_port_preds(model, tbatch), expected, mask, node_level)

    config.save_model(model, str(tmp_path / "port"))
    jm, jp = jconfig.load_saved_model(str(tmp_path / "port"))
    _assert_preds_close(_jax_preds(jm, jp, jbatch), expected, mask, node_level)
    jconfig.save_model(jmodel, params, str(tmp_path / "jax"))
    back = config.load_saved_model(str(tmp_path / "jax"), device="cpu")
    _assert_preds_close(_port_preds(back, tbatch), expected, mask, node_level)


def _subset(part, whole):
    """Whether every argument that ``part`` gives is in ``whole`` with the
    same value (a file may leave arguments at their defaults)."""
    if isinstance(part, dict):
        return isinstance(whole, dict) and all(
            k in whole and _subset(v, whole[k]) for k, v in part.items())
    if isinstance(part, list):
        return (isinstance(whole, list) and len(part) == len(whole)
                and all(_subset(a, b) for a, b in zip(part, whole)))
    return part == whole


@pytest.mark.parametrize("name", BUILDABLE + ["knn_graph_prometheus.yml"])
def test_dumped_config_reproduces_the_file(name, tmp_path):
    """The full model (or graph definition) of the file, as the port
    builds it, dumps the dict that the JAX package dumps for its own
    build of the file, word for word, with every argument the file gives.
    Each package builds from the other's dump, and dumps it again the
    same."""
    path = str(MODELS / name)
    built = config.load_model(path, device="cpu")
    port_yml, jax_yml = tmp_path / "port.yml", tmp_path / "jax.yml"
    config.save_model_config(built, str(port_yml))
    jconfig.save_model_config(jconfig.load_model(path), str(jax_yml))
    assert port_yml.read_text() == jax_yml.read_text()
    dumped = yaml.safe_load(port_yml.read_text())
    assert _subset(_file_dict(name), dumped)
    assert "hidden_size" not in port_yml.read_text()
    assert "device" not in port_yml.read_text()

    again = jconfig.capture_config(jconfig.load_model(str(port_yml)))
    assert again.as_dict() == dumped
    rebuilt = config.load_model(str(jax_yml), device="cpu")
    assert config.capture_config(rebuilt).as_dict() == dumped


@pytest.mark.parametrize("name", ["zoo/kaggle_icemix/S+DynEdge_d32/model.yml",
                                  "zoo/kaggle_icemix/B+DynEdge_d64/model.yml"])
def test_dynedge_zoo_files_name_include_dynedge(name, tmp_path):
    """(Named when these files raised.)  Each ``+DynEdge`` zoo file builds
    its DeepIce with the nested DynEdge, and dumps the JAX package's
    dict of its own build of the file, word for word."""
    path = str(MODELS / name)
    built = config.load_model(path, device="cpu")
    assert built.backbone.include_dynedge and hasattr(built.backbone, "dyn_edge")
    port_yml, jax_yml = tmp_path / "port.yml", tmp_path / "jax.yml"
    config.save_model_config(built, str(port_yml))
    jconfig.save_model_config(jconfig.load_model(path), str(jax_yml))
    assert port_yml.read_text() == jax_yml.read_text()
    assert _subset(_file_dict(name), yaml.safe_load(port_yml.read_text()))


def test_unported_class_is_named(tmp_path):
    """A file naming a class the port does not have raises a KeyError
    that names it.  Every public class of the JAX registry is ported;
    the one it lacks is the JAX NodeRNN's private flax cell
    ``_ResetGRUCell`` (the port's NodeRNN steps ``torch.gru_cell``)."""
    from graphnet_tpu.utils import config as jax_config

    jax_config._register_framework_classes()
    config._register_framework_classes()
    assert set(jax_config.CLASS_REGISTRY) - set(config.CLASS_REGISTRY) == {
        "_ResetGRUCell"}
    d = {"class_name": "_ResetGRUCell", "arguments": {"features": 16}}
    path = tmp_path / "gru_cell.yml"
    path.write_text(yaml.safe_dump(d, sort_keys=False))
    with pytest.raises(KeyError, match="_ResetGRUCell"):
        config.load_model(str(path), device="cpu")


def test_load_model_defaults_to_the_gpu():
    path = str(MODELS / "dynedge_energy_prometheus.yml")
    if torch.cuda.is_available():
        model = config.load_model(path)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.load_model(path)


# ---------------------------------------------------------- transforms
_DOMAIN = {
    "log10": (0.1, 100.0), "log": (0.1, 100.0), "log10_half": (0.1, 100.0),
    "pow10": (-3.0, 3.0), "pow10_double": (-3.0, 3.0), "exp": (-3.0, 3.0),
    "cosh": (-3.0, 3.0), "arccosh": (1.0, 10.0), "identity": (-5.0, 5.0),
    "softmax": (-5.0, 5.0),
}


@pytest.mark.parametrize("name", sorted(_DOMAIN))
def test_transform_matches_jax(name):
    assert set(config.TRANSFORM_REGISTRY) == set(jconfig.TRANSFORM_REGISTRY)
    lo, hi = _DOMAIN[name]
    x = np.random.default_rng(0).uniform(lo, hi, (4, 5)).astype(np.float32)
    got = config.TRANSFORM_REGISTRY[name](torch.from_numpy(x)).numpy()
    exp = np.asarray(jconfig.TRANSFORM_REGISTRY[name](jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=2e-6, atol=1e-7)


# ---------------------------------------------------------- heads
HEADS = [
    ("IdentityTask", dict(nb_outputs=3)),
    ("MulticlassClassificationTask", dict(nb_outputs=3)),
    ("BinaryClassificationTask", {}),
    ("BinaryClassificationTaskLogits", {}),
    ("ZenithReconstruction", {}),
    ("ZenithReconstructionWithKappa", {}),
]


def _head_classes(name):
    for jmod, tmod in ((jtask, ttask), (jcls, tcls), (jrec, trec)):
        if hasattr(tmod, name) and getattr(tmod, name).__module__ == tmod.__name__:
            return getattr(jmod, name), getattr(tmod, name)
    raise KeyError(name)


@pytest.mark.parametrize("name,kw", HEADS, ids=[h[0] for h in HEADS])
def test_head_matches_jax(name, kw):
    """Predictions, and the gradients of a weighted sum of them with
    respect to the latents and the affine map, rtol 2e-4.  The captured
    config is the JAX module's."""
    jcls_, tcls_ = _head_classes(name)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((4, 8)).astype(np.float32)
    jt = jcls_(**kw)
    params = _random_tree(jax.eval_shape(jt.init, jax.random.PRNGKey(0),
                                         jnp.asarray(lat)), 2)
    pred_j = np.asarray(jt.apply(params, jnp.asarray(lat))[0])
    g = rng.standard_normal(pred_j.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jt.apply(p, x)[0] * g)

    gp_j, gx_j = jax.grad(jloss, (0, 1))(params, jnp.asarray(lat))
    tt = tcls_(hidden_size=8, **kw)
    tt.load_state_dict(params_from_jax(params, tt.state_dict()))
    x = torch.tensor(lat, requires_grad=True)
    pred_t = tt(x)[0]
    (pred_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(pred_t.detach().numpy(), pred_j, rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_j), rtol=2e-4,
                               atol=1e-6)
    gw = params_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    for key, p in tt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gw[key].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=key)
    assert tt.predictions == jt.predictions
    assert config.capture_config(tt).as_dict() == jconfig.capture_config(
        jt).as_dict()


# ---------------------------------------------------------- losses
LOSSES = [
    ("CrossEntropyLoss", dict(options=3)),
    ("CrossEntropyLoss", dict(options=[12, 14, 16])),
    ("CrossEntropyLoss", dict(options={11: 0, 13: 1, -13: 1, 22: 2})),
    ("BinaryCrossEntropyLoss", {}),
    ("VonMisesFisher2DLoss", {}),
]


def _loss_inputs(name, kw, rng, n=6):
    if name == "CrossEntropyLoss":
        opts = kw["options"]
        pred = rng.standard_normal((n, 3))
        values = (list(range(opts)) if isinstance(opts, int)
                  else list(opts) + [99])  # 99: no option names it
        target = rng.choice(values, (n, 1)).astype(np.float32)
    elif name == "BinaryCrossEntropyLoss":
        pred = 1 / (1 + np.exp(-rng.standard_normal((n, 1))))
        target = (rng.random((n, 1)) > 0.5).astype(np.float32)
    else:
        pred = np.stack([rng.uniform(0, np.pi, n), rng.uniform(0.1, 150, n)],
                        axis=1)
        target = rng.uniform(0, np.pi, (n, 1))
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("name,kw", LOSSES,
                         ids=["ce_int", "ce_list", "ce_dict", "bce", "vmf2d"])
def test_loss_matches_jax(name, kw):
    """Value, elements and the gradient with respect to the prediction,
    rtol 2e-5 (vMF 2D: 2e-4, its normaliser's branches at kappa above and
    below the switch at 100); ``CrossEntropyLoss``'s options are captured
    as the JAX package captures them."""
    rng = np.random.default_rng(4)
    pred, target = _loss_inputs(name, kw, rng)
    jl, tl = getattr(jlf, name)(**kw), getattr(tlf, name)(**kw)
    tol = 2e-4 if name == "VonMisesFisher2DLoss" else 2e-5
    val_j, grad_j = jax.value_and_grad(
        lambda p: jl(p, jnp.asarray(target)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    val_t = tl(p, torch.from_numpy(target))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=tol)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_j), rtol=tol,
                               atol=1e-7)
    np.testing.assert_allclose(
        tl(torch.from_numpy(pred), torch.from_numpy(target),
           return_elements=True).numpy(),
        np.asarray(jl(jnp.asarray(pred), jnp.asarray(target),
                      return_elements=True)), rtol=tol, atol=1e-7)
    assert config.capture_config(tl).as_dict() == jconfig.capture_config(
        jl).as_dict()
