"""Port a GraphNeT (torch) checkpoint and serve it with the port
(counterpart of ``examples/06_deployment/02_port_pretrained.py``).

    python -m graphnet_tpu_torch.examples.port_pretrained
    python -m graphnet_tpu_torch.examples.port_pretrained --device cpu
    python -m graphnet_tpu_torch.examples.port_pretrained \\
        --ref-config model_config.yml --ref-state-dict state_dict.pth

A GraphNeT user has two files for a trained model: its ModelConfig YAML
and its ``state_dict``.  :func:`~graphnet_tpu_torch.utils.weight_port.
port_reference_model` turns them into the port's model, graph definition
and ``state_dict``; :func:`~graphnet_tpu_torch.utils.config.save_model`
writes them in this project's layout, and ``DeploymentModule`` serves
them on raw events of the bundled SQLite database.  Without the two
files, the script first writes stand-ins to ``--workdir``: a GraphNeT
DynEdge energy config for the Prometheus database and a checkpoint in
GraphNeT's key layout with random weights from ``--seed``
(:func:`graphnet_state_dict`), which take the same path a real
``*_state_dict.pth`` takes.  Everything runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import tempfile
from typing import Dict

import numpy as np
import torch
import yaml

from graphnet_tpu_torch.constants import EXAMPLE_SQLITE_DATA
from graphnet_tpu_torch.data.constants import FEATURES, TRUTH

# GraphNeT's DynEdge builds `_readout` even where it skips it; the
# width of that unused layer
_SKIPPED_READOUT = 128


def _draw(rng: np.random.Generator, key: str, shape, init: torch.Tensor):
    """A random value for a GraphNeT parameter: a linear (or GRU) weight
    uniform in +-1/sqrt(fan_in) (torch's own initialisation), a bias
    N(0, 0.05^2), a layer norm's, batch norm's weight and a layer scale
    1 + N(0, 0.1^2), a sinusoid scale its initial value times
    1 + N(0, 0.1^2), a batch norm's running variance uniform in
    [0.5, 2] and its batch count 0, anything else (the cls token, the
    aux table, the position embedding, a running mean) N(0, 1)."""
    name = key.rsplit(".", 1)[-1]
    z = rng.standard_normal(shape)
    if name == "num_batches_tracked":
        z = np.zeros(shape)
    elif name == "running_var":
        z = rng.uniform(0.5, 2.0, shape)
    elif name.endswith("bias") or name.startswith("bias_"):
        z = z * 0.05
    elif (name in ("weight", "in_proj_weight") or name.startswith("weight_")
          ) and len(shape) == 2 and (
            "aux_emb" not in key and "cls_token" not in key):
        z = rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[1])
    elif (name == "weight" and len(shape) == 1) or name.startswith("gamma"):
        z = 1.0 + z * 0.1
    elif name == "scale":
        z = init.detach().cpu().numpy() * (1.0 + z * 0.1)
    return z.astype(np.float32)


def _dynedge_layout(backbone, prefix: str) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port DynEdge: each conv's
    ``nn`` Sequential ``[Linear, (LayerNorm), act] * n`` with the first
    linear over ``cat[x_i, x_j - x_i]``, ``_post_processing``, and
    ``_readout`` (built by GraphNeT even where it is skipped)."""
    shapes = {}

    def mlp(key, d_in, sizes, norm):
        step = 3 if norm else 2
        for j, size in enumerate(sizes):
            shapes[f"{key}.{j * step}.weight"] = (size, d_in)
            shapes[f"{key}.{j * step}.bias"] = (size,)
            if norm:
                shapes[f"{key}.{j * step + 1}.weight"] = (size,)
                shapes[f"{key}.{j * step + 1}.bias"] = (size,)
            d_in = size

    for i in range(backbone.n_convs):
        conv = getattr(backbone, f"conv_{i}").conv
        mlp(f"{prefix}._conv_layers.{i}.nn", 2 * conv.self_dense.in_features,
            conv.nn_sizes, conv.add_norm_layer)
    post = backbone.post_processing
    mlp(f"{prefix}._post_processing", post.dense_0.in_features, post.sizes,
        post.add_norm_layer)
    if backbone.skip_readout:
        mlp(f"{prefix}._readout", backbone.nb_outputs, (_SKIPPED_READOUT,),
            False)
    else:
        mlp(f"{prefix}._readout", backbone.readout.dense_0.in_features,
            backbone.readout.sizes, False)
    return shapes


# port DeepIce parameter names -> GraphNeT's (applied in order)
_DEEPICE_NAMES = (
    (r"^fourier_ext\.aux_emb\.embedding$", "fourier_ext.aux_emb.weight"),
    (r"^fourier_ext\.mlp_0\.", "fourier_ext.mlp.0."),
    (r"^fourier_ext\.mlp_norm\.", "fourier_ext.mlp.1."),
    (r"^fourier_ext\.mlp_1\.", "fourier_ext.mlp.3."),
    (r"^cls_token$", "cls_token.weight"),
    (r"^blocks_(\d+)\.attn\.qkv\.(weight|bias)$", r"blocks_\1.attn.in_proj_\2"),
    (r"^blocks_(\d+)\.attn\.out\.", r"blocks_\1.attn.out_proj."),
    (r"\.mlp\.fc1\.", ".mlp.input_projection."),
    (r"\.mlp\.fc2\.", ".mlp.output_projection."),
    (r"^(sandwich|blocks)_(\d+)\.", r"\1.\2."),
)


def _deepice_layout(backbone) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port DeepIce (the nested
    ``dyn_edge`` by :func:`_dynedge_layout`).  The rel blocks' q and v
    projections carry no bias, as in GraphNeT's default
    (``qkv_bias=False``)."""
    shapes = {}
    for key, value in backbone.state_dict().items():
        if key.startswith("dyn_edge."):
            continue
        if re.match(r"^sandwich_\d+\.attn\.proj_[qv]\.bias$", key):
            continue
        for pattern, repl in _DEEPICE_NAMES:
            key = re.sub(pattern, repl, key)
        shapes[f"backbone.{key}"] = tuple(value.shape)
    if backbone.include_dynedge:
        shapes.update(_dynedge_layout(backbone.dyn_edge, "backbone.dyn_edge"))
    return shapes


def _linear(shapes, key: str, layer) -> None:
    shapes[f"{key}.weight"] = tuple(layer.weight.shape)
    shapes[f"{key}.bias"] = tuple(layer.bias.shape)


def _batch_norm(shapes, key: str, features: int) -> None:
    """A torch ``BatchNorm1d``'s parameters and buffers."""
    for name in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"{key}.{name}"] = (features,)
    shapes[f"{key}.num_batches_tracked"] = ()


def _jinst_layout(backbone) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port DynEdgeJINST: each
    ``conv_add{i}.nn`` Sequential ``[Linear, LeakyReLU] * 2`` (the first
    linear over ``cat[x_i, x_j - x_i]``), ``nn1``, ``nn2``, ``nn3``."""
    shapes = {}
    for i in range(1, 5):
        conv = getattr(backbone, f"conv_add{i}").conv
        h0, h1 = conv.nn_sizes
        key = f"backbone.conv_add{i}.nn"
        shapes[f"{key}.0.weight"] = (h0, 2 * conv.self_dense.in_features)
        shapes[f"{key}.0.bias"] = (h0,)
        shapes[f"{key}.2.weight"] = (h1, h0)
        shapes[f"{key}.2.bias"] = (h1,)
    for name in ("nn1", "nn2", "nn3"):
        _linear(shapes, f"backbone.{name}", getattr(backbone, name))
    return shapes


def _convnet_layout(backbone) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port ConvNet: three PyG
    ``TAGConv`` s in PyG's current layout (``lins.{h}`` without biases,
    one module ``bias``), ``batchnorm1``, ``linear1`` .. ``linear5``,
    ``out``."""
    shapes = {}
    for i in range(1, 4):
        conv = getattr(backbone, f"conv{i}")
        for h in range(conv.K + 1):
            shapes[f"backbone.conv{i}.lins.{h}.weight"] = tuple(
                getattr(conv, f"lin_{h}").weight.shape)
        shapes[f"backbone.conv{i}.bias"] = (conv.lin_0.out_features,)
    _batch_norm(shapes, "backbone.batchnorm1", backbone.bn_scale.shape[0])
    for name in ("linear1", "linear2", "linear3", "linear4", "linear5",
                 "out"):
        _linear(shapes, f"backbone.{name}", getattr(backbone, name))
    return shapes


def _particlenet_layout(backbone) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port ParticleNeT: each
    ``_conv_layers.{i}.nn`` Sequential ``[Linear, (BatchNorm1d), act] *
    n`` (the first linear over ``cat[x_i, x_j - x_i]``) and the
    ``_readout`` ``[Linear, act, Dropout] * m``."""
    shapes = {}
    for i in range(backbone.n_convs):
        conv = getattr(backbone, f"conv_{i}")
        step = 3 if conv.add_batchnorm else 2
        key = f"backbone._conv_layers.{i}.nn"
        d = 2 * conv.self_dense.in_features
        for j, size in enumerate(conv.nn_sizes):
            shapes[f"{key}.{j * step}.weight"] = (size, d)
            shapes[f"{key}.{j * step}.bias"] = (size,)
            if conv.add_batchnorm:
                _batch_norm(shapes, f"{key}.{j * step + 1}", size)
            d = size
    for j in range(len(backbone.readout_layer_sizes)):
        _linear(shapes, f"backbone._readout.{3 * j}",
                getattr(backbone, f"readout_{j}"))
    return shapes


# port ISeeCube parameter names -> GraphNeT's (torchscale's encoder;
# applied in order)
_ISEECUBE_NAMES = (
    (r"^fourier_ext\.aux_emb\.embedding$", "fourier_ext.aux_emb.weight"),
    (r"^fourier_ext\.mlp_0\.", "fourier_ext.mlp.0."),
    (r"^fourier_ext\.mlp_norm\.", "fourier_ext.mlp.1."),
    (r"^fourier_ext\.mlp_1\.", "fourier_ext.mlp.3."),
    (r"^rel_pos_bias\.rel_embedding$",
     "encoder.relative_position.relative_attention_bias.weight"),
    (r"^attn_(\d+)\.proj_([qkv])\.", r"encoder.layers.\1.self_attn.\2_proj."),
    (r"^attn_(\d+)\.inner_attn_ln\.",
     r"encoder.layers.\1.self_attn.inner_attn_ln."),
    (r"^attn_(\d+)\.out\.", r"encoder.layers.\1.self_attn.out_proj."),
    (r"^norm1_(\d+)\.", r"encoder.layers.\1.self_attn_layer_norm."),
    (r"^norm2_(\d+)\.", r"encoder.layers.\1.final_layer_norm."),
    (r"^fc([12])_(\d+)\.", r"encoder.layers.\2.ffn.fc\1."),
    (r"^ffn_ln_(\d+)\.", r"encoder.layers.\1.ffn.ffn_layernorm."),
    (r"^encoder_layer_norm\.", "encoder.layer_norm."),
)


def _iseecube_layout(backbone) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port ISeeCube (torchscale's
    Magneto encoder under ``encoder``)."""
    shapes = {}
    for key, value in backbone.state_dict().items():
        for pattern, repl in _ISEECUBE_NAMES:
            key = re.sub(pattern, repl, key)
        shapes[f"backbone.{key}"] = tuple(value.shape)
    return shapes


def _tito_layout(backbone, prefix: str) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port DynEdgeTITO: each DynTrans
    block's ``nn`` Sequential ``[Linear, LeakyReLU] * 2`` (the first
    linear over ``cat[x_i, x_j - x_i, x_j]``), ``norm1`` and its torch
    ``TransformerEncoderLayer``; ``_post_processing`` and ``_readout``
    ``[Linear, LeakyReLU] * n``."""
    shapes = {}
    for i in range(backbone.n_convs):
        blk = getattr(backbone, f"conv_{i}")
        h0, h1 = blk.conv.nn_sizes
        key = f"{prefix}._conv_layers.{i}"
        shapes[f"{key}.nn.0.weight"] = (h0, 3 * blk.conv.self_dense.in_features)
        shapes[f"{key}.nn.0.bias"] = (h0,)
        shapes[f"{key}.nn.2.weight"] = (h1, h0)
        shapes[f"{key}.nn.2.bias"] = (h1,)
        _linear(shapes, f"{key}.norm1", blk.norm1)
        t, tr = f"{key}._transformer_encoder.layers.0", blk.transformer
        shapes[f"{t}.self_attn.in_proj_weight"] = tuple(tr.mha.qkv.weight.shape)
        shapes[f"{t}.self_attn.in_proj_bias"] = tuple(tr.mha.qkv.bias.shape)
        _linear(shapes, f"{t}.self_attn.out_proj", tr.mha.out)
        for name in ("linear1", "linear2", "norm1", "norm2"):
            _linear(shapes, f"{t}.{name}", getattr(tr, name))
    for torch_name, name in (("_post_processing", "post_processing"),
                             ("_readout", "readout")):
        if hasattr(backbone, name):
            mlp = getattr(backbone, name)
            for j in range(len(mlp.sizes)):
                _linear(shapes, f"{prefix}.{torch_name}.{2 * j}",
                        getattr(mlp, f"dense_{j}"))
    return shapes


def _rnn_tito_layout(backbone) -> Dict[str, tuple]:
    """GraphNeT's keys and shapes of a port RNN_TITO: the Node_RNN's torch
    ``nn.GRU`` (``_rnn._rnn``; gate rows r, z, n) and the DynEdgeTITO
    under ``_dynedge_tito``."""
    shapes = {}
    rnn = backbone.rnn
    for layer in range(rnn.num_layers):
        cell = getattr(rnn, f"gru_{layer}").cell.gru
        H, d_in = cell.ir.out_features, cell.ir.in_features
        key = "backbone._rnn._rnn"
        shapes[f"{key}.weight_ih_l{layer}"] = (3 * H, d_in)
        shapes[f"{key}.weight_hh_l{layer}"] = (3 * H, H)
        shapes[f"{key}.bias_ih_l{layer}"] = (3 * H,)
        shapes[f"{key}.bias_hh_l{layer}"] = (3 * H,)
    shapes.update(_tito_layout(backbone.dynedge_tito,
                               "backbone._dynedge_tito"))
    return shapes


_LAYOUTS = {
    "DeepIce": _deepice_layout,
    "DynEdgeJINST": _jinst_layout,
    "ConvNet": _convnet_layout,
    "ParticleNeT": _particlenet_layout,
    "ISeeCube": _iseecube_layout,
    "RNNTITO": _rnn_tito_layout,
}


def graphnet_state_dict(model, rng: np.random.Generator
                        ) -> Dict[str, np.ndarray]:
    """A checkpoint in GraphNeT's key layout for a port ``StandardModel``
    (what GraphNeT's own model of the same configuration holds), with
    random weights from ``rng``: the stand-in for a trained
    ``*_state_dict.pth``."""
    backbone = model.backbone
    kind = type(backbone).__name__
    if kind == "DynEdge":
        shapes = _dynedge_layout(backbone, "backbone")
    elif kind == "DynEdgeTITO":
        shapes = _tito_layout(backbone, "backbone")
    elif kind in _LAYOUTS:
        shapes = _LAYOUTS[kind](backbone)
    else:
        raise NotImplementedError(
            f"no GraphNeT layout for a {kind} backbone here")
    for t, task in enumerate(model.tasks):
        shapes[f"_tasks.{t}._affine.weight"] = tuple(task.affine.weight.shape)
        shapes[f"_tasks.{t}._affine.bias"] = tuple(task.affine.bias.shape)
    init = {f"backbone.{k}": v for k, v in backbone.state_dict().items()}
    return {key: _draw(rng, key, shape, init.get(key))
            for key, shape in shapes.items()}


def reference_config() -> dict:
    """A GraphNeT ModelConfig of a DynEdge energy model for the bundled
    Prometheus database (the layout of GraphNeT's ``*_config.yml``)."""
    def component(name, **arguments):
        return {"ModelConfig": {"class_name": name, "arguments": arguments}}

    return {"class_name": "StandardModel", "arguments": {
        "backbone": component(
            "DynEdge", nb_inputs=len(FEATURES.PROMETHEUS),
            global_pooling_schemes=["min", "max", "mean", "sum"]),
        "graph_definition": component(
            "KNNGraph", detector=component("Prometheus"),
            node_definition=component("NodesAsPulses"),
            input_feature_names=list(FEATURES.PROMETHEUS),
            nb_nearest_neighbours=8, columns=[0, 1, 2]),
        "optimizer_class": "!class torch.optim.adam Adam",
        "optimizer_kwargs": {"eps": 0.001, "lr": 0.001},
        "tasks": [component(
            "IdentityTask", hidden_size=128, nb_outputs=1,
            target_labels="total_energy",
            loss_function=component("LogCoshLoss"),
            transform_target="!lambda x: torch.log10(x)",
            transform_inference="!lambda x: torch.pow(10,x)")],
    }}


def make_reference_artifacts(workdir: str, seed: int) -> tuple:
    """Write the stand-in ``ref_model_config.yml`` and
    ``ref_state_dict.pkl`` (a pickled dict of arrays in GraphNeT's
    layout) to ``workdir``; returns their paths."""
    from graphnet_tpu_torch.utils.weight_port import from_reference_config

    config_path = os.path.join(workdir, "ref_model_config.yml")
    weights_path = os.path.join(workdir, "ref_state_dict.pkl")
    with open(config_path, "w") as f:
        yaml.safe_dump(reference_config(), f, sort_keys=False)
    model, _ = from_reference_config(config_path, device="cpu")
    with open(weights_path, "wb") as f:
        pickle.dump(graphnet_state_dict(model, np.random.default_rng(seed)), f)
    return config_path, weights_path


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Port a GraphNeT checkpoint and serve it")
    parser.add_argument(
        "--workdir",
        default=os.path.join(tempfile.gettempdir(), "port_pretrained"))
    parser.add_argument("--ref-config", default=None,
                        help="GraphNeT ModelConfig YAML (default: a stand-in)")
    parser.add_argument("--ref-state-dict", default=None,
                        help="GraphNeT state_dict (.pth / .pt, or a pickled "
                        "dict of arrays)")
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the stand-in checkpoint's weights")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if (args.ref_config is None) != (args.ref_state_dict is None):
        parser.error("--ref-config and --ref-state-dict go together "
                     "(or leave both out for the stand-ins)")
    return args


def main(argv=None) -> np.ndarray:
    """Run the example; returns the served predictions."""
    from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset
    from graphnet_tpu_torch.deployment.deployment_module import (
        DeploymentModule,
    )
    from graphnet_tpu_torch.utils.config import save_model
    from graphnet_tpu_torch.utils.weight_port import port_reference_model

    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    if args.ref_config is None:
        args.ref_config, args.ref_state_dict = make_reference_artifacts(
            args.workdir, args.seed)
        print(f"wrote stand-in GraphNeT artifacts to {args.workdir}")

    model, graph_definition, _ = port_reference_model(
        args.ref_config, args.ref_state_dict, device=args.device)
    print(f"ported {type(model.backbone).__name__} with "
          f"{len(model.tasks)} task head(s)")
    ported = os.path.join(args.workdir, "ported")
    save_model(model, ported)
    module = DeploymentModule(os.path.join(ported, "config.yml"),
                              os.path.join(ported, "state_dict.pkl"),
                              device=args.device)
    ds = SQLiteDataset(
        path=EXAMPLE_SQLITE_DATA,
        graph_definition=graph_definition,
        pulsemaps="total",
        features=FEATURES.PROMETHEUS,
        truth=TRUTH.PROMETHEUS,
        truth_table="mc_truth",
    )
    events = [ds[i] for i in range(8)]
    preds = module(events)
    if not np.isfinite(preds).all():
        raise RuntimeError(f"non-finite predictions: {preds}")
    print(f"served {len(events)} events on {args.device}; predictions "
          f"{preds.ravel()}")
    return preds


if __name__ == "__main__":
    main()
