"""GraphNeT checkpoints and configs in the port (counterpart of
``graphnet_tpu/utils/weight_port.py``).

* The porters map a GraphNeT (torch) ``StandardModel`` state_dict onto a
  port model: :func:`port_dynedge_state_dict`,
  :func:`port_tito_state_dict`, :func:`port_deepice_state_dict`
  (plain and with the nested DynEdge), :func:`port_jinst_state_dict`,
  :func:`port_convnet_state_dict`, :func:`port_particlenet_state_dict`,
  :func:`port_iseecube_state_dict` and :func:`port_rnn_tito_state_dict`;
  :func:`port_state_dict` picks the porter of a model's backbone.  The
  first linear layer of each EdgeConv is linearised, as the port's
  layers compute it:
  ``cat[x_i, x_j - x_i] @ [W1; W2]^T = x_i @ (W1 - W2)^T + x_j @ W2^T``
  gives ``self_dense`` ``(W1 - W2)`` and ``nbr_dense`` ``W2``.
* :func:`from_reference_config` and :func:`from_reference_dataset_config`
  build the port's components from GraphNeT's ModelConfig and
  DatasetConfig YAML without evaluating code: ``!lambda`` strings are
  looked up in a table of known transforms, ``!class`` references
  (optimisers) are dropped.
* :func:`port_reference_model` does both in one call, and serves the
  batch-norm backbones (ConvNet, ParticleNeT) with the checkpoint's
  running statistics (``frozen_batchnorm``), torch's eval mode.

The port's modules keep the JAX package's flax names, so one name map
serves both packages: a porter fills the JAX-layout tree of the port
model (:func:`~graphnet_tpu_torch.utils.jax_params.params_to_jax` of its
``state_dict()``) by the JAX package's rules, and
:func:`~graphnet_tpu_torch.utils.jax_params.params_from_jax` turns the
filled tree into the port's ``state_dict``.  A leaf the checkpoint does
not fill keeps the model's value (a DeepIce checkpoint without q/v
biases: those are filled with zeros, which computes the same).

Errors: a checkpoint key no rule reads raises ``ValueError``
("unported"); a key a rule needs and the checkpoint lacks ``KeyError``;
a value of the wrong shape ``ValueError`` ("shape mismatch").
"""

from __future__ import annotations

import inspect
import pickle
import re
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from graphnet_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

# ------------------------------------------------------ state_dict porting
def _normalise_keys(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """float32 numpy values; GraphNeT's ``_gnn.`` prefix renamed
    ``backbone.`` (its own migration of old checkpoints)."""
    out = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[re.sub(r"^_gnn\.", "backbone.", k)] = np.asarray(v, np.float32)
    return out


class _Reader:
    """The checkpoint's values, keeping the keys a rule has read."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self.sd = _normalise_keys(state_dict)
        self.used: set = set()

    def __call__(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def check_unused(self) -> None:
        """Every weight and bias must have been read; the graph
        definition's buffers (host-side in this design) are not
        parameters."""
        unused = [
            k for k in self.sd
            if k not in self.used
            and ("weight" in k or "bias" in k)
            and not k.startswith("_graph_definition")
        ]
        if unused:
            raise ValueError(
                f"unported parameter keys in state_dict: {unused}"
            )


def _port(state_dict: Mapping[str, Any],
          expected: Mapping[str, torch.Tensor],
          fill: Callable[[_Reader, Dict[str, Any]], None]
          ) -> Dict[str, torch.Tensor]:
    """Fill the JAX-layout tree of ``expected`` (a port model's
    ``state_dict()``) by ``fill(take, root)``, then check that every
    checkpoint weight was read and return the port's ``state_dict``."""
    take = _Reader(state_dict)
    tree = params_to_jax(expected)
    fill(take, tree["params"])
    take.check_unused()
    return params_from_jax(tree, expected)


def _fill(node: Dict[str, Any], key: str, value: np.ndarray) -> None:
    if key not in node:
        raise ValueError(f"the model has no leaf {key!r} at {sorted(node)}")
    expect = np.shape(node[key])
    if tuple(value.shape) != tuple(expect):
        raise ValueError(
            f"shape mismatch for {key}: torch {value.shape} vs model {expect}"
        )
    node[key] = np.asarray(value, np.float32)


def _norm(take: "_Reader", dst, p: str) -> None:
    """A torch layer norm's (or batch norm's) weight and bias at ``p``."""
    _fill(dst, "scale", take(f"{p}.weight"))
    _fill(dst, "bias", take(f"{p}.bias"))


def _linear(take: "_Reader", dst, p: str) -> None:
    """A torch ``Linear`` at ``p``: its weight transposed, its bias."""
    _fill(dst, "kernel", take(f"{p}.weight").T)
    _fill(dst, "bias", take(f"{p}.bias"))


def _indices(sd, pattern: str) -> List[int]:
    """The sorted distinct integers that ``pattern``'s group 1 matches
    among the keys."""
    return sorted({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def _port_tasks(take: _Reader, root) -> None:
    """GraphNeT's task heads (``_tasks.{t}._affine``) onto ``tasks_{t}``."""
    for t in _indices(take.sd, r"_tasks\.(\d+)\._affine\.weight$"):
        _fill(root[f"tasks_{t}"]["affine"], "kernel",
              take(f"_tasks.{t}._affine.weight").T)
        _fill(root[f"tasks_{t}"]["affine"], "bias",
              take(f"_tasks.{t}._affine.bias"))


def _sequential_positions(sd, prefix) -> Tuple[List[int], List[int]]:
    """(linear positions, norm positions) of a torch ``Sequential`` under
    ``prefix``: linears have 2-D weights, layer norms 1-D."""
    seq = {}
    for k in sd:
        m = re.match(rf"{re.escape(prefix)}\.(\d+)\.weight$", k)
        if m:
            seq[int(m.group(1))] = sd[k].ndim
    lin = sorted(p for p, nd in seq.items() if nd == 2)
    norm = sorted(p for p, nd in seq.items() if nd == 1)
    return lin, norm


def _port_mlp_head(take: _Reader, prefix: str, node) -> None:
    """Torch ``Sequential([Linear, (LayerNorm), act] * n)`` onto the
    port's :class:`MLP` (``dense_{j}`` / ``norm_{j}``)."""
    lin_ids, norm_ids = _sequential_positions(take.sd, prefix)
    for j, lid in enumerate(lin_ids):
        _fill(node[f"dense_{j}"], "kernel", take(f"{prefix}.{lid}.weight").T)
        _fill(node[f"dense_{j}"], "bias", take(f"{prefix}.{lid}.bias"))
        if norm_ids:
            nid = norm_ids[j]
            _fill(node[f"norm_{j}"], "scale", take(f"{prefix}.{nid}.weight"))
            _fill(node[f"norm_{j}"], "bias", take(f"{prefix}.{nid}.bias"))


def _port_first_linear(take: _Reader, key: str, conv, ways: int = 2) -> None:
    """The EdgeConv's first linear layer ``[h, ways * d]``, linearised:
    ``self_dense`` ``(W1 - W2)``, ``nbr_dense`` ``W2`` (TITO's three-way
    message ``cat[x_i, x_j - x_i, x_j]``: ``W2 + W3``)."""
    w = take(f"{key}.weight")
    d_in = w.shape[1] // ways
    w1, w2 = w[:, :d_in], w[:, d_in: 2 * d_in]
    nbr = w2 if ways == 2 else w2 + w[:, 2 * d_in:]
    _fill(conv["self_dense"], "kernel", (w1 - w2).T)
    _fill(conv["self_dense"], "bias", take(f"{key}.bias"))
    _fill(conv["nbr_dense"], "kernel", nbr.T)


def _port_dynedge_backbone(take: _Reader, bb_prefix: str, bb_node) -> None:
    """A GraphNeT DynEdge backbone (``_conv_layers.{i}.nn`` Sequentials,
    ``_post_processing``, ``_readout``; with or without norm layers)
    rooted at ``bb_prefix`` onto the port's DynEdge subtree: with norms
    the first layer norm is ``conv.norm_0`` and the later ones sit in the
    ``nn`` MLP; without, a two-layer conv owns ``out_kernel`` /
    ``out_bias``."""
    sd = take.sd
    conv_ids = _indices(sd, rf"{re.escape(bb_prefix)}\._conv_layers\.(\d+)\.")
    if not conv_ids:
        raise ValueError(
            f"no `{bb_prefix}._conv_layers.*` keys found: is this a DynEdge "
            f"state_dict? keys: {sorted(sd)[:5]}..."
        )
    for i in conv_ids:
        prefix = f"{bb_prefix}._conv_layers.{i}.nn"
        lin_ids, norm_ids = _sequential_positions(sd, prefix)
        if not lin_ids:
            raise ValueError(f"no linear layers under {prefix}")
        conv = bb_node[f"conv_{i}"]["conv"]
        _port_first_linear(take, f"{prefix}.{lin_ids[0]}", conv)
        if norm_ids:
            _fill(conv["norm_0"], "scale",
                  take(f"{prefix}.{norm_ids[0]}.weight"))
            _fill(conv["norm_0"], "bias", take(f"{prefix}.{norm_ids[0]}.bias"))
        for j, lid in enumerate(lin_ids[1:]):
            w = take(f"{prefix}.{lid}.weight")
            b = take(f"{prefix}.{lid}.bias")
            if "out_kernel" in conv and len(lin_ids) == 2 and not norm_ids:
                _fill(conv, "out_kernel", w.T)
                _fill(conv, "out_bias", b)
                continue
            _fill(conv["nn"][f"dense_{j}"], "kernel", w.T)
            _fill(conv["nn"][f"dense_{j}"], "bias", b)
            if norm_ids:
                nid = norm_ids[j + 1]
                _fill(conv["nn"][f"norm_{j}"], "scale",
                      take(f"{prefix}.{nid}.weight"))
                _fill(conv["nn"][f"norm_{j}"], "bias",
                      take(f"{prefix}.{nid}.bias"))

    for torch_name, name in (("_post_processing", "post_processing"),
                             ("_readout", "readout")):
        if name not in bb_node:
            # a skip_readout backbone has no readout, but GraphNeT builds
            # `_readout` all the same: its keys are read and dropped
            for k in list(sd):
                if k.startswith(f"{bb_prefix}.{torch_name}."):
                    take(k)
            continue
        _port_mlp_head(take, f"{bb_prefix}.{torch_name}", bb_node[name])


def port_dynedge_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT DynEdge ``StandardModel`` state_dict
    (``backbone._conv_layers.{i}.nn.{j}.*``, ``backbone._post_processing``,
    ``backbone._readout``, ``_tasks.{t}._affine.*``) as the ``state_dict``
    of the port model whose ``state_dict()`` is ``expected``."""

    def fill(take, root):
        _port_dynedge_backbone(take, "backbone", root["backbone"])
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def port_tito_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT DynEdgeTITO ``StandardModel`` state_dict onto the port
    model of ``expected``: each DynTrans block's three-way EdgeConv
    (linearised), its layer norm and its torch ``TransformerEncoderLayer``
    (the packed ``in_proj_weight`` is the combined ``qkv`` dense,
    transposed), then the post-processing and readout linears."""

    def fill(take, root):
        _fill_tito(take, "backbone", root["backbone"])
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def _fill_tito(take: _Reader, bb_prefix: str, bb_node) -> None:
    """A GraphNeT DynEdgeTITO rooted at ``bb_prefix`` onto the port's
    DynEdgeTITO subtree ``bb_node`` (:func:`port_tito_state_dict`)."""
    sd = take.sd
    conv_ids = _indices(sd, rf"{re.escape(bb_prefix)}\._conv_layers\.(\d+)\.")
    if not conv_ids:
        raise ValueError(f"no `{bb_prefix}._conv_layers.*` keys found")
    for i in conv_ids:
        p = f"{bb_prefix}._conv_layers.{i}"
        conv = bb_node[f"conv_{i}"]
        _port_first_linear(take, f"{p}.nn.0", conv["conv"], ways=3)
        _fill(conv["conv"], "out_kernel", take(f"{p}.nn.2.weight").T)
        _fill(conv["conv"], "out_bias", take(f"{p}.nn.2.bias"))
        _fill(conv["norm1"], "scale", take(f"{p}.norm1.weight"))
        _fill(conv["norm1"], "bias", take(f"{p}.norm1.bias"))
        t = f"{p}._transformer_encoder.layers.0"
        tr = conv["transformer"]
        for dst, src in ((tr["mha"]["qkv"], "self_attn.in_proj_"),
                         (tr["mha"]["out"], "self_attn.out_proj."),
                         (tr["linear1"], "linear1."),
                         (tr["linear2"], "linear2.")):
            _fill(dst, "kernel", take(f"{t}.{src}weight").T)
            _fill(dst, "bias", take(f"{t}.{src}bias"))
        for norm in ("norm1", "norm2"):
            _fill(tr[norm], "scale", take(f"{t}.{norm}.weight"))
            _fill(tr[norm], "bias", take(f"{t}.{norm}.bias"))

    for torch_name, name in (("_post_processing", "post_processing"),
                             ("_readout", "readout")):
        prefix = f"{bb_prefix}.{torch_name}"
        lin_ids, _ = _sequential_positions(sd, prefix)
        node = bb_node[name]
        for j, lid in enumerate(lin_ids):
            _fill(node[f"dense_{j}"], "kernel",
                  take(f"{prefix}.{lid}.weight").T)
            _fill(node[f"dense_{j}"], "bias", take(f"{prefix}.{lid}.bias"))


def _port_fourier_encoder(take: _Reader, fe, fp: str) -> None:
    """GraphNeT's FourierEncoder at ``fp`` (DeepIce's and ISeeCube's):
    the sinusoid scales where scaled, the aux table, the ``mlp``
    Sequential ``[Linear, LayerNorm, GELU, Linear]``."""
    sd = take.sd
    if f"{fp}.sin_emb.scale" in sd:  # scaled_emb checkpoints
        _fill(fe["sin_emb"], "scale", take(f"{fp}.sin_emb.scale"))
        _fill(fe["sin_emb2"], "scale", take(f"{fp}.sin_emb2.scale"))
    if f"{fp}.aux_emb.weight" in sd:  # n_features >= 6
        _fill(fe["aux_emb"], "embedding", take(f"{fp}.aux_emb.weight"))
    _linear(take, fe["mlp_0"], f"{fp}.mlp.0")
    _norm(take, fe["mlp_norm"], f"{fp}.mlp.1")
    _linear(take, fe["mlp_1"], f"{fp}.mlp.3")


def port_deepice_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT DeepIce (IceMix) ``StandardModel`` state_dict onto the
    port model of ``expected``: ``fourier_ext`` (sinusoid scales where
    scaled, the aux table, the Linear / LayerNorm / GELU / Linear MLP),
    ``rel_pos.projection``, the bias-free ``cls_token`` Linear's weight,
    ``sandwich.{i}`` rel blocks (separate q/k/v projections; the q and v
    biases zero where the checkpoint has none, GraphNeT's ``qkv_bias``
    default), ``blocks.{i}`` (packed ``in_proj_weight``, layer scales
    ``gamma_1``/``gamma_2``) and, with ``include_dynedge``, the nested
    ``dyn_edge`` DynEdge."""

    def fill(take, root):
        sd = take.sd
        bb = root["backbone"]

        def mlp(dst, p):
            _linear(take, dst["fc1"], f"{p}.input_projection")
            _linear(take, dst["fc2"], f"{p}.output_projection")

        _port_fourier_encoder(take, bb["fourier_ext"], "backbone.fourier_ext")

        _linear(take, bb["rel_pos"]["projection"],
                "backbone.rel_pos.projection")
        _fill(bb, "cls_token", take("backbone.cls_token.weight"))

        sandwich_ids = _indices(sd, r"backbone\.sandwich\.(\d+)\.")
        if not sandwich_ids:
            raise ValueError(
                "no `backbone.sandwich.*` keys: not a DeepIce state_dict?")
        for i in sandwich_ids:
            p = f"backbone.sandwich.{i}"
            blk = bb[f"sandwich_{i}"]
            _norm(take, blk["norm1"], f"{p}.norm1")
            _norm(take, blk["norm2"], f"{p}.norm2")
            attn = blk["attn"]
            D = sd[f"{p}.attn.proj_q.weight"].shape[0]
            for proj in ("proj_q", "proj_k", "proj_v"):
                _fill(attn[proj], "kernel", take(f"{p}.attn.{proj}.weight").T)
            for proj, key in (("proj_q", "q_bias"), ("proj_v", "v_bias")):
                bias = (take(f"{p}.attn.{key}") if f"{p}.attn.{key}" in sd
                        else np.zeros(D, np.float32))
                _fill(attn[proj], "bias", bias)
            _linear(take, attn["proj"], f"{p}.attn.proj")
            mlp(blk["mlp"], f"{p}.mlp")

        for i in _indices(sd, r"backbone\.blocks\.(\d+)\."):
            p = f"backbone.blocks.{i}"
            blk = bb[f"blocks_{i}"]
            _norm(take, blk["norm1"], f"{p}.norm1")
            _norm(take, blk["norm2"], f"{p}.norm2")
            # torch's packed in_proj rows [q; k; v]: the qkv dense
            _fill(blk["attn"]["qkv"], "kernel",
                  take(f"{p}.attn.in_proj_weight").T)
            _fill(blk["attn"]["qkv"], "bias", take(f"{p}.attn.in_proj_bias"))
            _linear(take, blk["attn"]["out"], f"{p}.attn.out_proj")
            mlp(blk["mlp"], f"{p}.mlp")
            _fill(blk, "gamma_1", take(f"{p}.gamma_1"))
            _fill(blk, "gamma_2", take(f"{p}.gamma_2"))

        if any(k.startswith("backbone.dyn_edge.") for k in sd):
            _port_dynedge_backbone(take, "backbone.dyn_edge", bb["dyn_edge"])
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def port_jinst_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT DynEdgeJINST ``StandardModel`` state_dict onto the port
    model of ``expected``: each ``conv_add{i}.nn`` two-linear MLP (the
    first linearised, the second the conv's ``out_kernel``), then the
    ``nn1``, ``nn2``, ``nn3`` linears."""

    def fill(take, root):
        bb = root["backbone"]
        for i in (1, 2, 3, 4):
            prefix = f"backbone.conv_add{i}.nn"
            lin_ids, _ = _sequential_positions(take.sd, prefix)
            if len(lin_ids) != 2:
                raise ValueError(f"expected 2 linears under {prefix}, got "
                                 f"{len(lin_ids)}")
            conv = bb[f"conv_add{i}"]["conv"]
            _port_first_linear(take, f"{prefix}.{lin_ids[0]}", conv)
            _fill(conv, "out_kernel", take(f"{prefix}.{lin_ids[1]}.weight").T)
            _fill(conv, "out_bias", take(f"{prefix}.{lin_ids[1]}.bias"))
        for name in ("nn1", "nn2", "nn3"):
            _linear(take, bb[name], f"backbone.{name}")
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def _running_stats_unused(kind: str) -> None:
    warnings.warn(
        "state_dict carries BatchNorm running statistics but the model has "
        "no frozen statistics: its predictions will NOT reproduce torch's "
        f"eval mode.  Build the model with {kind}(frozen_batchnorm=True).",
        stacklevel=3,
    )


def port_convnet_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT ConvNet ``StandardModel`` state_dict onto the port model
    of ``expected``: three PyG ``TAGConv`` s (``lins.{h}`` per hop; every
    bias, per hop or the module's one, summed into ``lin_0``'s, as
    ``sum_h (W_h x_h + b_h) = sum_h W_h x_h + sum_h b_h``),
    ``batchnorm1`` (its running statistics into ``bn_mean`` / ``bn_var``
    where the model has them: ``frozen_batchnorm``), ``linear1`` ..
    ``linear5`` and ``out``."""

    def fill(take, root):
        sd, bb = take.sd, root["backbone"]
        for i in (1, 2, 3):
            prefix = f"backbone.conv{i}"
            hops = _indices(sd, rf"{re.escape(prefix)}\.lins\.(\d+)\.weight$")
            if not hops:
                raise ValueError(f"no TAGConv `lins` under {prefix}")
            conv = bb[f"conv{i}"]
            total_bias = np.zeros(np.shape(conv["lin_0"]["bias"]), np.float32)
            for h in hops:
                _fill(conv[f"lin_{h}"], "kernel",
                      take(f"{prefix}.lins.{h}.weight").T)
                if f"{prefix}.lins.{h}.bias" in sd:
                    total_bias = total_bias + take(f"{prefix}.lins.{h}.bias")
            if f"{prefix}.bias" in sd:  # PyG's single-bias layout
                total_bias = total_bias + take(f"{prefix}.bias")
            _fill(conv["lin_0"], "bias", total_bias)
        _fill(bb, "bn_scale", take("backbone.batchnorm1.weight"))
        _fill(bb, "bn_bias", take("backbone.batchnorm1.bias"))
        if "bn_mean" in bb:
            _fill(bb, "bn_mean", take("backbone.batchnorm1.running_mean"))
            _fill(bb, "bn_var", take("backbone.batchnorm1.running_var"))
        elif "backbone.batchnorm1.running_mean" in sd:
            _running_stats_unused("ConvNet")
        for name in ("linear1", "linear2", "linear3", "linear4", "linear5",
                     "out"):
            _linear(take, bb[name], f"backbone.{name}")
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def port_particlenet_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT ParticleNeT ``StandardModel`` state_dict onto the port
    model of ``expected``: each ``_conv_layers.{i}.nn`` Sequential
    ``[Linear, BatchNorm1d, act] * n`` (the first linear linearised; the
    running statistics into the frozen ``mean`` / ``var`` where the
    model has them), then the ``_readout`` linears."""

    def fill(take, root):
        sd, bb = take.sd, root["backbone"]
        conv_ids = _indices(sd, r"backbone\._conv_layers\.(\d+)\.")
        if not conv_ids:
            raise ValueError("no `backbone._conv_layers.*` keys found")
        warned = False
        for i in conv_ids:
            prefix = f"backbone._conv_layers.{i}.nn"
            lin_ids, bn_ids = _sequential_positions(sd, prefix)
            if not lin_ids:
                raise ValueError(f"no linear layers under {prefix}")
            conv = bb[f"conv_{i}"]
            _port_first_linear(take, f"{prefix}.{lin_ids[0]}", conv)
            for j, lid in enumerate(lin_ids[1:], start=1):
                _linear(take, conv[f"dense_{j}"], f"{prefix}.{lid}")
            for j, nid in enumerate(bn_ids):
                bn = conv[f"bn_{j}"]
                _norm(take, bn, f"{prefix}.{nid}")
                if "mean" in bn:
                    _fill(bn, "mean", take(f"{prefix}.{nid}.running_mean"))
                    _fill(bn, "var", take(f"{prefix}.{nid}.running_var"))
                elif f"{prefix}.{nid}.running_mean" in sd and not warned:
                    _running_stats_unused("ParticleNeT")
                    warned = True
        readout_ids, _ = _sequential_positions(sd, "backbone._readout")
        for j, lid in enumerate(readout_ids):
            _linear(take, bb[f"readout_{j}"], f"backbone._readout.{lid}")
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def port_iseecube_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT ISeeCube ``StandardModel`` state_dict (torchscale's
    Magneto encoder) onto the port model of ``expected``:
    ``fourier_ext`` as DeepIce's, the ``pos_embedding``, ``class_token``
    and ``register_tokens``, the shared bucket table
    ``encoder.relative_position.relative_attention_bias``, each
    ``encoder.layers.{i}`` (separate q, k, v projections, the sub-norms
    ``inner_attn_ln`` and ``ffn.ffn_layernorm``), torchscale's final
    ``encoder.layer_norm`` and ISeeCube's ``layer_norm``."""

    def fill(take, root):
        sd, bb = take.sd, root["backbone"]

        _port_fourier_encoder(take, bb["fourier_ext"], "backbone.fourier_ext")
        for name in ("pos_embedding", "class_token", "register_tokens"):
            _fill(bb, name, take(f"backbone.{name}"))
        _fill(bb["rel_pos_bias"], "rel_embedding", take(
            "backbone.encoder.relative_position.relative_attention_bias."
            "weight"))
        layer_ids = _indices(sd, r"backbone\.encoder\.layers\.(\d+)\.")
        if not layer_ids:
            raise ValueError(
                "no `backbone.encoder.layers.*` keys: not an ISeeCube "
                "state_dict?")
        for i in layer_ids:
            p = f"backbone.encoder.layers.{i}"
            attn = bb[f"attn_{i}"]
            for proj in ("q", "k", "v"):
                _linear(take, attn[f"proj_{proj}"],
                        f"{p}.self_attn.{proj}_proj")
            _norm(take, attn["inner_attn_ln"],
                  f"{p}.self_attn.inner_attn_ln")
            _linear(take, attn["out"], f"{p}.self_attn.out_proj")
            _norm(take, bb[f"norm1_{i}"], f"{p}.self_attn_layer_norm")
            _norm(take, bb[f"norm2_{i}"], f"{p}.final_layer_norm")
            _linear(take, bb[f"fc1_{i}"], f"{p}.ffn.fc1")
            _norm(take, bb[f"ffn_ln_{i}"], f"{p}.ffn.ffn_layernorm")
            _linear(take, bb[f"fc2_{i}"], f"{p}.ffn.fc2")
        _norm(take, bb["encoder_layer_norm"], "backbone.encoder.layer_norm")
        _norm(take, bb["layer_norm"], "backbone.layer_norm")
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


def _port_torch_gru(take: _Reader, prefix: str, rnn_node,
                    num_layers: int) -> None:
    """A torch ``nn.GRU`` (``weight_ih_l{l} [3H, in]``, gate rows r, z,
    n) onto the port's flax-layout GRU cells
    (``gru_{l}/cell/gru/{ir,iz,in,hr,hz,hn}``).  torch has two biases a
    gate where flax has one on the input projection of r and z: their
    sum goes there; the candidate keeps ``b_in`` and ``b_hn``, both
    inside the same formula ``n = tanh(W_in x + b_in + r (W_hn h +
    b_hn))``."""
    for layer in range(num_layers):
        w_ih = take(f"{prefix}.weight_ih_l{layer}")
        w_hh = take(f"{prefix}.weight_hh_l{layer}")
        b_ih = take(f"{prefix}.bias_ih_l{layer}")
        b_hh = take(f"{prefix}.bias_hh_l{layer}")
        H = w_hh.shape[1]
        gru = rnn_node[f"gru_{layer}"]["cell"]["gru"]
        for gi, gate in enumerate("rzn"):
            rows = slice(gi * H, (gi + 1) * H)
            _fill(gru[f"i{gate}"], "kernel", w_ih[rows].T)
            _fill(gru[f"h{gate}"], "kernel", w_hh[rows].T)
            if gate == "n":
                _fill(gru["in"], "bias", b_ih[rows])
                _fill(gru["hn"], "bias", b_hh[rows])
            else:
                _fill(gru[f"i{gate}"], "bias", b_ih[rows] + b_hh[rows])


def port_rnn_tito_state_dict(
    state_dict: Mapping[str, Any],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A GraphNeT RNN_TITO ``StandardModel`` state_dict onto the port
    model of ``expected``: the Node_RNN's torch GRU
    (``_rnn._rnn``, :func:`_port_torch_gru`), then the DynEdgeTITO under
    ``_dynedge_tito`` by :func:`port_tito_state_dict`'s rules."""

    def fill(take, root):
        sd, bb = take.sd, root["backbone"]
        num_layers = len(_indices(
            sd, r"backbone\._rnn\._rnn\.weight_ih_l(\d+)$"))
        if not num_layers:
            raise ValueError("no `backbone._rnn._rnn.weight_ih_l*` keys found")
        _port_torch_gru(take, "backbone._rnn._rnn", bb["rnn"], num_layers)
        _fill_tito(take, "backbone._dynedge_tito", bb["dynedge_tito"])
        _port_tasks(take, root)

    return _port(state_dict, expected, fill)


_PORTERS = {
    "DynEdge": port_dynedge_state_dict,
    "DynEdgeTITO": port_tito_state_dict,
    "DeepIce": port_deepice_state_dict,
    "DynEdgeJINST": port_jinst_state_dict,
    "ConvNet": port_convnet_state_dict,
    "ParticleNeT": port_particlenet_state_dict,
    "ISeeCube": port_iseecube_state_dict,
    "RNNTITO": port_rnn_tito_state_dict,
}


def port_state_dict(model: torch.nn.Module,
                    state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The porter of ``model``'s backbone applied to a GraphNeT
    ``state_dict``: the port's ``state_dict`` for ``model``."""
    name = type(model.backbone).__name__
    if name not in _PORTERS:
        raise ValueError(f"no GraphNeT porter for a {name} backbone")
    return _PORTERS[name](state_dict, model.state_dict())


# the frozen batch-norm statistics of ported ConvNet (bn_mean, bn_var)
# and ParticleNeT (MaskedBatchNorm's mean, var) models
FROZEN_STATISTICS = ("bn_mean", "bn_var", "mean", "var")


def frozen_stat_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """The weight-decay mask (True = decay) of every entry of ``model``'s
    ``state_dict``, False for the frozen batch-norm statistics: the JAX
    package's ``frozen_stat_decay_mask`` of the same model's parameter
    tree, by the port's names.

    The port keeps those statistics as buffers, which no optimizer
    steps, so a plain ``torch.optim.AdamW(model.parameters())`` already
    leaves them as they are.  The mask is for a caller that builds
    parameter groups by name (decay where True)."""
    return {name: name.rsplit(".", 1)[-1] not in FROZEN_STATISTICS
            for name in model.state_dict()}


# ------------------------------------------- GraphNeT config translation
# the transforms GraphNeT's zoo configs and examples write as lambdas,
# matched as strings (never evaluated), by registered transform name
_LAMBDA_TABLE = {
    "x: torch.log10(x)": "log10",
    "x: torch.pow(10,x)": "pow10",
    "x: torch.pow(10, x)": "pow10",
    "x: torch.log(x)": "log",
    "x: torch.exp(x)": "exp",
    "x: x": "identity",
    "x: torch.log10(x)/2.": "log10_half",
    "x: 10**(2*x)": "pow10_double",
    "x: torch.nn.functional.softmax(x, dim=-1)": "softmax",
    "x: torch.nn.functional.softmax(x,dim=-1)": "softmax",
}

# GraphNeT arguments with no meaning here: training glue (the Trainer's
# concern), torch dtypes, and task widths (given by the backbone)
_DROP_ARGS = {
    "optimizer_class",
    "optimizer_kwargs",
    "scheduler_class",
    "scheduler_config",
    "scheduler_kwargs",
    "dtype",
    "hidden_size",
}


def _resolve_lambda(s: str) -> Callable:
    from graphnet_tpu_torch.utils.config import TRANSFORM_REGISTRY

    body = s[len("!lambda"):].strip()
    if body not in _LAMBDA_TABLE:
        raise ValueError(
            f"Unknown reference lambda {s!r}; add it to "
            "weight_port._LAMBDA_TABLE with a registered transform."
        )
    return TRANSFORM_REGISTRY[_LAMBDA_TABLE[body]]


def _translate(value: Any) -> Any:
    if isinstance(value, dict) and "ModelConfig" in value:
        return _build_component(value["ModelConfig"])
    if isinstance(value, dict) and {"class_name", "arguments"} <= set(value):
        return _build_component(value)
    if isinstance(value, dict):
        return {k: _translate(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_translate(v) for v in value]
    if isinstance(value, str) and value.startswith("!lambda"):
        return _resolve_lambda(value)
    if isinstance(value, str) and value.startswith("!class"):
        return None  # torch classes (optimisers) have no counterpart
    return value


def _build_component(cfg: Dict[str, Any], **extra: Any) -> Any:
    """One of the port's classes from a GraphNeT ModelConfig dict;
    ``extra`` are further constructor arguments (a task's
    ``hidden_size``, ``node_level``), passed where the class takes
    them."""
    from graphnet_tpu_torch.utils.config import _lookup

    name = cfg["class_name"]
    cls = _lookup(name)
    args = {k: _translate(v) for k, v in (cfg.get("arguments") or {}).items()
            if k not in _DROP_ARGS}
    known = set(inspect.signature(cls.__init__).parameters)
    # GraphNeT's KNNGraph keeps k and the columns in its captured
    # `edge_definition`: fold them into the KNNGraph's arguments
    if name == "KNNGraph" and "edge_definition" in args:
        ed = args.pop("edge_definition")
        if type(ed).__name__ == "KNNEdges":
            args.setdefault("nb_nearest_neighbours", ed.nb_nearest_neighbours)
            args.setdefault("columns", tuple(ed.columns))
        elif ed is not None:
            warnings.warn(
                f"KNNGraph: non-KNN edge_definition {type(ed).__name__} "
                "dropped in translation"
            )
    # ConvNet's output width is its field `nb_outputs_` (as in the JAX
    # package, where `nb_outputs` is a property)
    if "nb_outputs" in args and "nb_outputs" not in known and (
            "nb_outputs_" in known):
        args["nb_outputs_"] = args.pop("nb_outputs")
    dropped = {k for k in args if k not in known}
    # None means "the default" (the defaults are GraphNeT's), except for
    # global_pooling_schemes, where GraphNeT's default is None itself
    # (no pooling: node-level latents) and the port's the four schemes
    keep_none = {"global_pooling_schemes"}
    args = {k: v for k, v in args.items()
            if k in known and (v is not None or k in keep_none)}
    if isinstance(args.get("target_labels"), str):
        args["target_labels"] = (args["target_labels"],)
    if isinstance(args.get("global_pooling_schemes"), str):
        args["global_pooling_schemes"] = (args["global_pooling_schemes"],)
    # a hand-written DynEdge config may omit global_pooling_schemes:
    # GraphNeT's default applies
    if name == "DynEdge" and "global_pooling_schemes" not in args:
        args["global_pooling_schemes"] = None
    args.update({k: v for k, v in extra.items() if k in known})
    obj = cls(**args)
    if dropped:
        warnings.warn(f"{name}: dropped reference-only arguments "
                      f"{sorted(dropped)}")
    return obj


def _config_of(value: Any) -> Dict[str, Any]:
    return value["ModelConfig"] if "ModelConfig" in value else value


def from_reference_config(
    path: str, device="cuda", seed: int = 0
) -> Tuple[Any, Optional[Any]]:
    """``(model, graph_definition)`` of a GraphNeT ModelConfig YAML (a
    zoo ``*_config.yml``): a port :class:`StandardModel` on ``device``
    (the GPU unless the caller asks for the CPU), its parameters from
    ``seed``, and the graph definition GraphNeT folds into the model
    (None if the file has none; graphs are built on the host here).  A
    backbone without pooling or readout gives node-level latents, so its
    tasks are built node-level."""
    import yaml

    from graphnet_tpu_torch.models.standard_model import StandardModel

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if cfg.get("class_name") != "StandardModel":
        raise ValueError(
            f"expected a StandardModel config, got {cfg.get('class_name')!r}"
        )
    arguments = dict(cfg["arguments"])
    gd_cfg = arguments.pop("graph_definition", None)
    graph_definition = _translate(gd_cfg) if gd_cfg is not None else None
    backbone = _translate(arguments.pop("backbone"))
    node_level = not getattr(backbone, "global_pooling_schemes", True) or (
        getattr(backbone, "skip_readout", False))
    extra = {"hidden_size": backbone.nb_outputs}
    if node_level:
        extra["node_level"] = True
    tasks = [_build_component(_config_of(t), **extra)
             for t in arguments.pop("tasks")]
    model = StandardModel(backbone=backbone, tasks=tasks, seed=seed,
                          device=device)
    return model, graph_definition


def from_reference_dataset_config(path: str) -> Any:
    """Dataset(s) of a GraphNeT DatasetConfig YAML (the flat format:
    ``path``, ``pulsemaps``, ``features``, ``truth``, ``selection``, a
    nested ``graph_definition``): a plain selection gives one dataset, a
    ``{name: selection}`` dict ``{name: dataset}``, and a list of
    selection strings an :class:`EnsembleDataset`.  ``$GRAPHNET`` in a
    path is the repository root.  The backend follows the path: SQLite
    for ``.db`` / ``.sqlite`` / ``.sqlite3``, Parquet otherwise."""
    import yaml

    from graphnet_tpu_torch.data.dataset import EnsembleDataset
    from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
    from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset

    with open(path) as f:
        cfg = dict(yaml.safe_load(f))
    gd_cfg = cfg.pop("graph_definition", None)
    graph_definition = _translate(gd_cfg) if gd_cfg is not None else None
    data_path = cfg.pop("path")
    selection = cfg.pop("selection", None)
    first = data_path[0] if isinstance(data_path, list) else data_path
    cls = (SQLiteDataset
           if str(first).endswith((".db", ".sqlite", ".sqlite3"))
           else ParquetDataset)

    allowed = {
        "pulsemaps", "features", "truth", "node_truth", "index_column",
        "truth_table", "node_truth_table", "string_selection",
        "loss_weight_table", "loss_weight_column",
        "loss_weight_default_value", "seed",
    }
    kwargs = {k: v for k, v in cfg.items() if k in allowed and v is not None}
    ignored = sorted(k for k in cfg if k not in allowed and cfg[k] is not None)
    if ignored:
        warnings.warn(f"reference dataset config: ignored arguments {ignored}")

    def one(sel):
        return cls(path=data_path, graph_definition=graph_definition,
                   selection=sel, **kwargs)

    def one_or_ensemble(sel):
        # only a list of selection strings is an ensemble (a list of
        # event ids, or of id lists, is one dataset's selection)
        if isinstance(sel, list) and sel and isinstance(sel[0], str):
            return EnsembleDataset([one(s) for s in sel])
        return one(sel)

    if isinstance(selection, dict):
        return {name: one_or_ensemble(sel) for name, sel in selection.items()}
    return one_or_ensemble(selection)


def load_reference_state_dict(path: str) -> Dict[str, Any]:
    """A GraphNeT checkpoint: a ``.pth``/``.pt`` torch state_dict (read
    with ``weights_only``) or a pickled dict of arrays (unpickling runs
    code: load only files of known origin)."""
    if path.endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return pickle.load(f)


def _with_frozen_batchnorm(model, device, seed: int):
    """``model`` built again from its config with
    ``frozen_batchnorm=True`` on its backbone."""
    from graphnet_tpu_torch.utils.config import (
        ModelConfig,
        build,
        capture_config,
    )

    cfg = capture_config(model).as_dict()
    cfg["arguments"]["backbone"]["__model__"]["arguments"][
        "frozen_batchnorm"] = True
    return build(ModelConfig.from_dict(cfg), seed=seed, device=device)


def port_reference_model(
    config_path: str,
    state_dict_path: str,
    device="cuda",
    seed: int = 0,
) -> Tuple[Any, Optional[Any], Dict[str, torch.Tensor]]:
    """GraphNeT config YAML + checkpoint -> ``(model, graph_definition,
    state_dict)``: the model built on ``device`` (the GPU unless the
    caller asks for the CPU) with the ported weights loaded, its graph
    definition, and the ported ``state_dict`` (what
    :func:`~graphnet_tpu_torch.utils.config.save_model` or
    ``DeploymentModule`` take).  A ConvNet or ParticleNeT with batch norm
    is built with ``frozen_batchnorm``: a trained checkpoint carries
    running statistics, and GraphNeT serves with them (torch's eval
    mode), as the JAX package's ``port_reference_model`` does."""
    model, graph_definition = from_reference_config(config_path, device, seed)
    if type(model.backbone).__name__ in ("ConvNet", "ParticleNeT") and (
            getattr(model.backbone, "add_batchnorm_layer", True)):
        model = _with_frozen_batchnorm(model, device, seed)
    state_dict = port_state_dict(
        model, load_reference_state_dict(state_dict_path))
    model.load_state_dict(state_dict)
    return model, graph_definition, state_dict
