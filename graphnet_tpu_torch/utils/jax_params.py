"""Carry the JAX package's parameters over to the port.

The JAX package's parameter tree (the output of ``model.init``, or the
unpickled ``state_dict.pkl`` that its ``Trainer.save_state_dict`` writes)
is a nest of dicts of numpy arrays.  The port's modules carry the flax
module names, so the map is mechanical:

* ``.../<dense>/kernel [in, out]`` -> ``<dense>.weight [out, in]``
  (transposed, ``nn.Linear``'s layout);
* ``.../<dense>/bias`` -> ``<dense>.bias``;
* ``.../<norm>/scale`` -> ``<norm>.weight`` (``nn.LayerNorm``);
* ``.../out_kernel [H1, H2]`` and ``out_bias`` keep their names and
  layout: ``out_kernel`` is the EdgeConv kernel's ``W2`` as it is;
* DeepIce's ``cls_token [1, D]``, layer scales ``gamma_1``/``gamma_2``
  ``[D]`` and the ``embedding [n, d]`` of a flax ``Embed`` keep their
  names and layout too (the port has parameters of those names, so no
  table is transposed), and so do ISeeCube's ``pos_embedding``,
  ``class_token``, ``register_tokens`` and ``rel_embedding``, ConvNet's
  batch norm (``bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``) and
  the frozen statistics ``mean``/``var`` of ParticleNeT's
  ``MaskedBatchNorm``;
* a ``scale`` for which the port model has a parameter ``<path>.scale``
  (a ``SinusoidalPosEmb``'s learned scale, a ``MaskedBatchNorm``'s)
  keeps its name; every other ``scale`` is a layer norm's.  The port's layer norms name theirs
  ``weight``, so a port parameter named ``scale`` is never a norm's.

A density model's conditioner (``NormalizingFlow`` and
``SphericalFlow``: ``cond_norm``, ``cond_0``, ``cond_1``) carries over by
the same rules.

Unpickling needs no JAX: the pickle holds numpy arrays only.
:func:`params_to_jax` is the inverse map, for writing the same pickle.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_LEAF_NAMES = {
    "kernel": ("weight", True),
    "bias": ("bias", False),
    "scale": ("weight", False),
    "out_kernel": ("out_kernel", False),
    "out_bias": ("out_bias", False),
    "cls_token": ("cls_token", False),
    "gamma_1": ("gamma_1", False),
    "gamma_2": ("gamma_2", False),
    "embedding": ("embedding", False),
    "pos_embedding": ("pos_embedding", False),
    "class_token": ("class_token", False),
    "register_tokens": ("register_tokens", False),
    "rel_embedding": ("rel_embedding", False),
    "bn_scale": ("bn_scale", False),
    "bn_bias": ("bn_bias", False),
    "bn_mean": ("bn_mean", False),
    "bn_var": ("bn_var", False),
    "mean": ("mean", False),
    "var": ("var", False),
}
# port parameter names that are JAX leaf names as they are (``scale``:
# a SinusoidalPosEmb's, as the port's layer norms name theirs ``weight``)
_KEPT = {name for name, (port, _) in _LEAF_NAMES.items() if name == port}
_KEPT.add("scale")


def _leaf_rule(path: Tuple[str, ...], expected: Optional[Mapping]):
    """``(port name, transpose)`` of a JAX leaf, None if unknown."""
    if path[-1] == "scale" and expected is not None and ".".join(path) in expected:
        return "scale", False
    return _LEAF_NAMES.get(path[-1])


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[
    Tuple[Tuple[str, ...], Any]
]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def params_from_jax(
    params: Mapping,
    expected: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter tree.

    Args:
        params: the JAX tree, with or without its top-level ``"params"``
            collection.
        expected: the port model's ``state_dict()``; when given, every
            key must be carried with its shape, and no leaf may be left
            over.  A ``scale`` leaf keeps its name only where ``expected``
            has a parameter of that name; without ``expected`` every
            ``scale`` is a layer norm's ``weight``.

    Raises:
        ValueError: on a leaf of unknown kind, a leaf with no
            counterpart in ``expected`` (unused), a key of ``expected``
            that no leaf fills (missing), or a shape mismatch.
    """
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    unknown = []
    for path, value in _leaves(params):
        rule = _leaf_rule(path, expected)
        if rule is None:
            unknown.append("/".join(path))
            continue
        name, transpose = rule
        arr = np.asarray(value, dtype=np.float32)
        if transpose:
            arr = arr.T
        out[".".join(path[:-1] + (name,))] = torch.tensor(arr)  # a copy
    if unknown:
        raise ValueError(f"JAX parameter leaves of unknown kind: {unknown}")
    if expected is not None:
        unused = sorted(set(out) - set(expected))
        missing = sorted(set(expected) - set(out))
        if unused or missing:
            raise ValueError(
                f"JAX parameters do not fit the model: unused leaves "
                f"{unused}, missing parameters {missing}"
            )
        wrong = [
            f"{k}: {tuple(out[k].shape)} vs {tuple(expected[k].shape)}"
            for k in out
            if out[k].shape != expected[k].shape
        ]
        if wrong:
            raise ValueError(f"JAX parameter shapes do not fit: {wrong}")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX parameter tree (``{"params": {...}}`` of float32 numpy
    arrays) for the port's ``state_dict``: the inverse of
    :func:`params_from_jax`.  A 2-D ``weight`` is an ``nn.Linear``'s
    (``kernel``, transposed back), a 1-D one a layer norm's (``scale``);
    the kept names (``out_kernel``, ``cls_token``, ``gamma_*``,
    ``embedding``, a ``SinusoidalPosEmb``'s or ``MaskedBatchNorm``'s
    ``scale`` and the other names above) stay as they are.
    """
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            if arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif arr.ndim == 1:
                name = "scale"
            else:
                raise ValueError(f"{key}: a weight of {arr.ndim} dims")
        elif name not in _KEPT:
            raise ValueError(f"{key}: a parameter of unknown kind")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": tree}


def load_jax_state_dict(
    path: str, expected: Optional[Mapping[str, torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """:func:`params_from_jax` of a pickled JAX parameter tree (a file
    this project's JAX trainer wrote: unpickling runs code, so load only
    files of known origin)."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return params_from_jax(tree, expected)
