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
  layout: ``out_kernel`` is the EdgeConv kernel's ``W2`` as it is.

Unpickling needs no JAX: the pickle holds numpy arrays only.
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
}


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
            over.

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
        rule = _LEAF_NAMES.get(path[-1])
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


def load_jax_state_dict(
    path: str, expected: Optional[Mapping[str, torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """:func:`params_from_jax` of a pickled JAX parameter tree (a file
    this project's JAX trainer wrote: unpickling runs code, so load only
    files of known origin)."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return params_from_jax(tree, expected)
