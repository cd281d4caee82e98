"""Dropout and stochastic depth on an explicit generator (the port's
counterpart of flax's ``nn.Dropout`` and the JAX package's ``DropPath``
with ``deterministic=False`` and a ``"dropout"`` rng).

A stochastic layer draws its keep masks through :func:`keep_mask`, the
one mask function of the port, from the generator that
:func:`use_generator` installs (the Trainer installs its own for each
step).  Nothing here reads torch's global generators: a layer that is
on and finds no generator raises.  A layer is on when its rate is above
0, its ``deterministic`` is ``False`` and its module is in training
mode, so ``eval()`` is the counterpart of the JAX package's
``deterministic_clone``.

Because every mask comes through :func:`keep_mask`, a caller can record
the masks of one run and feed them to another (another device, the JAX
package) by replacing this module's ``keep_mask`` from outside.

Across processes (:func:`global_rows`, which the Trainer installs under
a mesh) a mask over the batch is this process's rows of the mask the
whole global batch would draw, as the JAX package's fold-in over the
global batch draws it; every process seeds the same generator, so a
mask over replicated tensors is the same on each.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

# the generator of the current thread's (or task's) block, in a
# one-element list so a function given for it is called once; none outside
_GENERATOR: contextvars.ContextVar[Optional[list]] = (
    contextvars.ContextVar("stochastic_generator", default=None))
# (first row, local rows, global rows) of this process's batch
_ROWS: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "stochastic_rows", default=None)


@contextlib.contextmanager
def global_rows(first: int, local: int, total: int) -> Iterator[None]:
    """Inside the block, a mask whose leading dimension is the local
    batch (``local`` events) is drawn for the whole global batch of
    ``total`` events and cut to rows ``first .. first + local - 1``."""
    token = _ROWS.set((first, local, total))
    try:
        yield
    finally:
        _ROWS.reset(token)


@contextlib.contextmanager
def use_generator(
    generator: Union[torch.Generator, Callable[[], torch.Generator]],
) -> Iterator[None]:
    """Stochastic layers draw from ``generator`` inside the block (in
    this thread).  ``generator`` may be a function returning one: it is
    called at the block's first draw only, so a block in which no layer
    is on never builds or seeds a generator."""
    token = _GENERATOR.set([generator])
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def step_seed(seed: int, step: int) -> int:
    """A 63-bit seed of the pair ``(seed, step)``: the counterpart of
    ``jax.random.fold_in(PRNGKey(seed), step)``, so a step draws the same
    masks whatever ran before it."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


def keep_mask(
    shape: Sequence[int], keep_prob: float, device: torch.device
) -> torch.Tensor:
    """Bernoulli(``keep_prob``) keep mask of ``shape`` (bool, on
    ``device``), drawn from the installed generator."""
    slot = _GENERATOR.get()
    if slot is None:
        raise RuntimeError(
            "a stochastic layer is on (rate > 0, deterministic=False, "
            "training mode) but no generator is installed: train through "
            "Trainer, wrap the call in stochastic.use_generator(g), or "
            "call model.eval()"
        )
    if not isinstance(slot[0], torch.Generator):
        slot[0] = slot[0]()
    from graphnet_tpu_torch.parallel.graph_sharding import current_graph_axis

    if current_graph_axis() is not None:
        raise NotImplementedError("stochastic layers under node sharding")
    shape, rows = tuple(shape), _ROWS.get()
    if rows is not None and shape and shape[0] == rows[1] != rows[2]:
        first, local, total = rows
        u = torch.rand((total,) + shape[1:], generator=slot[0], device=device)
        return u[first:first + local] < keep_prob
    u = torch.rand(shape, generator=slot[0], device=device)
    return u < keep_prob


def apply_keep(
    x: torch.Tensor,
    keep: float,
    draw: Optional[Callable[[], torch.Tensor]] = None,
) -> torch.Tensor:
    """``where(mask, x / keep, 0)``, the mask from ``draw()`` (a mask
    broadcasting against ``x``) or, without ``draw``, a
    :func:`keep_mask` shaped like ``x``.  At ``keep`` 0 it is zeros and
    draws nothing, as flax's ``Dropout`` at rate 1."""
    if keep == 0.0:
        return torch.zeros_like(x)
    mask = keep_mask(x.shape, keep, x.device) if draw is None else draw()
    return torch.where(mask, x / keep, 0.0)


def dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's ``Dropout`` when it is on: ``where(mask, x / keep, 0)``."""
    return apply_keep(x, 1.0 - rate)


class Dropout(nn.Module):
    """Dropout of ``rate``, on only with ``deterministic=False`` in
    training mode; the identity otherwise (also at ``rate`` 0)."""

    def __init__(self, rate: float = 0.0, deterministic: bool = True):
        super().__init__()
        self.rate = float(rate)
        self.deterministic = deterministic

    @property
    def active(self) -> bool:
        return self.rate > 0.0 and not self.deterministic and self.training

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate) if self.active else x

    def extra_repr(self) -> str:
        return f"rate={self.rate}, deterministic={self.deterministic}"
