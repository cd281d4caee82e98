"""Model weights made on the card from ``--seed``.

One draw of standard normals for every parameter together, from a
``torch.Generator`` on the device, then each leaf shifted and scaled by
its family's ``init_std(name, shape)`` (``reference/<family>.py``).  The
program and the reference get the same values: the benchmark makes them
twice from the seed, once for each side."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

Init = Callable[[str, Tuple[int, ...]], Tuple[float, float]]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, init_std: Init) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` in the order of ``shapes``."""
    total = sum(_numel(s) for _, s in shapes)
    z = torch.randn(total, generator=generator(seed, device), device=device,
                    dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = _numel(shape)
        mean, std = init_std(name, tuple(shape))
        out[name] = z[at:at + n].view(shape).mul_(std).add_(mean)
        at += n
    return out


def fill_model(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
               ) -> None:
    """Copy ``weights`` into the model's parameters, every one of them."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            f"weights and parameters differ: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
