"""The benchmark measures the port alone: nothing it runs may load JAX or
the JAX package.  Module names are compared by their whole top-level
name, the part before the first dot, so ``graphnet_tpu_torch`` (the port)
passes and ``graphnet_tpu`` (the JAX package) does not."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "graphnet_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
