"""Guards of optional dependencies (counterpart of
``graphnet_tpu/utils/imports.py``).  The JAX package's
``has_jax_package`` is left out: it imports ``jax``, which this package
never does."""

from __future__ import annotations

from functools import wraps
from typing import Any, Callable


def has_icecube_package() -> bool:
    """Whether the IceCube software stack (IceTray) imports."""
    try:
        import icecube  # noqa: F401

        return True
    except ImportError:
        return False


def has_torch_package() -> bool:
    """Whether ``torch`` imports."""
    try:
        import torch  # noqa: F401

        return True
    except ImportError:
        return False


def requires_icecube(fn: Callable) -> Callable:
    """Decorator: ``fn`` raises ``ImportError`` when IceTray is not
    installed."""

    @wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        if not has_icecube_package():
            raise ImportError(
                f"{fn.__name__} requires the IceCube software stack "
                "(icetray), which is not installed."
            )
        return fn(*args, **kwargs)

    return wrapper
