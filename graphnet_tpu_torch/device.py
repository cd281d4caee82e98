"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  A CUDA
request on a machine without a GPU raises: the port never falls back to
the CPU quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, checked to exist.

    On the GPU path this also turns TF32 off for matrix products and
    convolutions: the JAX reference computes in full fp32, and TF32 keeps
    only about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but no CUDA device "
                "is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
