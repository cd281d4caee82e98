"""The operator namespace of the port's hand-written kernels.

Every kernel is a ``torch.library`` operator,
``torch.ops.graphnet_tpu_torch.<name>``, which the module that holds the
kernel registers beside it (:func:`define`) with three implementations:

* CUDA: the kernel's launch (its wrapper's checks, the ``ctypes`` call on
  the current stream, and the launch counter);
* CPU: the kernel's plain PyTorch version;
* fake: the outputs' shapes, dtypes and device and nothing else, so that
  ``torch.export`` traces a model through the operator without running
  it and keeps it as one node of the exported graph.

The dispatcher picks the implementation by the tensors' device: a CUDA
tensor never reaches the plain version.  Registration is pure Python and
builds nothing.  It uses ``torch.library.Library`` directly rather than
``torch.library.custom_op``, whose Python wrapper adds host time to
every call (PERF.md, PR 17).  The operators have no autograd formulas:
the ``torch.autograd.Function`` of each forward calls the forward
operator and, in its backward, the backward operators.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "graphnet_tpu_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(
    schema: str, cpu: Callable, cuda: Callable, fake: Callable
) -> torch._ops.OpOverloadPacket:
    """Define the operator ``schema`` (``"name(Tensor a, ...) -> ..."``)
    with its CPU, CUDA and fake implementations; returns
    ``torch.ops.graphnet_tpu_torch.<name>``."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    # the plain version records no autograd graph: the operator's output
    # requires no gradient on either device
    LIB.impl(name, torch.no_grad()(cpu), "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(torch.ops.graphnet_tpu_torch, name)
