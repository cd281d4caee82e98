"""kNN graph kernel for Hopper, and its plain PyTorch version.

Replaces ``graphnet_tpu/ops/knn_pallas.py:_knn_kernel`` (entry
``knn_graph_pallas``).  The kernel is ``csrc/knn.cu``; its header note
says what bounds it on the H100 (launch latency at the serving shape),
how it centres the coordinates itself and how it splits each query's
keys across the lanes of a warp.  Its second kernel, the rounds path,
takes ``k > 32`` and ``L > 8192`` (any ``k`` up to ``L``, any ``L``) in
the same arithmetic: ``k`` rounds of the least (distance, index) pair
above the previous pick, keys streamed through shared memory in tiles.

:func:`knn_graph_cuda` calls the operator
``torch.ops.graphnet_tpu_torch.knn_graph`` (:mod:`~graphnet_tpu_torch.
ops.library`), whose CPU implementation is the plain version
(:func:`graphnet_tpu_torch.ops.knn.knn_graph_plain`) and whose CUDA
implementation launches the kernel; it never falls back.  A call on the
card is one launch and nothing else on the device: the kernel reads a
strided ``[B, L, D]`` view in place (its last dimension of stride 1) and
centres it, and the implementation only checks the inputs and allocates
the outputs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from graphnet_tpu_torch.ops import library
from graphnet_tpu_torch.ops.knn import knn_graph_plain

# csrc/knn.cu's first kernel instantiates k = 1-32 and holds a whole
# event of at most MAX_L nodes in shared memory; every other (k, L) takes
# its rounds kernel (uses_rounds)
MAX_K = 32
MAX_L = 8192
DIMS = (3, 4)  # coordinate counts the kernel is built for (xyz, xyzt)
_NAME = "knn"
_launch = None  # the C entry, once its signature is declared


def _entry():
    global _launch
    if _launch is None:
        from graphnet_tpu_torch.kernels import build

        fn = build.load(_NAME).knn_graph_launch
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, LL, LL, P, LL, I, I, I, I, I, P, P, I, P]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check_shapes(coords: torch.Tensor, mask: torch.Tensor) -> None:
    if coords.dim() != 3 or mask.shape != coords.shape[:2]:
        raise ValueError(
            f"coords must be [B, L, D] and mask [B, L]; got "
            f"{tuple(coords.shape)} and {tuple(mask.shape)}"
        )
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")


def uses_rounds(L: int, k: int) -> bool:
    """Whether a call of ``(L, k)`` takes ``csrc/knn.cu``'s rounds kernel
    (``k > MAX_K`` or ``L > MAX_L``), the rule of its C entry
    ``knn_uses_rounds``."""
    return k > MAX_K or L > MAX_L


def check_launch(coords: torch.Tensor, mask: torch.Tensor, k: int) -> None:
    """Raise on what the kernels do not take: shapes, types, ``D``
    outside :data:`DIMS`, a last dimension of stride other than 1 (of the
    coordinates or the mask), ``k`` outside ``[1, L]``, and tensors that
    are not on one CUDA device (checked last, so the other rules can be
    tested on the CPU).  Any ``k`` up to ``L`` and any ``L`` are taken:
    past ``MAX_K`` or ``MAX_L`` the rounds kernel answers."""
    _check_shapes(coords, mask)
    B, L, D = coords.shape
    if D not in DIMS:
        raise ValueError(
            f"the CUDA kNN kernel takes D in {DIMS} coordinates, got {D}"
        )
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.stride(2) != 1 or (L > 1 and mask.stride(1) != 1):
        raise ValueError(
            "the kNN kernel reads rows whose last dimension has stride 1; "
            f"got coords strides {coords.stride()}, mask {mask.stride()}"
        )
    if not 1 <= k <= L:
        raise ValueError(f"k={k} must lie in [1, L={L}]")
    if coords.device.type != "cuda" or mask.device != coords.device:
        raise ValueError(
            f"coords on {coords.device} and mask on {mask.device}: both "
            "must be on one CUDA device (or on the CPU)"
        )


def knn_graph_cuda(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx [B, L, k] int32, edge_mask [B, L, k] bool)`` of the ``k``
    nearest valid nodes of each node; see :func:`~graphnet_tpu_torch.ops.
    knn.knn_graph` for the contract.  Counts its kernel launches in
    ``knn_graph_cuda.launches``, by ``k`` in
    ``knn_graph_cuda.launches_by_k``, and those of the rounds kernel
    (:func:`uses_rounds`) also in ``knn_graph_cuda.launches_rounds``."""
    return knn_graph_op(coords, mask, k, exclude_self)


def _knn_cpu(coords, mask, k, exclude_self):
    _check_shapes(coords, mask)
    return knn_graph_plain(coords, mask, k, exclude_self)


def _knn_cuda(coords, mask, k, exclude_self):
    check_launch(coords, mask, k)
    B, L, D = coords.shape
    dev = coords.device
    idx = torch.empty((B, L, k), dtype=torch.int32, device=dev)
    em = torch.empty((B, L, k), dtype=torch.bool, device=dev)
    err = _entry()(
        coords.data_ptr(), coords.stride(0), coords.stride(1),
        mask.data_ptr(), mask.stride(0), B, L, D, k, int(exclude_self),
        idx.data_ptr(), em.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    knn_graph_cuda.launches += 1
    knn_graph_cuda.launches_rounds += int(uses_rounds(L, k))
    by_k = knn_graph_cuda.launches_by_k
    by_k[k] = by_k.get(k, 0) + 1
    return idx, em


def _knn_fake(coords, mask, k, exclude_self):
    B, L, _ = coords.shape
    return (coords.new_empty((B, L, k), dtype=torch.int32),
            coords.new_empty((B, L, k), dtype=torch.bool))


knn_graph_cuda.launches = 0
knn_graph_cuda.launches_by_k = {}
knn_graph_cuda.launches_rounds = 0
# the coordinates may be a strided view (coordinate_view): the schema
# takes any strides, and the CUDA implementation checks them
knn_graph_op = library.define(
    "knn_graph(Tensor coords, Tensor mask, int k, bool exclude_self)"
    " -> (Tensor, Tensor)",
    _knn_cpu, _knn_cuda, _knn_fake)
