"""kNN graph kernel for Hopper, and its plain PyTorch version.

Replaces ``graphnet_tpu/ops/knn_pallas.py:_knn_kernel`` (entry
``knn_graph_pallas``).  The kernel is ``csrc/knn.cu``; its header note
says what bounds it on the H100 (launch latency at the serving shape)
and how the design keeps the selection in registers.

:func:`knn_graph_cuda` takes the plain version
(:func:`graphnet_tpu_torch.ops.knn.knn_graph_plain`) for a tensor on the
CPU and launches the kernel for a CUDA tensor; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from graphnet_tpu_torch.ops.knn import centre_coords, knn_graph_plain

MAX_K = 16
DIMS = (3, 4)  # coordinate counts the kernel is built for (xyz, xyzt)
_NAME = "knn"


def _lib() -> ctypes.CDLL:
    from graphnet_tpu_torch.kernels import build

    lib = build.load(_NAME)
    fn = lib.knn_graph_launch
    if fn.argtypes is None:  # first use: declare the C signature
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return lib


def knn_graph_cuda(
    coords: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(idx [B, L, k] int32, edge_mask [B, L, k] bool)`` of the ``k``
    nearest valid nodes of each node; see :func:`~graphnet_tpu_torch.ops.
    knn.knn_graph` for the contract.  Counts its kernel launches in
    ``knn_graph_cuda.launches``."""
    if coords.dim() != 3 or mask.shape != coords.shape[:2]:
        raise ValueError(
            f"coords must be [B, L, D] and mask [B, L]; got "
            f"{tuple(coords.shape)} and {tuple(mask.shape)}"
        )
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    # the output is integer and nothing differentiates it: build no
    # autograd graph for the centring (the coordinates are latents that
    # require grad during training)
    with torch.no_grad():
        if coords.device.type == "cpu":
            return knn_graph_plain(coords, mask, k, exclude_self)
        return _knn_cuda(coords, mask, k, exclude_self)


def _knn_cuda(coords, mask, k, exclude_self):
    B, L, D = coords.shape
    if D not in DIMS:
        raise ValueError(
            f"the CUDA kNN kernel takes D in {DIMS} coordinates, got {D}"
        )
    if coords.device.type != "cuda" or mask.device != coords.device:
        raise ValueError(
            f"coords on {coords.device} and mask on {mask.device}: both "
            "must be on one CUDA device (or on the CPU)"
        )
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if not 1 <= k <= min(MAX_K, L):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, L={L})]")

    with torch.cuda.device(coords.device):
        c = centre_coords(coords, mask).contiguous()
        m = mask.contiguous()
        idx = torch.empty((B, L, k), dtype=torch.int32, device=coords.device)
        em = torch.empty((B, L, k), dtype=torch.bool, device=coords.device)
        stream = torch.cuda.current_stream(coords.device).cuda_stream
        err = _lib().knn_graph_launch(
            c.data_ptr(), m.data_ptr(), B, L, D, k, int(exclude_self),
            idx.data_ptr(), em.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: CUDA error {err}")
    knn_graph_cuda.launches += 1
    return idx, em


knn_graph_cuda.launches = 0
