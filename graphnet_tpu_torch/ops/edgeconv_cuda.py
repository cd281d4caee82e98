"""Fused EdgeConv forward kernel for Hopper, and its plain PyTorch version.

Replaces ``graphnet_tpu/ops/edgeconv_pallas.py:_fwd_kernel`` (the forward
of ``fused_edgeconv``).  Computes, per node,

    ``aggr_k em[i,k] act(act(a[i] + b[idx[i,k]]) @ w2 + b2)``

where ``act`` is (leaky) relu with ``slope`` and ``aggr`` is "add" or
"max" (a node with no valid edge gives 0).  "mean" is "add" divided by
the valid-edge count outside the kernel, as in the JAX package.  The
kernel is ``csrc/edgeconv.cu``; its header note says what bounds it on
the H100 (the W2 product's FLOPs) and how the design keeps the
``[B, L, k, H1]`` messages in shared memory.

:func:`fused_edgeconv` takes :func:`fused_edgeconv_plain` for tensors
on the CPU and launches the kernel for CUDA tensors; it never falls
back.  The backward pass is not ported yet (serving only).
"""

from __future__ import annotations

import ctypes

import torch

_NAME = "edgeconv"
MAX_K = 64
AGGRS = ("add", "max")
HOPPER_SMEM_OPTIN = 232448  # bytes a block may opt in to on sm_90


def _act(x: torch.Tensor, slope: float) -> torch.Tensor:
    if slope:
        return torch.where(x > 0, x, slope * x)
    return x.clamp_min(0.0)


def fused_edgeconv_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    idx: torch.Tensor,
    edge_mask: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    aggr: str = "add",
    slope: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's numerics:
    messages formed in fp32, rounded once to ``w2``'s dtype, multiplied
    with fp32 accumulation; output fp32."""
    from graphnet_tpu_torch.ops.gather_reduce import gather_neighbors

    if aggr not in AGGRS:
        raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
    z = a.float()[:, :, None, :] + gather_neighbors(b, idx).float()
    msgs = _act(z, slope).to(w2.dtype).float()
    out = _act(torch.matmul(msgs, w2.float()) + b2.float(), slope)
    m = edge_mask[..., None]
    if aggr == "add":
        return torch.where(m, out, 0.0).sum(dim=2)
    r = torch.where(m, out, -1e30).amax(dim=2)
    return torch.where(edge_mask.any(dim=2, keepdim=True), r, 0.0)


def _lib() -> ctypes.CDLL:
    from graphnet_tpu_torch.kernels import build

    lib = build.load(_NAME)
    fn = lib.edgeconv_fwd_launch
    if fn.argtypes is None:  # first use: declare the C signature
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I,
                       ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
        lib.edgeconv_fwd_smem_bytes.argtypes = [I, I]
        lib.edgeconv_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(a, b, idx, edge_mask, w2, b2):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(
            f"a and b must be one [B, L, H1] shape; got {tuple(a.shape)} "
            f"and {tuple(b.shape)}"
        )
    B, L, H1 = a.shape
    if idx.dim() != 3 or idx.shape[:2] != (B, L):
        raise ValueError(f"idx must be [B, L, k]; got {tuple(idx.shape)}")
    if edge_mask.shape != idx.shape or edge_mask.dtype != torch.bool:
        raise ValueError("edge_mask must be a bool tensor shaped like idx")
    if w2.dim() != 2 or w2.shape[0] != H1 or b2.shape != (w2.shape[1],):
        raise ValueError(
            f"w2 must be [H1={H1}, H2] and b2 [H2]; got {tuple(w2.shape)} "
            f"and {tuple(b2.shape)}"
        )
    if not (a.dtype == b.dtype == w2.dtype == b2.dtype):
        raise TypeError(
            "a, b, w2 and b2 must share one dtype; got "
            f"{a.dtype}, {b.dtype}, {w2.dtype}, {b2.dtype}"
        )


def fused_edgeconv(
    a: torch.Tensor,
    b: torch.Tensor,
    idx: torch.Tensor,
    edge_mask: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    aggr: str = "add",
    slope: float = 0.0,
) -> torch.Tensor:
    """Fused EdgeConv forward.

    a, b: ``[B, L, H1]`` (float32, or bfloat16 for the mixed-precision
    mode); idx: ``[B, L, k]`` int32; edge_mask: ``[B, L, k]`` bool;
    w2: ``[H1, H2]``; b2: ``[H2]``, both of a's dtype.  Returns
    ``[B, L, H2]`` float32.  Counts its kernel launches in
    ``fused_edgeconv.launches``.
    """
    _check(a, b, idx, edge_mask, w2, b2)
    if aggr not in AGGRS:
        raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
    tensors = (a, b, idx, edge_mask, w2, b2)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_edgeconv_plain(a, b, idx, edge_mask, w2, b2, aggr, slope)
    dev = a.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "fused_edgeconv takes tensors all on one CUDA device (or all "
            f"on the CPU); got {[str(t.device) for t in tensors]}"
        )
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    B, L, H1 = a.shape
    H2, k = w2.shape[1], idx.shape[2]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    bf16 = int(a.dtype == torch.bfloat16)
    lib = _lib()
    smem = lib.edgeconv_fwd_smem_bytes(H1, bf16)
    limit = getattr(
        torch.cuda.get_device_properties(dev),
        "shared_memory_per_block_optin",
        HOPPER_SMEM_OPTIN,
    )
    if smem > limit:
        raise ValueError(
            f"H1={H1} needs {smem} bytes of shared memory per block; the "
            f"card allows {limit}"
        )

    with torch.cuda.device(dev):
        args = [t.contiguous() for t in tensors]
        out = torch.empty((B, L, H2), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.edgeconv_fwd_launch(
            *(t.data_ptr() for t in args), out.data_ptr(),
            B, L, H1, H2, k, float(slope), int(aggr == "max"), bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"edgeconv kernel launch failed: CUDA error {err}")
    fused_edgeconv.launches += 1
    return out


fused_edgeconv.launches = 0
