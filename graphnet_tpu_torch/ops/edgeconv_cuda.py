"""Fused EdgeConv kernels for Hopper (forward, forward + next-layer kNN,
and backward), and their plain PyTorch versions.

Replaces ``graphnet_tpu/ops/edgeconv_pallas.py``: ``_fwd_kernel`` (the
forward of ``fused_edgeconv``), ``_bwd_kernel`` (its custom VJP) and
``_fwd_knn_kernel`` (the forward of ``fused_edgeconv_knn``, whose VJP is
``_bwd_kernel`` too).
The forward computes, per node,

    ``aggr_k em[i,k] act(act(a[i] + b[idx[i,k]]) @ w2 + b2)``

where ``act`` is (leaky) relu with ``slope`` and ``aggr`` is "add" or
"max" (a node with no valid edge gives 0).  "mean" is "add" divided by
the valid-edge count outside the kernel, as in the JAX package.  The
kernels are ``csrc/edgeconv.cu``, ``csrc/edgeconv_knn.cu`` and
``csrc/edgeconv_bwd.cu``; their header notes say what bounds each on the
H100 and what the designs do about it (the backward keeps every sum in a
fixed order, so it is deterministic).

Each kernel is an operator of :mod:`~graphnet_tpu_torch.ops.library`:
``torch.ops.graphnet_tpu_torch.edgeconv_fwd`` (row 2),
``edgeconv_knn_fwd`` (row 4) and ``edgeconv_bwd`` (row 3), whose CPU
implementations are the plain versions (:func:`fused_edgeconv_plain`,
:func:`fused_edgeconv_knn_plain`, :func:`fused_edgeconv_bwd_plain`) and
whose CUDA implementations launch the kernels.  :func:`fused_edgeconv`
and :func:`fused_edgeconv_knn` are ``torch.autograd.Function`` classes
on both devices that call the forward operators and, in their backward,
the backward operator.  There is no fallback from CUDA to the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from graphnet_tpu_torch.ops import library
from graphnet_tpu_torch.ops.flash_attention_cuda import aligned16
from graphnet_tpu_torch.ops.gather_reduce import gather_neighbors
from graphnet_tpu_torch.ops.knn import knn_graph_plain

_NAME = "edgeconv"
_BWD_NAME = "edgeconv_bwd"
_KNN_NAME = "edgeconv_knn"
MAX_K = 64
# the fused EdgeConv + kNN: whole events of at most this many nodes (the
# TPU kernel's bound), at most this many neighbours, on 3 or 4 columns
KNN_MAX_L = 128
KNN_MAX_K = 16
KNN_DIMS = (3, 4)
AGGRS = ("add", "max")
HOPPER_SMEM_OPTIN = 232448  # bytes a block may opt in to on sm_90
_ROWS = 64  # edge rows per block of both kernels
# the backward's pre2 column chunk (csrc/edgeconv_bwd.cu, Cfg): the gm
# rows' padding
_BWD_COLS = {torch.bfloat16: 128, torch.float32: 256}
# the backward's routes, in the order of the C entry's `route`: fp32 with
# the 64-row edge kernel, bf16, fp32 with the 128-row edge kernel
# (csrc/edgeconv_bwd_f32.cuh)
BWD_ROUTES = ("fp32_rows64", "bf16", "fp32_rows128")


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
    """Plain PyTorch version of the forward kernel, with its numerics:
    messages formed in fp32, rounded once to ``w2``'s dtype, multiplied
    with fp32 accumulation; output fp32."""
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


def fused_edgeconv_knn_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    idx: torch.Tensor,
    edge_mask: torch.Tensor,
    nmask: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    aggr: str = "add",
    slope: float = 0.0,
    knn_k: int = 8,
    sub_lo: int = 0,
    sub_hi: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused EdgeConv + kNN kernel:
    :func:`fused_edgeconv_plain`, then the ``knn_k`` nearest valid nodes
    of each node over ``out[..., sub_lo:sub_hi]``, centred in the
    kernel's fixed order (:func:`~graphnet_tpu_torch.ops.knn.
    event_centre`).  Returns ``(out, nidx, nem)``."""
    out = fused_edgeconv_plain(a, b, idx, edge_mask, w2, b2, aggr, slope)
    return (out,) + output_knn_plain(out, nmask, knn_k, sub_lo, sub_hi)


def output_knn_plain(
    out: torch.Tensor,
    nmask: torch.Tensor,
    knn_k: int = 8,
    sub_lo: int = 0,
    sub_hi: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kNN half of :func:`fused_edgeconv_knn_plain`: ``(nidx, nem)``
    of the ``knn_k`` nearest valid nodes over ``out[..., sub_lo:sub_hi]``,
    centred in the kernel's order: ``knn_graph_plain``'s graph.  Given
    the kernel's ``out`` it gives the kernel's neighbours, bit for bit."""
    with torch.no_grad():
        return knn_graph_plain(out[..., sub_lo:sub_hi], nmask, knn_k)


def fused_edgeconv_bwd_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    idx: torch.Tensor,
    edge_mask: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    g: torch.Tensor,
    aggr: str = "add",
    slope: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: ``(da, db, dw2,
    db2)``, all fp32, for the output gradient ``g [B, L, H2]``.

    The contract of the TPU kernel, written out: messages recomputed
    (rounded once to ``w2``'s dtype); under "max" the gradient of each
    (node, channel) goes to the first valid edge whose activation equals
    the masked max (``torch.amax``'s own backward would split ties);
    ``msgs``, ``g_msgs`` and ``w2`` enter the products in ``w2``'s dtype
    with fp32 sums; ``da`` sums the fp32 ``g_z`` and ``db`` scatter-adds
    ``g_z`` rounded to that dtype.  Masked edges, and edges whose index
    lies outside ``[0, L)``, contribute nothing.
    """
    if aggr not in AGGRS:
        raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
    B, L, H1 = a.shape
    k = idx.shape[2]
    cdt = w2.dtype
    em = edge_mask & (idx >= 0) & (idx < L)
    safe = torch.where(em, idx, 0)
    z = a.float()[:, :, None, :] + gather_neighbors(b, safe).float()
    msgs = _act(z, slope).to(cdt).float()  # [B, L, k, H1]
    pre2 = torch.matmul(msgs, w2.float()) + b2.float()
    gate2 = torch.where(pre2 > 0, 1.0, slope)
    g_rep = g.float()[:, :, None, :]
    m = em[..., None]
    if aggr == "add":
        g_route = torch.where(m, g_rep, 0.0)
    else:
        masked = torch.where(m, _act(pre2, slope), -1e30)
        is_max = (masked == masked.amax(dim=2, keepdim=True)) & m
        kio = torch.arange(k, device=a.device)[None, None, :, None]
        first = torch.where(is_max, kio, k).amin(dim=2, keepdim=True)
        g_route = torch.where(kio == first, g_rep, 0.0)
    g_msgs = g_route * gate2
    g_msgs_c = g_msgs.to(cdt).float()
    dw2 = torch.einsum("blkh,blkc->hc", msgs, g_msgs_c)
    db2 = g_msgs.sum(dim=(0, 1, 2))
    gate_z = torch.where(z > 0, 1.0, slope)
    g_z = torch.matmul(g_msgs_c, w2.to(cdt).float().t()) * gate_z
    g_z = torch.where(m, g_z, 0.0)
    da = g_z.sum(dim=2)
    flat = safe.reshape(B, L * k, 1).long().expand(B, L * k, H1)
    db = torch.zeros(B, L, H1, dtype=torch.float32, device=a.device)
    db.scatter_add_(1, flat, g_z.to(cdt).float().reshape(B, L * k, H1))
    return da, db, dw2, db2


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


def _knn_lib() -> ctypes.CDLL:
    from graphnet_tpu_torch.kernels import build

    lib = build.load(_KNN_NAME)
    fn = lib.edgeconv_knn_launch
    if fn.argtypes is None:  # first use: declare the C signature
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 11 + [I] * 8 + [ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
        lib.edgeconv_knn_smem_bytes.argtypes = [I, I, I, I]
        lib.edgeconv_knn_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_lib() -> ctypes.CDLL:
    from graphnet_tpu_torch.kernels import build

    lib = build.load(_BWD_NAME)
    fn = lib.edgeconv_bwd_launch
    if fn.argtypes is None:  # first use: declare the C signature
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 19 + [I] * 6 + [ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
        lib.edgeconv_bwd_smem_bytes.argtypes = [I, I, I, I]
        lib.edgeconv_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.edgeconv_bwd_csr_smem_bytes.argtypes = [I]
        lib.edgeconv_bwd_csr_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(a, b, idx, edge_mask, w2, b2, aggr, g=None):
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
    if aggr not in AGGRS:
        raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
    if g is not None and g.shape != (B, L, w2.shape[1]):
        raise ValueError(
            f"g must be [B, L, H2] = {(B, L, w2.shape[1])}; got "
            f"{tuple(g.shape)}"
        )


def _cuda_device(tensors, name: str) -> torch.device:
    """The CUDA device of a kernel's tensors, all on one; raises
    otherwise (a CUDA implementation never takes CPU tensors).  Also
    checks the kernels' dtypes."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name} takes tensors all on one CUDA device (or all on the "
            f"CPU); got {[str(t.device) for t in tensors]}"
        )
    a, idx = tensors[0], tensors[2]
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    k = idx.shape[2]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    return dev


@functools.lru_cache(maxsize=16)
def _smem_limit(dev: torch.device) -> int:
    return getattr(
        torch.cuda.get_device_properties(dev),
        "shared_memory_per_block_optin",
        HOPPER_SMEM_OPTIN,
    )


def _check_smem(need: int, dev: torch.device, what: str) -> None:
    limit = _smem_limit(dev)
    if need > limit:
        raise ValueError(
            f"{what} needs {need} bytes of shared memory per block; the "
            f"card allows {limit}"
        )


def pad_operands(
    a: torch.Tensor, b: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``a``, ``b``, ``w2`` and ``b2`` with H1 and H2 zero-padded to
    multiples of 8, the kernels' rows of whole 16-byte chunks (the same
    tensors where both already are).  Zero columns of a and b give zero
    messages, zero rows and columns of W2 and b2 zero outputs: the first
    H2 output columns and the gradients' first H1 and H2 are unchanged.
    Made anew each call, so a W2 updated in place is always read."""
    H1, H2 = w2.shape
    P1, P2 = -(-H1 // 8) * 8, -(-H2 // 8) * 8
    if (P1, P2) == (H1, H2):
        return a, b, w2, b2
    pad = torch.nn.functional.pad
    return (pad(a, (0, P1 - H1)), pad(b, (0, P1 - H1)),
            pad(w2, (0, P2 - H2, 0, P1 - H1)), pad(b2, (0, P2 - H2)))


def _fwd_cuda(a, b, idx, edge_mask, w2, b2, aggr, slope):
    _check(a, b, idx, edge_mask, w2, b2, aggr)
    dev = _cuda_device((a, b, idx, edge_mask, w2, b2), "fused_edgeconv")
    H2, k = w2.shape[1], idx.shape[2]
    a, b, w2, b2 = pad_operands(a, b, w2, b2)
    B, L, H1 = a.shape
    H2p = w2.shape[1]
    bf16 = int(a.dtype == torch.bfloat16)
    lib = _lib()
    _check_smem(lib.edgeconv_fwd_smem_bytes(H1, bf16), dev, f"H1={H1}")
    with torch.cuda.device(dev):
        args = [aligned16(t) for t in (a, b, idx, edge_mask, w2, b2)]
        out = torch.empty((B, L, H2p), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.edgeconv_fwd_launch(
            *(t.data_ptr() for t in args), out.data_ptr(),
            B, L, H1, H2p, k, float(slope), int(aggr == "max"), bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"edgeconv kernel launch failed: CUDA error {err}")
    fused_edgeconv.launches += 1
    return out if H2p == H2 else out[..., :H2].contiguous()


# per (device, stream): the fused EdgeConv + kNN kernel's per-event
# arrival counters, zero between launches (the last block of each event
# resets its own); launches on one stream run one after another
_ARRIVALS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _arrival_counters(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    key = (dev, stream)
    cnt = _ARRIVALS.get(key)
    if cnt is None or cnt.numel() < B:
        size = B if cnt is None else max(B, 2 * cnt.numel())
        cnt = torch.zeros(size, dtype=torch.int32, device=dev)
        _ARRIVALS[key] = cnt
    return cnt


def _check_knn(nmask, a, w2, knn_k, sub_lo, sub_hi):
    B, L = a.shape[:2]
    if nmask.shape != (B, L) or nmask.dtype != torch.bool:
        raise ValueError(f"nmask must be a bool [B, L] = {(B, L)} tensor")
    if not 0 <= sub_lo < sub_hi <= w2.shape[1]:
        raise ValueError(
            f"the kNN columns [{sub_lo}, {sub_hi}) must lie in the output's "
            f"{w2.shape[1]}"
        )
    if not 1 <= knn_k <= L:
        raise ValueError(f"knn_k={knn_k} must lie in [1, L={L}]")


def _fwd_knn_cuda(a, b, idx, edge_mask, nmask, w2, b2, aggr, slope, knn_k,
                  sub_lo, sub_hi):
    _check(a, b, idx, edge_mask, w2, b2, aggr)
    _check_knn(nmask, a, w2, knn_k, sub_lo, sub_hi)
    dev = _cuda_device((a, b, idx, edge_mask, w2, b2, nmask),
                       "fused_edgeconv_knn")
    B, L, H1 = a.shape
    H2, k = w2.shape[1], idx.shape[2]
    D = sub_hi - sub_lo
    if L > KNN_MAX_L or knn_k > KNN_MAX_K or D not in KNN_DIMS:
        raise ValueError(
            f"the fused EdgeConv + kNN kernel takes L <= {KNN_MAX_L}, "
            f"knn_k <= {KNN_MAX_K} and {KNN_DIMS} columns; got L={L}, "
            f"knn_k={knn_k}, {D} columns"
        )
    a, b, w2, b2 = pad_operands(a, b, w2, b2)
    H1, H2p = w2.shape
    bf16 = int(a.dtype == torch.bfloat16)
    lib = _knn_lib()
    _check_smem(lib.edgeconv_knn_smem_bytes(H1, L, D, bf16), dev, f"H1={H1}")
    with torch.cuda.device(dev):
        args = [aligned16(t) for t in (a, b, idx, edge_mask, nmask, w2, b2)]
        out = torch.empty((B, L, H2p), dtype=torch.float32, device=dev)
        nidx = torch.empty((B, L, knn_k), dtype=torch.int32, device=dev)
        nem = torch.empty((B, L, knn_k), dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = _arrival_counters(dev, stream, B)
        err = lib.edgeconv_knn_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), nidx.data_ptr(),
            nem.data_ptr(), counters.data_ptr(), B, L, H1, H2p, k, knn_k,
            sub_lo, D, float(slope), int(aggr == "max"), bf16, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"edgeconv_knn kernel launch failed: CUDA error {err}"
        )
    fused_edgeconv_knn.launches += 1
    if H2p != H2:
        out = out[..., :H2].contiguous()
    return out, nidx, nem


def _rows128_smem(H1: int) -> int:
    """Shared memory of the 128-row fp32 edge kernel in bytes
    (``edgeconv_bwd_f32.cuh``, ``ecf::layout``): the messages (k-major,
    132 floats a row), or pre2 and gm (256 rows) with the staging of 64
    g_z columns; two ring slots; the z > 0 bits; the slots' indices and
    flags and the row blocks' flags."""
    h1p, h1g = -(-H1 // 16) * 16, -(-H1 // 128) * 128
    region = max(h1p * 132 * 4, 256 * 132 * 4 + 128 * 68 * 4)
    return region + 2 * 32 * 132 * 4 + 128 * (h1g // 8) + 128 * 5 + 4 * 4


def bwd_route(H1: int, H2: int, k: int, dtype: torch.dtype) -> str:
    """The backward's route for these widths (padded to multiples of 8
    as the kernels take them), ``k`` and compute dtype: "bf16" (the
    tensor-core kernel), else "fp32_rows128" where the 128-row fp32 edge
    kernel takes the shape (H2 <= 256 and its shared memory within the
    card's), else "fp32_rows64".  Every k in [1, 64] fits both fp32
    kernels alike."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} must lie in [1, {MAX_K}]")
    if dtype == torch.bfloat16:
        return "bf16"
    H1, H2 = -(-H1 // 8) * 8, -(-H2 // 8) * 8
    if H2 <= 256 and _rows128_smem(H1) <= HOPPER_SMEM_OPTIN:
        return "fp32_rows128"
    return "fp32_rows64"


def _dw2_splits(n_edges: int) -> int:
    """Slices of the edge rows in the split-K dW2 product: at most 1024
    rows each (the kernel's bound; at B=128, L=128, k=8 the 128 partials
    take ~44 MB at H1=336, H2=256)."""
    return max(1, -(-n_edges // 1024))


def bwd_scratch_plan(
    B: int, L: int, H1: int, H2: int, k: int, dtype: torch.dtype
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The backward kernel's scratch, in the order of its C entry: name
    -> (shape, dtype).  In the compute dtype: W2 transposed (read by the
    fp32 kernels), the gm rows (the routed, gated output gradient, for
    dW2), zero-padded to a multiple of 128 (bf16) or 256 (fp32) columns,
    and the g_z rows (for db); as float32 the dW2 partials of the split
    over the edge rows, as int32 which of them hold a valid edge (read in
    fp32), as float32 the per-block db2 partials (a block is two of the
    forward's on route "fp32_rows128"); as int32 the reverse (CSR) index
    of each event's edges."""
    n_edges = B * L * k
    H2p = -(-H2 // _BWD_COLS[dtype]) * _BWD_COLS[dtype]
    nodes = _ROWS // k * (2 if bwd_route(H1, H2, k, dtype) == "fp32_rows128"
                          else 1)
    blocks = B * -(-L // nodes)
    splits = _dw2_splits(n_edges)
    f32, i32 = torch.float32, torch.int32
    return {
        "w2t": ((H2, H1), dtype),
        "gm": ((n_edges, H2p), dtype),
        "gz": ((n_edges, H1), dtype),
        "dw2_part": ((splits, H1, H2), f32),
        "dw2_used": ((splits,), i32),
        "db2_part": ((blocks, H2), f32),
        "offs": ((B, L + 1), i32),
        "list": ((B, L * k), i32),
    }


@functools.lru_cache(maxsize=64)
def _bwd_layout(lib, dev, B, L, H1, H2, k, dtype):
    """For one call's shapes, checked once: the route, the byte offset of
    each part of :func:`bwd_scratch_plan` in one allocation (256-byte
    aligned), its size, and the dW2 slices."""
    route = bwd_route(H1, H2, k, dtype)
    smem = lib.edgeconv_bwd_smem_bytes(H1, H2, k, BWD_ROUTES.index(route))
    if route == "fp32_rows128" and smem != _rows128_smem(H1):
        raise RuntimeError(
            f"the 128-row edge kernel needs {smem} bytes of shared memory, "
            f"the wrapper counted {_rows128_smem(H1)}")
    _check_smem(smem, dev, f"H1={H1}, H2={H2}, k={k}")
    _check_smem(lib.edgeconv_bwd_csr_smem_bytes(L), dev, f"L={L}")
    plan = bwd_scratch_plan(B, L, H1, H2, k, dtype)
    starts, total = [], 0
    for shape, dt in plan.values():
        starts.append(total)
        total += -(-math.prod(shape) * dt.itemsize // 256) * 256
    return route, starts, total, plan["dw2_part"][0][0]


def fused_edgeconv_bwd(
    a: torch.Tensor,
    b: torch.Tensor,
    idx: torch.Tensor,
    edge_mask: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    g: torch.Tensor,
    aggr: str = "add",
    slope: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EdgeConv backward: ``(da, db, dw2, db2)``, all fp32, for the
    forward's inputs and the output gradient ``g [B, L, H2]`` (any float
    dtype and strides; it is made contiguous fp32).

    The operator ``edgeconv_bwd``: tensors on the CPU take
    :func:`fused_edgeconv_bwd_plain`; CUDA tensors launch
    ``csrc/edgeconv_bwd.cu`` (six kernels, seven in fp32, counted as one
    call in ``fused_edgeconv_bwd.launches`` and in its route's entry of
    ``fused_edgeconv_bwd.launches_by_route``, :func:`bwd_route`) with the
    scratch of :func:`bwd_scratch_plan`.
    """
    return edgeconv_bwd_op(a, b, idx, edge_mask, w2, b2, g, aggr, slope)


def _bwd_cuda(a, b, idx, edge_mask, w2, b2, g, aggr, slope):
    _check(a, b, idx, edge_mask, w2, b2, aggr, g)
    dev = _cuda_device((a, b, idx, edge_mask, w2, b2, g), "fused_edgeconv_bwd")
    B, L, H1 = a.shape
    H2, k = w2.shape[1], idx.shape[2]
    pa, pb, pw2, pb2 = pad_operands(a, b, w2, b2)
    if pw2 is not w2:
        # zero columns change no gradient, and are cut off again
        pg = torch.nn.functional.pad(g, (0, pw2.shape[1] - H2))
        da, db, dw2, db2 = _bwd_cuda(
            pa, pb, idx, edge_mask, pw2, pb2, pg, aggr, slope)
        return tuple(t.contiguous() for t in (
            da[..., :H1], db[..., :H1], dw2[:H1, :H2], db2[:H2]))
    lib = _bwd_lib()
    route, starts, total, splits = _bwd_layout(lib, dev, B, L, H1, H2, k,
                                               a.dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        args = [aligned16(t) for t in (a, b, idx, edge_mask, w2, b2)]
        gc = g.to(torch.float32).contiguous()
        outs = (torch.empty((B, L, H1), **f32), torch.empty((B, L, H1), **f32),
                torch.empty((H1, H2), **f32), torch.empty((H2,), **f32))
        scratch = torch.empty(total, dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.edgeconv_bwd_launch(
            *(t.data_ptr() for t in args), gc.data_ptr(),
            *(t.data_ptr() for t in outs),
            *(scratch.data_ptr() + s for s in starts),
            B, L, H1, H2, k, splits, float(slope),
            int(aggr == "max"), BWD_ROUTES.index(route), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"edgeconv backward kernel launch failed: CUDA error {err}"
        )
    fused_edgeconv_bwd.launches += 1
    fused_edgeconv_bwd.launches_by_route[route] += 1
    return outs


fused_edgeconv_bwd.launches = 0
fused_edgeconv_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


class _FusedEdgeConv(torch.autograd.Function):
    """The fused EdgeConv with its hand-written backward (the counterpart
    of ``jax.custom_vjp`` on ``fused_edgeconv``)."""

    @staticmethod
    def forward(ctx, a, b, idx, edge_mask, w2, b2, aggr, slope):
        out = edgeconv_fwd_op(a, b, idx, edge_mask, w2, b2, aggr, slope)
        ctx.save_for_backward(a, b, idx, edge_mask, w2, b2)
        ctx.aggr, ctx.slope = aggr, slope
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        da, db, dw2, db2 = _saved_grads(ctx, g)
        return da, db, None, None, dw2, db2, None, None


def _saved_grads(ctx, g):
    """``(da, db, dw2, db2)`` in the inputs' dtypes, from the tensors a
    fused EdgeConv forward saved and the output gradient ``g``."""
    a, b, idx, edge_mask, w2, b2 = ctx.saved_tensors
    da, db, dw2, db2 = fused_edgeconv_bwd(
        a, b, idx, edge_mask, w2, b2, g, ctx.aggr, ctx.slope
    )
    return da.to(a.dtype), db.to(b.dtype), dw2.to(w2.dtype), db2.to(b2.dtype)


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
    """Fused EdgeConv, differentiable in ``a``, ``b``, ``w2`` and ``b2``.

    a, b: ``[B, L, H1]`` (float32, or bfloat16 for the mixed-precision
    mode); idx: ``[B, L, k]`` int32; edge_mask: ``[B, L, k]`` bool;
    w2: ``[H1, H2]``; b2: ``[H2]``, both of a's dtype.  Returns
    ``[B, L, H2]`` float32.  Counts its forward kernel launches in
    ``fused_edgeconv.launches``; the backward counts its own in
    ``fused_edgeconv_bwd.launches``.
    """
    return _FusedEdgeConv.apply(a, b, idx, edge_mask, w2, b2, aggr, slope)


fused_edgeconv.launches = 0


class _FusedEdgeConvKnn(torch.autograd.Function):
    """The fused EdgeConv + kNN; its backward is the EdgeConv backward on
    the output gradient (the counterpart of ``_fused_knn_bwd``): the
    neighbour indices and edge mask are not differentiable."""

    @staticmethod
    def forward(ctx, a, b, idx, edge_mask, nmask, w2, b2, aggr, slope, knn_k,
                sub_lo, sub_hi):
        out, nidx, nem = edgeconv_knn_fwd_op(
            a, b, idx, edge_mask, nmask, w2, b2, aggr, slope, knn_k, sub_lo,
            sub_hi)
        ctx.mark_non_differentiable(nidx, nem)
        ctx.save_for_backward(a, b, idx, edge_mask, w2, b2)
        ctx.aggr, ctx.slope = aggr, slope
        return out, nidx, nem

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_nidx, _g_nem):
        da, db, dw2, db2 = _saved_grads(ctx, g)
        return (da, db, None, None, None, dw2, db2) + (None,) * 5


def fused_edgeconv_knn(
    a: torch.Tensor,
    b: torch.Tensor,
    idx: torch.Tensor,
    edge_mask: torch.Tensor,
    nmask: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    aggr: str = "add",
    slope: float = 0.0,
    knn_k: int = 8,
    sub_lo: int = 0,
    sub_hi: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EdgeConv forward + the kNN of its output, differentiable in
    ``a``, ``b``, ``w2`` and ``b2`` (the backward is
    :func:`fused_edgeconv_bwd`).

    Arguments as :func:`fused_edgeconv`, plus ``nmask [B, L]`` bool node
    validity.  The next layer's adjacency is the ``knn_k`` nearest valid
    nodes of each node over ``out[..., sub_lo:sub_hi]`` with
    :func:`~graphnet_tpu_torch.ops.knn.knn_graph`'s contract, centred in
    a fixed order.  Returns ``(out [B, L, H2] float32, nidx [B, L, knn_k]
    int32, nem [B, L, knn_k] bool)``.  CUDA tensors need L <= 128,
    ``knn_k`` <= 16 and 3 or 4 columns.  Counts its kernel launches in
    ``fused_edgeconv_knn.launches``.
    """
    return _FusedEdgeConvKnn.apply(a, b, idx, edge_mask, nmask, w2, b2, aggr,
                                   slope, knn_k, sub_lo, sub_hi)


fused_edgeconv_knn.launches = 0


# ----------------------------------------------------------- operators
# Each implementation checks its inputs (an operator is an entry point of
# its own).  The CPU implementations look the plain versions up at call
# time, so that a test may count their calls by replacing the module
# globals.
def _fwd_cpu(a, b, idx, edge_mask, w2, b2, aggr, slope):
    _check(a, b, idx, edge_mask, w2, b2, aggr)
    return fused_edgeconv_plain(a, b, idx, edge_mask, w2, b2, aggr, slope)


def _fwd_fake(a, b, idx, edge_mask, w2, b2, aggr, slope):
    return a.new_empty(a.shape[:2] + w2.shape[1:], dtype=torch.float32)


def _fwd_knn_cpu(a, b, idx, edge_mask, nmask, w2, b2, aggr, slope, knn_k,
                 sub_lo, sub_hi):
    _check(a, b, idx, edge_mask, w2, b2, aggr)
    _check_knn(nmask, a, w2, knn_k, sub_lo, sub_hi)
    return fused_edgeconv_knn_plain(a, b, idx, edge_mask, nmask, w2, b2, aggr,
                                    slope, knn_k, sub_lo, sub_hi)


def _fwd_knn_fake(a, b, idx, edge_mask, nmask, w2, b2, aggr, slope, knn_k,
                  sub_lo, sub_hi):
    B, L = a.shape[:2]
    return (a.new_empty((B, L, w2.shape[1]), dtype=torch.float32),
            a.new_empty((B, L, knn_k), dtype=torch.int32),
            a.new_empty((B, L, knn_k), dtype=torch.bool))


def _bwd_cpu(a, b, idx, edge_mask, w2, b2, g, aggr, slope):
    _check(a, b, idx, edge_mask, w2, b2, aggr, g)
    return fused_edgeconv_bwd_plain(a, b, idx, edge_mask, w2, b2, g, aggr,
                                    slope)


def _bwd_fake(a, b, idx, edge_mask, w2, b2, g, aggr, slope):
    f32 = dict(dtype=torch.float32)
    return (a.new_empty(a.shape, **f32), a.new_empty(a.shape, **f32),
            a.new_empty(w2.shape, **f32), a.new_empty(b2.shape, **f32))


_OPERANDS = "Tensor a, Tensor b, Tensor idx, Tensor edge_mask"
edgeconv_fwd_op = library.define(
    f"edgeconv_fwd({_OPERANDS}, Tensor w2, Tensor b2, str aggr, float slope)"
    " -> Tensor",
    _fwd_cpu, _fwd_cuda, _fwd_fake)
edgeconv_knn_fwd_op = library.define(
    f"edgeconv_knn_fwd({_OPERANDS}, Tensor nmask, Tensor w2, Tensor b2, "
    "str aggr, float slope, int knn_k, int sub_lo, int sub_hi)"
    " -> (Tensor, Tensor, Tensor)",
    _fwd_knn_cpu, _fwd_knn_cuda, _fwd_knn_fake)
edgeconv_bwd_op = library.define(
    f"edgeconv_bwd({_OPERANDS}, Tensor w2, Tensor b2, Tensor g, str aggr, "
    "float slope) -> (Tensor, Tensor, Tensor, Tensor)",
    _bwd_cpu, _bwd_cuda, _bwd_fake)
