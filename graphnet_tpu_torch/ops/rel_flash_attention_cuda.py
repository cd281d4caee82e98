"""Relative-bias attention kernels for Hopper (forward, dQ, dK/dV), and
the differentiable entry point of DeepIce's biased attention.

Replaces ``graphnet_tpu/ops/rel_flash_attention.py``: ``_rel_fwd_kernel``,
``_rel_bwd_dq_kernel`` and ``_rel_bwd_dkv_kernel`` behind the custom VJP
of ``rel_flash_attention``.  The kernels are
``csrc/rel_flash_attention.cu`` and ``csrc/rel_flash_attention_bwd.cu``;
their header notes say what bounds each on the H100 and what the design
does about it.  The contract, which the plain versions of
:mod:`graphnet_tpu_torch.ops.rel_flash_attention` share, is in that
module's docstring.

Each wrapper calls its operator (``torch.ops.graphnet_tpu_torch.
rel_fwd``, ``rel_bwd_dq``, ``rel_bwd_dkv``; :mod:`~graphnet_tpu_torch.
ops.library`), which takes the plain version for tensors on the CPU and
launches its kernel for CUDA tensors (counted in
``<wrapper>.launches``), raising on what the kernels do not take.  There
is no fallback from CUDA to the plain versions.  :func:`rel_flash_attention` folds the SpacetimeEncoder
projection around the core as plain tensor operations, so autograd gives
the projection's gradients; the core is a ``torch.autograd.Function``
whose backward is the two kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from graphnet_tpu_torch.ops import library
from graphnet_tpu_torch.ops.flash_attention_cuda import _cuda_device, aligned16
from graphnet_tpu_torch.ops.rel_flash_attention import (
    HEAD_DIMS,
    _freqs,
    rel_attention_bwd_plain,
    rel_attention_delta,
    rel_attention_plain,
)

_NAME = "rel_flash_attention"
_BWD_NAME = "rel_flash_attention_bwd"


def _lib(name: str, fn_name: str, n_ptr_in: int, n_ptr_out: int):
    from graphnet_tpu_torch.kernels import build

    fn = getattr(build.load(name), fn_name)
    if fn.argtypes is None:  # first use: declare the C signature
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * n_ptr_in + [I] * 6 + [P] * n_ptr_out + [P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, qt, qb, k, v, x0, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "q, k and v must share one [B, H, L, hd] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k and v must share one dtype; got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    B, H, L, _ = q.shape
    if qt.shape != q.shape or qt.dtype != torch.float32:
        raise ValueError(
            f"qt must be float32 {tuple(q.shape)} (pair dim = head dim); "
            f"got {qt.dtype} {tuple(qt.shape)}"
        )
    if qb.shape != (B, H, L) or qb.dtype != torch.float32:
        raise ValueError(
            f"qb must be float32 {(B, H, L)}; got {qb.dtype} {tuple(qb.shape)}"
        )
    if (x0.dim() != 3 or x0.shape[:2] != (B, L) or x0.shape[2] < 4
            or x0.dtype != torch.float32):
        raise ValueError(
            f"x0 must be float32 [B, L, >=4] with (B, L) = {(B, L)}; got "
            f"{x0.dtype} {tuple(x0.shape)}"
        )
    if mask.shape != (B, L) or mask.dtype != torch.bool:
        raise ValueError(
            f"mask must be bool [B, L] = {(B, L)}; got {mask.dtype} "
            f"{tuple(mask.shape)}"
        )


def _check_grads(q, lse, do, doe, delta):
    B, H, L, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, L) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 [B, H, L] = {(B, H, L)}; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if do.shape != q.shape or doe.shape != q.shape:
        raise ValueError(
            f"do and doe must be shaped like q {tuple(q.shape)}; got "
            f"{tuple(do.shape)}, {tuple(doe.shape)}"
        )


def _check_kernel(q):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the rel kernels take float32 or bfloat16, got {q.dtype}"
        )
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"the rel kernels take head dims {HEAD_DIMS}, got {q.shape[-1]}"
        )


# the frequency table on each device, per head dim (copied once)
_FREQS = {}


def _freqs_on(dev, hd: int) -> torch.Tensor:
    key = (str(dev), hd)
    if key not in _FREQS:
        _FREQS[key] = torch.from_numpy(_freqs(hd)).to(dev)
    return _FREQS[key]


def _launch(fn, counter, name, ins, outs, q, x0, dev):
    """Call a kernel's C entry on ``ins`` (made contiguous and 16-byte
    aligned, as the dkv kernel's asynchronous copies need) and the
    frequency table, writing into the fresh ``outs``; raises on a launch
    error."""
    B, H, L, hd = q.shape
    with torch.cuda.device(dev):
        ins = [aligned16(t) for t in ins]
        ins.insert(7, _freqs_on(dev, hd))  # after q, qt, qb, k, v, x0, mask
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in ins), B, H, L, hd, x0.shape[-1],
            int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in outs),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counter.launches += 1


def rel_attention_fwd(q, qt, qb, k, v, x0, mask):
    """The forward core: ``(o, oe, lse)``, the operator ``rel_fwd``.
    Tensors on the CPU take :func:`~graphnet_tpu_torch.ops.
    rel_flash_attention.rel_attention_plain`; CUDA tensors launch
    ``csrc/rel_flash_attention.cu`` (counted in
    ``rel_attention_fwd.launches``)."""
    return rel_fwd_op(q, qt, qb, k, v, x0, mask)


def _fwd_cuda(q, qt, qb, k, v, x0, mask):
    _check(q, qt, qb, k, v, x0, mask)
    dev = _cuda_device((q, qt, qb, k, v, x0, mask), "rel_attention")
    _check_kernel(q)
    o = torch.empty(q.shape, dtype=q.dtype, device=dev)
    oe = torch.empty(q.shape, dtype=torch.float32, device=dev)
    lse = torch.empty(qb.shape, dtype=torch.float32, device=dev)
    _launch(_lib(_NAME, "rel_fwd_launch", 8, 3), rel_attention_fwd,
            "rel forward", (q, qt, qb, k, v, x0, mask), (o, oe, lse), q, x0,
            dev)
    return o, oe, lse


rel_attention_fwd.launches = 0


def _bwd_inputs(q, qt, qb, k, v, x0, mask, lse, do, doe, delta):
    """The two backward operators' inputs: ``do`` rounded to q's dtype
    and ``doe`` to fp32."""
    return (q, qt, qb, k, v, x0, mask, lse, do.to(q.dtype), doe.float(),
            delta)


def _check_bwd(q, qt, qb, k, v, x0, mask, lse, do, doe, delta):
    _check(q, qt, qb, k, v, x0, mask)
    _check_grads(q, lse, do, doe, delta)


def _bwd_cuda_device(ins):
    _check_bwd(*ins)
    dev = _cuda_device(ins, "rel_attention_bwd")
    _check_kernel(ins[0])
    return dev


def rel_attention_bwd_dq(q, qt, qb, k, v, x0, mask, lse, do, doe, delta):
    """``(dq, dqt, dqb)`` for the output gradients ``do``, ``doe`` and
    ``delta`` (:func:`rel_attention_delta`), the operator ``rel_bwd_dq``.
    CUDA tensors launch the dq kernel of
    ``csrc/rel_flash_attention_bwd.cu`` (counted in
    ``rel_attention_bwd_dq.launches``); the CPU takes the plain
    backward."""
    return rel_bwd_dq_op(
        *_bwd_inputs(q, qt, qb, k, v, x0, mask, lse, do, doe, delta))


def _dq_cuda(*ins):
    dev = _bwd_cuda_device(ins)
    q, qb = ins[0], ins[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dqt = torch.empty(q.shape, dtype=torch.float32, device=dev)
    dqb = torch.empty(qb.shape, dtype=torch.float32, device=dev)
    _launch(_lib(_BWD_NAME, "rel_bwd_dq_launch", 12, 3), rel_attention_bwd_dq,
            "rel dq", ins, (dq, dqt, dqb), q, ins[5], dev)
    return dq, dqt, dqb


rel_attention_bwd_dq.launches = 0


def rel_attention_bwd_dkv(q, qt, qb, k, v, x0, mask, lse, do, doe, delta):
    """``(dk, dv)``, the operator ``rel_bwd_dkv``, as
    :func:`rel_attention_bwd_dq` (counted in
    ``rel_attention_bwd_dkv.launches``)."""
    return rel_bwd_dkv_op(
        *_bwd_inputs(q, qt, qb, k, v, x0, mask, lse, do, doe, delta))


def _dkv_cuda(*ins):
    dev = _bwd_cuda_device(ins)
    q, k, v = ins[0], ins[3], ins[4]
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    _launch(_lib(_BWD_NAME, "rel_bwd_dkv_launch", 12, 2),
            rel_attention_bwd_dkv, "rel dkv", ins, (dk, dv), q, ins[5], dev)
    return dk, dv


rel_attention_bwd_dkv.launches = 0


class _RelAttention(torch.autograd.Function):
    """The core with its hand-written backward (the counterpart of
    ``jax.custom_vjp`` on ``_rel_core``); x0 and the mask get no
    gradient."""

    @staticmethod
    def forward(ctx, q, qt, qb, k, v, x0, mask):
        q, qt, qb, k, v = (t.contiguous() for t in (q, qt, qb, k, v))
        o, oe, lse = rel_attention_fwd(q, qt, qb, k, v, x0, mask)
        ctx.save_for_backward(q, qt, qb, k, v, x0, mask, o, oe, lse)
        return o, oe

    @staticmethod
    @once_differentiable
    def backward(ctx, do, doe):
        q, qt, qb, k, v, x0, mask, o, oe, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if doe is None:
            doe = torch.zeros_like(oe)
        delta = rel_attention_delta(do.to(q.dtype), o, doe, oe)
        args = (q, qt, qb, k, v, x0, mask, lse, do, doe, delta)
        dq, dqt, dqb = rel_attention_bwd_dq(*args)
        dk, dv = rel_attention_bwd_dkv(*args)
        return dq, dqt, dqb, dk, dv, None, None


def rel_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    x0: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Relative-bias attention, differentiable in q, k, v, weight, bias.

    Args:
        q: ``[B, H, L, hd]``, already scaled; k, v alike (float32 or
            bfloat16; hd in ``HEAD_DIMS`` on CUDA).
        x0: ``[B, L, >=4]`` float32 pulse coordinates (x, y, z, t).
        weight, bias: the SpacetimeEncoder projection (``nn.Linear(hd,
            hd)``: ``rel = emb @ weight.T + bias``).
        key_padding_mask: ``[B, L]`` bool, True = valid key.

    Returns:
        ``[B, L, H, hd]`` float32: ``o + oe @ weight.T + bias``.
    """
    B, H, L, _ = q.shape
    if key_padding_mask is None:
        key_padding_mask = torch.ones((B, L), dtype=torch.bool,
                                      device=q.device)
    # the folds: q.rel = (q @ weight) . emb + q . bias
    qt = torch.matmul(q.float(), weight.float())
    qb = torch.matmul(q.float(), bias.float())
    o, oe = _RelAttention.apply(q, qt, qb, k, v, x0.float(),
                                key_padding_mask)
    out = o.float() + F.linear(oe, weight.float(), bias.float())
    return out.transpose(1, 2)



# ----------------------------------------------------------- operators
# Each implementation checks its inputs (an operator is an entry point of
# its own).  The CPU implementations look the plain versions up at call
# time, so that a test may count their calls by replacing the module
# globals.
def _fwd_cpu(q, qt, qb, k, v, x0, mask):
    _check(q, qt, qb, k, v, x0, mask)
    return rel_attention_plain(q, qt, qb, k, v, x0, mask)


def _fwd_fake(q, qt, qb, k, v, x0, mask):
    return (q.new_empty(q.shape), q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(qb.shape, dtype=torch.float32))


def _dq_cpu(*ins):
    _check_bwd(*ins)
    return rel_attention_bwd_plain(*ins)[:3]


def _dq_fake(q, qt, qb, *rest):
    return (q.new_empty(q.shape), q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(qb.shape, dtype=torch.float32))


def _dkv_cpu(*ins):
    _check_bwd(*ins)
    return rel_attention_bwd_plain(*ins)[3:]


def _dkv_fake(q, qt, qb, k, v, *rest):
    return k.new_empty(k.shape), v.new_empty(v.shape)


_CORE = "Tensor q, Tensor qt, Tensor qb, Tensor k, Tensor v, Tensor x0, Tensor mask"
_BWD = f"{_CORE}, Tensor lse, Tensor g_o, Tensor g_oe, Tensor delta"
rel_fwd_op = library.define(
    f"rel_fwd({_CORE}) -> (Tensor, Tensor, Tensor)",
    _fwd_cpu, _fwd_cuda, _fwd_fake)
rel_bwd_dq_op = library.define(
    f"rel_bwd_dq({_BWD}) -> (Tensor, Tensor, Tensor)",
    _dq_cpu, _dq_cuda, _dq_fake)
rel_bwd_dkv_op = library.define(
    f"rel_bwd_dkv({_BWD}) -> (Tensor, Tensor)", _dkv_cpu, _dkv_cuda,
    _dkv_fake)
