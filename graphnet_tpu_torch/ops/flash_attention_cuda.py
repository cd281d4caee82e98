"""Flash-attention kernels for Hopper (forward, dQ, dK/dV), and their
plain PyTorch versions.

Replaces ``graphnet_tpu/ops/flash_attention.py``: ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind the custom VJP of
``flash_attention``.  The kernels are ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``; their header notes say what bounds each
on the H100 and what the design does about it.

Exact masked softmax attention over ``[B, H, L, Dh]`` tensors with a
``[B, L]`` key mask (True = valid key), with the TPU kernel's numerics:

* q is scaled in its own dtype, ``q * scale`` (default ``1/sqrt(Dh)``),
  before the product; logits are fp32;
* a masked key's logit is ``NEG = -1e5`` (not ``-inf``), so a query row
  with no valid key comes out uniform over the L keys, with
  ``lse = NEG + log(L)``, and the backward's recompute
  ``p = exp(logit - lse)`` gives ``1/L`` there, with no NaN;
* softmax statistics and accumulators are fp32; with bf16 inputs p is
  rounded to bf16 before ``P.V`` and ``o`` is written in bf16;
* backward: ``delta = sum(g * o)`` in fp32 (plain PyTorch, outside the
  kernels), ``ds = p * (dp - delta) * valid`` (a masked key passes no
  gradient through its logit; ``dv`` still takes its p), ``dq`` scaled
  once at the end, ``dk = ds^T (q * scale)`` with no second scale.

The TPU wrapper pads a ragged L to lane tiles (``_pick_pad``); the
kernels here do not, and follow the dense formula: a fully masked row at
a ragged L reads ``sum(v) / L`` where the JAX flash path reads
``sum(v) / Lp`` over its padded length.

:func:`flash_attention` is a ``torch.autograd.Function`` on both
devices that calls the operators ``torch.ops.graphnet_tpu_torch.
flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
(:mod:`~graphnet_tpu_torch.ops.library`): tensors on the CPU take the
plain forward and backward (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`), CUDA tensors launch the kernels, and
raise on what the kernels do not take.  There is no fallback from CUDA
to the plain versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from graphnet_tpu_torch.ops import library

NEG = -1e5
HEAD_DIMS = (16, 32, 64)  # head dims the kernels are built for
_NAME = "flash_attention"
_BWD_NAME = "flash_attention_bwd"


def supported(head_dim: int) -> bool:
    """Whether the kernels take this head dim (the gate of
    ``MultiHeadAttention``, the same on both devices)."""
    return head_dim in HEAD_DIMS


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` in q's dtype (the scale rounded to it first)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _masked_logits(qs, k, mask):
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    return torch.where(mask[:, None, None, :], logits, NEG)


def _full_mask(q: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        B, _, L, _ = q.shape
        return torch.ones((B, L), dtype=torch.bool, device=q.device)
    return mask


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``(o [B, H, L, Dh]``
    in q's dtype, ``lse [B, H, L]`` fp32), from the dense formulation
    with the kernel's mask value, scale and rounding points."""
    mask = _full_mask(q, key_padding_mask)
    dt = q.dtype
    logits = _masked_logits(_scaled_q(q, _scale(q, scale)), k, mask)
    m = logits.amax(dim=-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(dt).float(), v.float()) / l
    return o.to(dt), (m + torch.log(l))[..., 0]


def attention_delta(g: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = sum(g * o)`` over the head dim, fp32 ``[B, H, L]``."""
    return (g.float() * o.float()).sum(dim=-1)


def _bwd_plain(q, k, v, mask, lse, g, delta, scale, out_dtype=None):
    dt = q.dtype
    qs = _scaled_q(q, scale)
    p = torch.exp(_masked_logits(qs, k, mask) - lse[..., None])
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    valid = mask[:, None, None, :].float()
    ds = (p * (dp - delta[..., None]) * valid).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g.float())
    return (dq.to(out_dtype or dt), dk.to(out_dtype or k.dtype),
            dv.to(out_dtype or v.dtype))


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` in
    the inputs' dtypes, recomputing the probabilities from ``lse``.
    ``out_dtype=torch.float32`` returns them before that last rounding
    (the values a kernel's bf16 gradients are held to)."""
    mask = _full_mask(q, key_padding_mask)
    return _bwd_plain(
        q, k, v, mask, lse, g.to(q.dtype), attention_delta(g, o),
        _scale(q, scale), out_dtype,
    )


# ------------------------------------------------------------- kernels
def _lib(name: str, fn_name: str, n_ptr_in: int, n_ptr_out: int):
    from graphnet_tpu_torch.kernels import build

    lib = build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:  # first use: declare the C signature
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P] * n_ptr_in + [I] * 4 + [ctypes.c_float, I]
                       + [P] * n_ptr_out + [P])
        fn.restype = ctypes.c_int
    return fn


def _cuda_device(tensors, what: str) -> torch.device:
    """The CUDA device of a kernel's tensors, all on one; raises
    otherwise (a CUDA implementation never takes CPU tensors)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{what} takes tensors all on one CUDA device (or all on the "
            f"CPU); got {[str(t.device) for t in tensors]}"
        )
    return dev


def _check(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "q, k and v must share one [B, H, L, Dh] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"q, k and v must share one dtype; got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    B, _, L, _ = q.shape
    if mask is not None and (mask.shape != (B, L) or mask.dtype != torch.bool):
        raise ValueError(
            f"key_padding_mask must be bool [B, L] = {(B, L)}; got "
            f"{mask.dtype} {tuple(mask.shape)}"
        )


def _check_stats(q, lse, g, delta):
    B, H, L, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, L) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 [B, H, L] = {(B, H, L)}; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if g.shape != q.shape:
        raise ValueError(
            f"g must be shaped like q {tuple(q.shape)}; got {tuple(g.shape)}"
        )


def _check_kernel(q):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the flash kernels take float32 or bfloat16, got {q.dtype}"
        )
    if not supported(q.shape[-1]):
        raise ValueError(
            f"the flash kernels take head dims {HEAD_DIMS}, got "
            f"{q.shape[-1]}"
        )


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data 16-byte aligned, as the kernels'
    ``cp.async`` copies need: ``t`` itself when it is, else a copy
    (a contiguous view whose storage offset is not a multiple of 16
    bytes is copied)."""
    t = t.contiguous()
    if t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _launch(fn, counter, name, ins, outs, q, scale, dev):
    """Call a kernel's C entry on ``ins`` (made contiguous and 16-byte
    aligned), writing into the fresh ``outs``; raises on a launch
    error."""
    B, H, L, Dh = q.shape
    with torch.cuda.device(dev):
        ins = [aligned16(t) for t in ins]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in ins), B * H, H, L, Dh, float(scale),
            int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in outs),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counter.launches += 1


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward: ``(o, lse)``, the operator ``flash_fwd``.  Tensors on
    the CPU take :func:`flash_attention_plain`; CUDA tensors launch
    ``csrc/flash_attention.cu`` (counted in
    ``flash_attention_fwd.launches``)."""
    return flash_fwd_op(q, k, v, key_padding_mask, scale)


def _fwd_cuda(q, k, v, key_padding_mask, scale):
    _check(q, k, v, key_padding_mask)
    mask = _full_mask(q, key_padding_mask)
    dev = _cuda_device((q, k, v, mask), "flash_attention")
    _check_kernel(q)
    B, H, L, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    _launch(_lib(_NAME, "flash_fwd_launch", 4, 2), flash_attention_fwd,
            "flash forward", (q, k, v, mask), (o, lse), q, _scale(q, scale),
            dev)
    return o, lse


flash_attention_fwd.launches = 0


def _bwd_cuda_device(q, k, v, key_padding_mask, lse, g, delta):
    """``(mask, device)`` of a backward call on the card, its inputs
    checked for the kernels."""
    _check(q, k, v, key_padding_mask)
    _check_stats(q, lse, g, delta)
    mask = _full_mask(q, key_padding_mask)
    dev = _cuda_device((q, k, v, mask, lse, g, delta), "flash_attention_bwd")
    _check_kernel(q)
    return mask, dev


def _bwd_plain_ops(q, k, v, key_padding_mask, lse, g, delta, scale):
    _check(q, k, v, key_padding_mask)
    _check_stats(q, lse, g, delta)
    return _bwd_plain(q, k, v, _full_mask(q, key_padding_mask), lse, g, delta,
                      _scale(q, scale))


def flash_attention_bwd_dq(q, k, v, key_padding_mask, lse, g, delta,
                           scale=None) -> torch.Tensor:
    """dQ for the output gradient ``g`` (q's dtype) and ``delta``
    (:func:`attention_delta`), the operator ``flash_bwd_dq``.  CUDA
    tensors launch the dq kernel of ``csrc/flash_attention_bwd.cu``
    (counted in ``flash_attention_bwd_dq.launches``); the CPU takes the
    plain backward."""
    return flash_bwd_dq_op(q, k, v, key_padding_mask, lse, g, delta, scale)


def _dq_cuda(q, k, v, key_padding_mask, lse, g, delta, scale):
    mask, dev = _bwd_cuda_device(q, k, v, key_padding_mask, lse, g, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _launch(_lib(_BWD_NAME, "flash_bwd_dq_launch", 7, 1),
            flash_attention_bwd_dq, "flash dq",
            (q, k, v, mask, lse, g.to(q.dtype), delta), (dq,), q,
            _scale(q, scale), dev)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, key_padding_mask, lse, g, delta,
                            scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``, the operator ``flash_bwd_dkv``, as
    :func:`flash_attention_bwd_dq` (counted in
    ``flash_attention_bwd_dkv.launches``)."""
    return flash_bwd_dkv_op(q, k, v, key_padding_mask, lse, g, delta, scale)


def _dkv_cuda(q, k, v, key_padding_mask, lse, g, delta, scale):
    mask, dev = _bwd_cuda_device(q, k, v, key_padding_mask, lse, g, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    _launch(_lib(_BWD_NAME, "flash_bwd_dkv_launch", 7, 2),
            flash_attention_bwd_dkv, "flash dkv",
            (q, k, v, mask, lse, g.to(q.dtype), delta), (dk, dv), q,
            _scale(q, scale), dev)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, key_padding_mask, o, lse, g, scale=None):
    """The backward: ``(dq, dk, dv)``: ``delta`` in plain PyTorch, then
    the dq and the dkv wrappers (the kernels on CUDA, the plain backward
    on the CPU)."""
    delta = attention_delta(g, o)
    g = g.to(q.dtype)
    dq = flash_attention_bwd_dq(q, k, v, key_padding_mask, lse, g, delta, scale)
    dk, dv = flash_attention_bwd_dkv(
        q, k, v, key_padding_mask, lse, g, delta, scale
    )
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward (the counterpart of
    ``jax.custom_vjp`` on ``_flash_bh``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, o, lse, g, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention, differentiable in q, k and v.

    Args:
        q, k, v: ``[B, H, L, Dh]``, float32 or bfloat16 (Dh 16, 32 or 64 on
            CUDA).
        key_padding_mask: ``[B, L]`` bool, True = valid key.
        scale: logits scale; default ``1/sqrt(Dh)``.

    Returns:
        ``[B, H, L, Dh]`` in q's dtype.
    """
    return _FlashAttention.apply(q, k, v, key_padding_mask, scale)


# ----------------------------------------------------------- operators
# Each implementation checks its inputs (an operator is an entry point of
# its own).  The CPU implementations look the plain versions up at call
# time, so that a test may count their calls by replacing the module
# globals.
def _fwd_cpu(q, k, v, key_padding_mask, scale):
    _check(q, k, v, key_padding_mask)
    return flash_attention_plain(q, k, v, key_padding_mask, scale)


def _fwd_fake(q, k, v, key_padding_mask, scale):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)


def _dq_cpu(q, k, v, key_padding_mask, lse, g, delta, scale):
    return _bwd_plain_ops(q, k, v, key_padding_mask, lse, g, delta, scale)[0]


def _dq_fake(q, k, v, key_padding_mask, lse, g, delta, scale):
    return q.new_empty(q.shape)


def _dkv_cpu(q, k, v, key_padding_mask, lse, g, delta, scale):
    return _bwd_plain_ops(q, k, v, key_padding_mask, lse, g, delta, scale)[1:]


def _dkv_fake(q, k, v, key_padding_mask, lse, g, delta, scale):
    return k.new_empty(k.shape), v.new_empty(v.shape)


_QKV = "Tensor q, Tensor k, Tensor v, Tensor? key_padding_mask"
_BWD = f"{_QKV}, Tensor lse, Tensor g, Tensor delta, float? scale"
flash_fwd_op = library.define(
    f"flash_fwd({_QKV}, float? scale) -> (Tensor, Tensor)",
    _fwd_cpu, _fwd_cuda, _fwd_fake)
flash_bwd_dq_op = library.define(
    f"flash_bwd_dq({_BWD}) -> Tensor", _dq_cpu, _dq_cuda, _dq_fake)
flash_bwd_dkv_op = library.define(
    f"flash_bwd_dkv({_BWD}) -> (Tensor, Tensor)", _dkv_cpu, _dkv_cuda,
    _dkv_fake)
