"""Relative-bias attention of DeepIce: the pair embedding, the plain
streaming forward and backward, and the gate of the kernels
(counterpart of ``graphnet_tpu/ops/rel_flash_attention.py``).

DeepIce's first ``BlockRel`` adds to each logit, and to each output, a
pair feature ``rel[b, i, j] = emb_ij @ W + b``, where ``emb_ij`` is the
sinusoidal embedding of the signed spacetime interval between pulses
``i`` and ``j``.  Two folds make it streamable without the ``[B, L, L,
e]`` tensor, as in the JAX package:

* relative key: ``q_i . rel_ij = (q_i @ W^T) . emb_ij + q_i . b``, so the
  core takes ``qt = q @ W^T`` and ``qb = q . b`` per head;
* relative value: the softmax rows sum to 1, so ``sum_j a_ij rel_ij =
  (sum_j a_ij emb_ij) @ W + b``; the core returns ``oe = sum_j a_ij
  emb_ij`` and the caller applies ``oe @ W + b`` once.

The core's contract (the kernels' and the plain versions' alike), per
``[B, H, L, d]`` head tensors with ``q`` already scaled:

* logits ``q.k + qt.emb + qb`` in fp32; a masked key's logit is exactly
  ``NEG = -1e5``, so a query row with no valid key comes out uniform
  over the L keys (``o`` the mean of ``v``, ``oe`` the mean of ``emb``)
  with ``lse = NEG + log(L)``;
* online softmax over key tiles of ``KEY_TILE``, running max from
  ``NEG``, ``l`` clamped at ``1e-30``; ``o`` in q's dtype, ``oe`` and
  ``lse`` in fp32;
* in bf16, ``p`` is rounded to bf16 before ``p.v`` (and ``ds`` before
  ``ds.k``, ``ds.q``; ``p`` before ``p.do`` in the backward) while
  ``qt.emb`` and ``p.emb`` stay fp32;
* backward by the extended-value recompute: ``p = exp(logit - lse)``,
  ``dp = do.v + doe.emb``, ``ds = p (dp - delta) valid`` with ``delta =
  do.o + doe.oe``; ``dq = ds.k``, ``dqt = ds.emb``, ``dqb = sum ds``,
  ``dk = ds^T q``, ``dv = p^T do``.  ``x0`` and the mask get no gradient.

Unlike the JAX package this takes any L: the Mosaic tile rule
``L % 128 == 0`` of its gate is a TPU constraint.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# light speed in the scaled detector units, the clip of the signed
# interval and the scale of the sinusoid's argument (the JAX package's
# SpacetimeEncoder constants)
_C = 3e4 / 500 * 3e-1
_CLIP = 4.0
_ARG_SCALE = 1024.0
NEG = -1e5
# keys per tile of the online softmax, in the kernels and here (the same
# tiling makes the bf16 roundings of p against the running max agree)
KEY_TILE = 16
# head dims the kernels are built for (the pair-feature dim equals it)
HEAD_DIMS = (16, 32, 64)


def supported(head_dim: int, pair_dim: int) -> bool:
    """The gate of the rel kernels, the same on both devices: the
    relative-value fold needs the pair-feature dim equal to the head dim,
    the sin/cos halves an even dim, and the kernels are built for
    ``HEAD_DIMS``.  Any L."""
    return pair_dim == head_dim and head_dim in HEAD_DIMS


def pair_distance(x_q: torch.Tensor, x_k: torch.Tensor) -> torch.Tensor:
    """Signed sqrt spacetime interval between two sets of pulses,
    clipped to +-4 and scaled by 1024: ``[B, Lq, >=4], [B, Lk, >=4] ->
    [B, Lq, Lk]`` fp32.

    Per-coordinate differences, then squares, summed in the order x, y,
    z, then the time term subtracted: the quadratic expansion
    ``|a|^2 + |b|^2 - 2ab`` cancels near the light cone, and the x1024
    and the sinusoid amplify that.  The CUDA kernels round at the same
    points (no contraction into FMAs)."""
    xq = x_q[..., :4].float()
    xk = x_k[..., :4].float()
    d = xq[:, :, None, :] - xk[:, None, :, :]
    interval = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    dt = d[..., 3] * _C
    interval = interval - dt * dt
    # the sqrt through float64: torch's vectorised float32 sqrt on the CPU
    # is not correctly rounded (1 ulp off in ~0.7% of values, measured
    # with AVX-512), and x1024 * f makes one ulp of d visible downstream
    root = torch.sqrt(interval.abs().double()).float()
    dist = torch.sign(interval) * root
    return _ARG_SCALE * dist.clamp(-_CLIP, _CLIP)


def _freqs(dim: int) -> np.ndarray:
    """Geometric frequencies of the sinusoidal embedding, bit for bit
    the JAX package's (the log of 10000 rounded to fp32 first)."""
    half = dim // 2
    log_nf = np.float32(np.log(np.float32(10000.0)))
    return np.exp(
        np.arange(half, dtype=np.float32)
        * np.float32(-log_nf / np.float32(half))
    )


def sinusoidal_pair_emb(d: torch.Tensor, dim: int) -> torch.Tensor:
    """``[...] -> [..., dim]``: ``[sin(d f), cos(d f)]``, fp32."""
    f = torch.from_numpy(_freqs(dim)).to(d.device)
    arg = d[..., None] * f
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


def _tile_emb(x0, s, e, tile):
    """The pair embedding of every query against keys ``[s, s+tile)``:
    ``[B, L, t, e]``."""
    return sinusoidal_pair_emb(pair_distance(x0, x0[:, s:s + tile]), e)


def _logits(qf, qt, qb, kf, emb, valid):
    s = torch.matmul(qf, kf.transpose(-1, -2))
    s = s + torch.einsum("bhie,bije->bhij", qt, emb) + qb[..., None]
    return torch.where(valid[:, None, None, :], s, NEG)


def rel_attention_plain(
    q: torch.Tensor,
    qt: torch.Tensor,
    qb: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    x0: torch.Tensor,
    mask: torch.Tensor,
    tile: int = KEY_TILE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``(o [B, H, L, hd]``
    in q's dtype, ``oe [B, H, L, e]`` fp32, ``lse [B, H, L]`` fp32),
    streamed over key tiles with the kernel's contract (module
    docstring).  ``q, k, v [B, H, L, hd]`` (q scaled), ``qt [B, H, L,
    e]``, ``qb [B, H, L]``, ``x0 [B, L, >=4]``, ``mask [B, L]`` bool."""
    B, H, L, hd = q.shape
    e = qt.shape[-1]
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, qb = qt.float(), qb.float()
    m = torch.full((B, H, L), NEG, device=q.device)
    l = torch.zeros((B, H, L), device=q.device)
    o = torch.zeros((B, H, L, hd), device=q.device)
    oe = torch.zeros((B, H, L, e), device=q.device)
    for s in range(0, L, tile):
        emb = _tile_emb(x0, s, e, tile)
        logits = _logits(qf, qt, qb, kf[:, :, s:s + tile], emb,
                         mask[:, s:s + tile])
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)[..., None]
        p = torch.exp(logits - m_new[..., None])
        l = l * corr[..., 0] + p.sum(dim=-1)
        o = o * corr + torch.matmul(p.to(dt).float(), vf[:, :, s:s + tile])
        oe = oe * corr + torch.einsum("bhij,bije->bhie", p, emb)
        m = m_new
    ls = l.clamp_min(1e-30)
    return (o / ls[..., None]).to(dt), oe / ls[..., None], m + torch.log(ls)


def rel_attention_delta(do, o, doe, oe) -> torch.Tensor:
    """``delta = do.o + doe.oe`` per head, fp32 ``[B, H, L]``."""
    return (do.float() * o.float()).sum(-1) + (doe.float() * oe.float()).sum(-1)


def rel_attention_bwd_plain(
    q, qt, qb, k, v, x0, mask, lse, do, doe, delta, tile: int = KEY_TILE,
    out_dtype=None,
):
    """Plain PyTorch version of the backward kernels: ``(dq, dqt, dqb,
    dk, dv)``, dq/dk/dv in the inputs' dtypes, dqt and dqb fp32, from
    the forward's ``lse``, the output gradients ``do`` (rounded to q's
    dtype) and ``doe`` and :func:`rel_attention_delta`.
    ``out_dtype=torch.float32`` returns dq, dk and dv before their last
    rounding (the values a kernel's bf16 gradients are held to)."""
    B, H, L, hd = q.shape
    e = qt.shape[-1]
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, qb = qt.float(), qb.float()
    do = do.to(dt).float()
    doe = doe.float()
    dq = torch.zeros((B, H, L, hd), device=q.device)
    dqt = torch.zeros((B, H, L, e), device=q.device)
    dqb = torch.zeros((B, H, L), device=q.device)
    dk = torch.empty((B, H, L, hd), device=q.device)
    dv = torch.empty((B, H, L, hd), device=q.device)
    for s in range(0, L, tile):
        sl = slice(s, s + tile)
        emb = _tile_emb(x0, s, e, tile)
        valid = mask[:, sl]
        p = torch.exp(_logits(qf, qt, qb, kf[:, :, sl], emb, valid)
                      - lse[..., None])
        dp = torch.matmul(do, vf[:, :, sl].transpose(-1, -2))
        dp = dp + torch.einsum("bhie,bije->bhij", doe, emb)
        ds = p * (dp - delta[..., None]) * valid[:, None, None, :].float()
        ds_t = ds.to(dt).float()
        dq = dq + torch.matmul(ds_t, kf[:, :, sl])
        dqt = dqt + torch.einsum("bhij,bije->bhie", ds, emb)
        dqb = dqb + ds.sum(dim=-1)
        dk[:, :, sl] = torch.matmul(ds_t.transpose(-1, -2), qf)
        dv[:, :, sl] = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    return (dq.to(out_dtype or dt), dqt, dqb, dk.to(out_dtype or k.dtype),
            dv.to(out_dtype or v.dtype))
