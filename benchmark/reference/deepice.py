"""Plain PyTorch fp32 reference of the Kaggle IceMix DeepIce with a
``DirectionReconstructionWithKappa`` head, for the check that decides
``correct``.  It imports nothing of the program: it reads the layout from
the configuration's frozen ``model.yml`` and takes the weights by the
program's parameter names.

What it computes (DeepIce as GraphNeT publishes it, laid out as
``graphnet_tpu_torch/models/gnn/icemix.py`` lays it out on dense-padded
events, every attention dense and materialised):

* the Fourier embedding of each pulse: sinusoids of 4096 x, y, z, 1024
  charge and 4096 time, the auxiliary flag's table and the sinusoid of
  log10 of the event length, then a dense layer, LayerNorm (eps 1e-5),
  exact GELU and a dense layer;
* ``depth_rel`` pre-norm blocks (LayerNorm eps 1e-6) of BEiTv2 attention
  (q and v with a bias, q scaled by ``hd ** -0.5``) and a GELU MLP; the
  first ``n_rel`` add the pair features ``rel_ij`` (the sinusoidal
  embedding of ``1024 clip(signed sqrt(dx^2 + dy^2 + dz^2 - (18 dt)^2),
  -4, 4)``, then a dense layer) to each logit as ``q_i . rel_ij`` and to
  each output as ``sum_j a_ij rel_ij``;
* a learned cls token before the pulses, ``depth`` pre-norm blocks with
  layer scales, and the head on the cls token's state: ``x / (|x| +
  eps)`` and ``kappa = |x| + eps``; the loss the 3-D von Mises-Fisher
  negative log-likelihood.

Masked keys take the float32 minimum before the softmax.  The constants
of the sinusoids and the pair argument are frozen copies of
``graphnet_tpu_torch/models/components/embedding.py:25-48`` and
``graphnet_tpu_torch/ops/rel_flash_attention.py:47-121``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1.1920929e-07
_C = 3e4 / 500 * 3e-1
_CLIP = 4.0
_ARG_SCALE = 1024.0


def init_std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """Mean and standard deviation of a leaf's seeded weights: LeCun
    normal ``[out, in]`` dense weights, N(0, 1) for the cls token and the
    auxiliary table, N(1, 0.1) for layer norm scales and layer scales,
    N(0, 0.1) for biases."""
    if name.endswith(("cls_token", "aux_emb.embedding")):
        return 0.0, 1.0
    if len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[1])
    last = name.rsplit(".", 1)[-1]
    if last in ("gamma_1", "gamma_2") or (
            last == "weight" and ("norm" in name.rsplit(".", 2)[-2])):
        return 1.0, 0.1
    return 0.0, 0.1


def freqs(dim: int, device) -> torch.Tensor:
    half = dim // 2
    log_nf = np.float32(np.log(np.float32(10000.0)))
    step = torch.tensor(np.float32(-log_nf / np.float32(half)))
    return torch.exp(torch.arange(half, dtype=torch.float32) * step).to(device)


def sin_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    arg = x[..., None] * freqs(dim, x.device)
    return torch.cat([torch.sin(arg), torch.cos(arg)], -1)


def pair_emb(x0: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B, L, L, dim]`` sinusoids of the clipped signed spacetime
    interval between every two pulses."""
    xq = x0[..., :4].float()
    d = xq[:, :, None, :] - xq[:, None, :, :]
    s = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    dt = d[..., 3] * _C
    s = s - dt * dt
    root = torch.sqrt(s.abs().double()).float()
    arg = _ARG_SCALE * (torch.sign(s) * root).clamp(-_CLIP, _CLIP)
    return sin_emb(arg, dim)


def _log_sinh_over_x(x):
    small = x < 0.1
    xb = torch.where(small, 1.0, x)
    big = xb + torch.log1p(-torch.exp(-2.0 * xb)) - math.log(2.0) - torch.log(xb)
    x2 = x * x
    return torch.where(small, x2 / 6.0 - x2 * x2 / 180.0, big)


def log_c3(kappa: torch.Tensor, switch: float = 100.0) -> torch.Tensor:
    """``log C_3(kappa)`` of the von Mises-Fisher density on the sphere,
    exact below ``switch`` and the asymptotic form (arXiv:1812.04616
    section 8.2), shifted to meet it, above."""

    def exact(k):
        return -math.log(4.0 * math.pi) - _log_sinh_over_x(k)

    def approx(k):
        a = torch.sqrt(2.0 ** 2 + k * k)
        return -a + 0.0 * torch.log(a)

    ks = torch.tensor(switch, device=kappa.device)
    offset = approx(ks) - exact(ks)
    lo = torch.clamp_max(kappa, switch)
    return torch.where(kappa < switch, exact(lo), approx(kappa) - offset)


class Model:
    """The reference of one configuration: ``Model(model_cfg, weights)``."""

    def __init__(self, model_cfg: Dict, weights: Dict[str, torch.Tensor]):
        a = model_cfg["arguments"]["backbone"]["__model__"]["arguments"]
        (task,) = model_cfg["arguments"]["tasks"]
        task = task["__model__"]
        if (task["class_name"] != "DirectionReconstructionWithKappa"
                or task["arguments"]["loss_function"]["__model__"]["class_name"]
                != "VonMisesFisher3DLoss"):
            raise NotImplementedError("the direction task of IceMix")
        if a.get("include_dynedge") or a.get("scaled_emb"):
            raise NotImplementedError("DeepIce with DynEdge or scaled embeddings")
        self.D = int(a["hidden_dim"])
        self.hd = int(a["head_size"])
        self.H = self.D // self.hd
        self.seq = int(a["seq_length"])
        self.depth, self.depth_rel, self.n_rel = (
            int(a["depth"]), int(a["depth_rel"]), int(a["n_rel"]))
        self.target = task["arguments"]["target_labels"][0]
        self.w = weights

    def _dense(self, name, x, bias=True):
        return F.linear(x, self.w[f"{name}.weight"],
                        self.w.get(f"{name}.bias") if bias else None)

    def _norm(self, name, x, eps):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], eps)

    def _fourier(self, x, n):
        B, L, _ = x.shape
        p = "backbone.fourier_ext"
        s = self.seq
        aux = self.w[f"{p}.aux_emb.embedding"][x[:, :, 5].long().clamp(0, 1)]
        length = sin_emb(torch.log10(n.clamp_min(1).float()), s // 2)
        h = torch.cat([sin_emb(4096.0 * x[:, :, :3], s).reshape(B, L, -1),
                       sin_emb(1024.0 * x[:, :, 4], s),
                       sin_emb(4096.0 * x[:, :, 3], s), aux,
                       length[:, None, :].expand(B, L, -1)], -1)
        h = F.gelu(self._norm(f"{p}.mlp_norm", self._dense(f"{p}.mlp_0", h), 1e-5))
        return self._dense(f"{p}.mlp_1", h)

    def _attend(self, q, k, v, keys, rel=None):
        """``[B, H, L, hd]`` q (scaled), k, v; ``rel [B, L, L, hd]``."""
        logits = q @ k.transpose(-1, -2)
        if rel is not None:
            logits = logits + torch.einsum("bhic,bijc->bhij", q, rel)
        logits = torch.where(keys[:, None, None, :], logits,
                             torch.finfo(torch.float32).min)
        a = torch.softmax(logits, -1)
        out = a @ v
        if rel is not None:
            out = out + torch.einsum("bhij,bijc->bhic", a, rel)
        B, H, L, hd = out.shape
        return out.transpose(1, 2).reshape(B, L, H * hd)

    def _heads(self, t):
        B, L, _ = t.shape
        return t.reshape(B, L, self.H, self.hd).transpose(1, 2)

    def _mlp(self, p, x):
        return self._dense(f"{p}.mlp.fc2", F.gelu(self._dense(f"{p}.mlp.fc1", x)))

    def forward(self, x0: torch.Tensor, mask: torch.Tensor,
                n_pulses: torch.Tensor) -> torch.Tensor:
        """The head's ``[B, 4]`` (direction, kappa)."""
        x = self._fourier(x0, n_pulses)
        rel = None
        if self.n_rel > 0 and self.depth_rel > 0:
            rel = self._dense("backbone.rel_pos.projection",
                              pair_emb(x0, self.hd))
        for i in range(self.depth_rel):
            p = f"backbone.sandwich_{i}"
            h = self._norm(f"{p}.norm1", x, 1e-6)
            q = self._heads(self._dense(f"{p}.attn.proj_q", h)) * self.hd ** -0.5
            k = self._heads(self._dense(f"{p}.attn.proj_k", h, bias=False))
            v = self._heads(self._dense(f"{p}.attn.proj_v", h))
            att = self._attend(q, k, v, mask, rel if i < self.n_rel else None)
            x = x + self._dense(f"{p}.attn.proj", att)
            x = x + self._mlp(p, self._norm(f"{p}.norm2", x, 1e-6))
        B = x.shape[0]
        cls = self.w["backbone.cls_token"][None].expand(B, 1, self.D)
        x = torch.cat([cls, x], 1)
        keys = torch.cat([torch.ones_like(mask[:, :1]), mask], 1)
        for i in range(self.depth):
            p = f"backbone.blocks_{i}"
            h = self._norm(f"{p}.norm1", x, 1e-6)
            q, k, v = self._dense(f"{p}.attn.qkv", h).split(self.D, -1)
            att = self._attend(self._heads(q) * self.hd ** -0.5, self._heads(k),
                               self._heads(v), keys)
            x = x + self.w[f"{p}.gamma_1"] * self._dense(f"{p}.attn.out", att)
            x = x + self.w[f"{p}.gamma_2"] * self._mlp(
                p, self._norm(f"{p}.norm2", x, 1e-6))
        y = self._dense("tasks_0.affine", x[:, 0])
        kappa = torch.linalg.vector_norm(y, dim=1) + EPS
        return torch.cat([y / kappa[:, None], kappa[:, None]], 1)

    def answer(self, pred: torch.Tensor) -> torch.Tensor:
        return pred

    @staticmethod
    def answer_scale(answers):
        """The scale of a served answer's gap: 1 for the unit direction's
        components, kappa itself for kappa."""
        scale = abs(answers).copy()
        scale[:, :3] = 1.0
        return scale

    def loss(self, pred: torch.Tensor, labels: Dict[str, torch.Tensor],
             rows: slice = slice(None)) -> torch.Tensor:
        """Mean von Mises-Fisher 3-D loss over the events ``rows``."""
        p = (pred[:, 3:4] * pred[:, :3])[rows]
        t = labels[self.target][rows].float().reshape(-1, 3)
        k = torch.linalg.vector_norm(p, dim=1)
        return (-log_c3(k) - (p * t).sum(1)).mean()
