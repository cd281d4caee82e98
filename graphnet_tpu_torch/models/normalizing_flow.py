"""Conditional density models on backbone latents (counterpart of
``graphnet_tpu/models/normalizing_flow.py``).

:class:`NormalizingFlow`: per target dimension, a stack of conditional
[affine -> elementwise transform] layers whose parameters a small
conditioner predicts from the backbone's latents (and optional label
columns).  Two transform families (``transform=``): the two-parameter
``"sinh_arcsinh"`` skew/tail family, and ``"spline"``, monotone
rational-quadratic splines with linear tails (Durkan et al., Neural
Spline Flows, arXiv:1906.04032).  Every transform is inverted in closed
form with its log-determinant, so the exact negative log-likelihood
trains end to end.

:class:`SphericalFlow`: a conditional mixture of von Mises-Fisher
densities on the unit sphere for directions, normalised through the vMF
``log C_3`` of :mod:`~graphnet_tpu_torch.training.loss_functions`.

Both follow the Trainer's contract (``forward(batch) -> nllh [B]``,
``loss_from_batch``, ``prediction_labels``, ``tasks``), and their
parameters carry the JAX names (``cond_norm``, ``cond_0``, ``cond_1``),
so ``utils.jax_params.params_from_jax`` maps the JAX tree onto them.
Parameters are initialised from ``torch.Generator().manual_seed(seed)``
on the CPU and moved to ``device`` (the GPU unless the caller asks for
the CPU); the conditioner's last kernel starts at zero, so a new flow is
the base density.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.device import DeviceLike, resolve_device
from graphnet_tpu_torch.models.components.layers import init_parameters
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.training.loss_functions import log_cmk
from graphnet_tpu_torch.utils.config import save_config

_LOG_2PI = math.log(2.0 * math.pi)
# softplus(c) == 1: zero raw derivatives give the spline slope 1
_SOFTPLUS_INV_1 = float(np.log(np.e - 1.0))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` without a threshold (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sinh_arcsinh(z, eps, delta):
    """``x = sinh(delta * arcsinh(z) + eps)``, invertible for delta > 0."""
    return torch.sinh(delta * torch.asinh(z) + eps)


def _sinh_arcsinh_inv_and_logdet(x, eps, delta):
    """The inverse of :func:`_sinh_arcsinh` and its log-determinant."""
    z = torch.sinh((torch.asinh(x) - eps) / delta)
    u = delta * torch.asinh(z) + eps
    logdet_fwd = (torch.log(torch.cosh(u)) + torch.log(delta)
                  - 0.5 * torch.log1p(z * z))
    return z, -logdet_fwd


def _rqs_prepare(raw: torch.Tensor, n_bins: int, bound: float):
    """Raw spline parameters ``[..., 3K-1]`` -> (x edges, y edges,
    derivatives) of a monotone rational-quadratic spline on ``[-bound,
    bound]``; zero parameters give the identity."""
    K = n_bins
    w, h, d = raw[..., :K], raw[..., K:2 * K], raw[..., 2 * K:]
    min_frac = 1e-3  # no bin collapses
    widths = min_frac + (1 - min_frac * K) * torch.softmax(w, dim=-1)
    heights = min_frac + (1 - min_frac * K) * torch.softmax(h, dim=-1)

    def edges(sizes):
        e = torch.cumsum(sizes, dim=-1) * (2 * bound) - bound
        return torch.cat([torch.full_like(e[..., :1], -bound), e], dim=-1)

    # interior derivatives > 0; the boundary ones pinned to 1, so the
    # spline meets the identity tails with a continuous slope
    d_in = _softplus(d + _SOFTPLUS_INV_1)
    ones = torch.ones_like(d_in[..., :1])
    return edges(widths), edges(heights), torch.cat([ones, d_in, ones], dim=-1)


def _rqs_bin_quantities(edges_x, edges_y, derivs, idx):
    def take(t, i):
        return torch.gather(t, -1, i[..., None])[..., 0]

    x_k, x_k1 = take(edges_x, idx), take(edges_x, idx + 1)
    y_k, y_k1 = take(edges_y, idx), take(edges_y, idx + 1)
    d_k, d_k1 = take(derivs, idx), take(derivs, idx + 1)
    dx = x_k1 - x_k
    return x_k, y_k, dx, y_k1 - y_k, (y_k1 - y_k) / dx, d_k, d_k1


def _rqs_forward_and_logdet(z, raw, n_bins: int, bound: float):
    """Elementwise spline ``x = f(z)`` and ``log |df/dz|`` (identity tails
    outside ``(-bound, bound)``)."""
    ex, ey, dv = _rqs_prepare(raw, n_bins, bound)
    inside = (z > -bound) & (z < bound)
    zc = torch.clamp(z, -bound, bound)
    idx = torch.clamp((zc[..., None] > ex[..., 1:-1]).sum(-1), 0, n_bins - 1)
    x_k, y_k, dx, dy, s, d_k, d_k1 = _rqs_bin_quantities(ex, ey, dv, idx)
    xi = torch.clamp((zc - x_k) / dx, 0.0, 1.0)
    om = 1.0 - xi
    denom = s + (d_k1 + d_k - 2.0 * s) * xi * om
    x = y_k + dy * (s * xi * xi + d_k * xi * om) / denom
    deriv = (s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om)
             / (denom * denom))
    return (torch.where(inside, x, z),
            torch.where(inside, torch.log(deriv), 0.0))


def _rqs_inverse_and_logdet(x, raw, n_bins: int, bound: float):
    """Elementwise spline inverse ``z = f^-1(x)`` and ``log |dz/dx|``."""
    ex, ey, dv = _rqs_prepare(raw, n_bins, bound)
    inside = (x > -bound) & (x < bound)
    xc = torch.clamp(x, -bound, bound)
    idx = torch.clamp((xc[..., None] > ey[..., 1:-1]).sum(-1), 0, n_bins - 1)
    x_k, y_k, dx, dy, s, d_k, d_k1 = _rqs_bin_quantities(ex, ey, dv, idx)
    r = xc - y_k
    t = d_k1 + d_k - 2.0 * s
    a = dy * (s - d_k) + r * t
    b = dy * d_k - r * t
    c = -s * r
    disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
    xi = torch.clamp(2.0 * c / (-b - torch.sqrt(disc) - 1e-12), 0.0, 1.0)
    om = 1.0 - xi
    z = x_k + xi * dx
    denom = s + t * xi * om
    deriv = (s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om)
             / (denom * denom))
    return (torch.where(inside, z, x),
            torch.where(inside, -torch.log(deriv), 0.0))


class _ConditionalDensity(nn.Module):
    """What both densities share: the backbone, the conditioner's layer
    norm and first dense layer, the conditioning vector and the
    Trainer's contract."""

    def _build(self, backbone: GNN, condition_columns: Sequence[str],
               n_out: int, seed: int, device: DeviceLike) -> None:
        dev = resolve_device(device)
        self.backbone = backbone
        self.condition_columns = tuple(condition_columns)
        # one value a condition column (a scalar label)
        width = backbone.nb_outputs + len(self.condition_columns)
        self.cond_norm = nn.LayerNorm(width, eps=1e-5)
        self.cond_0 = nn.Linear(width, 128)
        self.cond_1 = nn.Linear(128, n_out)
        init_parameters(self, torch.Generator().manual_seed(seed))
        nn.init.zeros_(self.cond_1.weight)
        self.to(dev)

    def _conditioning(self, batch: EventBatch) -> torch.Tensor:
        latents = self.backbone(batch).float()
        if self.condition_columns:
            B = latents.shape[0]
            extra = [batch.labels[c].reshape(B, -1).float()
                     for c in self.condition_columns]
            if sum(e.shape[1] for e in extra) != len(extra):
                raise ValueError(
                    f"condition columns {self.condition_columns} must be "
                    "scalar labels (one value an event)")
            latents = torch.cat([latents] + extra, dim=-1)
        return latents

    def _raw(self, batch: EventBatch) -> torch.Tensor:
        h = self.cond_norm(self._conditioning(batch))
        return self.cond_1(torch.relu(self.cond_0(h)))

    # --- the Trainer's contract ----------------------------------------
    def loss_from_batch(self, outputs: torch.Tensor,
                        batch: EventBatch) -> torch.Tensor:
        """The mean NLLH, weighted by the batch's event weights if set."""
        if batch.event_weight is not None:
            return (outputs * batch.event_weight).mean()
        return outputs.mean()

    @property
    def prediction_labels(self):
        return [f"{t}_nllh" for t in self.target_labels]

    @property
    def tasks(self):
        return ()


class NormalizingFlow(_ConditionalDensity):
    """Backbone + conditional flow over ``nb_targets`` dimensions:
    ``forward(batch) -> nllh [B]``; :meth:`log_prob` and :meth:`sample`
    are the density's interface.  The arguments are the JAX module's
    fields, then ``seed`` and ``device``."""

    @save_config(ignore=("seed", "device"))
    def __init__(
        self,
        backbone: GNN,
        nb_targets: int = 1,
        target_labels: Tuple[str, ...] = ("energy",),
        n_layers: int = 3,
        condition_columns: Tuple[str, ...] = (),
        transform: str = "sinh_arcsinh",
        spline_bins: int = 8,
        spline_bound: float = 4.0,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        super().__init__()
        if transform not in ("sinh_arcsinh", "spline"):
            raise ValueError(f"unknown transform {transform!r}")
        self.nb_targets = nb_targets
        self.target_labels = tuple(target_labels)
        self.n_layers = n_layers
        self.transform = transform
        self.spline_bins = spline_bins
        self.spline_bound = spline_bound
        self._build(backbone, condition_columns,
                    n_layers * nb_targets * self._params_per_dim, seed, device)

    @property
    def _params_per_dim(self) -> int:
        if self.transform == "spline":
            # 2 affine + K widths + K heights + (K-1) interior derivatives
            return 2 + 3 * self.spline_bins - 1
        return 4

    def _layer_params(self, raw: torch.Tensor) -> torch.Tensor:
        """``[B, n_layers * T * P] -> [B, n_layers, T, P]``."""
        return raw.reshape(raw.shape[0], self.n_layers, self.nb_targets,
                           self._params_per_dim)

    def _nllh(self, raw: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Raw parameters and ``y [B, T]`` -> NLLH ``[B]``: the layers
        inverted from the last to the first."""
        p = self._layer_params(raw)
        x = y
        logdet = torch.zeros_like(y)
        for layer in range(self.n_layers - 1, -1, -1):
            mu = p[:, layer, :, 0]
            log_s = torch.clamp(p[:, layer, :, 1], -7.0, 7.0)
            if self.transform == "spline":
                z, ld = _rqs_inverse_and_logdet(
                    x, p[:, layer, :, 2:], self.spline_bins, self.spline_bound)
            else:
                # bounded skew and tail: unbounded ones overflow sinh
                eps = 2.0 * torch.tanh(p[:, layer, :, 2])
                delta = 0.2 + _softplus(p[:, layer, :, 3] + 0.55)
                z, ld = _sinh_arcsinh_inv_and_logdet(x, eps, delta)
            logdet = logdet + ld
            x = (z - mu) * torch.exp(-log_s)
            logdet = logdet - log_s
        base_logp = -0.5 * (x * x + _LOG_2PI)
        return -(base_logp + logdet).sum(dim=1)

    def _targets(self, batch: EventBatch) -> torch.Tensor:
        cols = [batch.labels[label] for label in self.target_labels]
        cols = [v if v.dim() > 1 else v[:, None] for v in cols]
        return torch.cat(cols, dim=1).float()

    def forward(self, batch: EventBatch, inference: bool = False) -> torch.Tensor:
        return self._nllh(self._raw(batch), self._targets(batch))

    def log_prob(self, batch: EventBatch, y: torch.Tensor) -> torch.Tensor:
        """``log p(y | batch)`` for any ``y [B, nb_targets]``."""
        return -self._nllh(self._raw(batch), y.float())

    def transform_base(self, raw: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Base draws ``z [B, n, T]`` through the flow's layers, first to
        last, under the raw parameters ``[B, n_layers * T * P]``."""
        p = self._layer_params(raw)
        B, n = z.shape[:2]
        x = z
        for layer in range(self.n_layers):
            mu = p[:, None, layer, :, 0]
            log_s = torch.clamp(p[:, None, layer, :, 1], -7.0, 7.0)
            x = x * torch.exp(log_s) + mu
            if self.transform == "spline":
                q = p[:, None, layer, :, 2:].expand(
                    B, n, self.nb_targets, self._params_per_dim - 2)
                x, _ = _rqs_forward_and_logdet(x, q, self.spline_bins,
                                               self.spline_bound)
            else:
                eps = 2.0 * torch.tanh(p[:, None, layer, :, 2])
                delta = 0.2 + _softplus(p[:, None, layer, :, 3] + 0.55)
                x = _sinh_arcsinh(x, eps, delta)
        return x

    def sample(self, batch: EventBatch, generator: torch.Generator,
               n_samples: int = 100) -> torch.Tensor:
        """Draws ``[B, n_samples, nb_targets]``: standard normal base
        draws from ``generator`` (on the model's device) through
        :meth:`transform_base`."""
        raw = self._raw(batch)
        z = torch.randn((raw.shape[0], n_samples, self.nb_targets),
                        generator=generator, device=raw.device)
        return self.transform_base(raw, z)


def anchor_directions(k: int) -> np.ndarray:
    """``k`` roughly uniform fixed unit vectors (a Fibonacci sphere),
    float32 ``[k, 3]``."""
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = np.pi * (1.0 + np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / k
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=-1).astype(np.float32)


class SphericalFlow(_ConditionalDensity):
    """Conditional density on the unit sphere for a direction target: a
    mixture of ``n_components`` von Mises-Fisher densities whose means,
    concentrations and weights the conditioner predicts,

        p(y | x) = sum_k w_k(x) C_3(kappa_k(x)) exp(kappa_k(x) mu_k(x) . y),

    normalised on the sphere by construction.  At the start (the last
    kernel zero) the means are fixed anchor directions, so the
    components differ."""

    @save_config(ignore=("seed", "device"))
    def __init__(
        self,
        backbone: GNN,
        target_labels: Tuple[str, ...] = ("direction",),
        n_components: int = 8,
        condition_columns: Tuple[str, ...] = (),
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        super().__init__()
        self.target_labels = tuple(target_labels)
        self.n_components = n_components
        self.register_buffer(
            "anchors", torch.from_numpy(anchor_directions(n_components)),
            persistent=False)
        # per component: 3 (mean direction) + 1 (kappa) + 1 (weight logit)
        self._build(backbone, condition_columns, n_components * 5, seed, device)

    @property
    def nb_targets(self) -> int:
        return 3

    def mixture_params(self, batch: EventBatch):
        """``(mu [B, K, 3] unit, kappa [B, K] in (0, 700], log_w [B, K])``."""
        raw = self._raw(batch)
        raw = raw.reshape(raw.shape[0], self.n_components, 5)
        mu = raw[..., 0:3] + self.anchors[None]
        mu = mu / torch.clamp_min(
            torch.linalg.vector_norm(mu, dim=-1, keepdim=True), 1e-6)
        kappa = torch.clamp_max(_softplus(raw[..., 3]) * 10.0 + 1e-3, 700.0)
        log_w = torch.log_softmax(raw[..., 4], dim=-1)
        return mu, kappa, log_w

    @staticmethod
    def _log_prob_from_params(mu, kappa, log_w, y):
        """Unit ``y [B, 3]`` -> ``log p [B]``."""
        dot = torch.einsum("bkd,bd->bk", mu, y)
        return torch.logsumexp(log_w + log_cmk(3, kappa) + kappa * dot, dim=-1)

    def forward(self, batch: EventBatch, inference: bool = False) -> torch.Tensor:
        y = batch.labels[self.target_labels[0]].float()
        y = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                                1e-6)
        return -self._log_prob_from_params(*self.mixture_params(batch), y)

    def log_prob(self, batch: EventBatch, y: torch.Tensor) -> torch.Tensor:
        """``log p(y | batch)`` for unit vectors ``y [B, 3]``."""
        return self._log_prob_from_params(*self.mixture_params(batch), y.float())

    def mean_direction(self, batch: EventBatch) -> torch.Tensor:
        """The mixture's mean direction, a unit vector an event ``[B, 3]``."""
        mu, _, log_w = self.mixture_params(batch)
        m = torch.einsum("bk,bkd->bd", torch.exp(log_w), mu)
        return m / torch.clamp_min(
            torch.linalg.vector_norm(m, dim=-1, keepdim=True), 1e-6)
