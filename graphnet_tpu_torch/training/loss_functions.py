"""Loss functions (counterpart of ``graphnet_tpu/training/
loss_functions.py``).

Every loss of the JAX module: the base class, the regression losses
(``MSELoss``, ``RMSELoss``, ``LogCoshLoss``, ``EuclideanDistanceLoss``),
the classification losses (``CrossEntropyLoss``,
``BinaryCrossEntropyLoss``), the von Mises-Fisher losses
(``VonMisesFisherLoss``, ``VonMisesFisher2DLoss``,
``VonMisesFisher3DLoss``) and the weighted sums (``EnsembleLoss``,
``RMSEVonMisesFisher3DLoss``).  The vMF normaliser ``log C_m(kappa)`` is
computed on the device: m = 2 through ``i0e``, m = 3 in closed form,
any other m through the log-space series of ``log I_nu``
(:func:`log_iv_series`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from graphnet_tpu_torch.utils.config import save_config

_LOG_2 = math.log(2.0)
_LOG_2PI = math.log(2.0 * math.pi)


class LossFunction:
    """Base class: ``__call__(prediction, target, weights) -> scalar``,
    or the elementwise terms with ``return_elements=True``.  Stateless:
    instances hold only static configuration."""

    def __call__(
        self,
        prediction: torch.Tensor,
        target: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        return_elements: bool = False,
    ) -> torch.Tensor:
        elements = self._forward(prediction, target)
        if weights is not None:
            # per-event weights are [B]; elements may be [B] or [B, d]:
            # align by appending singleton axes (a bare broadcast of [B]
            # against [B, 1] would give a bogus [B, B] outer product)
            if weights.dim() < elements.dim():
                weights = weights.reshape(
                    weights.shape + (1,) * (elements.dim() - weights.dim())
                )
            elements = elements * weights
        return elements if return_elements else elements.mean()

    def _forward(
        self, prediction: torch.Tensor, target: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError


class MSELoss(LossFunction):
    def _forward(self, prediction, target):
        if target.dim() != prediction.dim():
            target = target.reshape(prediction.shape)
        return ((prediction - target) ** 2).mean(dim=-1)


class RMSELoss(MSELoss):
    def _forward(self, prediction, target):
        return torch.sqrt(super()._forward(prediction, target))


class LogCoshLoss(LossFunction):
    """Stable ``log cosh(x) = x + softplus(-2x) - log 2``."""

    @staticmethod
    def _log_cosh(x: torch.Tensor) -> torch.Tensor:
        return x + F.softplus(-2.0 * x) - _LOG_2

    def _forward(self, prediction, target):
        if target.dim() < prediction.dim():
            target = target[..., None]
        return self._log_cosh(prediction - target)


class CrossEntropyLoss(LossFunction):
    """Multi-class cross entropy on logits.  ``options`` is an int (the
    targets are already 0..C-1), a list (target values mapped to their
    position) or a dict (an explicit value -> class map).  A target value
    that no option names maps to class 0, as in the JAX package."""

    @save_config
    def __init__(self, options: Union[int, List[Any], Dict[Any, int]]):
        self._options = options
        if isinstance(options, int):
            if options < 2:
                raise ValueError(f"options must be at least 2; got {options}")
            self._nb_classes = options
            self._keys = self._vals = None
        elif isinstance(options, list):
            self._nb_classes = len(options)
            self._keys = torch.tensor(options, dtype=torch.int64)
            self._vals = torch.arange(len(options), dtype=torch.int64)
        elif isinstance(options, dict):
            self._nb_classes = len(np.unique(list(options.values())))
            self._keys = torch.tensor(list(options.keys()), dtype=torch.int64)
            self._vals = torch.tensor(list(options.values()), dtype=torch.int64)
        else:
            raise ValueError(f"Unsupported options type {type(options)}")

    def _map_target(self, target: torch.Tensor) -> torch.Tensor:
        if self._keys is None:
            return target.to(torch.int64)
        target = target.reshape(-1).to(torch.int64)
        keys = self._keys.to(target.device)
        vals = self._vals.to(target.device)
        eq = target[:, None] == keys[None, :]
        return torch.where(eq, vals[None, :], 0).sum(dim=1)

    def _forward(self, prediction, target):
        t = self._map_target(target.reshape(-1))
        logp = F.log_softmax(prediction, dim=-1)
        classes = torch.arange(self._nb_classes, device=t.device)
        onehot = (t[:, None] == classes[None, :]).to(logp.dtype)
        return -(onehot * logp).sum(dim=-1)


class BinaryCrossEntropyLoss(LossFunction):
    """Binary cross entropy on probabilities in (0, 1)."""

    def _forward(self, prediction, target):
        p = torch.clamp(prediction.reshape(-1), 1e-7, 1.0 - 1e-7)
        t = target.reshape(-1).to(p.dtype)
        return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))


# ------------------------------------------------------------ log C_m(k)
def log_iv_series(
    nu: float, kappa: torch.Tensor, n_terms: int = 256
) -> torch.Tensor:
    """``log I_nu(kappa)`` by the ascending series in log space:
    ``logsumexp_j((2j + nu) log(k/2) - lgamma(j + 1) - lgamma(j + nu +
    1))``, in float32; reliable for ``kappa`` up to a few hundred (the vMF
    switch is at 100)."""
    kappa = torch.as_tensor(kappa, dtype=torch.float32)
    safe = torch.clamp_min(kappa, 1e-30)
    j = torch.arange(n_terms, dtype=torch.float32, device=kappa.device)
    log_half_k = torch.log(safe / 2.0)
    log_terms = ((2.0 * j + nu) * log_half_k[..., None]
                 - torch.lgamma(j + 1.0) - torch.lgamma(j + nu + 1.0))
    return torch.logsumexp(log_terms, dim=-1)


def _log_sinh_over_x(x: torch.Tensor) -> torch.Tensor:
    """Stable ``log(sinh(x)/x)`` for x >= 0 (series below 0.1)."""
    small = x < 0.1
    x_big = torch.where(small, 1.0, x)  # double where: NaN-free gradients
    big = x_big + torch.log1p(-torch.exp(-2.0 * x_big)) - _LOG_2 - torch.log(x_big)
    x2 = x * x
    return torch.where(small, x2 / 6.0 - x2 * x2 / 180.0, big)


def log_cmk_exact(m: int, kappa: torch.Tensor) -> torch.Tensor:
    """``log C_m(kappa) = (m/2-1) log k - log I_{m/2-1}(k) - (m/2)
    log(2 pi)``: m = 2 through ``i0e``, m = 3 in closed form, other m
    through :func:`log_iv_series` (in float32)."""
    if m == 2:
        return -(torch.log(torch.special.i0e(kappa)) + kappa) - _LOG_2PI
    if m == 3:
        return -math.log(4.0 * math.pi) - _log_sinh_over_x(kappa)
    nu = m / 2.0 - 1.0
    safe = torch.clamp_min(kappa, 1e-30)
    return (nu * torch.log(safe) - log_iv_series(nu, kappa)
            - (m / 2.0) * _LOG_2PI)


def log_cmk_approx(m: int, kappa: torch.Tensor) -> torch.Tensor:
    """Asymptotic approximation (arXiv:1812.04616 section 8.2)."""
    v = m / 2.0 - 0.5
    a = torch.sqrt((v + 1.0) ** 2 + kappa * kappa)
    b = v - 1.0
    return -a + b * torch.log(b + a)


def log_cmk(
    m: int, kappa: torch.Tensor, kappa_switch: float = 100.0
) -> torch.Tensor:
    """Exact below ``kappa_switch``, the shifted approximation above,
    continuous at the switch."""
    ks = torch.tensor(kappa_switch, dtype=kappa.dtype, device=kappa.device)
    offset = log_cmk_approx(m, ks) - log_cmk_exact(m, ks)
    kappa_lo = torch.clamp_max(kappa, kappa_switch)  # exact branch finite
    return torch.where(
        kappa < kappa_switch,
        log_cmk_exact(m, kappa_lo),
        log_cmk_approx(m, kappa) - offset,
    )


def bessel_ratio(m: int, kappa: torch.Tensor) -> torch.Tensor:
    """``I_{m/2}(k) / I_{m/2-1}(k)``, the derivative of ``-log C_m`` in
    ``kappa``."""
    kappa = torch.as_tensor(kappa, dtype=torch.float32)
    if m == 2:
        return torch.special.i1e(kappa) / torch.special.i0e(kappa)
    if m == 3:
        small = kappa < 1e-3
        safe = torch.where(small, 1.0, kappa)
        return torch.where(small, kappa / 3.0,
                           1.0 / torch.tanh(safe) - 1.0 / safe)
    return torch.exp(log_iv_series(m / 2.0, kappa)
                     - log_iv_series(m / 2.0 - 1.0, kappa))


class VonMisesFisherLoss(LossFunction):
    """``-log C_m(|p|) - p . t`` for a unit target ``t``."""

    def _evaluate(
        self, prediction: torch.Tensor, target: torch.Tensor
    ) -> torch.Tensor:
        m = target.shape[1]
        k = torch.linalg.vector_norm(prediction, dim=1)
        dotprod = (prediction * target).sum(dim=1)
        return -log_cmk(m, k) - dotprod


class VonMisesFisher2DLoss(VonMisesFisherLoss):
    """prediction ``[N, 2] = (angle, kappa)``; target ``[N, >=1]``, the
    angle in its first column."""

    def _forward(self, prediction, target):
        target = target.reshape(prediction.shape[0], -1)
        angle_true = target[:, 0]
        t = torch.stack([torch.cos(angle_true), torch.sin(angle_true)], dim=1)
        angle_pred = prediction[:, 0]
        kappa = prediction[:, 1]
        p = kappa[:, None] * torch.stack(
            [torch.cos(angle_pred), torch.sin(angle_pred)], dim=1)
        return self._evaluate(p, t)


class VonMisesFisher3DLoss(VonMisesFisherLoss):
    """prediction ``[N, 4] = (x, y, z, kappa)``; target a unit 3-vector."""

    def _forward(self, prediction, target):
        target = target.reshape(-1, 3)
        kappa = prediction[:, 3]
        p = kappa[:, None] * prediction[:, :3]
        return self._evaluate(p, target)


class EuclideanDistanceLoss(LossFunction):
    """``|p[:, :3] - t[:, :3]|``."""

    def _forward(self, prediction, target):
        return torch.sqrt(
            ((prediction[:, :3] - target[:, :3]) ** 2).sum(dim=1))


class EnsembleLoss(LossFunction):
    """Weighted sum of losses, each on its slice of the prediction's
    columns (``prediction_keys``; all columns by default)."""

    @save_config
    def __init__(
        self,
        loss_functions: List[LossFunction],
        loss_factors: Optional[List[float]] = None,
        prediction_keys: Optional[List[List[int]]] = None,
    ):
        if loss_factors is None:
            loss_factors = [1.0] * len(loss_functions)
        if len(loss_functions) != len(loss_factors):
            raise ValueError(
                f"{len(loss_functions)} loss functions but "
                f"{len(loss_factors)} factors")
        self._loss_functions = loss_functions
        self._factors = loss_factors
        self._prediction_keys = prediction_keys

    def _forward(self, prediction, target):
        keys = self._prediction_keys
        if keys is None:
            keys = [list(range(prediction.shape[1]))] * len(self._loss_functions)
        elements = 0.0
        for fac, fn, key in zip(self._factors, self._loss_functions, keys):
            elements = elements + fac * fn._forward(prediction[:, key], target)
        return elements


class RMSEVonMisesFisher3DLoss(EnsembleLoss):
    """RMSE of the direction plus ``vmfs_factor`` times the 3D vMF loss."""

    @save_config
    def __init__(self, vmfs_factor: float = 0.05):
        super().__init__(
            loss_functions=[RMSELoss(), VonMisesFisher3DLoss()],
            loss_factors=[1.0, vmfs_factor],
            prediction_keys=[[0, 1, 2], [0, 1, 2, 3]],
        )
