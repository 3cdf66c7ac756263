"""Robust loss functions (PyTorch port of the JAX package's ``core/losses.py``).

A loss maps the *squared* residual norm ``s = ||r||^2`` to
``(rho(s), rho'(s), rho''(s))``. The Gauss-Newton reweighting uses
``w = rho'(s)``: the weight multiplies both the gradient J^T r and the
Hessian J^T J, while the accumulated cost uses ``rho(s)``
(reference: mahalanobis_distance_minimizer_analytic.cc:36-48).

The set mirrors the reference (nonlinear_optimizer/loss_function.h:11-77)
plus Cauchy, Tukey, Geman-McClure and DCS. Every loss is branch-free
(``torch.where`` instead of ``if``). Parameters are plain floats, cast to
the residual's dtype before use, as the JAX losses do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Tensor = torch.Tensor


def _scalar(value: float, like: Tensor) -> Tensor:
    # a fill on the device, not a host-to-device copy (which would wait)
    return like.new_full((), value)


_LN2 = 0.6931471805599453


def exp_rounded(x: Tensor) -> Tensor:
    """exp(x), rounded near 1 as a correctly rounded exp rounds it.

    ``torch.exp`` is accurate to about one ulp, not correctly rounded.
    Close to an optimum the exponential loss's cost c1 (1 - exp(-c2 s)) is
    a sum of values of a few ulps of 1, so those roundings are the cost:
    the reference (glibc's std::exp) and XLA round them correctly, and
    ORACLE_REPROJ's last costs differ from torch.exp's by up to 15 %.
    For x > -ln 2 (results in (1/2, 1]), 1 + expm1(x) rounds once from a
    value accurate far below an ulp of 1; elsewhere torch.exp."""
    return torch.where(x > -_LN2, 1.0 + torch.expm1(x), torch.exp(x))


class LossFunction:
    """Base class. Subclasses implement ``evaluate``."""

    def evaluate(self, squared_residual: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """Return (rho, rho', rho'') elementwise over ``squared_residual``."""
        raise NotImplementedError

    def __call__(self, squared_residual: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return self.evaluate(squared_residual)


@dataclasses.dataclass(frozen=True)
class TrivialLoss(LossFunction):
    """rho(s) = s. The no-loss path of the reference solvers
    (mahalanobis_distance_minimizer_analytic.cc:44-47)."""

    def evaluate(self, s: Tensor):
        return s, torch.ones_like(s), torch.zeros_like(s)


@dataclasses.dataclass(frozen=True)
class ExponentialLoss(LossFunction):
    """NDT score function: rho(s) = c1 * (1 - exp(-c2 * s)).

    rho'  = 2*c1*c2 * exp(-c2*s)   [reference stores 2*c1*c2 as two_c1c2_]
    rho'' = -2*c2 * rho'

    Reference: loss_function.h:20-47. The reference's rho' carries the
    factor 2; it is kept for cost/step parity.
    """

    c1: float = 1.0
    c2: float = 1.0

    def evaluate(self, s: Tensor):
        c1 = _scalar(self.c1, s)
        c2 = _scalar(self.c2, s)
        exp_term = exp_rounded(-c2 * s)
        rho = c1 - c1 * exp_term
        d_rho = 2.0 * c1 * c2 * exp_term
        dd_rho = -2.0 * c2 * d_rho
        return rho, d_rho, dd_rho


@dataclasses.dataclass(frozen=True)
class HuberLoss(LossFunction):
    """Huber loss on the squared residual.

    For s <= delta^2: (s, 1, 0)
    For s >  delta^2: (2*delta*sqrt(s) - delta^2, delta/sqrt(s), ...)

    Reference: loss_function.h:49-77. sqrt is guarded so nothing is NaN
    at s = 0.
    """

    threshold: float = 1.0

    def evaluate(self, s: Tensor):
        delta = _scalar(self.threshold, s)
        sq_delta = delta * delta
        outlier = s > sq_delta
        safe_s = torch.where(outlier, s, sq_delta)
        root = torch.sqrt(safe_s)
        rho = torch.where(outlier, 2.0 * delta * root - sq_delta, s)
        d_rho = torch.where(outlier, delta / root, torch.ones_like(s))
        dd_rho = torch.where(
            outlier, -0.5 * delta / (safe_s * root), torch.zeros_like(s)
        )
        return rho, d_rho, dd_rho


@dataclasses.dataclass(frozen=True)
class CauchyLoss(LossFunction):
    """Cauchy (Lorentzian) loss: rho(s) = c^2 * log(1 + s/c^2)."""

    scale: float = 1.0

    def evaluate(self, s: Tensor):
        c2 = _scalar(self.scale, s) ** 2
        inv = 1.0 / (1.0 + s / c2)
        rho = c2 * torch.log1p(s / c2)
        d_rho = inv
        dd_rho = -(inv * inv) / c2
        return rho, d_rho, dd_rho


@dataclasses.dataclass(frozen=True)
class TukeyLoss(LossFunction):
    """Tukey biweight: for s <= b^2, rho = (b^2/3) (1 - (1 - s/b^2)^3) and
    rho' = (1 - s/b^2)^2; beyond b^2 it saturates at b^2/3 with zero
    weight."""

    threshold: float = 1.0

    def evaluate(self, s: Tensor):
        b2 = _scalar(self.threshold, s) ** 2
        u = torch.clamp(1.0 - s / b2, min=0.0)
        rho = (b2 / 3.0) * (1.0 - u * u * u)
        d_rho = u * u
        dd_rho = -(2.0 / b2) * u
        return rho, d_rho, dd_rho


@dataclasses.dataclass(frozen=True)
class GemanMcClureLoss(LossFunction):
    """Geman-McClure: rho(s) = c^2 s / (c^2 + s), saturating at c^2 (the
    unclamped Dynamic Covariance Scaling objective with c^2 = Phi)."""

    scale: float = 1.0

    def evaluate(self, s: Tensor):
        c2 = _scalar(self.scale, s) ** 2
        inv = c2 / (c2 + s)
        rho = s * inv
        d_rho = inv * inv
        dd_rho = -2.0 * (inv * inv) / (c2 + s)
        return rho, d_rho, dd_rho


@dataclasses.dataclass(frozen=True)
class DCSLoss(LossFunction):
    """Dynamic Covariance Scaling with the clamped scaling
    s = min(1, 2 Phi / (Phi + chi^2)): a truncated quadratic, quadratic for
    chi^2 <= Phi and constant Phi beyond, with weight 1 inside and 0
    outside (see the JAX package's DCSLoss for the trade-offs)."""

    phi: float = 1.0

    def evaluate(self, s: Tensor):
        phi = _scalar(self.phi, s)
        inlier = s <= phi
        rho = torch.where(inlier, s, phi)
        d_rho = torch.where(inlier, torch.ones_like(s), torch.zeros_like(s))
        return rho, d_rho, torch.zeros_like(s)
