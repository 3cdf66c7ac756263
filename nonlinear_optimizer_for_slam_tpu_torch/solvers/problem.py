"""Generic pose-problem framework (PyTorch port of the JAX package's
``solvers/problem.py``): the reference's unbuilt mini-Ceres, built.

The reference ships an unbuilt, templated Problem / CostFunction /
ResidualBlock / PoseOptimizer quartet (pose_optimizer/pose_optimizer.h:
43-145, cost_function.h, cost_functors.h; excluded from its CMake build).
This module provides the working equivalent:

- ``CostFunction``: a BATCH of residuals of one type. Subclasses provide
  ``residuals(rotation, translation) -> (N, D)``; analytic Jacobians are
  optional — the default differentiates through the SE(3) retraction with
  ``torch.func.jacfwd``.
- ``Problem``: a set of residual blocks, each with an optional robust loss
  (the reference's ResidualBlock::Evaluate has an inverted
  ``if (loss_function_)`` branch that SKIPS a configured loss,
  cost_function.h:96-104 — applied correctly here).
- ``PoseOptimizer``: LM with the reference pose_optimizer's OWN policy,
  which differs from the per-module solvers of ``solvers/lm.py``:
  max_iterations=100, parameter/gradient/function tolerances
  1e-8/1e-10/1e-6, the function_tolerance IS read (|cost - prev| < tol
  breaks), and convergence is tested BEFORE the step is applied
  (pose_optimizer.h:115-127).

Update rule: t += dt; R <- R * exp(dR) with the shared ComputeQuaternion
small-angle map, as in the JAX package.

Built-in functors mirror cost_functors.h: Mahalanobis (3,), point-to-plane
(1,), translation prior, rotation prior (the reference's
RotationDeltaCostFunctor is an empty stub — implemented for real here).
They evaluate with the plain factor code of ``ops/mahalanobis`` and
``ops/point_to_plane``, as the JAX package's reach no Pallas kernel. The
two priors give their Jacobians in closed form where the JAX package
differentiates them with ``jax.jacfwd``: the same values to rounding, and
no ``torch.func`` transform on the host every iteration.

The LM loop runs on the host and reads one flag per iteration,
``converged``; every other quantity stays a tensor on the solve's device.
Entry points default to ``device="cuda"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.losses import LossFunction
from ..core.pose import Pose, np_quat_to_rotmat
from ..ops import mahalanobis, point_to_plane
from ..ops.quadratic import quadratic_from_jacobians
from .lm import IterationRecord, Summary

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GenericOptions:
    """Reference pose_optimizer Options (pose_optimizer.h:43-61)."""

    max_iterations: int = 100
    parameter_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    function_tolerance: float = 1e-6
    min_lambda: float = 1e-6
    max_lambda: float = 1e-2
    initial_lambda: float = 1e-3
    lambda_increasing_factor: float = 2.0
    lambda_decreasing_factor: float = 0.6


class CostFunction:
    """A batch of same-type residuals on SE(3). Subclasses implement
    ``residuals``; override ``residuals_and_jacobians`` for analytic J."""

    def residuals(self, rotation: Tensor, translation: Tensor) -> Tensor:
        raise NotImplementedError

    def residuals_and_jacobians(
        self, rotation: Tensor, translation: Tensor
    ) -> Tuple[Tensor, Tensor]:
        """(r (N, D), J (N, D, 6)); default = ``torch.func.jacfwd``
        through the SE(3) retraction at delta = 0."""
        r = self.residuals(rotation, translation)

        def at_delta(delta):
            dR = lie.quat_to_rotmat(lie.so3_exp_quaternion(delta[3:6]))
            return self.residuals(rotation @ dR, translation + delta[:3])

        zero = torch.zeros(6, dtype=rotation.dtype, device=rotation.device)
        return r, torch.func.jacfwd(at_delta)(zero)

    def mask(self) -> Optional[Tensor]:
        return None


def _tensor(value, device) -> Tensor:
    """A tensor or array on ``device`` in its own dtype (numpy float64
    stays float64, as ``jnp.asarray`` keeps it under x64)."""
    if isinstance(value, Tensor):
        return value.to(device)
    return torch.tensor(np.asarray(value), device=device)


class MahalanobisDistanceCostFunctor(CostFunction):
    """r = S (R p + t - mu) (reference: cost_functors.h:55-104)."""

    def __init__(self, points, means, sqrt_infos, mask=None, device="cuda"):
        device = resolve_device(device)
        self.points = _tensor(points, device)
        self.means = _tensor(means, device)
        self.sqrt_infos = _tensor(sqrt_infos, device)
        self._mask = None if mask is None else _tensor(mask, device)

    def _data(self, dtype) -> mahalanobis.MahalanobisData:
        ones = torch.ones(self.points.shape[0], dtype=dtype, device=self.points.device)
        return mahalanobis.MahalanobisData(self.points, self.means, self.sqrt_infos, ones).astype(
            dtype
        )

    def residuals(self, R, t):
        return mahalanobis.residuals(R, t, self._data(R.dtype))

    def residuals_and_jacobians(self, R, t):
        return mahalanobis.residuals_and_jacobians(R, t, self._data(R.dtype))

    def mask(self):
        return self._mask


class PointToPlaneCostFunctor(CostFunction):
    """r = n . (R p + t - mu) (reference: cost_functors.h:106-157)."""

    def __init__(self, points, means, normals, mask=None, device="cuda"):
        device = resolve_device(device)
        self.points = _tensor(points, device)
        self.means = _tensor(means, device)
        self.normals = _tensor(normals, device)
        self._mask = None if mask is None else _tensor(mask, device)

    def _data(self, dtype) -> point_to_plane.PointToPlaneData:
        ones = torch.ones(self.points.shape[0], dtype=dtype, device=self.points.device)
        return point_to_plane.PointToPlaneData(
            self.points, self.means, self.normals, ones
        ).astype(dtype)

    def residuals(self, R, t):
        return point_to_plane.residuals(R, t, self._data(R.dtype))

    def residuals_and_jacobians(self, R, t):
        return point_to_plane.residuals_and_jacobians(R, t, self._data(R.dtype))

    def mask(self):
        return self._mask


class TranslationDeltaCostFunctor(CostFunction):
    """Translation prior r = S (t - t_prior)
    (reference: cost_functors.h:159-198)."""

    def __init__(self, target_translation, sqrt_info=None, device="cuda"):
        device = resolve_device(device)
        self.target = _tensor(target_translation, device)
        self.sqrt_info = (
            torch.eye(3, dtype=self.target.dtype, device=device)
            if sqrt_info is None
            else _tensor(sqrt_info, device)
        )

    def residuals(self, R, t):
        S, target = self.sqrt_info.to(t.dtype), self.target.to(t.dtype)
        return (S @ (t - target))[None, :]

    def residuals_and_jacobians(self, R, t):
        """J = [S 0]: the retraction moves t by delta[:3] alone."""
        S = self.sqrt_info.to(t.dtype)
        return self.residuals(R, t), torch.cat([S, torch.zeros_like(S)], dim=1)[None]


class RotationDeltaCostFunctor(CostFunction):
    """Rotation prior r = S * 2 vec(q_prior^* (x) q(R)) — the reference
    declares this functor but leaves Evaluate an empty stub
    (cost_functors.h:200-223); implemented for real."""

    def __init__(self, target_rotation, sqrt_info=None, device="cuda"):
        device = resolve_device(device)
        self.target = _tensor(target_rotation, device)
        self.sqrt_info = (
            torch.eye(3, dtype=self.target.dtype, device=device)
            if sqrt_info is None
            else _tensor(sqrt_info, device)
        )

    def _error(self, R):
        q = lie.rotmat_to_quat(R)
        q_t = lie.rotmat_to_quat(self.target.to(R.dtype))
        return lie.quat_multiply(lie.quat_conjugate(q_t), q)

    def residuals(self, R, t):
        err = self._error(R)
        return (self.sqrt_info.to(R.dtype) @ (2.0 * err[1:]))[None, :]

    def residuals_and_jacobians(self, R, t):
        """With R <- R Exp(dtheta), q <- q (x) (1, dtheta / 2) to first
        order (the small-angle branch of the retraction at 0), so
        d(2 vec(e))/d dtheta = w I + [v]x for the error quaternion
        e = (w, v); the translation columns are 0."""
        err = self._error(R)
        S = self.sqrt_info.to(R.dtype)
        r = (S @ (2.0 * err[1:]))[None, :]
        d_rot = err[0] * torch.eye(3, dtype=R.dtype, device=R.device) + lie.skew(err[1:])
        return r, torch.cat([torch.zeros_like(S), S @ d_rot], dim=1)[None]


@dataclasses.dataclass
class _Block:
    cost_function: CostFunction
    loss: Optional[LossFunction]


class Problem:
    """Residual-block container (reference: pose_optimizer.h:20-41)."""

    def __init__(self):
        self._blocks: List[_Block] = []

    def add_residual_block(
        self, cost_function: CostFunction, loss: Optional[LossFunction] = None
    ):
        self._blocks.append(_Block(cost_function, loss))

    @property
    def residual_blocks(self) -> List[_Block]:
        return list(self._blocks)


class PoseOptimizer:
    """Generic SE(3) LM solver over a Problem
    (reference: pose_optimizer.h:66-145, with its distinct policy)."""

    def __init__(self, dtype: torch.dtype = torch.float64, device="cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)

    def solve(
        self,
        problem: Problem,
        options: GenericOptions,
        pose: Pose,
    ) -> Tuple[Pose, Summary]:
        dtype, device = self.dtype, self.device
        blocks = problem.residual_blocks
        if not blocks:
            raise ValueError("problem has no residual blocks")
        as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        eye = torch.eye(6, dtype=dtype, device=device)

        def eval_quadratic(R, t):
            H = torch.zeros((6, 6), dtype=dtype, device=device)
            g = torch.zeros(6, dtype=dtype, device=device)
            cost = torch.zeros((), dtype=dtype, device=device)
            for blk in blocks:
                r, J = blk.cost_function.residuals_and_jacobians(R, t)
                Hb, gb, cb = quadratic_from_jacobians(
                    r.to(dtype), J.to(dtype), blk.cost_function.mask(), blk.loss
                )
                H, g, cost = H + Hb, g + gb, cost + cb
            return H, g, cost

        max_it = options.max_iterations
        t, q = as_t(pose.translation), as_t(pose.quaternion())
        lam = as_t(options.initial_lambda)
        big = as_t(torch.finfo(dtype).max)
        prev_cost, last_cost = big, big
        records = IterationRecord(
            *(torch.full((max_it,), float("nan"), dtype=dtype, device=device) for _ in range(4))
        )
        it, done = 0, False
        while it < max_it and not done:
            H, g, cost = eval_quadratic(lie.quat_to_rotmat(q), t)
            damped = H * (1.0 + lam * eye)
            # rank-deficiency floor: a problem constraining only part of the
            # pose (priors on translation alone) has an exactly zero block
            # in H; the floor keeps the solve finite and the unconstrained
            # directions step by exactly 0 (their g is 0)
            floor = 1e-10 * (torch.max(torch.abs(torch.diagonal(H))) + 1.0)
            delta = torch.linalg.solve(damped + floor * eye, -g)
            delta = torch.where(torch.all(torch.isfinite(delta)), delta, torch.zeros_like(delta))
            step_norm = torch.linalg.vector_norm(delta)
            grad_norm = torch.linalg.vector_norm(g)
            # convergence tested BEFORE the step is applied; function_tolerance
            # IS read (pose_optimizer.h:115-127)
            converged = (
                (step_norm < options.parameter_tolerance)
                | (grad_norm < options.gradient_tolerance)
                | (torch.abs(cost - prev_cost) < options.function_tolerance)
            )
            dq = lie.so3_exp_quaternion(delta[3:6])
            q = torch.where(converged, q, lie.quat_normalize(lie.quat_multiply(q, dq)))
            t = torch.where(converged, t, t + delta[:3])
            adapted = torch.where(
                cost > prev_cost,
                lam * options.lambda_increasing_factor,
                lam * options.lambda_decreasing_factor,
            )
            adapted = torch.clamp(adapted, options.min_lambda, options.max_lambda)
            for rec, value in zip(records, (cost, lam, grad_norm, step_norm)):
                rec[it] = value
            lam = torch.where(converged, lam, adapted)
            prev_cost = torch.where(converged, prev_cost, cost)
            last_cost = cost
            it += 1
            done = bool(converged)  # the one host read of the iteration

        tq = torch.cat([t, q]).cpu().numpy().astype(np.float64)
        qn = tq[3:] / np.linalg.norm(tq[3:])
        out = Pose(np_quat_to_rotmat(qn), tq[:3])
        int_t = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
        summary = Summary(
            final_cost=last_cost,
            reported_cost=prev_cost,
            iterations=int_t(it - 1 if done else it),
            final_lambda=lam,
            converged=torch.tensor(done, device=device),
            records=records,
        )
        return out, summary
