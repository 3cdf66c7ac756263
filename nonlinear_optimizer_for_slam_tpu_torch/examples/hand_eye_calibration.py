"""Hand-eye calibration (AX = XB) with the generic Problem framework.

    python -m nonlinear_optimizer_for_slam_tpu_torch.examples.hand_eye_calibration [--device cuda|cpu]

The classic robotics extrinsic-calibration problem: a camera rigidly
mounted on a robot arm observes a target while the arm moves. Each motion
pair gives arm motion A_i and camera motion B_i related by the unknown
hand-eye transform X: A_i X = X B_i. This is a single-SE(3) least-squares
problem, exactly what solvers/problem.py's generic
Problem/CostFunction/PoseOptimizer solves, so the whole example is one
custom CostFunction (chordal residual, Jacobians by ``torch.func.jacfwd``
through the base class) plus a solve() call.
"""

import argparse

import numpy as np
import torch

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.core import HuberLoss
from nonlinear_optimizer_for_slam_tpu_torch.core.device import resolve_device
from nonlinear_optimizer_for_slam_tpu_torch.solvers.problem import (
    CostFunction,
    GenericOptions,
    PoseOptimizer,
    Problem,
)


class HandEyeCostFunctor(CostFunction):
    """Chordal AX = XB residual per motion pair:
    rows = [flatten(R_A R - R R_B) ; (R_A t + t_A) - (R t_B + t)]."""

    def __init__(self, R_a, t_a, R_b, t_b, device="cuda"):
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=device)
        self.R_a = as_t(R_a)  # (N, 3, 3)
        self.t_a = as_t(t_a)  # (N, 3)
        self.R_b = as_t(R_b)
        self.t_b = as_t(t_b)

    def residuals(self, R, t):
        rot = (self.R_a @ R - R @ self.R_b).reshape(len(self.t_a), 9)
        trans = (
            torch.einsum("nij,j->ni", self.R_a, t) + self.t_a
            - torch.einsum("ij,nj->ni", R, self.t_b) - t
        )
        return torch.cat([rot, trans], dim=1)  # (N, 12)


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def main(device="cuda"):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    X_true = nls.Pose(_exp_so3([0.2, -0.4, 0.7]), np.array([0.12, -0.05, 0.30]))

    N = 40
    R_a = np.stack([_exp_so3(rng.uniform(-1.2, 1.2, 3)) for _ in range(N)])
    t_a = rng.uniform(-0.5, 0.5, (N, 3))
    # B_i = X^-1 A_i X (+ measurement noise on the camera side)
    R_b, t_b = [], []
    Xi = X_true.inverse()
    for k in range(N):
        A = nls.Pose(R_a[k], t_a[k])
        B = Xi * A * X_true
        R_b.append(B.rotation @ _exp_so3(rng.normal(0, 2e-3, 3)))
        t_b.append(B.translation + rng.normal(0, 1e-3, 3))
    R_b, t_b = np.stack(R_b), np.stack(t_b)

    problem = Problem()
    problem.add_residual_block(
        HandEyeCostFunctor(R_a, t_a, R_b, t_b, device=device), HuberLoss(0.05)
    )
    pose0 = nls.Pose.identity()  # cold start
    est, summary = PoseOptimizer(device=device).solve(
        problem, GenericOptions(max_iterations=100), pose0
    )

    rot_err = np.degrees(
        np.arccos(np.clip((np.trace(est.rotation.T @ X_true.rotation) - 1) / 2, -1, 1))
    )
    t_err = np.linalg.norm(est.translation - X_true.translation)
    print(f"iterations: {int(summary.iterations)}  final cost: {float(summary.final_cost):.3e}")
    print(f"rotation error: {rot_err * 60:.2f} arcmin   translation error: {t_err * 1e3:.2f} mm")
    print(f"X est:  t={np.round(est.translation, 4)}")
    print(f"X true: t={np.round(X_true.translation, 4)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
