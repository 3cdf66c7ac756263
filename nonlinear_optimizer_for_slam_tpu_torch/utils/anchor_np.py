"""Independent numpy/scipy implementations backing the external anchors
(a copy of the JAX package's ``utils/anchor_np.py``, on the port's
``io.bal``).

The reference anchors each solver to Ceres — an INDEPENDENT optimizer
consuming the same cost definition (pose_graph_optimizer_ceres.cc:15-69).
This module is that pattern's "shared functor" layer for the offline
environment: pure-numpy residual/chi^2 evaluations written from the
mathematical spec (NOT imported from the solver code — numpy twin,
separate author path, parity is what the anchors test), plus scipy
trust-region solves of the same objectives (separate optimizer, separate
linear algebra, finite-difference Jacobians — a completely independent
derivative mechanism).

Consumed by tests/test_torch_bal.py (the BAL anchor at test scale).
Everything here is numpy and scipy.
"""

from __future__ import annotations

import numpy as np

from ..io import bal as bal_io

# ---------------------------------------------------------------------------
# BAL / bundle adjustment (Snavely model; numpy projection lives in io.bal)
# ---------------------------------------------------------------------------


def scipy_solve_bal(problem, max_nfev=400, verbose=0):
    """Independent BAL solve: scipy TRF + finite-difference sparse
    Jacobians over the NUMPY residual (io.bal.snavely_project — written
    separately from the solver path). Returns the scipy result;
    `result.cost` is 0.5 * sum r^2, the same convention as
    solvers.bal.bal_cost."""
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    C, P, O = problem.num_cameras, problem.num_points, problem.num_observations
    ci, pi = problem.camera_indices, problem.point_indices
    obs = problem.observations

    def residuals(x):
        cams = x[: 9 * C].reshape(C, 9)
        pts = x[9 * C :].reshape(P, 3)
        pred = bal_io.snavely_project(cams[ci], pts[pi])
        return (pred - obs).ravel()

    x0 = np.concatenate([problem.camera_params.ravel(), problem.points.ravel()])
    spars = lil_matrix((2 * O, x0.size), dtype=int)
    for o in range(O):
        spars[2 * o : 2 * o + 2, 9 * ci[o] : 9 * ci[o] + 9] = 1
        spars[2 * o : 2 * o + 2, 9 * C + 3 * pi[o] : 9 * C + 3 * pi[o] + 3] = 1
    return least_squares(
        residuals,
        x0,
        jac_sparsity=spars,
        method="trf",
        tr_solver="lsmr",
        x_scale="jac",
        ftol=1e-12,
        xtol=1e-12,
        gtol=1e-12,
        max_nfev=max_nfev,
        verbose=verbose,
    )


# ---------------------------------------------------------------------------
# pose graph (g2o-convention SE(3) edges)
# ---------------------------------------------------------------------------


def np_quat_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def np_quat_multiply(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def np_quat_rotate(q, v):
    w, xyz = q[..., 0:1], q[..., 1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def edge_residuals_np(positions, quats, edges_ij, t_rel, q_rel):
    """Independent numpy implementation of the g2o-convention edge error
    the loader wires up: r = [ (p_q - p_ref) - R(q_ref) t_rel,
    vec(q_q^-1 q_ref q_rel) ], quaternions normalized. (The repo residual
    carries 2*vec on the rotation rows — ops/relative_pose.py — and
    io/g2o.py's loader folds the compensating diag(1,1,1,.5,.5,.5) into
    the edge sqrt-information, so what the solver MINIMIZES for a g2o
    file is exactly this chi^2. The world-frame translation spelling is
    norm-equivalent to g2o's measurement-frame one for the block-scalar
    information the sphere fixtures carry.)"""
    i, j = edges_ij[:, 0], edges_ij[:, 1]
    q = np_quat_normalize(quats)
    r_t = (positions[j] - positions[i]) - np_quat_rotate(q[i], t_rel)
    err_q = np_quat_multiply(np_quat_multiply(np_quat_conj(q[j]), q[i]), q_rel)
    r_q = err_q[..., 1:]
    return np.concatenate([r_t, r_q], axis=-1)  # (E, 6)


def sphere_chi2(positions, quats, edges_ij, t_rel, q_rel, sqrt_infos):
    """chi^2 = sum |S_e r_e|^2 evaluated by the numpy twin."""
    r = edge_residuals_np(positions, quats, edges_ij, t_rel, q_rel)
    wr = np.einsum("eab,eb->ea", sqrt_infos, r)
    return float(np.sum(wr * wr))


def scipy_solve_sphere(edges_ij, t_rel, q_rel, sqrt_infos, pos0, q0,
                       max_nfev=300, verbose=0):
    """Independent pose-graph solve: scipy TRF over the numpy residual,
    pose 0 held fixed (gauge), quaternion norms pinned by extra residual
    rows (quaternion scale is an exact gauge direction of the normalized
    residual). Returns (positions, unit quaternions)."""
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    N = pos0.shape[0]
    E = edges_ij.shape[0]

    def unpack(x):
        pos = np.concatenate([pos0[:1], x[: 3 * (N - 1)].reshape(N - 1, 3)])
        q = np.concatenate([q0[:1], x[3 * (N - 1) :].reshape(N - 1, 4)])
        return pos, q

    def residuals(x):
        pos, q = unpack(x)
        r = edge_residuals_np(pos, q, edges_ij, t_rel, q_rel)
        wr = np.einsum("eab,eb->ea", sqrt_infos, r).ravel()
        pin = np.sum(q[1:] * q[1:], axis=-1) - 1.0
        return np.concatenate([wr, pin])

    x0 = np.concatenate([pos0[1:].ravel(), q0[1:].ravel()])
    spars = lil_matrix((6 * E + (N - 1), x0.size), dtype=int)
    for e in range(E):
        for v in edges_ij[e]:
            if v == 0:
                continue
            spars[6 * e : 6 * e + 6, 3 * (v - 1) : 3 * v] = 1
            spars[
                6 * e : 6 * e + 6,
                3 * (N - 1) + 4 * (v - 1) : 3 * (N - 1) + 4 * v,
            ] = 1
    for v in range(1, N):
        spars[6 * E + v - 1, 3 * (N - 1) + 4 * (v - 1) : 3 * (N - 1) + 4 * v] = 1
    res = least_squares(
        residuals,
        x0,
        jac_sparsity=spars,
        method="trf",
        tr_solver="lsmr",
        x_scale="jac",
        ftol=1e-12,
        xtol=1e-12,
        gtol=1e-12,
        max_nfev=max_nfev,
        verbose=verbose,
    )
    pos, q = unpack(res.x)
    return pos, np_quat_normalize(q)
