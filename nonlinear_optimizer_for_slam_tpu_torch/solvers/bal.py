"""Bundle Adjustment in the Large (BAL) solver: the Snavely 9-parameter
camera model over the Schur-complement camera/landmark solve (PyTorch port
of the JAX package's ``solvers/bal.py``).

This is the external-anchor path. The reference anchors every solver to
Ceres (pose_graph_optimizer_ceres.cc:15-69 pattern); Ceres' own published
anchor for bundle adjustment is the BAL dataset family
(simple_bundle_adjuster.cc over problem-*-pre.txt). :func:`solve_bal`
takes exactly those files through ``io.bal.read_bal``;
``utils.anchor_np.scipy_solve_bal`` solves the same problems with
scipy.optimize.least_squares (a separate optimizer with finite-difference
Jacobians) for the anchor tests.

Model (BAL convention, see io/bal.py):
  P = R(rod) X + t,   p = -P_xy / P_z,   r^2 = |p|^2
  predicted = f (1 + k1 r^2 + k2 r^4) p,   residual = predicted - observed
  cost = 0.5 sum |residual|^2   (the Ceres / scipy.least_squares
  convention. NOTE: the rest of this package reports sum |r|^2 without
  the 1/2, the reference's convention; the 0.5 here is deliberate so that
  numbers compare directly to Ceres logs and scipy's ``result.cost``.)

Parameterization matches Ceres' simple_bundle_adjuster: plain additive
updates on all 9 camera parameters (the Rodrigues vector is an ambient
parameterization, no local manifold) and on the 3D points. The LM policy
is the repository-wide reference policy, through the bundle adjuster's
loop (``bundle_adjustment._ba_lm_loop``).

Residuals and Jacobians batch over the observations
(``torch.func.vmap`` of ``torch.func.jacfwd`` of the 12-input, 2-output
observation function); U (9x9) and V (3x3) blocks are sums over the
observations (``bundle_adjustment._SegmentSum``); V inverts by the
closed-form adjugate; the Schur rhs and the landmark back-substitution are
observation-level sums (no dense cross tensor). The reduced camera system
(9C x 9C) has its cross term assembled from the (C, P, 9, 3) scatter in
one product, or over landmark chunks (``landmark_chunk=``: peak memory
O(chunk C 27) whatever P), and is solved by Cholesky; or, with
``schur="iterative"``, solved by preconditioned CG on matrix-free
products, never assembled. Matrix products run in full float32 on
float32 inputs (TF32 off, PyTorch's default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.options import LinearSolverType, Options
from ..io.bal import BALProblem
from .bundle_adjustment import (
    _add_diagonal_blocks,
    _SegmentSum,
    _ba_lm_loop,
    _bmv,
    _btv,
    _cross_blocks,
    _inv3x3,
)
from .linear import solve_normal_equations
from .lm import Summary

Tensor = torch.Tensor


def _rodrigues_rotate(rod: Tensor, x: Tensor) -> Tensor:
    """R(rod) @ x, differentiable at rod = 0 (Taylor-guarded sin/cos
    factors: the ``where(small, 1, theta^2)`` keeps the unused branch
    finite)."""
    theta2 = rod @ rod
    small = theta2 < 1e-14
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    c1 = torch.linalg.cross(rod, x)
    c2 = torch.linalg.cross(rod, c1)
    return x + a * c1 + b * c2


def snavely_residual(cam: Tensor, point: Tensor, observed: Tensor) -> Tensor:
    """(2,) reprojection residual for one observation (the twin of
    io.bal.snavely_project; parity held in the tests)."""
    P = _rodrigues_rotate(cam[0:3], point) + cam[3:6]
    p = -P[:2] / P[2]
    r2 = p @ p
    distortion = 1.0 + cam[7] * r2 + cam[8] * r2 * r2
    return cam[6] * distortion * p - observed


def _residual_and_jacobians(cam: Tensor, point: Tensor, observed: Tensor):
    jc, jl = torch.func.jacfwd(snavely_residual, argnums=(0, 1))(cam, point, observed)
    return snavely_residual(cam, point, observed), jc, jl


# (O, 9), (O, 3), (O, 2) -> r (O, 2), J_c (O, 2, 9), J_l (O, 2, 3)
_res_and_jac = torch.func.vmap(_residual_and_jacobians)


def bal_cost(problem: BALProblem, dtype: torch.dtype = torch.float64, device="cuda") -> float:
    """0.5 * sum of squared reprojection residuals (Ceres convention),
    evaluated on ``device`` in ``dtype``."""
    device = resolve_device(device)
    real = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
    r = torch.func.vmap(snavely_residual)(
        real(problem.camera_params)[index(problem.camera_indices)],
        real(problem.points)[index(problem.point_indices)],
        real(problem.observations),
    )
    return float(0.5 * torch.sum(r * r))


def _bal_schur_step(cam_idx: Tensor, pt_idx: Tensor, obs: Tensor, C: int, P: int,
                    landmark_chunk: Optional[int], schur: str, schur_iterations: int,
                    chunk_obs: Optional[Tuple[Tensor, int]] = None):
    """``step((cams, points), lam) -> (dc, dl, cost, g_c, |g_l|^2)`` with
    g = -J^T r (this module's sign). ``chunk_obs``: (the observations
    sorted by landmark chunk with every chunk padded to one occupancy, as
    an index into the observations (-1 on padding), that occupancy), for
    the chunked cross term."""
    dtype, device = obs.dtype, obs.device
    by_cam = _SegmentSum(cam_idx.cpu().numpy(), C, device)
    by_pt = _SegmentSum(pt_idx.cpu().numpy(), P, device)
    eye9 = torch.eye(9, dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)

    def step(params, lam):
        cams, points = params
        r, Jc, Jl = _res_and_jac(cams[cam_idx], points[pt_idx], obs)
        cost = 0.5 * torch.sum(r * r)

        # block sums over the observations
        W = Jc.mT @ Jl  # (O, 9, 3)
        U, g_c = by_cam(Jc.mT @ Jc), -by_cam(_btv(Jc, r))
        V, g_l = by_pt(Jl.mT @ Jl), -by_pt(_btv(Jl, r))

        # reference damping diag *= (1 + lambda), plus a tiny absolute
        # floor so never-observed blocks stay invertible (the reference's
        # ldlt on a singular H is undefined)
        dampU = U + lam * U * eye9 + 1e-10 * eye9
        dampV = V + lam * V * eye3 + 1e-10 * eye3
        Vinv = _inv3x3(dampV)

        # Schur rhs without a cross tensor: sum_p G_cp Vinv_p g_l[p]
        # = sum_o W_o Vinv[pt(o)] g_l[pt(o)] summed at cam(o)
        WV = W @ Vinv[pt_idx]  # (O, 9, 3)
        rhs = g_c - by_cam(_bmv(WV, g_l[pt_idx]))

        def back_substitute(dc):
            # (G^T dc)_p = sum_{o: pt(o) = p} W_o^T dc[cam(o)]
            return _bmv(Vinv, g_l - by_pt(_btv(W, dc[cam_idx])))

        if schur == "iterative":
            # ITERATIVE_SCHUR: PCG on the reduced camera system with the
            # Schur-Jacobi preconditioner; S is never formed, its product
            # is three observation-level sums:
            #   S x = dampU x - scatter_cam(W Vinv[pt] gather_pt(W^T x))
            def S_matvec(x):  # (C, 9) -> (C, 9)
                z = _bmv(Vinv, by_pt(_btv(W, x[cam_idx])))
                return _bmv(dampU, x) - by_cam(_bmv(W, z[pt_idx]))

            # Schur-Jacobi: the block diagonal of S, exactly
            Dblocks = dampU - by_cam(WV @ W.mT)
            Dchol = torch.linalg.cholesky_ex(Dblocks + 1e-12 * eye9)[0]

            def precond(v):
                return torch.cholesky_solve(v[..., None], Dchol)[..., 0]

            x = torch.zeros_like(rhs)
            res = rhs
            z = precond(res)
            p = z
            rz = torch.sum(res * z)
            one = torch.ones_like(rz)
            # a fixed count of iterations, nothing read on the host
            for _ in range(schur_iterations):
                Ap = S_matvec(p)
                denom = torch.sum(p * Ap)
                alpha = rz / torch.where(denom == 0, one, denom)
                x = x + alpha * p
                res = res - alpha * Ap
                z = precond(res)
                rz_new = torch.sum(res * z)
                beta = rz_new / torch.where(rz == 0, one, rz)
                p = z + beta * p
                rz = rz_new
            return x, back_substitute(x), cost, g_c, torch.sum(g_l * g_l)

        # cross term S -= G Vinv G^T: the only piece that pairs
        # observations sharing a landmark
        if landmark_chunk is None or landmark_chunk >= P:
            S = -_cross_blocks(pt_idx, cam_idx, WV, W, P, C)
        else:
            order, occupancy = chunk_obs
            real = order >= 0
            safe = torch.clamp(order, min=0)
            # padding: zero blocks at camera C, which the product leaves out
            cams = torch.where(real, cam_idx[safe], C)
            real = real.to(dtype)[:, None, None]
            S = cost.new_zeros((C * 9, C * 9))
            for k in range(-(-P // landmark_chunk)):
                c = slice(k * occupancy, (k + 1) * occupancy)
                o = safe[c]
                rel = torch.clamp(pt_idx[o] - k * landmark_chunk, 0, landmark_chunk - 1)
                S -= _cross_blocks(rel, cams[c], WV[o] * real[c], W[o] * real[c],
                                   landmark_chunk, C)
        # damped S is symmetric positive definite (the multiplicative
        # damping lifts the gauge freedom); Cholesky solve
        dc = solve_normal_equations(
            _add_diagonal_blocks(S, dampU), rhs.reshape(-1), LinearSolverType.DENSE_CHOLESKY
        ).reshape(C, 9)
        return dc, back_substitute(dc), cost, g_c, torch.sum(g_l * g_l)

    return step


def _chunk_order(pt_idx: np.ndarray, P: int, chunk: int):
    """Observation ids sorted by landmark chunk, every chunk padded with -1
    to the largest chunk's occupancy. Returns (order, occupancy)."""
    n_chunks = -(-P // chunk)
    chunk_of = pt_idx // chunk
    counts = np.bincount(chunk_of, minlength=n_chunks)
    occupancy = int(max(counts.max(), 1)) if len(pt_idx) else 1
    order = np.full((n_chunks, occupancy), -1, np.int64)
    for k in range(n_chunks):
        ix = np.nonzero(chunk_of == k)[0]
        order[k, : len(ix)] = ix
    return order.reshape(-1), occupancy


def _additive(params, dc, dl):
    """Ambient additive update (Ceres' simple_bundle_adjuster)."""
    cams, points = params
    return (cams + dc, points + dl)


# the dense (C, P, 9, 3) cross tensor auto-switches to chunked
# accumulation above this byte budget (float64 worst case)
_DENSE_CROSS_BUDGET_BYTES = 512 * 1024 * 1024


def solve_bal(
    problem: BALProblem,
    options: Optional[Options] = None,
    dtype: torch.dtype = torch.float64,
    landmark_chunk: Optional[int] = None,
    schur: str = "dense",
    schur_iterations: int = 100,
    device="cuda",
) -> Tuple[BALProblem, Summary]:
    """Solve a BAL problem; returns (solved problem, Summary). The
    summary's tensors stay on ``device``.

    ``dtype`` defaults to float64 (the anchor comparisons run against
    float64 scipy).

    ``landmark_chunk``: accumulate the Schur cross term in landmark chunks
    of this size (memory O(chunk C 27) instead of the dense O(P C 27)
    tensor). Default: dense when the cross tensor fits ~512 MB, else an
    auto-selected chunk; the same math either way.

    ``schur="iterative"`` is Ceres' ITERATIVE_SCHUR: PCG on the reduced
    camera system (``schur_iterations`` per LM step, Schur-Jacobi
    preconditioner) with matrix-free observation-level products, the path
    for 1000+-camera problems whose dense 9C x 9C system cannot exist (BAL
    final/13682: S alone would be 121 GB in float64). Its steps are
    inexact (truncated Krylov), so LM may take a few more iterations than
    the exact-Schur path.

    ``device``: where the solve runs, default "cuda"; raises without a GPU
    unless "cpu" is asked for."""
    if schur not in ("dense", "iterative"):
        raise ValueError(f"unknown schur mode {schur!r}")
    device = resolve_device(device)
    if options is None:
        options = Options().replace(max_iterations=50)
    C, P = problem.num_cameras, problem.num_points
    if schur == "iterative":
        landmark_chunk = None  # no cross tensor exists on this path
    elif landmark_chunk is None:
        itemsize = torch.finfo(dtype).bits // 8
        dense_bytes = C * P * 27 * itemsize * 2  # G and GV both live
        if dense_bytes > _DENSE_CROSS_BUDGET_BYTES:
            landmark_chunk = max(128, _DENSE_CROSS_BUDGET_BYTES // (2 * C * 27 * itemsize))
    real = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
    chunk_obs = None
    if landmark_chunk is not None and landmark_chunk < P:
        order, occupancy = _chunk_order(np.asarray(problem.point_indices), P, landmark_chunk)
        chunk_obs = (index(order), occupancy)
    step = _bal_schur_step(
        index(problem.camera_indices), index(problem.point_indices),
        real(problem.observations), C, P, landmark_chunk, schur, schur_iterations, chunk_obs,
    )
    (cams, points), summary = _ba_lm_loop(
        step, _additive, (real(problem.camera_params), real(problem.points)), options
    )
    state = torch.cat([cams.reshape(-1), points.reshape(-1)]).cpu().numpy().astype(np.float64)
    solved = BALProblem(
        state[: 9 * C].reshape(C, 9),
        state[9 * C:].reshape(P, 3),
        problem.camera_indices,
        problem.point_indices,
        problem.observations,
    )
    return solved, summary
