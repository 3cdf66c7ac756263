"""Schur-complement bundle adjustment: joint camera + landmark solve
(PyTorch port of the JAX package's ``solvers/bundle_adjustment.py``).

The reference lists bundle adjustment as absent; BASELINE.json config 5
asks for it. The solve is the camera-landmark bipartite Schur method:

- every observation evaluates in one batch: the residual r (O, 2) on the
  normalized image plane and the analytic Jacobians J_c (O, 2, 6) with
  respect to its camera and J_l (O, 2, 3) with respect to its landmark
  (the reprojection factor's projection and depth gating,
  reference: reprojection_error_minimizer_analytic.cc:105-163);
- per-landmark 3x3 blocks V_j and per-camera 6x6 blocks U_i are sums over
  the observations; V_j inverts by the closed-form adjugate;
- the reduced camera system S = U - G V^{-1} G^T (G: the 6x3 cross blocks
  placed by (landmark, camera)) is assembled as one matrix product per
  landmark chunk and solved dense (6C x 6C) by Cholesky;
- landmark back-substitution is again per landmark.

The LM policy is the reference's (damping H_diag *= 1 + lam on BOTH the U
and V diagonals, lambda in [1e-6, 1e-2] x2.0/x0.6,
mahalanobis_distance_minimizer_analytic.cc:84-152), in a loop of its own
(:func:`_ba_lm_loop`, shared with ``solvers/bal.py``) that reads one
boolean on the host per LM iteration.

Layouts. ``layout="flat"`` keeps the observations as given; sums over
cameras and over landmarks gather each camera's (landmark's) rows
through a table built once a solve and reduce them (:class:`_SegmentSum`:
a fixed order of summation, no float atomics), and the cross term S is
one product over the landmarks, or over landmark chunks (a Python loop)
when the one-shot (M, C, 6, 3) tensor would be too large.
``layout="grouped"`` (the default) lays the observations out track-major,
(M, T) with row m holding landmark m's observations: the per-landmark
sums become reductions over the track axis, and the camera sums are the
flat layout's over the real slots of the tracks. (The JAX package's
grouped path turns the camera sums into one-hot matrix products for the
TPU.) Both evaluate the same objective with the same damping and follow
the same LM trajectory.

``mesh=`` shards landmarks and their observations over the ranks of a
``torch.distributed`` group by landmark range (always the flat layout).
The landmark side stays on its rank; the reduced camera system (U, the S
cross term, g_c, the rhs), the cost and |g_l|^2 are summed across ranks by
one ``parallel.all_sum`` an evaluation, and the landmark step's |dl|^2 by
a second one (the JAX package's two psums): the Schur reduction happens
before any communication, so the payload is the (6C)^2 system.

Matrix products run in full float32 on float32 inputs (TF32 off, PyTorch's
default), as the JAX package forces with ``default_matmul_precision
("highest")``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.losses import LossFunction
from ..core.options import LinearSolverType, Options
from ..core.pose import Pose, np_quat_to_rotmat
from ..ops.reprojection import MIN_DEPTH, CameraIntrinsics
from ..parallel import FactorMesh, reducer
from .linear import solve_normal_equations
from .lm import IterationRecord, Summary, tree_map
from .pose_graph import _bmv, _btv, _scatter_add

Tensor = torch.Tensor


class BAData(NamedTuple):
    """SoA observation batch for bundle adjustment (tensors or numpy
    arrays; :meth:`BundleAdjuster.solve` prepares them on the host)."""

    camera_indices: Tensor  # (O,) int
    landmark_indices: Tensor  # (O,) int
    pixels: Tensor  # (O, 2) observed pixels
    mask: Tensor  # (O,) 1.0 = real observation

    @property
    def num_observations(self) -> int:
        return self.camera_indices.shape[0]


class GroupedBAData(NamedTuple):
    """Track-major (landmark-grouped) observation layout: row m holds the
    up-to-T observations of landmark m, zero-mask padded. Sums over a
    landmark's observations are reductions over the track axis."""

    camera_indices: Tensor  # (M, T) int, 0 on padded slots
    pixels: Tensor  # (M, T, 2)
    mask: Tensor  # (M, T) 1.0 = real observation


class BAParams(NamedTuple):
    translations: Tensor  # (C, 3)
    quaternions: Tensor  # (C, 4) (w, x, y, z)
    landmarks: Tensor  # (M, 3)


def _inv3x3(V: Tensor) -> Tensor:
    """Closed-form adjugate inverse of batched 3x3 matrices: a handful of
    elementwise ops, and each matrix's inverse is the same bits in any
    batch. V is LM-damped (+1e-8 floor), so det > 0."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    c00 = e * i - f * h
    c01 = f * g - d * i
    c02 = d * h - e * g
    c10 = c * h - b * i
    c11 = a * i - c * g
    c12 = b * g - a * h
    c20 = b * f - c * e
    c21 = c * d - a * f
    c22 = a * e - b * d
    det = a * c00 + b * c01 + c * c02
    inv_det = 1.0 / det
    row0 = torch.stack([c00, c10, c20], dim=-1)
    row1 = torch.stack([c01, c11, c21], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def _add_diagonal_blocks(S: Tensor, blocks: Tensor) -> Tensor:
    """S (C k, C k) with ``blocks`` (C, k, k) added on its diagonal blocks,
    in place."""
    C, k = blocks.shape[0], blocks.shape[-1]
    S.view(C, k, C, k).diagonal(dim1=0, dim2=2).add_(blocks.permute(1, 2, 0))
    return S


class _SegmentSum:
    """Sums of per-row values by segment (the observations of one camera,
    or of one landmark) in a fixed order and with no scatter: a (S, K)
    table of each segment's row ids, built once on the host (padded with a
    zero row), gathers the rows, and one reduction over K sums them. Rows
    whose segment id is negative (padding) belong to no segment.

    ``index_put_(accumulate=True)`` on CUDA adds the rows of one index
    serially: summing 350,000 observations onto 100 cameras took 10 ms a
    call, and 170 ms with 210,000 padded slots on one camera, on an H100
    (``chip_smoke.py``'s ``bundle_adjustment`` phase), against a gather and
    a reduction here."""

    def __init__(self, ids, num_segments: int, device):
        ids = np.asarray(ids, np.int64)
        keep = np.nonzero(ids >= 0)[0]
        order = keep[np.argsort(ids[keep], kind="stable")]
        counts = np.bincount(ids[keep], minlength=num_segments)
        starts = np.cumsum(counts) - counts
        table = np.full((num_segments, max(int(counts.max(initial=0)), 1)), len(ids), np.int64)
        table[ids[order], np.arange(len(order)) - np.repeat(starts, counts)] = order
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, values: Tensor) -> Tensor:
        """(n, ...) per-row values -> (S, ...) per-segment sums."""
        padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
        return padded[self.table].sum(dim=1)


def _cross_blocks(rows: Tensor, cams: Tensor, A: Tensor, W: Tensor, n_rows: int,
                  C: int) -> Tensor:
    """sum over landmarks m of G_m V_m^{-1} G_m^T as a (C k, C k) matrix:
    the per-observation (k, 3) blocks ``A`` (= W V^{-1}) and ``W`` placed at
    (landmark row, camera) in (n_rows, C + 1, k, 3) tensors, then one
    product contracting the landmark rows and the landmark coordinate. A
    padding row names camera C, a column the product leaves out (so that
    padding does not pile onto one real (row, camera) slot)."""
    k = W.shape[-2]
    GV = _scatter_add(W.new_zeros((n_rows, C + 1, k, 3)), (rows, cams), A)[:, :C]
    G = _scatter_add(W.new_zeros((n_rows, C + 1, k, 3)), (rows, cams), W)[:, :C]
    GVf = GV.permute(1, 2, 0, 3).reshape(C * k, n_rows * 3)
    Gf = G.permute(1, 2, 0, 3).reshape(C * k, n_rows * 3)
    return GVf @ Gf.T


def _observation_residuals_jacobians(params: BAParams, data: BAData, intr: CameraIntrinsics):
    """Batched (r (O, 2), J_c (O, 2, 6), J_l (O, 2, 3), valid (O,)) with
    depth gating at ``MIN_DEPTH``; the camera Jacobian's columns are the
    translation, then the rotation."""
    R_all = lie.quat_to_rotmat(params.quaternions)  # (C, 3, 3)
    R = R_all[data.camera_indices]  # (O, 3, 3)
    t = params.translations[data.camera_indices]  # (O, 3)
    X = params.landmarks[data.landmark_indices]  # (O, 3)
    p = data.pixels

    Xw = torch.sum(R * X[..., None, :], dim=-1) + t  # R X + t
    zw = Xw[..., 2]
    deep = zw >= MIN_DEPTH
    valid = (deep & (data.mask > 0)).to(Xw.dtype)
    safe_z = torch.where(deep, zw, torch.ones_like(zw))
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z

    proj = Xw[..., :2] * inv_z[..., None]
    matched = torch.stack(
        [intr.inv_fx * (p[..., 0] - intr.cx), intr.inv_fy * (p[..., 1] - intr.cy)], dim=-1
    )
    r = (proj - matched) * valid[..., None]

    zero = torch.zeros_like(inv_z)
    dK = torch.stack(
        [
            torch.stack([inv_z, zero, -Xw[..., 0] * inv_z2], dim=-1),
            torch.stack([zero, inv_z, -Xw[..., 1] * inv_z2], dim=-1),
        ],
        dim=-2,
    )  # (O, 2, 3)

    # camera Jacobian [dK | -dK R skew(X)] (translation, then rotation)
    x, y, z = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    col0 = R[..., 1] * z - R[..., 2] * y  # (O, 3) columns of R skew(X)
    col1 = R[..., 2] * x - R[..., 0] * z
    col2 = R[..., 0] * y - R[..., 1] * x
    Rskew = torch.stack([col0, col1, col2], dim=-1)  # (O, 3, 3)
    J_c = torch.cat([dK, -(dK @ Rskew)], dim=-1) * valid[..., None, None]
    J_l = (dK @ R) * valid[..., None, None]  # landmark Jacobian dK R
    return r, J_c, J_l, valid


def _robust_weights(loss: Optional[LossFunction], r: Tensor, valid: Tensor):
    """(rho, w) of each observation's squared residual norm, zero where the
    observation is gated off."""
    sq = torch.sum(r * r, dim=-1)
    if loss is None:
        rho, w = sq, torch.ones_like(sq)
    else:
        rho, w, _ = loss.evaluate(sq)
    return rho * valid, w * valid


def _reduced_solve(U, S_cross, g_c, rhs_cross, lam, cam_free):
    """Damp U (diag *= 1 + lam), put identity blocks on the gauge-fixed
    cameras (their g is zero, so their step is exactly zero), add U to the
    cross term's diagonal blocks and solve S dc = -(g_c + rhs_cross) by
    Cholesky (a NaN step if S is not positive definite). Returns dc (C, k)."""
    C, k = U.shape[0], U.shape[-1]
    eye = torch.eye(k, dtype=U.dtype, device=U.device)
    U = U + lam * U * eye + (1.0 - cam_free)[:, None, None] * eye
    S = _add_diagonal_blocks(S_cross, U)
    rhs = g_c + rhs_cross
    return solve_normal_equations(
        S, -rhs.reshape(C * k), LinearSolverType.DENSE_CHOLESKY
    ).reshape(C, k)


def _flat_schur_step(data: BAData, intr, loss, cam_free: Tensor, C: int, M: int,
                     chunk: Optional[int] = None, chunk_obs: Optional[int] = None,
                     reduce: Optional[Callable] = None):
    """``step(params, lam) -> (dc, dl, cost, g_c, |g_l|^2)`` on the flat
    layout. ``chunk``: accumulate the S cross term over landmark chunks of
    this size, whose observations are contiguous slices of ``chunk_obs``
    rows (:meth:`BundleAdjuster._chunk_group`). With ``reduce`` (sharded:
    ``data`` and the landmarks are this rank's), U, the S cross term, g_c,
    the rhs, the cost and |g_l|^2 are summed across ranks."""
    cam_idx, lm_idx = data.camera_indices, data.landmark_indices
    obs_free = cam_free[cam_idx]
    dtype, device = cam_free.dtype, cam_free.device
    eye3 = torch.eye(3, dtype=dtype, device=device)
    # masked rows (padding) add zeros: no segment holds them, and the cross
    # term puts them at camera C
    real = data.mask > 0
    by_cam = _SegmentSum(torch.where(real, cam_idx, -1).cpu().numpy(), C, device)
    by_lm = _SegmentSum(torch.where(real, lm_idx, -1).cpu().numpy(), M, device)
    cam_cross = torch.where(real, cam_idx, C)

    def step(params: BAParams, lam: Tensor):
        r, J_c, J_l, valid = _observation_residuals_jacobians(params, data, intr)
        J_c = J_c * obs_free[:, None, None]  # fixed cameras: no derivatives
        rho, w = _robust_weights(loss, r, valid)
        cost = torch.sum(rho)

        JcW = J_c * w[:, None, None]
        JlW = J_l * w[:, None, None]
        U_o = JcW.mT @ J_c  # (O, 6, 6)
        V_o = JlW.mT @ J_l  # (O, 3, 3)
        W_o = JcW.mT @ J_l  # (O, 6, 3)
        U, g_c = by_cam(U_o), by_cam(_btv(JcW, r))
        V, g_l = by_lm(V_o), by_lm(_btv(JlW, r))

        # LM damping (reference policy); the floor keeps unobserved
        # landmarks invertible
        V = V + lam * V * eye3 + 1e-8 * eye3
        V_inv = _inv3x3(V)

        # Schur rhs cross term at observation level:
        # rhs_c = -sum_o W_o V^{-1}_{m(o)} g_l[m(o)]
        A_o = W_o @ V_inv[lm_idx]  # (O, 6, 3) = W V^-1
        rhs_cross = -by_cam(_bmv(A_o, g_l[lm_idx]))

        # S cross term: one product over all landmarks, or over chunks
        # (peak memory O(chunk C 18) instead of O(M C 18))
        if chunk is None or chunk >= M:
            S_cross = -_cross_blocks(lm_idx, cam_cross, A_o, W_o, M, C)
        else:
            S_cross = cost.new_zeros((C * 6, C * 6))
            for k in range(-(-M // chunk)):
                o = slice(k * chunk_obs, (k + 1) * chunk_obs)
                rel = torch.clamp(lm_idx[o] - k * chunk, 0, chunk - 1)
                S_cross -= _cross_blocks(rel, cam_cross[o], A_o[o], W_o[o], chunk, C)

        gl_sq = torch.sum(g_l * g_l)
        if reduce is not None:
            # one collective for the whole reduced system
            U, S_cross, g_c, rhs_cross, cost, gl_sq = reduce(
                (U, S_cross, g_c, rhs_cross, cost, gl_sq)
            )
        dc = _reduced_solve(U, S_cross, g_c, rhs_cross, lam, cam_free)

        # landmark back-substitution at observation level:
        # dl = -V^{-1} (g_l + sum_{o in m} W_o^T dc[cam(o)])
        Wt_dc = by_lm(_btv(W_o, dc[cam_idx]))
        dl = -_bmv(V_inv, g_l + Wt_dc)
        return dc, dl, cost, g_c, gl_sq

    return step


def _grouped_schur_step(gdata: GroupedBAData, intr, loss, cam_free: Tensor, C: int,
                        lm_chunk: int):
    """``step(params, lam) -> (dc, dl, cost, g_c, |g_l|^2)`` on the
    track-major layout (M, T): the landmark-side sums (V, g_l, the
    back-substitution) are reductions over the track axis; the camera-side
    sums (U, g_c, the rhs) are segment sums over the tracks' real slots;
    the S cross term is accumulated over chunks of ``lm_chunk`` landmarks
    (M is a multiple of it). The residuals and Jacobians are the flat
    layout's, on the flattened tracks."""
    M, T = gdata.camera_indices.shape
    device, dtype = cam_free.device, cam_free.dtype
    cam_idx = gdata.camera_indices
    obs_free = cam_free[cam_idx]
    rows = torch.arange(lm_chunk, device=device).repeat_interleave(T)
    # padded track slots belong to no camera: camera C in the cross term,
    # no segment in the camera sums
    real = gdata.mask > 0
    cam_cross = torch.where(real, cam_idx, C)
    by_cam = _SegmentSum(torch.where(real, cam_idx, -1).reshape(-1).cpu().numpy(), C, device)
    flat_data = BAData(
        camera_indices=cam_idx.reshape(-1),
        landmark_indices=torch.arange(M, device=device).repeat_interleave(T),
        pixels=gdata.pixels.reshape(-1, 2),
        mask=gdata.mask.reshape(-1),
    )
    eye3 = torch.eye(3, dtype=dtype, device=device)

    def step(params: BAParams, lam: Tensor):
        r_f, Jc_f, Jl_f, valid_f = _observation_residuals_jacobians(params, flat_data, intr)
        r = r_f.reshape(M, T, 2)
        J_c = Jc_f.reshape(M, T, 2, 6) * obs_free[..., None, None]
        J_l = Jl_f.reshape(M, T, 2, 3)
        rho, w = _robust_weights(loss, r, valid_f.reshape(M, T))
        cost = torch.sum(rho)

        JcW = J_c * w[..., None, None]
        JlW = J_l * w[..., None, None]
        # landmark side: reductions over the track axis
        V = torch.sum(JlW.mT @ J_l, dim=1)  # (M, 3, 3)
        g_l = torch.sum(_btv(JlW, r), dim=1)  # (M, 3)
        V = V + lam * V * eye3 + 1e-8 * eye3
        V_inv = _inv3x3(V)

        # camera side: per-observation blocks summed by camera
        W_mt = JcW.mT @ J_l  # (M, T, 6, 3)
        A_mt = W_mt @ V_inv[:, None]  # (M, T, 6, 3) = W V^-1
        U = by_cam((JcW.mT @ J_c).reshape(-1, 6, 6))
        g_c = by_cam(_btv(JcW, r).reshape(-1, 6))
        rhs_cross = -by_cam(_bmv(A_mt, g_l[:, None, :]).reshape(-1, 6))
        S_cross = cost.new_zeros((C * 6, C * 6))
        for k in range(M // lm_chunk):
            m = slice(k * lm_chunk, (k + 1) * lm_chunk)
            S_cross -= _cross_blocks(rows, cam_cross[m].reshape(-1), A_mt[m].reshape(-1, 6, 3),
                                     W_mt[m].reshape(-1, 6, 3), lm_chunk, C)

        dc = _reduced_solve(U, S_cross, g_c, rhs_cross, lam, cam_free)

        # back-substitution: gather dc per observation, reduce over T
        Wt_dc = torch.sum(_btv(W_mt, dc[cam_idx]), dim=1)  # (M, 3)
        dl = -_bmv(V_inv, g_l + Wt_dc)
        return dc, dl, cost, g_c, torch.sum(g_l * g_l)

    return step


def _ba_retract(params: BAParams, dc: Tensor, dl: Tensor) -> BAParams:
    t = params.translations + dc[:, :3]
    dq = lie.so3_exp_quaternion(dc[:, 3:6])
    q = lie.quat_normalize(lie.quat_multiply(params.quaternions, dq))
    return BAParams(t, q, params.landmarks + dl)


def _ba_lm_loop(schur_step: Callable, retract: Callable, params0, options: Options,
                reduce: Optional[Callable] = None):
    """The LM policy loop shared by every bundle-adjustment layout and the
    BAL solver: ``schur_step(params, lam) -> (dc, dl, cost, g_c,
    |g_l|^2)`` (g_c and |g_l|^2 summed over ranks when sharded) and
    ``retract(params, dc, dl) -> params``; ``params0`` is a tuple of
    tensors. A non-finite step becomes a zero step. With
    ``relative_function_tolerance > 0`` three iterations in a row that do
    not beat the best cost by that fraction end the solve, which then
    returns the best-seen state (the monotone safeguard of
    ``solvers/lm.py``). With ``reduce``, |dl|^2 of the rank's landmarks is
    summed across ranks. The host reads one boolean per iteration."""
    oh = options.optimization_handle
    ch = options.convergence_handle
    max_it = options.max_iterations
    first = params0[0]
    dtype, device = first.dtype, first.device
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=device)
    big = torch.finfo(dtype).max
    rtol = ch.relative_function_tolerance
    track_best = rtol > 0.0

    records = IterationRecord(
        *(torch.full((max_it,), float("nan"), dtype=dtype, device=device) for _ in range(4))
    )
    params, best_params = params0, params0
    lam = scalar(oh.initial_lambda)
    prev_cost, last_cost, best = scalar(big), scalar(big), scalar(big)
    stall = torch.zeros((), dtype=torch.int32, device=device)
    plateau = torch.zeros((), dtype=torch.bool, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    count = 0
    for it in range(max_it):
        dc, dl, cost, g_c, gl_sq = schur_step(params, lam)
        finite = torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dl))
        dc = torch.where(finite, dc, torch.zeros_like(dc))
        dl = torch.where(finite, dl, torch.zeros_like(dl))
        new_params = retract(params, dc, dl)

        dl_sq = torch.sum(dl * dl)
        if reduce is not None:
            dl_sq = reduce(dl_sq)
        step_norm = torch.sqrt(torch.sum(dc * dc) + dl_sq)
        grad_norm = torch.sqrt(torch.sum(g_c * g_c) + gl_sq)
        ref_converged = (step_norm < ch.parameter_tolerance) | (grad_norm < ch.gradient_tolerance)
        converged = ref_converged
        if track_best:
            # (best - cost) > rtol * best, as solvers/lm.py; ``cost`` was
            # evaluated at ``params``, the pre-step state
            improved = (best - cost) > rtol * best
            stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
            converged = converged | (stall >= 3)
            better = cost < best
            best_params = tree_map(lambda p, b: torch.where(better, p, b), params, best_params)
            plateau = converged & ~ref_converged
        best = torch.minimum(best, cost)
        increase = cost > prev_cost
        adapted = torch.where(increase, lam * oh.lambda_increase_factor,
                              lam * oh.lambda_decrease_factor)
        adapted = torch.clamp(adapted, oh.min_lambda, oh.max_lambda)
        for rec, value in zip(records, (cost, lam, grad_norm, step_norm)):
            rec[it] = value
        lam = torch.where(converged, lam, adapted)
        prev_cost = torch.where(converged, prev_cost, cost)
        params, last_cost, done = new_params, cost, converged
        count = it + 1
        if bool(converged):  # the one host read of the iteration
            break

    iterations = torch.tensor(count - 1 if bool(done) else count, dtype=torch.int32,
                              device=device)
    final_cost = last_cost
    if track_best:
        params = tree_map(lambda b, p: torch.where(plateau, b, p), best_params, params)
        final_cost = torch.where(plateau, best, last_cost)
    summary = Summary(
        final_cost=final_cost,
        reported_cost=prev_cost,
        iterations=iterations,
        final_lambda=lam,
        converged=done,
        records=records,
        plateau_stop=plateau if track_best else None,
        best_cost=best if track_best else None,
    )
    return params, summary


def _host(a) -> np.ndarray:
    """A host copy of a tensor or an array-like (a writable numpy array)."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.array(a)


class BundleAdjuster:
    """Joint camera-landmark refinement via Schur complement."""

    def __init__(
        self,
        dtype: torch.dtype = torch.float64,
        mesh: Optional[FactorMesh] = None,
        landmark_chunk="auto",
        layout: str = "grouped",
        device="cuda",
    ):
        """``mesh``: optional ``parallel.FactorMesh``: landmarks and their
        observations shard over its ranks, camera state replicates, and the
        reduced camera system is summed across them (BASELINE config 5's
        multi-host BA).

        ``landmark_chunk``: chunk size for the Schur cross-term
        accumulation on the flat layout. "auto" (default) picks one that
        caps the per-chunk (chunk, C, 6, 3) tensor near 64 MB once the
        one-shot (M, C, 6, 3) tensor would exceed 256 MB; None forces one
        shot; an int forces that chunk size.

        ``layout``: "grouped" (default) is the track-major layout on one
        device; "flat" keeps the flat layout (``landmark_chunk`` applies
        to it). The sharded (mesh) path always uses the flat layout.

        ``device``: where the solve runs, default "cuda"; raises without a
        GPU unless "cpu" is asked for."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.mesh = mesh
        self.landmark_chunk = landmark_chunk
        self.layout = layout
        self.loss_function: Optional[LossFunction] = None

    def _resolve_chunk(self, C: int, M: int):
        if self.landmark_chunk != "auto":
            return self.landmark_chunk
        itemsize = torch.finfo(self.dtype).bits // 8
        one_shot_bytes = M * C * 18 * itemsize
        if one_shot_bytes <= 256 * 1024 * 1024:
            return None
        target = 64 * 1024 * 1024
        return max(64, target // (C * 18 * itemsize))

    def set_loss_function(self, loss: Optional[LossFunction]):
        self.loss_function = loss
        return self

    @staticmethod
    def _group_by_landmark(data: BAData, M: int, C: int, itemsize: int):
        """Host-side prep for the grouped layout: bucket observations
        track-major (row m holds landmark m's observations, zero-mask
        padded to the longest track T, rounded up to a multiple of 4). M
        pads up to a multiple of the chunk, chosen as the JAX package
        chooses it (its one-hot (chunk, T, C) tensor near 32 MB). Returns
        (GroupedBAData of numpy arrays, M_pad, lm_chunk)."""
        cam = _host(data.camera_indices)
        lm = _host(data.landmark_indices)
        px = _host(data.pixels)
        mask = _host(data.mask)
        counts = np.bincount(lm, minlength=M)
        T = -(-int(max(counts.max(), 1)) // 4) * 4

        target = 32 * 1024 * 1024
        lm_chunk = max(64, target // max(T * C * itemsize, 1))
        if lm_chunk >= M:
            lm_chunk = M
        M_pad = -(-M // lm_chunk) * lm_chunk

        order = np.argsort(lm, kind="stable")
        slot = (np.concatenate([np.arange(c) for c in counts]) if len(order)
                else np.zeros(0, np.int64))
        rows = lm[order]
        cam_out = np.zeros((M_pad, T), np.int64)
        px_out = np.zeros((M_pad, T, 2), px.dtype)
        mask_out = np.zeros((M_pad, T), mask.dtype)
        cam_out[rows, slot] = cam[order]
        px_out[rows, slot] = px[order]
        mask_out[rows, slot] = mask[order]
        return GroupedBAData(cam_out, px_out, mask_out), M_pad, lm_chunk

    @staticmethod
    def _chunk_group(data: BAData, M: int, chunk: int):
        """Host-side grouping for the chunked Schur path: sort observations
        by landmark chunk and pad every chunk to the same occupancy, so
        each chunk's observations are one contiguous slice. Reordering and
        zero-mask padding preserve every sum. Returns (grouped BAData of
        numpy arrays, O_chunk)."""
        n_chunks = -(-M // chunk)
        cam = _host(data.camera_indices)
        lm = _host(data.landmark_indices)
        px = _host(data.pixels)
        mask = _host(data.mask)
        chunk_of = lm // chunk
        counts = np.bincount(chunk_of, minlength=n_chunks)
        O_chunk = int(max(counts.max(), 1))
        cam_out = np.zeros((n_chunks, O_chunk), np.int64)
        lm_out = np.zeros((n_chunks, O_chunk), np.int64)
        px_out = np.zeros((n_chunks, O_chunk, 2), px.dtype)
        mask_out = np.zeros((n_chunks, O_chunk), mask.dtype)
        for k in range(n_chunks):
            ix = np.nonzero(chunk_of == k)[0]
            cam_out[k, : len(ix)] = cam[ix]
            # padded rows keep a landmark index INSIDE chunk k (their mask
            # is 0: no contribution)
            lm_out[k] = min(k * chunk, M - 1)
            lm_out[k, : len(ix)] = lm[ix]
            px_out[k, : len(ix)] = px[ix]
            mask_out[k, : len(ix)] = mask[ix]
        grouped = BAData(cam_out.reshape(-1), lm_out.reshape(-1), px_out.reshape(-1, 2),
                         mask_out.reshape(-1))
        return grouped, O_chunk

    @staticmethod
    def _shard_prep(data: BAData, M: int, num_shards: int):
        """Sort observations into per-landmark-range shard blocks with
        LOCAL landmark indices; equal block sizes by masked padding.
        Returns (flat BAData of numpy arrays, M_pad, local_M)."""
        local_M = -(-M // num_shards)
        M_pad = local_M * num_shards
        cam = _host(data.camera_indices)
        lm = _host(data.landmark_indices)
        px = _host(data.pixels)
        mask = _host(data.mask)
        shard_of = lm // local_M

        per_shard = [np.nonzero(shard_of == d)[0] for d in range(num_shards)]
        O_shard = max((len(ix) for ix in per_shard), default=1) or 1
        cam_out = np.zeros((num_shards, O_shard), np.int64)
        lm_out = np.zeros((num_shards, O_shard), np.int64)
        px_out = np.zeros((num_shards, O_shard, 2), px.dtype)
        mask_out = np.zeros((num_shards, O_shard), mask.dtype)
        for d, ix in enumerate(per_shard):
            k = len(ix)
            cam_out[d, :k] = cam[ix]
            lm_out[d, :k] = lm[ix] - d * local_M  # LOCAL index
            px_out[d, :k] = px[ix]
            mask_out[d, :k] = mask[ix]
        flat = BAData(cam_out.reshape(-1), lm_out.reshape(-1), px_out.reshape(-1, 2),
                      mask_out.reshape(-1))
        return flat, M_pad, local_M

    def _upload(self, data: BAData) -> BAData:
        """Host observations to the device: indices as int64, pixels and
        mask in the solve's dtype."""
        index = lambda a: torch.as_tensor(_host(a), dtype=torch.int64, device=self.device)
        real = lambda a: torch.as_tensor(_host(a), dtype=self.dtype, device=self.device)
        return type(data)(*(index(f) if "indices" in name else real(f)
                            for name, f in zip(data._fields, data)))

    def solve(
        self,
        options: Options,
        data: BAData,
        intrinsics: CameraIntrinsics,
        camera_poses,  # list[Pose] length C
        landmarks: np.ndarray,  # (M, 3)
        fixed_cameras=(0,),
    ):
        """Returns (optimized_poses, optimized_landmarks, summary); the
        summary's tensors stay on the solve's device.

        ``fixed_cameras`` pins gauge freedom (default: camera 0; pass two
        cameras to also pin scale in monocular problems)."""
        dev, dtype = self.device, self.dtype
        C = len(camera_poses)
        landmarks = _host(landmarks)
        M = landmarks.shape[0]
        free = np.ones(C)
        for ci in fixed_cameras:
            free[ci] = 0.0
        real = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        intr = CameraIntrinsics(*(real(float(v)) for v in intrinsics[:6]),
                                intrinsics.width, intrinsics.height)
        t_arr = real(np.stack([p.translation for p in camera_poses]))
        q_arr = real(np.stack([p.quaternion() for p in camera_poses]))
        cam_free = real(free)
        loss = self.loss_function
        reduce = None

        if self.mesh is None and self.layout == "grouped":
            gdata, M_pad, lm_chunk = self._group_by_landmark(
                data, M, C, torch.finfo(dtype).bits // 8
            )
            lms_pad = np.zeros((M_pad, 3))
            lms_pad[:M] = landmarks
            step = _grouped_schur_step(self._upload(gdata), intr, loss, cam_free, C, lm_chunk)
            params0 = BAParams(t_arr, q_arr, real(lms_pad))
        elif self.mesh is None:
            chunk = self._resolve_chunk(C, M)
            chunk_obs = None
            if chunk is not None and chunk < M:
                data, chunk_obs = self._chunk_group(data, M, chunk)
            step = _flat_schur_step(self._upload(data), intr, loss, cam_free, C, M, chunk,
                                    chunk_obs)
            params0 = BAParams(t_arr, q_arr, real(landmarks))
        else:
            D = self.mesh.devices.size
            flat, M_pad, local_M = self._shard_prep(data, M, D)
            # this rank's block of observations and of landmarks
            O_shard = flat.camera_indices.shape[0] // D
            mine = slice(self.mesh.rank * O_shard, (self.mesh.rank + 1) * O_shard)
            local = BAData(*(f[mine] for f in flat))
            chunk = self._resolve_chunk(C, local_M)
            chunk_obs = None
            if chunk is not None and chunk < local_M:
                local, chunk_obs = self._chunk_group(local, local_M, chunk)
            reduce = reducer(self.mesh)
            step = _flat_schur_step(self._upload(local), intr, loss, cam_free, C, local_M,
                                    chunk, chunk_obs, reduce)
            lms_pad = np.zeros((M_pad, 3))
            lms_pad[:M] = landmarks
            rank_rows = slice(self.mesh.rank * local_M, (self.mesh.rank + 1) * local_M)
            params0 = BAParams(t_arr, q_arr, real(lms_pad[rank_rows]))

        params, summary = _ba_lm_loop(step, _ba_retract, params0, options, reduce)
        if self.mesh is not None:
            from ..parallel import all_gather_rows

            lms_all = all_gather_rows(self.mesh, (params.landmarks,), M_pad)[0]
            params = BAParams(params.translations, params.quaternions, lms_all)
        # one device-to-host copy of the solved state
        state = torch.cat([params.translations.reshape(-1), params.quaternions.reshape(-1),
                           params.landmarks[:M].reshape(-1)]).cpu().numpy().astype(np.float64)
        ts = state[: 3 * C].reshape(C, 3)
        qs = state[3 * C: 7 * C].reshape(C, 4)
        lms = state[7 * C:].reshape(M, 3)
        poses = [Pose(np_quat_to_rotmat(q / np.linalg.norm(q)), ts[i]) for i, q in enumerate(qs)]
        return poses, lms, summary
