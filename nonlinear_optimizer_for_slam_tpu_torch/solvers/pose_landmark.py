"""Pose-landmark SLAM: joint optimization of SE(3) poses and 3-D landmarks
from body-frame landmark observations plus relative-pose (odometry and
loop-closure) edges (PyTorch port of the JAX package's
``solvers/pose_landmark.py``), and its SE(2) counterpart.

The classic landmark-SLAM factor graph, which the reference does not cover
(its pose graph is pose-only, its BA is camera-projection-specific).
Observation factor, for pose i observing landmark j at body-frame
position z:

    r = R(q_i)^T (l_j - p_i) - z        (3,)

whitened by optional per-observation sqrt-information, robustified by an
optional loss. Pose-pose edges reuse the pose graph's edge machinery
(``ops/relative_pose.py`` and ``pose_graph._Graph``: ambient
parameterization, switchable loop constraints, closed-form Jacobians).

Two linear solvers eliminate the landmarks by Schur complement each LM
step, on the one ``solvers/lm`` loop (:func:`_dense_solve` and
:func:`_sparse_solve`, each written once for k-wide poses: the JAX
package's ``_pose_landmark_solve`` and ``_pose_landmark_solve_sparse`` at
k = 7, its ``_pose_landmark_2d_solve`` and
``_pose_landmark_2d_solve_sparse`` at k = 3):

- ``pose_solver="dense"``: the quadratic keeps the landmark block
  structure explicit (a dense (kP+L)^2 pose/switch block T, a dense
  (kP+L, M, 3) coupling W, per-landmark (M, 3, 3) blocks D), and the
  reduced system (T - W D^-1 W^T) dp = -g_T + W D^-1 g_l is one dense
  Cholesky; dl = D^-1 (-g_l - W^T dp). Right up to a few thousand poses.
- ``pose_solver="sparse"``: landmarks are eliminated at observation level
  (no dense coupling) and the reduced pose system, whose sparsity is the
  pose edges plus landmark co-visibility pairs (:func:`build_covis_pairs`),
  is solved by the nested-dissection multifrontal Cholesky
  (``solvers/multifrontal.py``), with the loop switches eliminated per
  edge. City scale.

Every sum of contributions that may repeat a row is
``index_put_(accumulate=True)``: a fixed order of summation (a sort on
CUDA, no float atomics). Marginal covariances (``covariance``,
``landmark_covariance``) linearize on the host in float64 as the JAX
package does; the sparse method's factorization and selected inverse run
on the optimizer's device in float64.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.lie import np_quat_left_matrix
from ..core.options import LinearSolverType, Options
from ..core.pose import Pose, np_quat_to_rotmat
from ..ops.relative_pose import (
    SWITCH_PENALTY_SCALE,
    PoseGraphEdges,
    _normalize_jacobian,
    _rotate_jacobian_wrt_quat,
    apply_sqrt_info,
    np_edge_residuals_and_jacobians,
    stack_sqrt_info,
)
from . import lm, multifrontal
from .bundle_adjustment import _inv3x3
from .linear import damp_hessian, solve_normal_equations
from .pose_graph import (
    ConstraintType,
    PoseGraph2DEdges,
    _bmv,
    _btv,
    _expand_sqrt_info,
    _expand_sqrt_info_2d,
    _Graph,
    _scatter_add,
)

Tensor = torch.Tensor

_CONJ = np.array([1.0, -1.0, -1.0, -1.0])


class LandmarkObservations(NamedTuple):
    """SoA batch of body-frame landmark observations."""

    pose_indices: Tensor  # (O,) int64 into packed poses
    landmark_indices: Tensor  # (O,) int64 into packed landmarks
    measurements: Tensor  # (O, 3) landmark position in the POSE frame
    mask: Tensor  # (O,)
    sqrt_info: Optional[Tensor] = None  # (O, 3) diag or (O, 3, 3)


def observation_residuals_and_jacobians(
    positions: Tensor,  # (P, 3)
    quaternions: Tensor,  # (P, 4) ambient (normalized inside)
    landmarks: Tensor,  # (M, 3)
    obs: LandmarkObservations,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched residuals r = R(n(q))^T (l - p) - z and CLOSED-FORM
    Jacobians with respect to the ambient pose (7) and the landmark (3).

    R(n)^T v = R(conj(n)) v, so the quaternion derivative is the classic
    rotate-Jacobian at conj(n) chained through conjugation and
    normalization.

    Returns (r (O,3), J_pose (O,3,7), J_lm (O,3,3))."""
    p = positions[obs.pose_indices]
    q = quaternions[obs.pose_indices]
    l = landmarks[obs.landmark_indices]
    n = lie.quat_normalize(q)
    cn = lie.quat_conjugate(n)
    v = l - p  # (O, 3)

    Rt_rows = lie.quat_to_rotmat(cn)  # R(conj n) = R(n)^T, (O, 3, 3)
    r = _bmv(Rt_rows, v) - obs.measurements

    # d r / d l = R^T ; d r / d p = -R^T
    # d r / d q = d(R(conj n) v)/d(conj n) @ d(conj n)/dn @ dn/dq
    conj_sign = torch.as_tensor(_CONJ, dtype=positions.dtype, device=positions.device)
    J_q = (_rotate_jacobian_wrt_quat(cn, v) * conj_sign) @ _normalize_jacobian(q)  # (O, 3, 4)
    J_pose = torch.cat([-Rt_rows, J_q], dim=-1)  # (O, 3, 7)
    J_l = Rt_rows

    if obs.sqrt_info is not None:
        r, J_pose, J_l = apply_sqrt_info(obs.sqrt_info, r, J_pose, J_l)
    m = obs.mask
    return r * m[:, None], J_pose * m[:, None, None], J_l * m[:, None, None]


def _robustify(loss, r, *jacobians):
    """Ceres-style per-block robust reweighting over the squared residual
    norm: returns (cost, r', jacobians'); identity when ``loss`` is None.
    Shared by the observation terms of both landmark solvers (the edge
    terms go through ``pose_graph._Graph.linearize``, which does the
    same)."""
    if loss is None:
        return (torch.sum(r * r), r) + jacobians
    sq = torch.sum(r * r, dim=1)
    rho, w, _ = loss.evaluate(sq)
    sw = torch.sqrt(w)
    out = [r * sw[:, None]]
    out += [J * sw.reshape((-1,) + (1,) * (J.dim() - 1)) for J in jacobians]
    return (torch.sum(rho), *out)


def _observe_3d(pose_params: Tensor, landmarks: Tensor, obs: LandmarkObservations):
    return observation_residuals_and_jacobians(
        pose_params[:, :3], pose_params[:, 3:], landmarks, obs
    )


def _observe_2d(pose_params: Tensor, landmarks: Tensor, obs):
    return observation_residuals_and_jacobians_2d(pose_params, landmarks, obs)


def _retract(free_pose: Tensor, free_lm: Tensor):
    """The ambient update of (pose params, switches, landmarks); constant
    poses and landmarks do not move."""

    def retract(params, delta):
        pose_params, sw, lms = params
        dpose, dsw, dlm = delta
        return (pose_params + dpose * free_pose[:, None], sw + dsw, lms + dlm * free_lm[:, None])

    return retract


def _observation_terms(obs, observe: Callable, obs_loss, free_obs_pose: Tensor,
                       free_obs_lm: Tensor):
    """``terms(pose_params, lms) -> (cost, r, J_pose, J_lm)``: the
    gauge-masked, robustified observation blocks."""

    def terms(pose_params, lms):
        r_o, J_po, J_lo = observe(pose_params, lms, obs)
        J_po = J_po * free_obs_pose[:, None, None]
        J_lo = J_lo * free_obs_lm[:, None, None]
        return _robustify(obs_loss, r_o, J_po, J_lo)

    return terms


def _dense_solve(pose0, switches0, landmarks0, edges, obs, free_pose, free_lm,
                 switch_penalty, edge_loss, obs_loss, P: int, M: int, L: int,
                 options: Options, observe: Callable, floor: float):
    """The dense landmark-Schur path for k-wide poses (SE(3): k = 7, 3-D
    landmarks; SE(2): k = 3, 2-D landmarks). The (kP+L)^2 block T, the
    gradient and the (kP+L, M, ld) coupling W are each one
    ``index_put_(accumulate=True)`` of all their per-edge and
    per-observation blocks (edges first, in the JAX package's order).
    ``floor``: the Tikhonov floor on T's and D's diagonals (1e-8 for
    SE(3), 1e-10 for SE(2)). Returns (pose params, switches, landmarks,
    summary)."""
    k, ld = pose0.shape[1], landmarks0.shape[1]
    dimT = k * P + L
    graph = _Graph(edges, free_pose, P, L, switch_penalty, edge_loss)
    dtype, device = graph.dtype, graph.device
    pose_idx, lm_idx = obs.pose_indices, obs.landmark_indices
    ks = torch.arange(k, device=device)
    rows_ref = k * graph.ref_i[:, None] + ks  # (E, k)
    rows_qry = k * graph.qry_i[:, None] + ks
    col_sw = k * P + graph.loop_slot  # (E,)
    rows_obs = k * pose_idx[:, None] + ks  # (O, k)
    col_mask_T = torch.cat(
        [free_pose.repeat_interleave(k), torch.ones(L, dtype=dtype, device=device)]
    )
    terms = _observation_terms(obs, observe, obs_loss, free_pose[pose_idx], free_lm[lm_idx])

    def block(r, c):
        return (r[:, :, None] * dimT + c[:, None, :]).reshape(-1)

    t_index = [block(rows_ref, rows_ref), block(rows_ref, rows_qry),
               block(rows_qry, rows_ref), block(rows_qry, rows_qry)]
    g_index = [rows_ref.reshape(-1), rows_qry.reshape(-1)]
    if L > 0:
        swk = col_sw[:, None].expand_as(rows_ref)
        t_index += [(rows_ref * dimT + swk).reshape(-1), (swk * dimT + rows_ref).reshape(-1),
                    (rows_qry * dimT + swk).reshape(-1), (swk * dimT + rows_qry).reshape(-1),
                    col_sw * dimT + col_sw]
        g_index.append(col_sw)
    t_index = torch.cat(t_index + [block(rows_obs, rows_obs)])
    g_index = torch.cat(g_index + [rows_obs.reshape(-1)])
    w_index = (rows_obs[:, :, None] * (M * ld) + lm_idx[:, None, None] * ld
               + torch.arange(ld, device=device)).reshape(-1)
    eye_ld = torch.eye(ld, dtype=dtype, device=device)

    def quad(params):
        pose_params, sw, lms = params
        r_e, J_ref, J_query, J_s, cost_e = graph.linearize(pose_params, sw)
        cost_o, r_o, J_po, J_lo = terms(pose_params, lms)

        B_rq = J_ref.mT @ J_query
        t_vals = [J_ref.mT @ J_ref, B_rq, B_rq.mT, J_query.mT @ J_query]
        g_vals = [_btv(J_ref, r_e), _btv(J_query, r_e)]
        if L > 0:
            b_rs = _btv(J_ref, J_s)
            b_qs = _btv(J_query, J_s)
            t_vals += [b_rs, b_rs, b_qs, b_qs, torch.sum(J_s * J_s, dim=1)]
            g_vals.append(torch.sum(J_s * r_e, dim=1))
        t_vals.append(J_po.mT @ J_po)
        g_vals.append(_btv(J_po, r_o))
        T = _scatter_add(r_o.new_zeros(dimT * dimT), t_index,
                         torch.cat([v.reshape(-1) for v in t_vals])).reshape(dimT, dimT)
        gT = _scatter_add(r_o.new_zeros(dimT), g_index,
                          torch.cat([v.reshape(-1) for v in g_vals]))
        D = _scatter_add(r_o.new_zeros((M, ld, ld)), lm_idx, J_lo.mT @ J_lo)
        g_l = _scatter_add(r_o.new_zeros((M, ld)), lm_idx, _btv(J_lo, r_o))
        W = _scatter_add(r_o.new_zeros(dimT * M * ld), w_index,
                         (J_po.mT @ J_lo).reshape(-1)).reshape(dimT, M, ld)

        # gauge + rank floors (see the pose graph's dense path)
        diagonal = T.diagonal()
        diagonal.add_(1.0 - col_mask_T)
        diagonal.add_(floor)
        D = D + ((1.0 - free_lm)[:, None, None] + floor) * eye_ld
        return (T, W, D), (gT, g_l), torch.sum(cost_e) + cost_o

    def solve_linear(H_rep, g, lam):
        T, W, D = H_rep
        gT, g_l = g
        # multiplicative damping on both diagonals (lm.damp_hessian form)
        Td = damp_hessian(T, lam)
        # inv_ex: no host read of the info flags
        Dinv = torch.linalg.inv_ex(D + lam * (D * eye_ld))[0]  # (M, ld, ld)
        WDinv = torch.einsum("tma,mab->tmb", W, Dinv).reshape(dimT, M * ld)
        Wf = W.reshape(dimT, M * ld)
        A = Td - WDinv @ Wf.T
        rhs = -gT + WDinv @ g_l.reshape(-1)
        dp = solve_normal_equations(A, rhs, LinearSolverType.DENSE_CHOLESKY)
        dl = _bmv(Dinv, -g_l - (dp @ Wf).reshape(M, ld))
        return (dp[: k * P].reshape(P, k), dp[k * P:], dl)

    (pose_params, sw, lms), summary = lm.solve(
        quad, _retract(free_pose, free_lm), (pose0, switches0, landmarks0), options,
        solve_linear=solve_linear,
    )
    return pose_params, sw, lms, summary


def _sparse_solve(pose0, switches0, landmarks0, edges, obs, free_pose, free_lm,
                  switch_penalty, pair_a, pair_b, pr_i, pr_j, pair_slot, dg_i, dg_j, *,
                  edge_loss, obs_loss, num_poses: int, num_landmarks: int, num_loops: int,
                  num_pairs: int, plan: multifrontal.Plan, options: Options,
                  observe: Callable, inv_block: Callable, floor: float):
    """Landmark SLAM at city scale for k-wide poses: the landmark block is
    eliminated at OBSERVATION level (as the BAL solver does: sums over
    observations, no dense (kP+L, M) coupling) and the Schur-reduced pose
    system is solved by the nested-dissection multifrontal factorization
    instead of a dense (kP+L)^2 Cholesky:

      pair blocks   -W_a D^-1 W_b^T  (co-visibility fill-in, summed per
                                      unique pose pair)
      diag blocks   A_pp - sum_o W_o D^-1 W_o^T  (per pose, dense k x k)
      edge blocks   the pose graph's, the loop switches eliminated
                    exactly per edge (rank 1, inside the pattern)

    Memory is O(observations + pairs + fronts). ``inv_block`` is the
    closed-form inverse of the landmark blocks; ``floor`` the Tikhonov
    floor (1e-8 SE(3), 1e-10 SE(2)). Returns (pose params, switches,
    landmarks, summary)."""
    P, M, L = num_poses, num_landmarks, num_loops
    k, ld = pose0.shape[1], landmarks0.shape[1]
    graph = _Graph(edges, free_pose, P, L, switch_penalty, edge_loss)
    dtype, device = graph.dtype, graph.device
    ref_i, qry_i = graph.ref_i, graph.qry_i
    pose_idx, lm_idx = obs.pose_indices, obs.landmark_indices
    eye_ld = torch.eye(ld, dtype=dtype, device=device)
    eye_k = torch.eye(k, dtype=dtype, device=device)
    # the plan's combined edge list: pose edges, then co-visibility pairs
    all_a = torch.cat([ref_i, pair_a])
    all_b = torch.cat([qry_i, pair_b])
    rows_p = torch.cat([ref_i, qry_i, pose_idx])
    terms = _observation_terms(obs, observe, obs_loss, free_pose[pose_idx], free_lm[lm_idx])

    def quad(params):
        pose_params, sw, lms = params
        r_e, J_ref, J_query, J_s, cost_e = graph.linearize(pose_params, sw)
        cost_o, r_o, J_po, J_lo = terms(pose_params, lms)
        # gradient pieces (observation level, no dense assembly)
        g_p = _scatter_add(r_o.new_zeros((P, k)), rows_p,
                           torch.cat([_btv(J_ref, r_e), _btv(J_query, r_e), _btv(J_po, r_o)]))
        if L > 0:
            g_s = graph.per_switch(torch.sum(J_s * r_e, dim=1))
        else:
            g_s = r_o.new_zeros(0)
        g_l = _scatter_add(r_o.new_zeros((M, ld)), lm_idx, _btv(J_lo, r_o))
        return (J_ref, J_query, J_s, J_po, J_lo), (g_p, g_s, g_l), torch.sum(cost_e) + cost_o

    def solve_linear(H_rep, g, lam):
        J_ref, J_query, J_s, J_po, J_lo = H_rep
        g_p, g_s, g_l = g
        # landmark blocks + damping (reference policy on D)
        D = _scatter_add(J_lo.new_zeros((M, ld, ld)), lm_idx, J_lo.mT @ J_lo)
        D = D + ((1.0 - free_lm)[:, None, None] + floor) * eye_ld
        Dinv = inv_block(D + lam * (D * eye_ld))

        W = J_po.mT @ J_lo  # (O, k, ld)
        WD = W @ Dinv[lm_idx]
        # per-pose diagonal blocks: A_pp - same-observation W D^-1 W^T
        diag_blocks = _scatter_add(J_po.new_zeros((P, k, k)), pose_idx,
                                   J_po.mT @ J_po - WD @ W.mT)
        if dg_i.shape[0]:  # same-pose pairs of one landmark's observations
            Csame = -(WD[dg_i] @ W[dg_j].mT)
            _scatter_add(diag_blocks, pose_idx[dg_i], Csame + Csame.mT)
        # co-visibility pair blocks (row a, column b)
        B_pair = J_po.new_zeros((num_pairs, k, k))
        if num_pairs:
            _scatter_add(B_pair, pair_slot, -(WD[pr_i] @ W[pr_j].mT))

        # pose-edge blocks + exact switch elimination (the sparse pose
        # graph's algebra)
        B_aa = J_ref.mT @ J_ref
        B_bb = J_query.mT @ J_query
        B_ab = J_ref.mT @ J_query
        b_p = _scatter_add(-g_p, pose_idx, _bmv(WD, g_l[lm_idx]))
        if L > 0:
            d_s = graph.per_switch(torch.sum(J_s * J_s, dim=1))
            inv_gamma, g_s_e, Jac, Jbc = graph.eliminate_switches(
                J_ref, J_query, J_s, d_s, g_s, lam, graph.pose_rows, b_p
            )
            ig = inv_gamma[:, None, None]
            B_aa = B_aa - ig * (Jac[:, :, None] * Jac[:, None, :])
            B_bb = B_bb - ig * (Jbc[:, :, None] * Jbc[:, None, :])
            B_ab = B_ab - ig * (Jac[:, :, None] * Jbc[:, None, :])

        # reference damping on the pose diagonal (the diagonal of the
        # UNREDUCED T: edge + observation entries), gauge, rank floor
        d_p = _scatter_add(J_po.new_zeros((P, k)), rows_p, torch.cat(
            [torch.sum(J_ref * J_ref, dim=1), torch.sum(J_query * J_query, dim=1),
             torch.sum(J_po * J_po, dim=1)]))
        dvec = lam * d_p + graph.fixed_p + floor
        diag_blocks = diag_blocks + dvec[:, :, None] * eye_k

        Z = J_po.new_zeros((num_pairs, k, k))
        dp = multifrontal.solve(
            plan, all_a, all_b, torch.cat([B_aa, Z]), torch.cat([B_bb, Z]),
            torch.cat([B_ab, B_pair]), diag_blocks, b_p,
        )
        # switch + landmark back-substitution
        if L > 0:
            ds = graph.back_substitute(J_ref, J_query, J_s, dp[ref_i], dp[qry_i], g_s_e,
                                       inv_gamma)
        else:
            ds = J_po.new_zeros(0)
        Wt_dp = _scatter_add(J_po.new_zeros((M, ld)), lm_idx, _btv(W, dp[pose_idx]))
        dl = _bmv(Dinv, -g_l - Wt_dp)
        return (dp, ds, dl)

    (pose_params, sw, lms), summary = lm.solve(
        quad, _retract(free_pose, free_lm), (pose0, switches0, landmarks0), options,
        solve_linear=solve_linear,
    )
    return pose_params, sw, lms, summary


class _LandmarkRegistry:
    """The registry, the solve and the covariance queries shared by the
    SE(3) and SE(2) optimizers; subclasses give the pose dimension and the
    packing."""

    _K = 7  # pose parameters
    _DP = 6  # tangent pose dimension of the covariance blocks
    _LD = 3  # landmark dimension

    def __init__(self, dtype, switch_penalty, edge_loss, obs_loss, pose_solver, device):
        if pose_solver not in ("dense", "sparse"):
            raise ValueError(f"unknown pose_solver {pose_solver!r}")
        self.device = resolve_device(device)
        self.pose_solver = pose_solver
        self._sparse_cache = None
        self.dtype = dtype
        self.edge_loss = edge_loss
        self.obs_loss = obs_loss
        self.switch_penalty = (
            SWITCH_PENALTY_SCALE if switch_penalty is None else switch_penalty
        )
        self._poses: Dict[int, object] = {}
        self._landmarks: Dict[int, np.ndarray] = {}
        self._constant_poses: set = set()
        self._constant_landmarks: set = set()
        self._constraints: List[dict] = []
        self._observations: List[dict] = []
        self._cov_cache = None
        self._sparse_cov_cache = None

    def _invalidate(self):
        self._cov_cache = None
        self._sparse_cov_cache = None

    def set_landmark(self, index: int, position) -> None:
        self._landmarks[index] = np.asarray(position, np.float64).copy()
        self._invalidate()

    def set_pose_constant(self, index: int) -> None:
        if index not in self._poses:
            raise KeyError(f"pose {index} not registered")
        self._constant_poses.add(index)

    def set_landmark_constant(self, index: int) -> None:
        if index not in self._landmarks:
            raise KeyError(f"landmark {index} not registered")
        self._constant_landmarks.add(index)

    def _check_observation(self, pose_index: int, landmark_index: int) -> None:
        if pose_index not in self._poses:
            raise KeyError(f"pose {pose_index} not registered")
        if landmark_index not in self._landmarks:
            raise KeyError(f"landmark {landmark_index} not registered")

    def _add_observation(self, pose_index, landmark_index, measurement, w) -> None:
        self._observations.append(
            dict(
                pose_index=pose_index,
                landmark_index=landmark_index,
                measurement=np.asarray(measurement, np.float64).copy(),
                sqrt_info=w,
            )
        )

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    @property
    def num_landmarks(self) -> int:
        return len(self._landmarks)

    def pose_indices(self) -> List[int]:
        """Registered pose ids, sorted (the solver's packing order)."""
        return sorted(self._poses)

    def landmark_indices(self) -> List[int]:
        """Registered landmark ids, sorted."""
        return sorted(self._landmarks)

    def constraints(self) -> List[dict]:
        """Shallow copies of the registered pose-pose edge records."""
        return [dict(c) for c in self._constraints]

    def observations(self) -> List[dict]:
        """Shallow copies of the registered observation records."""
        return [dict(o) for o in self._observations]

    def get_landmark(self, index: int) -> np.ndarray:
        return self._landmarks[index].copy()

    # -- solve ---------------------------------------------------------
    def _packing(self):
        pose_ids = sorted(self._poses)
        lm_ids = sorted(self._landmarks)
        pose_of = {pi: i for i, pi in enumerate(pose_ids)}
        lm_of = {li: i for i, li in enumerate(lm_ids)}
        return pose_ids, lm_ids, pose_of, lm_of

    def _observations_dev(self, pose_of, lm_of):
        dev, dtype = self.device, self.dtype
        index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
        w = stack_sqrt_info([o["sqrt_info"] for o in self._observations], self._LD)
        return LandmarkObservations(
            index([pose_of[o["pose_index"]] for o in self._observations]),
            index([lm_of[o["landmark_index"]] for o in self._observations]),
            torch.as_tensor(np.stack([o["measurement"] for o in self._observations]),
                            dtype=dtype, device=dev),
            torch.ones(len(self._observations), dtype=dtype, device=dev),
            sqrt_info=None if w is None else torch.as_tensor(w, dtype=dtype, device=dev),
        )

    def _solve_packed(self, pose_np, lms_np, options):
        """The solve on packed host arrays: (pose params (P, k) float64,
        switches, landmarks (M, ld) float64, summary)."""
        if options is None:
            options = Options().replace(max_iterations=200)
        if not self._observations:
            raise ValueError(f"{type(self).__name__}.solve: no observations registered")
        pose_ids, lm_ids, pose_of, lm_of = self._packing()
        P, M = len(pose_ids), len(lm_ids)
        dev, dtype = self.device, self.dtype
        tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        edges, L = self._edges(pose_of, P)
        obs = self._observations_dev(pose_of, lm_of)
        free_pose = np.ones(P)
        for pi in self._constant_poses:
            free_pose[pose_of[pi]] = 0.0
        free_lm = np.ones(M)
        for li in self._constant_landmarks:
            free_lm[lm_of[li]] = 0.0
        args = (tensor(pose_np), torch.ones(L, dtype=dtype, device=dev), tensor(lms_np), edges,
                obs, tensor(free_pose), tensor(free_lm), self.switch_penalty)
        if self.pose_solver == "sparse":
            plan, pairs = self._sparse_plan(pose_np, obs, edges, P, M)
            index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
            pose, sw, lms, summary = _sparse_solve(
                *args, *(index(a) for a in pairs), edge_loss=self.edge_loss,
                obs_loss=self.obs_loss, num_poses=P, num_landmarks=M, num_loops=L,
                num_pairs=int(len(pairs[0])), plan=plan, options=options, **self._sparse_kw,
            )
        else:
            pose, sw, lms, summary = _dense_solve(
                *args, self.edge_loss, self.obs_loss, P, M, L, options, **self._dense_kw
            )
        # one device-to-host copy of the solved state
        k, ld = self._K, self._LD
        state = torch.cat([pose.reshape(-1), sw, lms.reshape(-1)]).cpu().numpy()
        state = state.astype(np.float64)
        pose = state[: k * P].reshape(P, k).copy()
        sw = state[k * P: k * P + L].copy()
        lms = state[k * P + L:].reshape(M, ld)
        for j, li in enumerate(lm_ids):
            self._landmarks[li] = lms[j].copy()
        self._last_switches = sw.copy()
        return pose_ids, pose, sw, summary

    def _sparse_plan(self, pose_np, obs, edges, P, M):
        """Co-visibility symbolic phase, cached per topology (warm
        restarts reuse the plan)."""
        pose_idx = obs.pose_indices.cpu().numpy()
        lm_idx = obs.landmark_indices.cpu().numpy()
        ref_np = edges.reference_indices.cpu().numpy()
        qry_np = edges.query_indices.cpu().numpy()
        key = (P, M, pose_idx.tobytes(), lm_idx.tobytes(), ref_np.tobytes(), qry_np.tobytes())
        if self._sparse_cache is not None and self._sparse_cache[0] == key:
            return self._sparse_cache[1]
        pairs = build_covis_pairs(pose_idx, lm_idx)
        plan = multifrontal.symbolic(
            P, np.concatenate([ref_np, pairs[0]]), np.concatenate([qry_np, pairs[1]]),
            d=self._K, coords=np.asarray(pose_np[:, self._COORDS], np.float64),
            leaf_size=self._LEAF,
        )
        self._sparse_cache = (key, (plan, pairs))
        return plan, pairs

    # -- uncertainty ---------------------------------------------------
    def covariance(self, indices=None, method="auto") -> Dict[int, np.ndarray]:
        """Marginal pose covariance blocks in the TANGENT chart (6x6 for
        SE(3): translation, then rotation; 3x3 for SE(2): x, y, theta) from
        the JOINT pose+landmark information; constant poses get zero.

        ``method``: "dense" inverts the full joint information on the host
        (O((dp P + dl M)^3), fine to a few hundred poses); "sparse"
        eliminates the landmark blocks exactly per landmark and runs the
        multifrontal selected inverse on the reduced pose system over
        pose-edge + co-visibility sparsity; "auto" picks sparse once the
        joint dimension exceeds 2,400. Both agree to float64 roundoff."""
        method = self._pick_cov_method(method)
        ids = self.pose_indices() if indices is None else indices
        if method == "sparse":
            pose_blocks, _, pose_of, _ = self._sparse_marginals()
            return {pi: pose_blocks[pose_of[pi]].copy() for pi in ids}
        Sigma, pose_of, lm_of = self._joint_covariance()
        d = self._DP
        return {pi: Sigma[d * pose_of[pi]: d * pose_of[pi] + d,
                          d * pose_of[pi]: d * pose_of[pi] + d].copy() for pi in ids}

    def landmark_covariance(self, indices=None, method="auto") -> Dict[int, np.ndarray]:
        """Marginal landmark covariance blocks (pose uncertainty fully
        propagated); constant landmarks get zero. ``method`` as in
        :meth:`covariance`; the sparse path back-propagates the reduced
        pose covariance through each landmark's Schur complement,
        Sigma_l = D^-1 + D^-1 W^T Sigma_p W D^-1 (over the co-visibility
        pairs; no joint inverse is formed)."""
        method = self._pick_cov_method(method)
        ids = self.landmark_indices() if indices is None else indices
        if method == "sparse":
            _, lm_blocks, _, lm_of = self._sparse_marginals()
            return {li: lm_blocks[lm_of[li]].copy() for li in ids}
        Sigma, pose_of, lm_of = self._joint_covariance()
        base, d = self._DP * len(pose_of), self._LD
        return {li: Sigma[base + d * lm_of[li]: base + d * lm_of[li] + d,
                          base + d * lm_of[li]: base + d * lm_of[li] + d].copy() for li in ids}

    def _pick_cov_method(self, method: str) -> str:
        if method not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown covariance method {method!r}")
        if method == "auto":
            dim = self._DP * len(self._poses) + self._LD * len(self._landmarks)
            method = "sparse" if dim > 2400 else "dense"
        return method

    def _sparse_marginals(self):
        """(pose_blocks, lm_blocks, pose_of, lm_of) by landmark elimination
        + the multifrontal selected inverse (:func:`_sparse_marginals_from_lin`).

        The joint information is [[A, W], [W^T, D]] with D block-diagonal
        per landmark. Pose marginals are the diagonal blocks of S^-1,
        S = A - W D^-1 W^T, from the selected inverse over the reduced
        system's pose-edge + co-visibility sparsity. Landmark marginals
        back-propagate: Sigma_l = D_l^-1 + D_l^-1 (sum_{a,b in obs(l)}
        W_al^T Sigma_p[a,b] W_bl) D_l^-1; every needed off-diagonal
        Sigma_p[a,b] is a co-visibility pair, an EDGE of the reduced
        system, so the selected inverse holds it."""
        if self._sparse_cov_cache is not None:
            return self._sparse_cov_cache
        lin = self._tangent_linearization()
        pose_blocks, lm_blocks = _sparse_marginals_from_lin(
            lin, dp=self._DP, dl=self._LD, device=self.device
        )
        self._sparse_cov_cache = (pose_blocks, lm_blocks, lin["pose_of"], lin["lm_of"])
        return self._sparse_cov_cache

    def _check_gauge(self):
        if not self._observations:
            raise ValueError("covariance: no observations registered")
        if not self._constant_poses and not self._constant_landmarks:
            raise ValueError(
                "covariance: gauge-free graph has unbounded covariance; "
                "fix a pose or landmark first"
            )

    def _loop_switches(self):
        """(is_loop (E,), each edge's switch value): loops at the values
        the last solve() learned (fixed at their MAP value; a rejected
        loop, s ~ 0, contributes ~no information)."""
        is_loop = np.array(
            [1.0 if c["type"] == ConstraintType.LOOP else 0.0 for c in self._constraints]
        )
        L = int(is_loop.sum())
        sw = getattr(self, "_last_switches", None)
        if sw is None or len(sw) != L:
            sw = np.ones(L)
        slot = np.clip(np.cumsum(is_loop.astype(int)) - 1, 0, max(L - 1, 0))
        return is_loop, np.where(is_loop > 0, sw[slot] if L else 1.0, 1.0)

    def _joint_covariance(self):
        if self._cov_cache is not None:
            # one inverse serves covariance() and landmark_covariance();
            # solve() and registry edits invalidate it
            return self._cov_cache
        lin = self._tangent_linearization()
        P, M = lin["P"], lin["M"]
        dp, dl = self._DP, self._LD
        dim = dp * P + dl * M
        H = np.zeros((dim, dim))
        rp = np.arange(dp)
        if lin["edge"] is not None:
            J_ref, J_qry, ref_i, qry_i = lin["edge"]
            _np_scatter_pair(H, dp * ref_i[:, None] + rp, dp * qry_i[:, None] + rp, J_ref, J_qry)
        J_pose, J_lm, o_pi, o_li = lin["obs"]
        _np_scatter_pair(H, dp * o_pi[:, None] + rp,
                         dp * P + dl * o_li[:, None] + np.arange(dl), J_pose, J_lm)
        keep = np.concatenate([np.repeat(lin["free_p"], dp).astype(bool),
                               np.repeat(lin["free_l"], dl).astype(bool)])
        try:
            Sigma_red = np.linalg.inv(H[np.ix_(keep, keep)])
        except np.linalg.LinAlgError as exc:
            raise ValueError(self._SINGULAR) from exc
        Sigma = np.zeros((dim, dim))
        kk = np.nonzero(keep)[0]
        Sigma[np.ix_(kk, kk)] = Sigma_red
        self._cov_cache = (Sigma, lin["pose_of"], lin["lm_of"])
        return self._cov_cache


def _loss_sqrt_weight(loss, r: np.ndarray) -> np.ndarray:
    """(E, 1, 1) sqrt(rho'(|r|^2)) of a loss, on the host in float64."""
    _, w, _ = loss.evaluate(torch.as_tensor(np.sum(r * r, axis=1), dtype=torch.float64))
    return np.sqrt(w.numpy())[:, None, None]


class PoseLandmarkOptimizer(_LandmarkRegistry):
    """Registry + solve() for the pose-landmark graph (the API of
    PoseGraphOptimizer, extended with landmarks and observations)."""

    _K, _DP, _LD = 7, 6, 3
    _COORDS = slice(0, 3)
    _LEAF = 16
    _dense_kw = dict(observe=_observe_3d, floor=1e-8)
    _sparse_kw = dict(observe=_observe_3d, inv_block=_inv3x3, floor=1e-8)
    _SINGULAR = ("covariance: information matrix is singular — under-constrained graph "
                 "(unobserved landmarks or disconnected poses)")

    def __init__(
        self,
        dtype: torch.dtype = torch.float64,
        switch_penalty: float = None,
        edge_loss=None,
        obs_loss=None,
        pose_solver: str = "dense",
        device="cuda",
    ):
        """``pose_solver``: "dense" solves the landmark-Schur-reduced pose
        system as one (7P+L)^2 Cholesky (right up to a few thousand poses);
        "sparse" eliminates landmarks at OBSERVATION level and solves the
        reduced system with the nested-dissection multifrontal
        factorization over pose-edge + landmark co-visibility sparsity
        (city scale: the dense coupling tensor never exists).

        ``device``: where the solve runs, default "cuda"; raises without a
        GPU unless "cpu" is asked for."""
        super().__init__(dtype, switch_penalty, edge_loss, obs_loss, pose_solver, device)

    # -- registry ----------------------------------------------------
    def set_pose(self, index: int, pose: Pose) -> None:
        self._poses[index] = pose.copy()
        self._invalidate()

    def set_constraint(
        self,
        reference_index: int,
        query_index: int,
        relative_pose: Pose,
        constraint_type: int = ConstraintType.ODOMETRY,
        sqrt_info=None,
    ) -> None:
        """Pose-pose edge; see PoseGraphOptimizer.set_constraint."""
        if reference_index not in self._poses or query_index not in self._poses:
            raise KeyError("constraint endpoints must be registered poses")
        if reference_index == query_index:
            raise ValueError("self-constraint is not allowed")
        self._constraints.append(
            dict(
                reference_index=reference_index,
                query_index=query_index,
                relative_pose=relative_pose.copy(),
                type=constraint_type,
                sqrt_info=_expand_sqrt_info(sqrt_info),
            )
        )

    def set_observation(
        self, pose_index: int, landmark_index: int, measurement, sqrt_info=None
    ) -> None:
        """Body-frame observation of a landmark from a pose:
        measurement = R_i^T (l_j - p_i) + noise. ``sqrt_info``: scalar /
        (3,) diagonal / (3, 3) matrix."""
        self._check_observation(pose_index, landmark_index)
        w = sqrt_info
        if w is not None:
            w = np.asarray(w, np.float64)
            if w.ndim == 0 or w.size == 1:
                w = np.full(3, float(w.reshape(-1)[0]))
            elif not (w.shape == (3,) or w.shape == (3, 3)):
                # NOT the SE(2) (trans, rot) shorthand: a point residual
                # has no translation/rotation split, so (2,) is an error
                raise ValueError(
                    f"observation sqrt_info must be scalar, (3,) diagonal, "
                    f"or (3, 3); got shape {w.shape}"
                )
        self._add_observation(pose_index, landmark_index, measurement, w)

    def get_pose(self, index: int) -> Pose:
        return self._poses[index].copy()

    def _edges(self, pose_of, P):
        dev, dtype = self.device, self.dtype
        index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
        real = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        cs = self._constraints
        if not cs:
            # one masked placeholder edge keeps the shapes nonzero
            return PoseGraphEdges(
                index([0]), index([min(1, P - 1)]), real(np.zeros((1, 3))),
                real([[1.0, 0.0, 0.0, 0.0]]), real([0.0]), real([0.0]),
            ), 0
        is_loop = np.array([1.0 if c["type"] == ConstraintType.LOOP else 0.0 for c in cs])
        w = stack_sqrt_info([c["sqrt_info"] for c in cs], 6)
        return PoseGraphEdges(
            index([pose_of[c["reference_index"]] for c in cs]),
            index([pose_of[c["query_index"]] for c in cs]),
            real(np.stack([c["relative_pose"].translation for c in cs])),
            real(np.stack([c["relative_pose"].quaternion() for c in cs])),
            real(is_loop),
            real(np.ones(len(cs))),
            sqrt_info=None if w is None else real(w),
        ), int(is_loop.sum())

    def solve(self, options: Optional[Options] = None):
        """Optimize all poses and landmarks; write them back (quaternions
        renormalized). Returns (summary, switch_values); the summary's
        tensors stay on the solve's device."""
        pose_ids = sorted(self._poses)
        pose_np = np.concatenate([
            np.stack([self._poses[pi].translation for pi in pose_ids]),
            np.stack([self._poses[pi].quaternion() for pi in pose_ids]),
        ], axis=1) if pose_ids else np.zeros((0, 7))
        lms_np = np.stack([self._landmarks[li] for li in sorted(self._landmarks)]) \
            if self._landmarks else np.zeros((0, 3))
        pose_ids, pose, sw, summary = self._solve_packed(pose_np, lms_np, options)
        quat = pose[:, 3:] / np.linalg.norm(pose[:, 3:], axis=1, keepdims=True)
        for i, pi in enumerate(pose_ids):
            self._poses[pi] = Pose(np_quat_to_rotmat(quat[i]), pose[i, :3].copy())
        self._invalidate()
        return summary, sw

    def _tangent_linearization(self):
        """Host float64 tangent-chart (6-DoF pose / 3-DoF landmark)
        linearization at the current estimates, shared by the dense joint
        inverse and the sparse marginals. Constant poses and landmarks
        have their Jacobian columns zeroed.

        Returns a dict with the pose and landmark id maps, free masks, the
        freed tangent edge blocks (J_ref, J_qry, ref_i, qry_i; None
        without constraints), and the freed observation blocks (J_pose,
        J_lm, o_pi, o_li)."""
        self._check_gauge()
        pose_ids, lm_ids, pose_of, lm_of = self._packing()
        P, M = len(pose_ids), len(lm_ids)
        pos = np.stack([self._poses[pi].translation for pi in pose_ids]).astype(np.float64)
        quat = np.stack([self._poses[pi].quaternion() for pi in pose_ids]).astype(np.float64)
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        lms = np.stack([self._landmarks[li] for li in lm_ids]).astype(np.float64)
        Tq = 0.5 * np_quat_left_matrix(quat)[:, :, 1:]  # (P, 4, 3)
        free_p = np.array([0.0 if pi in self._constant_poses else 1.0 for pi in pose_ids])
        free_l = np.array([0.0 if li in self._constant_landmarks else 1.0 for li in lm_ids])

        def tangent(J, idx):
            return np.concatenate([J[:, :, :3], J[:, :, 3:] @ Tq[idx]], axis=2)

        edge = None
        if self._constraints:
            cs = self._constraints
            ref_i = np.array([pose_of[c["reference_index"]] for c in cs])
            qry_i = np.array([pose_of[c["query_index"]] for c in cs])
            is_loop, sw_full = self._loop_switches()
            r, J_ref, J_qry, _ = np_edge_residuals_and_jacobians(
                pos, quat, sw_full, ref_i, qry_i,
                np.stack([c["relative_pose"].translation for c in cs]),
                np.stack([c["relative_pose"].quaternion() for c in cs]),
                is_loop, 0.0, sqrt_info=stack_sqrt_info([c["sqrt_info"] for c in cs], 6),
            )
            if self.edge_loss is not None:
                s = _loss_sqrt_weight(self.edge_loss, r)
                J_ref, J_qry = J_ref * s, J_qry * s
            edge = (tangent(J_ref, ref_i) * free_p[ref_i][:, None, None],
                    tangent(J_qry, qry_i) * free_p[qry_i][:, None, None], ref_i, qry_i)

        o_pi = np.array([pose_of[o["pose_index"]] for o in self._observations])
        o_li = np.array([lm_of[o["landmark_index"]] for o in self._observations])
        meas = np.stack([o["measurement"] for o in self._observations])
        wo = stack_sqrt_info([o["sqrt_info"] for o in self._observations], 3)
        r_o, J_pose_amb, J_lm = np_observation_jacobians(pos, quat, lms, o_pi, o_li, meas, wo)
        if self.obs_loss is not None:
            s = _loss_sqrt_weight(self.obs_loss, r_o)
            J_pose_amb, J_lm = J_pose_amb * s, J_lm * s
        J_pose = tangent(J_pose_amb, o_pi) * free_p[o_pi][:, None, None]
        J_lm = J_lm * free_l[o_li][:, None, None]
        return dict(
            pose_ids=pose_ids, lm_ids=lm_ids, pose_of=pose_of, lm_of=lm_of,
            P=P, M=M, pos=pos, free_p=free_p, free_l=free_l, edge=edge,
            obs=(J_pose, J_lm, o_pi, o_li),
        )


def _sparse_marginals_from_lin(lin, dp: int, dl: int, device):
    """The sparse selected-inverse marginals shared by the SE(3) (dp=6,
    dl=3) and SE(2) (dp=3, dl=2) landmark optimizers (see
    ``_LandmarkRegistry._sparse_marginals`` for the derivation). ``lin``
    is a tangent-linearization dict. The landmark elimination and the
    back-propagation run on the host in float64, as in the JAX package;
    the multifrontal factorization and selected inverse on ``device`` in
    float64, with one copy back."""
    P, M = lin["P"], lin["M"]
    free_p, free_l = lin["free_p"], lin["free_l"]
    J_pose, J_lm, o_pi, o_li = lin["obs"]

    # aggregate observations per (pose, landmark): W_pl cross blocks and
    # per-landmark D blocks
    key = o_pi.astype(np.int64) * M + o_li
    ukey, inv = np.unique(key, return_inverse=True)
    e_pose = (ukey // M).astype(np.int64)
    e_lm = (ukey % M).astype(np.int64)
    nE = len(ukey)
    W_pl = np.zeros((nE, dp, dl))
    np.add.at(W_pl, inv, np.einsum("odi,odj->oij", J_pose, J_lm))
    D = np.zeros((M, dl, dl))
    np.add.at(D, o_li, np.einsum("odi,odj->oij", J_lm, J_lm))
    U = np.zeros((P, dp, dp))
    np.add.at(U, o_pi, np.einsum("odi,odj->oij", J_pose, J_pose))

    # D^-1 per free landmark (constant landmarks have zeroed J_lm: pad
    # their D with identity, then zero the result)
    try:
        Dinv = np.linalg.inv(D + (1.0 - free_l)[:, None, None] * np.eye(dl))
    except np.linalg.LinAlgError as exc:
        raise ValueError(
            "covariance: landmark information is singular — unobserved free landmarks"
        ) from exc
    Dinv *= free_l[:, None, None]

    # Schur downdates over the co-visibility structure of the DEDUPED
    # (pose, landmark) entries (no same-pose pairs after the dedup)
    pair_a, pair_b, pr_i, pr_j, pair_slot, _, _ = build_covis_pairs(e_pose, e_lm)
    X = np.einsum("eij,ejk->eik", W_pl, Dinv[e_lm])  # (nE, dp, dl)
    np.add.at(U, e_pose, -np.einsum("eij,ekj->eik", X, W_pl))
    npairs = len(pair_a)
    cross = np.zeros((npairs, dp, dp))
    np.add.at(cross, pair_slot, -np.einsum("kij,klj->kil", X[pr_i], W_pl[pr_j]))

    # reduced-system edges: pose-pose constraints + co-visibility pairs
    if lin["edge"] is not None:
        J_ref, J_qry, ref_i, qry_i = lin["edge"]
        e_a = np.concatenate([ref_i.astype(np.int64), pair_a])
        e_b = np.concatenate([qry_i.astype(np.int64), pair_b])
        B_aa = np.concatenate([np.einsum("edi,edj->eij", J_ref, J_ref), np.zeros((npairs, dp, dp))])
        B_bb = np.concatenate([np.einsum("edi,edj->eij", J_qry, J_qry), np.zeros((npairs, dp, dp))])
        B_ab = np.concatenate([np.einsum("edi,edj->eij", J_ref, J_qry), cross])
    else:
        e_a, e_b = pair_a, pair_b
        B_aa = np.zeros((npairs, dp, dp))
        B_bb = np.zeros((npairs, dp, dp))
        B_ab = cross
    diag = U + (1.0 - free_p)[:, None, None] * np.eye(dp)

    # leaf 192 as the JAX package plans it (fewer, larger fronts)
    plan = multifrontal.symbolic(P, e_a, e_b, d=dp, coords=lin["pos"], leaf_size=192)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    fact = multifrontal.factor(plan, f64(B_aa), f64(B_bb), f64(B_ab), f64(diag))
    sig_diag, sig_pairs = multifrontal.selected_inverse_pairs(plan, fact, pair_a, pair_b)
    both = torch.cat([sig_diag.reshape(-1), sig_pairs.reshape(-1)]).cpu().numpy()
    sig_diag = both[: P * dp * dp].reshape(P, dp, dp)
    sig_pairs = both[P * dp * dp:].reshape(npairs, dp, dp)
    if not np.all(np.isfinite(sig_diag)):
        raise ValueError(
            "covariance: information matrix is singular — "
            "under-constrained graph (unobserved landmarks or "
            "disconnected poses)"
        )
    pose_blocks = sig_diag * free_p[:, None, None]

    # landmark back-propagation: M_l = sum W^T Sigma_p W over the (a, a)
    # diagonal and both orientations of each (a, b) pair
    Mk = np.zeros((M, dl, dl))
    np.add.at(Mk, e_lm, np.einsum("eji,ejk,ekl->eil", W_pl, sig_diag[e_pose], W_pl))
    if npairs:
        Sab = np.einsum("kji,kjl,klm->kim", W_pl[pr_i], sig_pairs[pair_slot], W_pl[pr_j])
        np.add.at(Mk, e_lm[pr_i], Sab + np.swapaxes(Sab, 1, 2))
    lm_blocks = Dinv + np.einsum("lij,ljk,lkm->lim", Dinv, Mk, Dinv)
    lm_blocks *= free_l[:, None, None]
    return pose_blocks, lm_blocks


def _np_scatter_pair(H, rows_a, rows_b, J_a, J_b):
    """Scatter-add the Gauss-Newton contributions of a two-block factor
    batch into dense H: diagonal blocks for a and b plus the symmetric
    cross term (shared by the edge and observation assemblies of both
    joint-covariance assemblies)."""
    np.add.at(H, (rows_a[:, :, None], rows_a[:, None, :]), np.einsum("edi,edj->eij", J_a, J_a))
    np.add.at(H, (rows_b[:, :, None], rows_b[:, None, :]), np.einsum("edi,edj->eij", J_b, J_b))
    cross = np.einsum("edi,edj->eij", J_a, J_b)
    np.add.at(H, (rows_a[:, :, None], rows_b[:, None, :]), cross)
    np.add.at(H, (rows_b[:, :, None], rows_a[:, None, :]), np.swapaxes(cross, 1, 2))


def np_observation_jacobians(
    positions, quaternions_unit, landmarks, pose_idx, lm_idx, measurements,
    sqrt_info=None,
):
    """Numpy twin of :func:`observation_residuals_and_jacobians` for UNIT
    quaternions (host covariance assembly; d(q/|q|)/dq at |q| = 1 is
    I - q q^T). Returns (r (O,3), J_pose (O,3,7) ambient, J_lm (O,3,3))."""
    q = quaternions_unit[pose_idx]
    p = positions[pose_idx]
    l = landmarks[lm_idx]
    v = l - p
    cn = q * _CONJ

    Rt = np.stack([np_quat_to_rotmat(ci) for ci in cn])  # (O, 3, 3)
    r = np.einsum("oij,oj->oi", Rt, v) - measurements

    def skew(x):
        a, b, c = x[..., 0], x[..., 1], x[..., 2]
        o = np.zeros_like(a)
        return np.stack(
            [np.stack([o, -c, b], -1), np.stack([c, o, -a], -1), np.stack([-b, a, o], -1)], -2,
        )

    w = cn[:, 0]
    u = cn[:, 1:]
    uxv = np.cross(u, v)
    d_dw = 2.0 * uxv
    d_du = -2.0 * w[:, None, None] * skew(v) - 2.0 * skew(uxv) - 2.0 * skew(u) @ skew(v)
    drot_dcn = np.concatenate([d_dw[:, :, None], d_du], axis=-1)  # (O, 3, 4)
    Dn = np.eye(4)[None] - q[:, :, None] * q[:, None, :]  # unit-q normalize J
    J_q = (drot_dcn * _CONJ[None, None, :]) @ Dn
    J_pose = np.concatenate([-Rt, J_q], axis=-1)
    J_lm = Rt.copy()
    if sqrt_info is not None:
        r, J_pose, J_lm = apply_sqrt_info(sqrt_info, r, J_pose, J_lm)
    return r, J_pose, J_lm


# ----------------------------------------------------------------------------
# SE(2) landmark SLAM (victoria-park style: VERTEX_XY / EDGE_SE2_XY). The
# same Schur-eliminated design with a (3P+L) pose/switch block and 2x2
# landmark blocks; pose-pose edges are the SE(2) pose graph's.
# ----------------------------------------------------------------------------


class LandmarkObservations2D(NamedTuple):
    pose_indices: Tensor  # (O,) int64
    landmark_indices: Tensor  # (O,) int64
    measurements: Tensor  # (O, 2) landmark position in the POSE frame
    mask: Tensor  # (O,)
    sqrt_info: Optional[Tensor] = None  # (O, 2) diag or (O, 2, 2)


def observation_residuals_and_jacobians_2d(
    xyt: Tensor,  # (P, 3)
    landmarks: Tensor,  # (M, 2)
    obs: LandmarkObservations2D,
) -> Tuple[Tensor, Tensor, Tensor]:
    """r = R(th)^T (l - p) - z; closed-form J with respect to (x, y, th)
    and l. Returns (r (O,2), J_pose (O,2,3), J_lm (O,2,2))."""
    pose = xyt[obs.pose_indices]
    l = landmarks[obs.landmark_indices]
    c, s = torch.cos(pose[:, 2]), torch.sin(pose[:, 2])
    dx = l[:, 0] - pose[:, 0]
    dy = l[:, 1] - pose[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    r = torch.stack([lx, ly], dim=-1) - obs.measurements

    # d r / d th = [-s dx + c dy ; -c dx - s dy]
    J_pose = torch.stack(
        [
            torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
            torch.stack([s, -c, -c * dx - s * dy], dim=-1),
        ],
        dim=-2,
    )  # (O, 2, 3)
    J_lm = torch.stack([torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)], dim=-2)

    if obs.sqrt_info is not None:
        r, J_pose, J_lm = apply_sqrt_info(obs.sqrt_info, r, J_pose, J_lm)
    m = obs.mask
    return r * m[:, None], J_pose * m[:, None, None], J_lm * m[:, None, None]


def _inv2x2(A: Tensor) -> Tensor:
    """Closed-form batched 2x2 inverse."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    return torch.stack(
        [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
    ) / det[..., None, None]


class PoseLandmark2DOptimizer(_LandmarkRegistry):
    """SE(2) pose-landmark SLAM (the victoria-park family); the API of
    :class:`PoseLandmarkOptimizer` with xyt poses and 2-D landmarks,
    ``pose_solver="sparse"`` included."""

    _K, _DP, _LD = 3, 3, 2
    _COORDS = slice(0, 2)
    _LEAF = 32
    _dense_kw = dict(observe=_observe_2d, floor=1e-10)
    _sparse_kw = dict(observe=_observe_2d, inv_block=_inv2x2, floor=1e-10)
    _SINGULAR = "covariance: information matrix is singular — under-constrained graph"

    def __init__(
        self,
        dtype: torch.dtype = torch.float64,
        switch_penalty: float = None,
        edge_loss=None,
        obs_loss=None,
        pose_solver: str = "dense",
        device="cuda",
    ):
        super().__init__(dtype, switch_penalty, edge_loss, obs_loss, pose_solver, device)

    def set_pose(self, index: int, xyt) -> None:
        self._poses[index] = np.asarray(xyt, np.float64).copy()
        self._invalidate()

    def set_constraint(
        self,
        reference_index: int,
        query_index: int,
        relative_xyt,
        constraint_type: int = ConstraintType.ODOMETRY,
        sqrt_info=None,
    ) -> None:
        if reference_index not in self._poses or query_index not in self._poses:
            raise KeyError("constraint endpoints must be registered poses")
        if reference_index == query_index:
            raise ValueError("self-constraint is not allowed")
        self._constraints.append(
            dict(
                reference_index=reference_index,
                query_index=query_index,
                relative_xyt=np.asarray(relative_xyt, np.float64).copy(),
                type=constraint_type,
                sqrt_info=_expand_sqrt_info_2d(sqrt_info),
            )
        )

    def set_observation(
        self, pose_index: int, landmark_index: int, measurement, sqrt_info=None
    ) -> None:
        """Pose-frame observation: measurement = R(th)^T (l - p) + noise.
        ``sqrt_info``: scalar / (2,) diagonal / (2, 2) matrix."""
        self._check_observation(pose_index, landmark_index)
        w = sqrt_info
        if w is not None:
            w = np.asarray(w, np.float64)
            if w.ndim == 0:
                w = np.full(2, float(w))
            elif w.ndim == 1 and w.size == 1:
                w = np.full(2, w[0])
            elif not (w.shape == (2,) or w.shape == (2, 2)):
                raise ValueError(f"sqrt_info must be scalar, (2,), or (2, 2); got {w.shape}")
        self._add_observation(pose_index, landmark_index, measurement, w)

    def get_pose(self, index: int) -> np.ndarray:
        return self._poses[index].copy()

    def _edges(self, pose_of, P):
        dev, dtype = self.device, self.dtype
        index = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
        real = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        cs = self._constraints
        if not cs:
            return PoseGraph2DEdges(
                index([0]), index([min(1, P - 1)]), real(np.zeros((1, 3))), real([0.0]),
                real([0.0]),
            ), 0
        is_loop = np.array([1.0 if c["type"] == ConstraintType.LOOP else 0.0 for c in cs])
        w = stack_sqrt_info([c["sqrt_info"] for c in cs], 3)
        return PoseGraph2DEdges(
            index([pose_of[c["reference_index"]] for c in cs]),
            index([pose_of[c["query_index"]] for c in cs]),
            real(np.stack([c["relative_xyt"] for c in cs])),
            real(is_loop),
            real(np.ones(len(cs))),
            sqrt_info=None if w is None else real(w),
        ), int(is_loop.sum())

    def solve(self, options: Optional[Options] = None):
        """Optimize all poses and landmarks; write them back with theta
        wrapped to (-pi, pi]. Returns (summary, switch_values)."""
        pose_np = (np.stack([self._poses[pi] for pi in sorted(self._poses)])
                   if self._poses else np.zeros((0, 3)))
        lms_np = (np.stack([self._landmarks[li] for li in sorted(self._landmarks)])
                  if self._landmarks else np.zeros((0, 2)))
        pose_ids, xyt, sw, summary = self._solve_packed(pose_np, lms_np, options)
        for i, pi in enumerate(pose_ids):
            o = xyt[i].copy()
            o[2] = float(np.arctan2(np.sin(o[2]), np.cos(o[2])))
            self._poses[pi] = o
        self._invalidate()
        return summary, sw

    def _tangent_linearization_2d(self):
        """Host float64 SE(2) linearization at the current estimates (the
        contract of the SE(3) class's ``_tangent_linearization``; ``pos``
        carries the (x, y) coordinates for the dissection)."""
        self._check_gauge()
        pose_ids, lm_ids, pose_of, lm_of = self._packing()
        P, M = len(pose_ids), len(lm_ids)
        xyt = np.stack([self._poses[pi] for pi in pose_ids]).astype(np.float64)
        lms = np.stack([self._landmarks[li] for li in lm_ids]).astype(np.float64)
        free_p = np.array([0.0 if pi in self._constant_poses else 1.0 for pi in pose_ids])
        free_l = np.array([0.0 if li in self._constant_landmarks else 1.0 for li in lm_ids])

        edge = None
        if self._constraints:
            cs = self._constraints
            ref_i = np.array([pose_of[c["reference_index"]] for c in cs])
            qry_i = np.array([pose_of[c["query_index"]] for c in cs])
            rel = np.stack([c["relative_xyt"] for c in cs])
            c_, s_ = np.cos(xyt[ref_i, 2]), np.sin(xyt[ref_i, 2])
            dx = xyt[qry_i, 0] - xyt[ref_i, 0]
            dy = xyt[qry_i, 1] - xyt[ref_i, 1]
            zero = np.zeros_like(c_)
            one = np.ones_like(c_)
            J_ref = np.stack(
                [
                    np.stack([-c_, -s_, -s_ * dx + c_ * dy], -1),
                    np.stack([s_, -c_, -c_ * dx - s_ * dy], -1),
                    np.stack([zero, zero, -one], -1),
                ],
                -2,
            )
            J_qry = np.stack(
                [
                    np.stack([c_, s_, zero], -1),
                    np.stack([-s_, c_, zero], -1),
                    np.stack([zero, zero, one], -1),
                ],
                -2,
            )
            w3 = stack_sqrt_info([c["sqrt_info"] for c in cs], 3)
            if w3 is not None or self.edge_loss is not None:
                dth = xyt[qry_i, 2] - xyt[ref_i, 2] - rel[:, 2]
                r_e = np.stack(
                    [c_ * dx + s_ * dy - rel[:, 0], -s_ * dx + c_ * dy - rel[:, 1],
                     np.arctan2(np.sin(dth), np.cos(dth))], -1,
                )
            if w3 is not None:
                r_e, J_ref, J_qry = apply_sqrt_info(w3, r_e, J_ref, J_qry)
            if self.edge_loss is not None:
                s = _loss_sqrt_weight(self.edge_loss, r_e)
                J_ref, J_qry = J_ref * s, J_qry * s
            # loop edges at their learned (fixed) switch values, as the
            # SE(3) class
            _, sw_full = self._loop_switches()
            J_ref = J_ref * (sw_full * free_p[ref_i])[:, None, None]
            J_qry = J_qry * (sw_full * free_p[qry_i])[:, None, None]
            edge = (J_ref, J_qry, ref_i, qry_i)

        o_pi = np.array([pose_of[o["pose_index"]] for o in self._observations])
        o_li = np.array([lm_of[o["landmark_index"]] for o in self._observations])
        meas = np.stack([o["measurement"] for o in self._observations])
        c_, s_ = np.cos(xyt[o_pi, 2]), np.sin(xyt[o_pi, 2])
        dx = lms[o_li, 0] - xyt[o_pi, 0]
        dy = lms[o_li, 1] - xyt[o_pi, 1]
        r_o = np.stack([c_ * dx + s_ * dy - meas[:, 0], -s_ * dx + c_ * dy - meas[:, 1]], -1)
        J_pose = np.stack(
            [
                np.stack([-c_, -s_, -s_ * dx + c_ * dy], -1),
                np.stack([s_, -c_, -c_ * dx - s_ * dy], -1),
            ],
            -2,
        )
        J_lm = np.stack([np.stack([c_, s_], -1), np.stack([-s_, c_], -1)], -2)
        wo = stack_sqrt_info([o["sqrt_info"] for o in self._observations], 2)
        if wo is not None:
            r_o, J_pose, J_lm = apply_sqrt_info(wo, r_o, J_pose, J_lm)
        if self.obs_loss is not None:
            s = _loss_sqrt_weight(self.obs_loss, r_o)
            J_pose, J_lm = J_pose * s, J_lm * s
        J_pose = J_pose * free_p[o_pi][:, None, None]
        J_lm = J_lm * free_l[o_li][:, None, None]
        return dict(
            pose_ids=pose_ids, lm_ids=lm_ids, pose_of=pose_of, lm_of=lm_of,
            P=P, M=M, pos=xyt[:, :2].copy(), free_p=free_p, free_l=free_l,
            edge=edge, obs=(J_pose, J_lm, o_pi, o_li),
        )

    # the registry's covariance queries call it by the SE(3) class's name
    _tangent_linearization = _tangent_linearization_2d


def build_covis_pairs(pose_idx: np.ndarray, lm_idx: np.ndarray):
    """HOST symbolic helper for the sparse reduced pose system: all
    landmark co-visibility contributions.

    For each landmark, every unordered pair of its observations (i, j)
    contributes the Schur cross block -W_i D^-1 W_j^T. Pairs whose two
    observations come from DIFFERENT poses (a < b by pose index) map to a
    unique (a, b) pose pair (the fill-in edges of the reduced system);
    same-pose pairs fold into that pose's diagonal block.

    Returns (pair_a, pair_b, pr_i, pr_j, pair_slot, dg_i, dg_j):
      pair_a/pair_b (npairs,) unique pose pairs;
      pr_i/pr_j (ncontrib,) observation ids with pose(pr_i) < pose(pr_j);
      pair_slot (ncontrib,) contribution -> pair row;
      dg_i/dg_j (nsame,) same-pose observation pairs (i != j).
    """
    pose_idx = np.asarray(pose_idx)
    lm_idx = np.asarray(lm_idx)
    n = len(lm_idx)
    empty32 = np.zeros(0, np.int32)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                empty32, empty32, empty32, empty32, empty32)
    order = np.argsort(lm_idx, kind="stable")
    sl = lm_idx[order]
    starts = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
    ends = np.r_[starts[1:], n]
    sizes = ends - starts
    total_pairs = int(np.sum(sizes.astype(np.int64) * (sizes - 1) // 2))
    kmax = int(sizes.max())
    # the contribution count is quadratic in the largest observation
    # group: one long-lived landmark seen from k poses alone yields
    # k(k-1)/2 Schur cross contributions
    if total_pairs > 20_000_000:
        import warnings

        warnings.warn(
            f"build_covis_pairs: {total_pairs:,} co-visibility "
            f"contributions (largest landmark group {kmax:,} "
            f"observations — k(k-1)/2 pairs per landmark). The sparse "
            "reduced system will be built but the symbolic arrays are "
            "O(pairs); consider pose_solver='dense' or capping "
            "observations per landmark.",
            stacklevel=2,
        )
    # vectorized pair enumeration: one triu_indices template per distinct
    # group size, gathered through each group's observation ids
    tri_cache = {}
    ii, jj = [], []
    for s, e, k in zip(starts, ends, sizes):
        if k < 2:
            continue
        t = tri_cache.get(k)
        if t is None:
            t = np.triu_indices(int(k), 1)
            tri_cache[k] = t
        g = order[s:e]
        ii.append(g[t[0]])
        jj.append(g[t[1]])
    if not ii:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                empty32, empty32, empty32, empty32, empty32)
    i = np.concatenate(ii)
    j = np.concatenate(jj)
    pa = pose_idx[i].astype(np.int64)
    pb = pose_idx[j].astype(np.int64)
    same = pa == pb
    dg_i, dg_j = i[same], j[same]
    i, j, pa, pb = i[~same], j[~same], pa[~same], pb[~same]
    swap = pa > pb
    pr_i = np.where(swap, j, i)
    pr_j = np.where(swap, i, j)
    a = np.minimum(pa, pb)
    b = np.maximum(pa, pb)
    span = int(pose_idx.max()) + 1
    uk, pair_slot = np.unique(a * span + b, return_inverse=True)
    return (
        uk // span, uk % span,
        pr_i.astype(np.int32), pr_j.astype(np.int32),
        pair_slot.astype(np.int32),
        dg_i.astype(np.int32), dg_j.astype(np.int32),
    )
