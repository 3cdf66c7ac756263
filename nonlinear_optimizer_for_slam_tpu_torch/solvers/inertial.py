"""Inertial state-estimation graph (PyTorch port of the JAX package's
``solvers/inertial.py``): keyframe states (p, q, v, b_g, b_a) bound by
preintegrated IMU factors, bias random-walk factors, relative-pose
(vision/lidar odometry) edges, and unary priors (GPS positions, velocity,
bias).

GPS-INS smoothing and inertial odometry on top of ``ops/imu.py``, beyond
the reference (which has nothing inertial). Each LM iteration evaluates
the closed-form per-factor Jacobians (``ops.imu.imu_residuals_and_jacobians``
and the pose-graph edge closed form) and assembles the dense (16N)^2
normal equations; the canonical ``lm.solve`` policy loop drives damping
and convergence. The full-stack ``torch.func.jacfwd`` formulation is kept
as :func:`_inertial_solve_ad`, the test oracle.

Assembly: every factor family contributes 16x16 blocks at (state, state)
block positions; all of an evaluation's blocks are summed into an
(N N, 16, 16) block array by ONE ``index_put_(accumulate=True)`` over the
block index (a few factors share a block, so the serial sum of an index's
duplicates on CUDA costs little), then laid out as the dense matrix. The
JAX package scatters each family's blocks element by element; the sums
differ only in their order.

State layout per keyframe: [p (3), q (4, ambient), v (3), b_g (3),
b_a (3)] = 16. Gauge: fix the first state (``set_state_constant``) and/or
anchor with position priors; with gravity observable through the
accelerometer, position priors and a fixed (or yaw-prior'd) first state
make the graph well-posed.

Entry points take ``device=`` (default "cuda", raising without a GPU
unless the caller asks for the CPU) and default to float64, which the
H100 has natively (the JAX package's own default is float64 too).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.options import Options
from ..core.pose import Pose, np_quat_to_rotmat
from ..ops.imu import (
    GRAVITY,
    ImuPreintegrator,
    PreintegratedImuFactor,
    imu_residuals,
    imu_residuals_and_jacobians,
    np_imu_residual,
)
from ..ops.relative_pose import (
    PoseGraphEdges,
    _normalize_jacobian,
    _quat_left_matrix,
    edge_residuals,
    edge_residuals_and_jacobians,
    np_quat_conjugate,
    np_quat_multiply,
    stack_sqrt_info,
)
from . import lm
from .pose_graph import _expand_sqrt_info, _fetch

Tensor = torch.Tensor


class _Priors(NamedTuple):
    """SoA unary priors; each row targets one state's component block."""

    idx: Tensor  # (K,) int64
    value: Tensor  # (K, d)
    weight: Tensor  # (K, d) diagonal sqrt-info


# (prior family, offset in the packed state, width)
_PRIOR_SLOTS = (("pos", 0, 3), ("vel", 7, 3), ("bias", 10, 6))


def _mprior_dphi(xs: Tensor, m_lin: Tensor):
    """The marginal prior's 15-D tangent deviation of state ``xs`` from its
    linearization point, and the hemisphere sign of the rotation part."""
    q_lin = m_lin[3:7] / torch.linalg.vector_norm(m_lin[3:7])
    nq = xs[3:7] / torch.linalg.vector_norm(xs[3:7])
    e_q = lie.quat_multiply(lie.quat_conjugate(q_lin), nq)
    # shortest-arc hemisphere (every other rotation residual here
    # sign-normalizes; without it a large window step that flips the
    # ambient sign measures the 2 pi complement)
    sign = torch.where(e_q[0] < 0, -torch.ones_like(e_q[0]), torch.ones_like(e_q[0]))
    dtheta = 2.0 * (sign * e_q)[1:]
    return torch.cat([xs[:3] - m_lin[:3], dtheta, xs[7:] - m_lin[7:]]), sign, q_lin


def _inertial_solve(
    x0,  # (N, 16)
    factors: PreintegratedImuFactor,
    walk_pairs,  # (B, 2) int64
    walk_w,  # (B, 6)
    edges: Optional[PoseGraphEdges],
    priors,  # dict of _Priors (pos / vel / bias)
    free_mask,  # (N, 16) per-component
    gravity,  # (3,) world-frame gravity vector
    mprior,  # None | (idx (), S (15,15), c (15,), lin (16,)): the fixed-lag
    # smoother's Gaussian marginal over one state's 15-DoF tangent
    num_states: int,
    options: Options,
):
    """Production inertial solve: closed-form per-factor Jacobians,
    block-assembled into the dense normal equations (module docstring).
    :func:`_inertial_solve_ad` is its oracle."""
    N = num_states
    dtype, device = x0.dtype, x0.device
    col_mask = free_mask.reshape(-1)
    n = 16 * N
    eye16 = torch.eye(16, dtype=dtype, device=device)
    has_imu, has_walks = factors.dt.shape[0] > 0, walk_pairs.shape[0] > 0
    active_priors = [(key, off, d) for key, off, d in _PRIOR_SLOTS if priors[key].idx.shape[0] > 0]

    def pair_blocks(Ja, Jb):
        """H blocks of a two-block factor family: Ja (F, d, 16) at state
        column block a, Jb at b."""
        Hab = Ja.mT @ Jb
        return [Ja.mT @ Ja, Hab, Hab.mT, Jb.mT @ Jb]

    def pair_grads(Ja, Jb, r):
        return [(Ja.mT @ r[..., None])[..., 0], (Jb.mT @ r[..., None])[..., 0]]

    # Built once per solve: where each family's blocks and gradients go (in
    # the order they are summed: IMU, walks, edges, priors, marginal
    # prior), and the blocks of the families whose residuals are linear
    # (bias walks, priors), so an LM iteration evaluates only the rest.
    block_at, grad_at = [], []

    def pair_slots(idx_a, idx_b):
        block_at.extend([idx_a * N + idx_a, idx_a * N + idx_b,
                         idx_b * N + idx_a, idx_b * N + idx_b])
        grad_at.extend([idx_a, idx_b])

    if has_imu:
        pair_slots(factors.i, factors.j)
    if has_walks:
        wi, wj = walk_pairs[:, 0], walk_pairs[:, 1]
        # bias columns live at state offset 10:16
        diag_w = torch.diag_embed(walk_w)
        pad = torch.zeros((walk_w.shape[0], 6, 10), dtype=dtype, device=device)
        Jw_i = torch.cat([pad, -diag_w], dim=-1) * free_mask[wi][:, None, :]
        Jw_j = torch.cat([pad, diag_w], dim=-1) * free_mask[wj][:, None, :]
        walk_blocks = pair_blocks(Jw_i, Jw_j)
        pair_slots(wi, wj)
    if edges is not None:
        pair_slots(edges.reference_indices, edges.query_indices)
        E = edges.mask.shape[0]
        ones_e = torch.ones((E,), dtype=dtype, device=device)
        pad_e = torch.zeros((E, 7, 9), dtype=dtype, device=device)
    prior_wm, prior_blocks = {}, {}
    for key, off, d in active_priors:
        pr = priors[key]
        prior_wm[key] = pr.weight * free_mask[pr.idx, off:off + d]  # masked diag J
        blk = torch.zeros((pr.idx.shape[0], 16), dtype=dtype, device=device)
        blk[:, off:off + d] = prior_wm[key] * prior_wm[key]
        prior_blocks[key] = torch.diag_embed(blk)
        block_at.append(pr.idx * N + pr.idx)
        grad_at.append(pr.idx)
    if mprior is not None:
        m_idx, m_S, m_c, m_lin = mprior
        block_at.append((m_idx * N + m_idx).reshape(1))
        grad_at.append(m_idx.reshape(1))
    block_at = torch.cat(block_at)
    grad_at = torch.cat(grad_at)

    def quad(xflat):
        x = xflat.reshape(N, 16)
        p, q, v, b = x[:, :3], x[:, 3:7], x[:, 7:10], x[:, 10:16]
        blocks, grads = [], []
        cost = torch.zeros((), dtype=dtype, device=device)

        if has_imu:
            r_f, J_i, J_j = imu_residuals_and_jacobians(p, q, v, b, factors, gravity)
            J_i = J_i * free_mask[factors.i][:, None, :]
            J_j = J_j * free_mask[factors.j][:, None, :]
            blocks += pair_blocks(J_i, J_j)
            grads += pair_grads(J_i, J_j, r_f)
            cost = cost + torch.sum(r_f * r_f)

        if has_walks:
            r_w = (b[wj] - b[wi]) * walk_w  # (B, 6)
            blocks += walk_blocks
            grads += pair_grads(Jw_i, Jw_j, r_w)
            cost = cost + torch.sum(r_w * r_w)

        if edges is not None:
            r_e, J_ref, J_qry, _ = edge_residuals_and_jacobians(p, q, ones_e, edges, 0.0)
            # (E, 7), (E, 7, 7) over the (p, q) columns
            Je_ref = torch.cat([J_ref, pad_e], dim=-1) * free_mask[edges.reference_indices][:, None, :]
            Je_qry = torch.cat([J_qry, pad_e], dim=-1) * free_mask[edges.query_indices][:, None, :]
            blocks += pair_blocks(Je_ref, Je_qry)
            grads += pair_grads(Je_ref, Je_qry, r_e)
            cost = cost + torch.sum(r_e * r_e)

        for key, off, d in active_priors:
            pr = priors[key]
            r_p = (x[pr.idx, off:off + d] - pr.value) * pr.weight  # (K, d)
            gk = torch.zeros((pr.idx.shape[0], 16), dtype=dtype, device=device)
            gk[:, off:off + d] = prior_wm[key] * r_p
            blocks.append(prior_blocks[key])
            grads.append(gk)
            cost = cost + torch.sum(r_p * r_p)

        if mprior is not None:
            xs = x[m_idx]
            dphi, sign, q_lin = _mprior_dphi(xs, m_lin)
            r_m = m_S @ dphi + m_c  # (15,)
            # d dphi / d xs: translation/vel/bias identity; rotation rows
            # 2 sign (L(conj(q_lin)) Dn)[1:4] over the ambient quaternion
            Dn = _normalize_jacobian(xs[3:7])
            Dth = 2.0 * sign * (_quat_left_matrix(lie.quat_conjugate(q_lin)) @ Dn)[1:4]
            Ddphi = torch.zeros((15, 16), dtype=dtype, device=device)
            Ddphi[0:3, 0:3] = eye16[:3, :3]
            Ddphi[3:6, 3:7] = Dth
            Ddphi[6:15, 7:16] = eye16[:9, :9]
            J_m = (m_S @ Ddphi) * free_mask[m_idx][None, :]  # (15, 16)
            blocks.append((J_m.T @ J_m)[None])
            grads.append((J_m.T @ r_m)[None])
            cost = cost + torch.sum(r_m * r_m)

        Hb = torch.zeros((N * N, 16, 16), dtype=dtype, device=device)
        Hb.index_put_((block_at,), torch.cat(blocks), accumulate=True)
        H = Hb.view(N, N, 16, 16).permute(0, 2, 1, 3).reshape(n, n)
        diag = H.diagonal()
        diag.add_(1.0 - col_mask)
        diag.add_(1e-10)
        g = torch.zeros((N, 16), dtype=dtype, device=device)
        g.index_put_((grad_at,), torch.cat(grads), accumulate=True)
        return H, g.reshape(n), cost

    def retract(xflat, delta):
        return xflat + delta * col_mask

    x, summary = lm.solve(quad, retract, x0.reshape(-1), options)
    return x.reshape(N, 16), summary


def _residual_stack(xflat, factors, walk_pairs, walk_w, edges, priors,
                    gravity, mprior, N):
    """The full whitened residual stack at a flattened (N*16,) state: the
    one objective definition that every solve path (closed form, jacfwd
    oracle) and the external scipy anchor consume (the reference's
    shared-cost-functor pattern, pose_graph_optimizer_ceres.cc:15-69)."""
    x = xflat.reshape(N, 16)
    p, q, v, b = x[:, :3], x[:, 3:7], x[:, 7:10], x[:, 10:16]
    parts = [imu_residuals(p, q, v, b, factors, gravity).reshape(-1)]
    if walk_pairs.shape[0] > 0:
        dw = (b[walk_pairs[:, 1]] - b[walk_pairs[:, 0]]) * walk_w
        parts.append(dw.reshape(-1))
    if edges is not None:
        E = edges.mask.shape[0]
        ones = torch.ones((E,), dtype=xflat.dtype, device=xflat.device)
        # (E, 7); no switchable loops on odometry edges
        parts.append(edge_residuals(p, q, ones, edges, 0.0).reshape(-1))
    for key, off, d in _PRIOR_SLOTS:
        pr = priors[key]
        if pr.idx.shape[0] > 0:
            parts.append(((x[pr.idx, off:off + d] - pr.value) * pr.weight).reshape(-1))
    if mprior is not None:
        # affine tangent prior r = S dphi + c (the pose fixed-lag
        # smoother's form and rationale, fixed_lag.py)
        m_idx, m_S, m_c, m_lin = mprior
        parts.append(m_S @ _mprior_dphi(x[m_idx], m_lin)[0] + m_c)
    return torch.cat(parts)


def _inertial_solve_ad(
    x0,  # (N, 16)
    factors: PreintegratedImuFactor,
    walk_pairs,  # (B, 2) int64
    walk_w,  # (B, 6)
    edges: Optional[PoseGraphEdges],
    priors,
    free_mask,  # (N, 16) per-component
    gravity,  # (3,)
    mprior,
    num_states: int,
    options: Options,
):
    """Full-stack jacfwd formulation, the TEST ORACLE for
    :func:`_inertial_solve`: one ``torch.func.jacfwd`` over the flattened
    (N, 16) state, 16N columns."""
    N = num_states
    col_mask = free_mask.reshape(-1)

    def residual_stack(xflat):
        return _residual_stack(
            xflat, factors, walk_pairs, walk_w, edges, priors, gravity, mprior, N,
        )

    def quad(xflat):
        r = residual_stack(xflat)
        J = torch.func.jacfwd(residual_stack)(xflat) * col_mask[None, :]
        H = J.T @ J
        diag = H.diagonal()
        diag.add_(1.0 - col_mask)
        diag.add_(1e-10)
        return H, J.T @ r, torch.sum(r * r)

    def retract(xflat, delta):
        return xflat + delta * col_mask

    x, summary = lm.solve(quad, retract, x0.reshape(-1), options)
    return x.reshape(N, 16), summary


def _pack_imu_factors(imu, of, dtype, device="cpu") -> PreintegratedImuFactor:
    """SoA-pack registered IMU factor dicts (shared by the batch optimizer
    and the fixed-lag smoother)."""
    index = lambda a: torch.as_tensor(np.asarray(a, np.int64).reshape(-1), device=device)
    if imu:
        def st(key):
            return torch.as_tensor(np.stack([f[key] for f in imu]), dtype=dtype, device=device)

        return PreintegratedImuFactor(
            index([of[f["i"]] for f in imu]),
            index([of[f["j"]] for f in imu]),
            st("delta_q"), st("delta_v"), st("delta_p"),
            torch.as_tensor(np.array([f["dt"] for f in imu]), dtype=dtype, device=device),
            st("dR_dbg"), st("dv_dbg"), st("dv_dba"),
            st("dp_dbg"), st("dp_dba"), st("sqrt_info"), st("bias0"),
        )
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return PreintegratedImuFactor(
        index([]), index([]), z(0, 4), z(0, 3), z(0, 3), z(0),
        z(0, 3, 3), z(0, 3, 3), z(0, 3, 3), z(0, 3, 3), z(0, 3, 3), z(0, 9, 9), z(0, 6),
    )


def _pack_walks(walks, of, dtype, device="cpu"):
    pairs = torch.as_tensor(
        np.array([[of[i], of[j]] for (i, j, _) in walks], np.int64).reshape(-1, 2),
        device=device,
    )
    w = torch.as_tensor(
        np.array([w for (_, _, w) in walks], np.float64).reshape(-1, 6), dtype=dtype, device=device
    )
    return pairs, w


def _pack_priors(prior_lists, of, dtype, device="cpu"):
    out = {}
    for key, _, d in _PRIOR_SLOTS:
        rows = prior_lists[key]
        out[key] = _Priors(
            torch.as_tensor(np.array([of[i] for (i, _, _) in rows], np.int64), device=device),
            torch.as_tensor(np.array([v for (_, v, _) in rows], np.float64).reshape(-1, d),
                            dtype=dtype, device=device),
            torch.as_tensor(np.array([w for (_, _, w) in rows], np.float64).reshape(-1, d),
                            dtype=dtype, device=device),
        )
    return out


def _walk_weights(sqrt_info) -> np.ndarray:
    """(6,) bias-walk weights from a scalar, (2,) = (gyro, accel) or (6,)."""
    w = np.asarray(sqrt_info, np.float64).reshape(-1)
    if w.size == 1:
        return np.full(6, w[0])
    if w.size == 2:
        return np.concatenate([np.full(3, w[0]), np.full(3, w[1])])
    if w.size != 6:
        raise ValueError(f"sqrt_info must be scalar/(2,)/(6,), got {w.size}")
    return w


def _factor_arrays(preintegrated) -> dict:
    return (
        preintegrated.to_factor_arrays()
        if isinstance(preintegrated, ImuPreintegrator)
        else dict(preintegrated)
    )


def _packed_state(pose: Pose, velocity, gyro_bias, accel_bias) -> np.ndarray:
    v = np.zeros(3) if velocity is None else np.asarray(velocity, np.float64)
    bg = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias, np.float64)
    ba = np.zeros(3) if accel_bias is None else np.asarray(accel_bias, np.float64)
    return np.concatenate([pose.translation, pose.quaternion(), v, bg, ba])


def _state_tuple(x: np.ndarray):
    """(Pose, velocity (3,), bias (6,)) of a packed state."""
    q = x[3:7] / np.linalg.norm(x[3:7])
    return Pose(np_quat_to_rotmat(q), x[:3].copy()), x[7:10].copy(), x[10:16].copy()


def _unit_rows(x: np.ndarray) -> np.ndarray:
    """Fetched (N, 16) states as float64 with unit quaternions."""
    x = np.array(x, np.float64)
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    return x


class InertialGraphOptimizer:
    """Registry and solve() for the inertial keyframe graph.

    ``device`` defaults to "cuda" (raising without a GPU unless the caller
    asks for "cpu"); ``dtype`` to float64."""

    def __init__(self, dtype: Optional[torch.dtype] = None, gravity=None, device="cuda"):
        """``gravity``: world-frame gravity vector; default ENU
        (0, 0, -9.81). Pass (0, 0, +9.81) for NED, or a locally calibrated
        magnitude: every IMU residual whitens against it."""
        self.device = resolve_device(device)
        self.dtype = torch.float64 if dtype is None else dtype
        self.gravity = (
            GRAVITY.copy() if gravity is None else np.asarray(gravity, np.float64)
        )
        self._states: Dict[int, np.ndarray] = {}  # (16,) packed
        self._constant: Dict[int, set] = {}
        self._imu: List[dict] = []  # (i, j, factor-array dict)
        self._walks: List[tuple] = []  # (i, j, w6)
        self._edges: List[dict] = []
        self._priors: Dict[str, List[tuple]] = {"pos": [], "vel": [], "bias": []}
        # the device SoA of the registered factors, kept until the registry
        # changes (residual_vector is called once per function evaluation
        # by an external solver)
        self._packed = None

    # -- registry ------------------------------------------------------
    def add_state(
        self, index: int, pose: Pose, velocity=None, gyro_bias=None, accel_bias=None
    ) -> None:
        self._packed = None
        self._states[index] = _packed_state(pose, velocity, gyro_bias, accel_bias)

    _COMPONENT_SLICES = {"pose": slice(0, 7), "velocity": slice(7, 10),
                         "bias": slice(10, 16)}

    def set_state_constant(self, index: int, components=("pose",)) -> None:
        """Freeze components of a state. The DEFAULT freezes only the POSE
        (the gauge): freezing the whole state would pin its bias at the
        initial guess, and strong bias-walk factors then drag every other
        bias toward that frozen value, the classic way to silently break
        bias estimation. Pass components=("pose", "velocity", "bias") to
        freeze everything."""
        if index not in self._states:
            raise KeyError(f"state {index} not registered")
        for c in components:
            if c not in self._COMPONENT_SLICES:
                raise ValueError(
                    f"unknown component {c!r}; use pose/velocity/bias"
                )
        self._packed = None
        self._constant.setdefault(index, set()).update(components)

    def add_imu_factor(self, i: int, j: int, preintegrated) -> None:
        """``preintegrated``: an ``ops.imu.ImuPreintegrator`` (or its
        ``to_factor_arrays()`` dict)."""
        if i not in self._states or j not in self._states:
            raise KeyError("IMU factor endpoints must be registered states")
        self._packed = None
        self._imu.append(dict(i=i, j=j, **_factor_arrays(preintegrated)))

    def add_bias_walk(self, i: int, j: int, sqrt_info) -> None:
        """Random-walk factor (b_j - b_i) * w; ``sqrt_info``: scalar,
        (2,) = (gyro, accel), or (6,)."""
        if i not in self._states or j not in self._states:
            raise KeyError("bias-walk endpoints must be registered states")
        self._packed = None
        self._walks.append((i, j, _walk_weights(sqrt_info)))

    def set_constraint(self, i: int, j: int, relative_pose: Pose, sqrt_info=None) -> None:
        """Relative-pose (odometry) edge on the pose slice: the pose-graph
        edge machinery, no switch variables."""
        if i not in self._states or j not in self._states:
            raise KeyError("edge endpoints must be registered states")
        self._packed = None
        self._edges.append(
            dict(i=i, j=j, rel=relative_pose.copy(), sqrt_info=_expand_sqrt_info(sqrt_info))
        )

    def add_position_prior(self, index: int, position, sqrt_info=1.0) -> None:
        """GPS-style unary prior on p; ``sqrt_info`` scalar or (3,)."""
        self._add_prior("pos", index, np.asarray(position, np.float64), sqrt_info, 3)

    def add_velocity_prior(self, index: int, velocity, sqrt_info=1.0) -> None:
        self._add_prior("vel", index, np.asarray(velocity, np.float64), sqrt_info, 3)

    def add_bias_prior(self, index: int, bias6, sqrt_info=1.0) -> None:
        self._add_prior("bias", index, np.asarray(bias6, np.float64), sqrt_info, 6)

    def _add_prior(self, key, index, value, sqrt_info, d):
        if index not in self._states:
            raise KeyError(f"state {index} not registered")
        w = np.asarray(sqrt_info, np.float64).reshape(-1)
        w = np.full(d, w[0]) if w.size == 1 else w
        if w.size != d or value.size != d:
            raise ValueError(f"{key} prior needs ({d},) value/weight")
        self._packed = None
        self._priors[key].append((index, value, w))

    def get_state(self, index: int):
        """(Pose, velocity (3,), bias (6,))."""
        return _state_tuple(self._states[index])

    def get_pose(self, index: int) -> Pose:
        return self.get_state(index)[0]

    @property
    def num_states(self) -> int:
        return len(self._states)

    # -- solve ---------------------------------------------------------
    def _pack_problem(self):
        """The current states (N, 16) and the SoA of the registered factors
        on the device (shared by solve and the residual-vector
        evaluation; the SoA is packed once per registry)."""
        if self._packed is None:
            self._packed = self._pack_factors()
        ids = self._packed[0]
        x0 = np.stack([self._states[si] for si in ids])
        return (*self._packed[:3], x0, *self._packed[3:])

    def _pack_factors(self):
        ids = sorted(self._states)
        of = {si: k for k, si in enumerate(ids)}
        N = len(ids)
        dtype, device = self.dtype, self.device

        factors = _pack_imu_factors(self._imu, of, dtype, device)
        walk_pairs, walk_w = _pack_walks(self._walks, of, dtype, device)

        edges = None
        if self._edges:
            E = len(self._edges)
            tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
            index = lambda key: torch.as_tensor(
                np.array([of[e[key]] for e in self._edges], np.int64), device=device
            )
            w = stack_sqrt_info([e["sqrt_info"] for e in self._edges], 6)
            edges = PoseGraphEdges(
                index("i"), index("j"),
                tensor(np.stack([e["rel"].translation for e in self._edges])),
                tensor(np.stack([e["rel"].quaternion() for e in self._edges])),
                torch.zeros((E,), dtype=dtype, device=device),
                torch.ones((E,), dtype=dtype, device=device),
                sqrt_info=None if w is None else tensor(w),
            )

        priors = _pack_priors(self._priors, of, dtype, device)

        free = np.ones((N, 16))
        for si, comps in self._constant.items():
            for c in comps:
                free[of[si], self._COMPONENT_SLICES[c]] = 0.0
        return ids, of, N, factors, walk_pairs, walk_w, edges, priors, free

    def residual_vector(self, states: Optional[np.ndarray] = None) -> np.ndarray:
        """Whitened residual stack evaluated at ``states`` ((N, 16) in
        sorted-id order; default: the optimizer's current states): the
        exact objective every solve path minimizes (chi^2 = |r|^2)."""
        ids, of, N, x0, factors, walk_pairs, walk_w, edges, priors, _ = (
            self._pack_problem()
        )
        x = x0 if states is None else np.asarray(states, np.float64)
        if x.shape != (N, 16):
            raise ValueError(f"states must be ({N}, 16), got {x.shape}")
        r = _residual_stack(
            torch.as_tensor(x.reshape(-1), dtype=self.dtype, device=self.device),
            factors, walk_pairs, walk_w, edges, priors,
            torch.as_tensor(self.gravity, dtype=self.dtype, device=self.device), None, N,
        )
        return r.cpu().numpy().astype(np.float64)

    def chi2(self, states: Optional[np.ndarray] = None) -> float:
        """Sum of squared whitened residuals at ``states`` (default: the
        current estimate)."""
        r = self.residual_vector(states)
        return float(r @ r)

    def solve(self, options: Optional[Options] = None) -> lm.Summary:
        """Optimize every state; write them back (quaternions
        renormalized). Returns the summary as numpy arrays."""
        if options is None:
            options = Options().replace(max_iterations=100)
        if not self._imu and not self._edges:
            raise ValueError(
                "InertialGraphOptimizer.solve: no IMU factors or edges"
            )
        ids, of, N, x0, factors, walk_pairs, walk_w, edges, priors, free = (
            self._pack_problem()
        )
        tensor = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        x, summary = _inertial_solve(
            tensor(x0), factors, walk_pairs, walk_w, edges, priors, tensor(free),
            tensor(self.gravity), None, N, options,
        )
        (x,), summary = _fetch((x,), summary)
        x = _unit_rows(x)
        for k, si in enumerate(ids):
            self._states[si] = x[k]
        return summary


class FixedLagInertialSmoother:
    """Online sliding-window inertial smoother (fixed-lag VIO/GPS-INS back
    end): keeps the last ``lag`` keyframe states and marginalizes older
    ones EXACTLY. The graph is a Markov chain (IMU and bias-walk factors
    couple only consecutive states, priors are unary), so dropping the
    oldest state produces a single dense Gaussian prior over the next
    state's 15-DoF tangent, carried forward as the affine residual
    r = S dphi + c (the pose fixed-lag smoother's prior form,
    ``fixed_lag.py``).

    Marginalization runs on the host in float64; the IMU factors' tangent
    Jacobians come from central differences of the numpy residual twin
    (``ops.imu.np_imu_residual``; step 1e-6 in float64, about 1e-9
    accurate, far below the prior's own linearization error). Window
    solves are :func:`_inertial_solve` on ``device``.

    A documented difference from the pose ``FixedLagSmoother``, kept from
    the JAX package: with ``marginalize_every`` > 1, :meth:`update_async`
    marginalizes (inside ``_dispatch``) BEFORE the pending window solve is
    flushed, so the absorbed prior is linearized at the last FLUSHED
    estimates, up to ``marginalize_every - 1`` frames stale; the pose
    smoother defers its marginalization until after the write-back. With
    ``marginalize_every=1`` (and in :meth:`update`) every marginalization
    sees the flushed state.

    Usage::

        sm = FixedLagInertialSmoother(lag=10)
        sm.add_state(0, pose0, velocity=v0)
        for k, pre in stream:           # consecutive keyframes
            sm.add_state(k, prediction, velocity=v_pred)
            sm.add_imu_factor(k - 1, k, pre)
            sm.add_position_prior(k, gps, 1 / sigma)
            sm.update()
    """

    def __init__(self, lag: int = 10, dtype: Optional[torch.dtype] = None, gravity=None,
                 marginalize_every: int = 1, device="cuda"):
        """``marginalize_every``: flush cadence of the :meth:`update_async`
        streaming mode. 1 (the default) keeps blocking semantics; N > 1
        runs the fetch and write-back every N frames (see the class
        docstring for where marginalization then linearizes)."""
        if lag < 2:
            raise ValueError("lag must be >= 2")
        if marginalize_every < 1:
            raise ValueError("marginalize_every must be >= 1")
        self.lag = lag
        self.marginalize_every = marginalize_every
        self.device = resolve_device(device)
        self._pending: Optional[dict] = None
        self._pending_age = 0
        self._last_summary = None
        self.dtype = torch.float64 if dtype is None else dtype
        self.gravity = (
            GRAVITY.copy() if gravity is None else np.asarray(gravity, np.float64)
        )
        self._est: Dict[int, np.ndarray] = {}
        self._history: Dict[int, np.ndarray] = {}
        self._window: List[int] = []
        self._imu: List[dict] = []  # consecutive (i, j) only
        self._walks: List[tuple] = []
        self._priors: Dict[str, List[tuple]] = {"pos": [], "vel": [], "bias": []}
        self._mprior = None  # (anchor_idx, S (15,15), c (15,), lin (16,))
        self._gauge: Optional[int] = None

    # -- registry (same shapes as InertialGraphOptimizer) ---------------
    def add_state(self, index, pose, velocity=None, gyro_bias=None, accel_bias=None):
        if self._window and index != self._window[-1] + 1:
            raise ValueError(
                f"states must be consecutive (next is {self._window[-1] + 1})"
            )
        self._est[index] = _packed_state(pose, velocity, gyro_bias, accel_bias)
        self._window.append(index)
        if self._gauge is None and self._mprior is None:
            self._gauge = index

    def add_imu_factor(self, i, j, preintegrated):
        if j != i + 1:
            raise ValueError("chain smoother: IMU factors must join i, i+1")
        if i not in self._est or j not in self._est:
            raise KeyError("IMU factor endpoints must be in the window")
        self._imu.append(dict(i=i, j=j, **_factor_arrays(preintegrated)))

    def add_bias_walk(self, i, j, sqrt_info):
        if j != i + 1:
            raise ValueError("chain smoother: bias walks must join i, i+1")
        if i not in self._est or j not in self._est:
            raise KeyError("bias-walk endpoints must be in the window")
        self._walks.append((i, j, _walk_weights(sqrt_info)))

    def _add_prior(self, key, index, value, sqrt_info, d):
        if index not in self._est:
            raise KeyError(
                f"state {index} is not in the active window "
                f"(marginalized or never added)"
            )
        w = np.asarray(sqrt_info, np.float64).reshape(-1)
        self._priors[key].append(
            (index, np.asarray(value, np.float64), np.full(d, w[0]) if w.size == 1 else w)
        )

    def add_position_prior(self, index, position, sqrt_info=1.0):
        self._add_prior("pos", index, position, sqrt_info, 3)

    def add_velocity_prior(self, index, velocity, sqrt_info=1.0):
        self._add_prior("vel", index, velocity, sqrt_info, 3)

    def add_bias_prior(self, index, bias6, sqrt_info=1.0):
        self._add_prior("bias", index, bias6, sqrt_info, 6)

    def get_state(self, index):
        self.flush()
        x = self._est.get(index)
        if x is None:
            x = self._history[index]
        return _state_tuple(x)

    def get_pose(self, index) -> Pose:
        return self.get_state(index)[0]

    @property
    def window(self) -> List[int]:
        self.flush()
        return list(self._window)

    # -- streaming ------------------------------------------------------
    def update_async(self, options: Optional[Options] = None) -> None:
        """Solve the window without fetching; the fetch and write-back run
        at the next flush (every ``marginalize_every`` calls, any state
        read, or an explicit :meth:`flush`). As in the pose smoother, the
        LM reads its `all done` flag every iteration, so the device solve
        itself ends inside this call; what is deferred is the copy back
        and the write-back."""
        if self._pending is not None:
            self._pending_age += 1
            if self._pending_age >= self.marginalize_every:
                self.flush()
        self._pending = self._dispatch(options)

    @property
    def last_summary(self):
        """Summary of the most recently flushed update, as numpy arrays."""
        return self._last_summary

    def flush(self):
        """Complete a pending :meth:`update_async`: one device-to-host copy
        and the write-back. A no-op without a pending update."""
        pending = self._pending
        if pending is None:
            return self._last_summary
        self._pending = None
        self._pending_age = 0
        (x,), summary = _fetch((pending["x"],), pending["summary"])
        x = _unit_rows(x)
        for k, si in enumerate(pending["ids"]):
            self._est[si] = x[k]
        self._last_summary = summary
        return self._last_summary

    # -- marginalization -------------------------------------------------
    @staticmethod
    def _apply_tangent(x, dphi):
        out = x.copy()
        out[:3] += dphi[:3]
        q = x[3:7] / np.linalg.norm(x[3:7])
        dq = np.concatenate([[1.0], 0.5 * dphi[3:6]])
        out[3:7] = np_quat_multiply(q, dq)
        out[7:16] += dphi[6:15]
        return out

    def _dphi(self, x, lin):
        q = x[3:7] / np.linalg.norm(x[3:7])
        q_lin = lin[3:7] / np.linalg.norm(lin[3:7])
        e_q = np_quat_multiply(np_quat_conjugate(q_lin), q)
        if e_q[0] < 0:  # shortest arc, matching the device prior
            e_q = -e_q
        return np.concatenate(
            [x[:3] - lin[:3], 2.0 * e_q[1:], x[7:] - lin[7:]]
        )

    def _marginalize_oldest(self):
        """Drop the oldest window state: absorb every factor touching it
        into a Gaussian over the (x_old, x_next) tangent (30 dims), then
        Schur-eliminate the old 15 into a new affine prior on x_next."""
        old = self._window[0]
        nxt = self._window[1]
        x_old = self._est[old]
        x_nxt = self._est[nxt]
        H = np.zeros((30, 30))
        g = np.zeros(30)
        eps = 1e-6

        def fd_jacobian(res_fn, x_o, x_n):
            r0 = res_fn(x_o, x_n)
            J = np.zeros((r0.size, 30))
            for a in range(15):
                d = np.zeros(15); d[a] = eps
                J[:, a] = (
                    res_fn(self._apply_tangent(x_o, d), x_n)
                    - res_fn(self._apply_tangent(x_o, -d), x_n)
                ) / (2 * eps)
            for a in range(15):
                d = np.zeros(15); d[a] = eps
                J[:, 15 + a] = (
                    res_fn(x_o, self._apply_tangent(x_n, d))
                    - res_fn(x_o, self._apply_tangent(x_n, -d))
                ) / (2 * eps)
            return r0, J

        def absorb(r0, J):
            nonlocal H, g
            H += J.T @ J
            g += J.T @ r0

        imu_keep = []
        for f in self._imu:
            if f["i"] == old:
                absorb(*fd_jacobian(
                    lambda a, b: np_imu_residual(a, b, f, self.gravity), x_old, x_nxt,
                ))
            else:
                imu_keep.append(f)
        self._imu = imu_keep

        walk_keep = []
        for (i, j, w) in self._walks:
            if i == old:
                r0 = (x_nxt[10:16] - x_old[10:16]) * w
                J = np.zeros((6, 30))
                J[:, 9:15] = -np.diag(w)
                J[:, 24:30] = np.diag(w)
                absorb(r0, J)
            else:
                walk_keep.append((i, j, w))
        self._walks = walk_keep

        for key, sl, tsl in (("pos", slice(0, 3), slice(0, 3)),
                             ("vel", slice(7, 10), slice(6, 9)),
                             ("bias", slice(10, 16), slice(9, 15))):
            keep = []
            for (idx, val, w) in self._priors[key]:
                if idx == old:
                    r0 = (x_old[sl] - val) * w
                    J = np.zeros((r0.size, 30))
                    J[:, tsl] = np.diag(w)
                    absorb(r0, J)
                else:
                    keep.append((idx, val, w))
            self._priors[key] = keep

        if self._mprior is not None:
            a_idx, S, c, lin = self._mprior
            assert a_idx == old, "marginal prior must sit on the oldest state"
            r0 = S @ self._dphi(x_old, lin) + c
            # d dphi / d tangent at x_old by central differences, exact to
            # O(eps^2) like the factor Jacobians
            J = np.zeros((15, 30))
            for a in range(15):
                d = np.zeros(15); d[a] = eps
                J[:, a] = (
                    S @ self._dphi(self._apply_tangent(x_old, d), lin)
                    - S @ self._dphi(self._apply_tangent(x_old, -d), lin)
                ) / (2 * eps)
            absorb(r0, J)
            self._mprior = None

        if self._gauge == old:
            # the very first marginalization absorbs the gauge: pin the
            # old state's POSE tangent (only: its velocity and bias carry
            # real information from the absorbed factors) so the
            # eliminated block is nonsingular and the gauge flows into
            # the prior
            H[:6, :6] += 1e8 * np.eye(6)
            self._gauge = None

        H_oo = H[:15, :15]
        H_on = H[:15, 15:]
        g_o = g[:15]
        sol = np.linalg.solve(H_oo + 1e-12 * np.eye(15),
                              np.concatenate([H_on, g_o[:, None]], axis=1))
        Lam = H[15:, 15:] - H_on.T @ sol[:, :15]
        g_n = g[15:] - H_on.T @ sol[:, 15]
        w_e, Vec = np.linalg.eigh(Lam)
        w_e = np.clip(w_e, 0.0, None)
        S_new = np.sqrt(w_e)[:, None] * Vec.T
        keep = w_e > 1e-12 * max(w_e.max(), 1.0)
        c_new = np.where(
            keep, (Vec.T @ g_n) / np.sqrt(np.maximum(w_e, 1e-300)), 0.0
        )
        self._mprior = (nxt, S_new, c_new, x_nxt.copy())
        self._history[old] = self._est.pop(old)
        self._window = self._window[1:]

    # -- update ----------------------------------------------------------
    def update(self, options: Optional[Options] = None):
        """Marginalize down to the lag, then solve the window (blocking:
        dispatch and immediate flush). Returns the summary (numpy)."""
        self.flush()
        self._pending = self._dispatch(options)
        return self.flush()

    def _dispatch(self, options: Optional[Options] = None) -> dict:
        """Marginalize down to the lag (at the last flushed estimates: see
        the class docstring), then run the window solve and return its
        result on the device, unfetched (see :meth:`flush`)."""
        if options is None:
            options = Options().replace(max_iterations=50)
        while len(self._window) > self.lag:
            self._marginalize_oldest()
        ids = list(self._window)
        of = {si: k for k, si in enumerate(ids)}
        N = len(ids)
        dtype, device = self.dtype, self.device
        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        x0 = np.stack([self._est[si] for si in ids])

        factors = _pack_imu_factors(self._imu, of, dtype, device)
        walk_pairs, walk_w = _pack_walks(self._walks, of, dtype, device)
        priors = _pack_priors(self._priors, of, dtype, device)
        free = np.ones((N, 16))
        if self._gauge is not None:
            free[of[self._gauge], :7] = 0.0
        mprior = None
        if self._mprior is not None:
            a_idx, S, c, lin = self._mprior
            mprior = (
                torch.as_tensor(of[a_idx], dtype=torch.int64, device=device),
                tensor(S), tensor(c), tensor(lin),
            )
        x, summary = _inertial_solve(
            tensor(x0), factors, walk_pairs, walk_w, None, priors, tensor(free),
            tensor(self.gravity), mprior, N, options,
        )
        return dict(x=x, ids=ids, summary=summary)
