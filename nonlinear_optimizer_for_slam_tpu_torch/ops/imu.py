"""IMU preintegration (on-manifold, Forster et al., T-RO 2016): PyTorch
port of the JAX package's ``ops/imu.py``.

Raw gyro/accel samples between two keyframes are compressed into ONE
relative-motion factor (delta rotation / velocity / position), with
first-order bias-correction Jacobians and a propagated 9x9 covariance, so
the optimizer never touches individual IMU samples and re-linearization
under changing bias estimates costs a matrix-vector product instead of
re-integration.

Split of responsibilities:

- :class:`ImuPreintegrator` is host-side float64 numpy (a copy of the JAX
  package's): integration is sequential per sample and happens in the data
  front end.
- :class:`PreintegratedImuFactor` is the device-side SoA batch; the residual
  functions are plain tensor functions (``torch.func``-safe), consumed by
  ``solvers.inertial``.

Conventions: quaternions (w, x, y, z); gravity is a world-frame vector
(default (0, 0, -9.81)); the accelerometer measures SPECIFIC FORCE
a_meas = R^T (a_world - g) + b_a + noise; the state per keyframe is
(p, q, v, b_g, b_a). Residual (whitened by the preintegration
sqrt-information):

    r_phi = Log( (dR Exp(J_R_bg dbg))^T R_i^T R_j )
    r_v   = R_i^T (v_j - v_i - g dt) - (dv + J_v_bg dbg + J_v_ba dba)
    r_p   = R_i^T (p_j - p_i - v_i dt - 0.5 g dt^2)
            - (dp + J_p_bg dbg + J_p_ba dba)

with dbg/dba the deviation of the STATE bias at keyframe i from the bias
the batch was integrated at.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import lie
from ..core.pose import np_quat_to_rotmat, np_rotmat_to_quat
from .relative_pose import (
    _quat_left_matrix,
    _quat_right_matrix,
    np_quat_conjugate,
    np_quat_multiply,
)

Tensor = torch.Tensor

GRAVITY = np.array([0.0, 0.0, -9.81])


@dataclasses.dataclass(frozen=True)
class ImuParams:
    """Continuous-time noise densities (units per sqrt(Hz)); the discrete
    per-sample covariance is density^2 / dt. The bias-walk densities feed
    :func:`bias_walk_sqrt_info` (the between-keyframe bias random-walk
    factor weight); the gyro/accel densities feed the preintegration
    covariance."""

    gyro_noise: float = 1.7e-4  # rad / s / sqrt(Hz)
    accel_noise: float = 2.0e-3  # m / s^2 / sqrt(Hz)
    gyro_bias_walk: float = 2.0e-5  # rad / s^2 / sqrt(Hz)
    accel_bias_walk: float = 3.0e-3  # m / s^3 / sqrt(Hz)


def bias_walk_sqrt_info(params: ImuParams, dt: float) -> np.ndarray:
    """(6,) diagonal sqrt-information for the bias random-walk factor
    (b_j - b_i) over an interval of ``dt`` seconds: the walk variance is
    density^2 * dt, so w = 1 / (density * sqrt(dt)). Pass to
    ``InertialGraphOptimizer.add_bias_walk``."""
    if dt <= 0.0:
        raise ValueError(f"dt must be positive, got {dt}")
    wg = 1.0 / (params.gyro_bias_walk * np.sqrt(dt))
    wa = 1.0 / (params.accel_bias_walk * np.sqrt(dt))
    return np.array([wg, wg, wg, wa, wa, wa])


def _skew(v):
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]]
    )


def _exp_so3(w):
    th = np.linalg.norm(w)
    K = _skew(w)
    if th < 1e-8:
        return np.eye(3) + K + 0.5 * K @ K
    return (
        np.eye(3)
        + (np.sin(th) / th) * K
        + ((1.0 - np.cos(th)) / th**2) * K @ K
    )


def _right_jacobian(w):
    """SO(3) right Jacobian J_r(w): Exp(w + dw) ~ Exp(w) Exp(J_r dw)."""
    th = np.linalg.norm(w)
    K = _skew(w)
    if th < 1e-8:
        return np.eye(3) - 0.5 * K + (1.0 / 6.0) * K @ K
    return (
        np.eye(3)
        - ((1.0 - np.cos(th)) / th**2) * K
        + ((th - np.sin(th)) / th**3) * K @ K
    )


class ImuPreintegrator:
    """Accumulates gyro/accel samples into (dR, dv, dp) with bias
    Jacobians and a propagated (phi, v, p) covariance (host float64).

    Usage::

        pre = ImuPreintegrator(ImuParams(), bg0, ba0)
        for (gyro, accel, dt) in samples:
            pre.integrate(gyro, accel, dt)
        arrays = pre.to_factor_arrays()
    """

    def __init__(self, params: ImuParams, gyro_bias=None, accel_bias=None):
        self.params = params
        self.bg0 = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias, np.float64).copy()
        self.ba0 = np.zeros(3) if accel_bias is None else np.asarray(accel_bias, np.float64).copy()
        self.reset()

    def reset(self) -> None:
        self.dR = np.eye(3)
        self.dv = np.zeros(3)
        self.dp = np.zeros(3)
        self.dt = 0.0
        self.dR_dbg = np.zeros((3, 3))
        self.dv_dbg = np.zeros((3, 3))
        self.dv_dba = np.zeros((3, 3))
        self.dp_dbg = np.zeros((3, 3))
        self.dp_dba = np.zeros((3, 3))
        self.cov = np.zeros((9, 9))  # over (phi, v, p)
        self.num_samples = 0

    def integrate(self, gyro, accel, dt: float) -> None:
        if dt <= 0.0:
            raise ValueError(f"dt must be positive, got {dt}")
        w = np.asarray(gyro, np.float64) - self.bg0
        a = np.asarray(accel, np.float64) - self.ba0
        wdt = w * dt
        dRk = _exp_so3(wdt)
        Jr = _right_jacobian(wdt)
        Ra = self.dR @ a
        Rax = self.dR @ _skew(a)

        # covariance propagation (Forster eq. (63)-style, state (phi,v,p))
        A = np.eye(9)
        A[0:3, 0:3] = dRk.T
        A[3:6, 0:3] = -Rax * dt
        A[6:9, 0:3] = -0.5 * Rax * dt * dt
        A[6:9, 3:6] = np.eye(3) * dt
        B = np.zeros((9, 6))
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = self.dR * dt
        B[6:9, 3:6] = 0.5 * self.dR * dt * dt
        sg2 = self.params.gyro_noise**2 / dt
        sa2 = self.params.accel_noise**2 / dt
        N = np.diag([sg2] * 3 + [sa2] * 3)
        self.cov = A @ self.cov @ A.T + B @ N @ B.T

        # bias Jacobians (use PRE-update dR / dv jacobians)
        self.dp_dbg += self.dv_dbg * dt - 0.5 * Rax @ self.dR_dbg * dt * dt
        self.dp_dba += self.dv_dba * dt - 0.5 * self.dR * dt * dt
        self.dv_dbg += -Rax @ self.dR_dbg * dt
        self.dv_dba += -self.dR * dt
        self.dR_dbg = dRk.T @ self.dR_dbg - Jr * dt

        # deltas
        self.dp += self.dv * dt + 0.5 * Ra * dt * dt
        self.dv += Ra * dt
        self.dR = self.dR @ dRk
        self.dt += dt
        self.num_samples += 1

    def corrected(self, gyro_bias, accel_bias) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """First-order bias-corrected (dR, dv, dp) at a new bias estimate."""
        dbg = np.asarray(gyro_bias, np.float64) - self.bg0
        dba = np.asarray(accel_bias, np.float64) - self.ba0
        dR = self.dR @ _exp_so3(self.dR_dbg @ dbg)
        dv = self.dv + self.dv_dbg @ dbg + self.dv_dba @ dba
        dp = self.dp + self.dp_dbg @ dbg + self.dp_dba @ dba
        return dR, dv, dp

    def sqrt_information(self) -> np.ndarray:
        """Whitening S (9, 9) with S^T S = cov^-1 (a tiny floor keeps a
        zero-sample or exactly deterministic batch factorizable)."""
        cov = self.cov + 1e-16 * np.eye(9)
        L = np.linalg.cholesky(cov)
        # S = inv(L) gives S^T S = inv(L)^T inv(L) = inv(L L^T) = inv(cov)
        return np.linalg.inv(L)

    def to_factor_arrays(self) -> dict:
        """Flat dict of arrays for PreintegratedImuFactor stacking."""
        if self.num_samples == 0:
            raise ValueError(
                "preintegrator holds no samples — an empty factor would "
                "whiten against the 1e-16 covariance floor and rigidly "
                "weld its two states together"
            )
        return dict(
            delta_q=np_rotmat_to_quat(self.dR),
            delta_v=self.dv.copy(),
            delta_p=self.dp.copy(),
            dt=float(self.dt),
            dR_dbg=self.dR_dbg.copy(),
            dv_dbg=self.dv_dbg.copy(),
            dv_dba=self.dv_dba.copy(),
            dp_dbg=self.dp_dbg.copy(),
            dp_dba=self.dp_dba.copy(),
            sqrt_info=self.sqrt_information(),
            bias0=np.concatenate([self.bg0, self.ba0]),
        )


class PreintegratedImuFactor(NamedTuple):
    """SoA batch of F preintegrated IMU factors (device-side)."""

    i: Tensor  # (F,) int64 state index of frame i
    j: Tensor  # (F,) int64 state index of frame j
    delta_q: Tensor  # (F, 4)
    delta_v: Tensor  # (F, 3)
    delta_p: Tensor  # (F, 3)
    dt: Tensor  # (F,)
    dR_dbg: Tensor  # (F, 3, 3)
    dv_dbg: Tensor  # (F, 3, 3)
    dv_dba: Tensor  # (F, 3, 3)
    dp_dbg: Tensor  # (F, 3, 3)
    dp_dba: Tensor  # (F, 3, 3)
    sqrt_info: Tensor  # (F, 9, 9)
    bias0: Tensor  # (F, 6) integration-time (bg, ba)


def _matvec(A: Tensor, x: Tensor) -> Tensor:
    """(F, a, b) @ (F, b) -> (F, a)."""
    return (A @ x[..., None])[..., 0]


class _Constants(NamedTuple):
    left: Tensor  # (4, 16): a -> L(a), a (x) b = L(a) b
    right: Tensor  # (4, 16): b -> R(b), a (x) b = R(b) a
    conj: Tensor  # (4,) the conjugation's signs
    eye4: Tensor
    sign_i: Tensor  # (9, 16) the signs of J_i's blocks (see below)


# The constants of the closed form, made once per dtype and device: the
# residuals run a few hundred small kernels an LM iteration, each a launch
# on the card, and a tensor made from host values inside the loop is a
# host-to-device copy that waits for the stream. The products go through
# L and R as one matmul each (the JAX package's expressions round
# otherwise, at float rounding).
_CONSTANTS = {}


def _constants(like: Tensor) -> _Constants:
    key = (like.dtype, like.device)
    c = _CONSTANTS.get(key)
    if c is None:
        basis = torch.eye(4, dtype=like.dtype, device=like.device)
        sign_i = torch.ones((9, 16), dtype=like.dtype, device=like.device)
        sign_i[3:6, 7:16] = -1.0  # v rows: -R_i^T, -dv_dbg, -dv_dba
        sign_i[6:9, 0:3] = -1.0  # p rows: -R_i^T
        sign_i[6:9, 7:16] = -1.0  # p rows: -R_i^T dt, -dp_dbg, -dp_dba
        c = _Constants(
            _quat_left_matrix(basis).reshape(4, 16), _quat_right_matrix(basis).reshape(4, 16),
            basis[0] - basis[1] - basis[2] - basis[3], basis, sign_i,
        )
        _CONSTANTS[key] = c
    return c


def _left(a: Tensor) -> Tensor:
    """L(a) (..., 4, 4): one matmul."""
    return (a @ _constants(a).left).reshape(a.shape[:-1] + (4, 4))


def _right(b: Tensor) -> Tensor:
    """R(b) (..., 4, 4): one matmul."""
    return (b @ _constants(b).right).reshape(b.shape[:-1] + (4, 4))


def _qmul(a: Tensor, b: Tensor) -> Tensor:
    """a (x) b as L(a) b."""
    return (_left(a) @ b[..., None])[..., 0]


def _rotation(c: Tensor) -> Tensor:
    """R(c) (..., 3, 3) of unit quaternions c: the vector part of
    c (x) X (x) conj(c), X = (0, x), is (L(c) R(conj(c)))[1:, 1:] x."""
    return (_left(c) @ _right(c * _constants(c).conj))[..., 1:, 1:]


def _normalize_jacobian(q: Tensor, eye4: Tensor) -> Tensor:
    """d(q/|q|)/dq = (I - n n^T) / |q|: ``relative_pose._normalize_jacobian``
    with the identity made once."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    n = q / norm
    return (eye4 - n[..., :, None] * n[..., None, :]) / norm[..., None]


def imu_residuals(
    positions: Tensor,  # (N, 3)
    quaternions: Tensor,  # (N, 4) ambient
    velocities: Tensor,  # (N, 3)
    biases: Tensor,  # (N, 6) (bg, ba)
    factors: PreintegratedImuFactor,
    gravity: Tensor,  # (3,)
) -> Tensor:
    """Whitened 9-D preintegration residuals (F, 9), batched over factors;
    ``torch.func``-safe."""
    pi = positions[factors.i]
    pj = positions[factors.j]
    qi = lie.quat_normalize(quaternions[factors.i])
    qj = lie.quat_normalize(quaternions[factors.j])
    vi = velocities[factors.i]
    vj = velocities[factors.j]
    bi = biases[factors.i]
    dbg = bi[:, :3] - factors.bias0[:, :3]
    dba = bi[:, 3:] - factors.bias0[:, 3:]
    dt = factors.dt[:, None]

    # corrected deltas
    q_corr = _qmul(factors.delta_q, lie.so3_exp_quaternion(_matvec(factors.dR_dbg, dbg)))
    dv_corr = factors.delta_v + _matvec(factors.dv_dbg, dbg) + _matvec(factors.dv_dba, dba)
    dp_corr = factors.delta_p + _matvec(factors.dp_dbg, dbg) + _matvec(factors.dp_dba, dba)

    qi_inv = lie.quat_conjugate(qi)
    r_phi = lie.quat_log_vec(_qmul(lie.quat_conjugate(q_corr), _qmul(qi_inv, qj)))
    RiT = _rotation(qi_inv)
    r_v = _matvec(RiT, vj - vi - gravity[None, :] * dt) - dv_corr
    r_p = _matvec(RiT, pj - pi - vi * dt - 0.5 * gravity[None, :] * dt * dt) - dp_corr
    r = torch.cat([r_phi, r_v, r_p], dim=1)  # (F, 9)
    return _matvec(factors.sqrt_info, r)


def imu_residuals_and_jacobians(
    positions: Tensor,  # (N, 3)
    quaternions: Tensor,  # (N, 4) ambient
    velocities: Tensor,  # (N, 3)
    biases: Tensor,  # (N, 6)
    factors: PreintegratedImuFactor,
    gravity: Tensor,  # (3,)
) -> Tuple[Tensor, Tensor, Tensor]:
    """Whitened residuals and CLOSED-FORM Jacobian blocks per factor.

    Returns ``(r (F, 9), J_i (F, 9, 16), J_j (F, 9, 16))`` over the packed
    state layout [p (3), q (4, ambient), v (3), b_g (3), b_a (3)]. The
    residual only touches x_j's pose and velocity, so J_j's bias columns
    are zero.

    The algebra of the pose-graph edge closed form
    (``relative_pose.edge_residuals_and_jacobians``): quaternion products
    are the linear maps L(a)/R(b), normalization contributes
    (I - nn^T)/|q|, and the two nonlinear maps, Exp (bias correction) and
    Log (rotation residual), carry the branch-exact Jacobians of
    ``core/lie.py``. The products and rotations go through L/R as one
    matmul each (so the values round otherwise than :func:`imu_residuals`,
    at float rounding). The production path of ``solvers/inertial.py``;
    :func:`imu_residuals_and_jacobians_ad` is its oracle."""
    F = factors.dt.shape[0]
    dtype, device = positions.dtype, positions.device
    consts = _constants(positions)
    conj_sign = consts.conj

    pi = positions[factors.i]
    pj = positions[factors.j]
    qi = quaternions[factors.i]
    qj = quaternions[factors.j]
    vi = velocities[factors.i]
    vj = velocities[factors.j]
    bi = biases[factors.i]
    dbg = bi[:, :3] - factors.bias0[:, :3]
    dba = bi[:, 3:] - factors.bias0[:, 3:]
    dt = factors.dt[:, None]

    n_i = lie.quat_normalize(qi)
    n_j = lie.quat_normalize(qj)
    Dn_i = _normalize_jacobian(qi, consts.eye4)  # (F, 4, 4)
    Dn_j = _normalize_jacobian(qj, consts.eye4)
    c_i = n_i * conj_sign

    # ---- corrected deltas and the rotation-residual chain ------------
    u = _matvec(factors.dR_dbg, dbg)  # (F, 3)
    q_exp = lie.so3_exp_quaternion(u)
    q_corr = _qmul(factors.delta_q, q_exp)
    m = _qmul(c_i, n_j)
    L_cc = _left(q_corr * conj_sign)  # L(conj(q_corr))
    e = (L_cc @ m[..., None])[..., 0]
    r_phi = lie.quat_log_vec(e)
    dLog = lie.quat_log_vec_jacobian(e)  # (F, 3, 4)

    # e = L(conj(q_corr) (x) c_i) n_j
    de_dqj = _left((L_cc @ c_i[..., None])[..., 0]) @ Dn_j  # (F, 4, 4)
    # e = L(conj(q_corr)) R(n_j) conj(n_i): conj is the column sign flip
    de_dqi = (L_cc @ _right(n_j)) * conj_sign @ Dn_i
    # e = R(conj(delta_q) (x) m) conj(Exp(u)), u = dR_dbg dbg
    w2 = _qmul(factors.delta_q * conj_sign, m)
    Dexp = lie.so3_exp_quaternion_jacobian(u)  # (F, 4, 3)
    de_dbg = ((_right(w2) * conj_sign) @ Dexp) @ factors.dR_dbg  # (F, 4, 3)

    dphi_dqi = dLog @ de_dqi  # (F, 3, 4)
    dphi_dqj = dLog @ de_dqj
    dphi_dbg = dLog @ de_dbg  # (F, 3, 3)

    # ---- velocity / position rows ------------------------------------
    dv_corr = factors.delta_v + _matvec(factors.dv_dbg, dbg) + _matvec(factors.dv_dba, dba)
    dp_corr = factors.delta_p + _matvec(factors.dp_dbg, dbg) + _matvec(factors.dp_dba, dba)
    w_v = vj - vi - gravity[None, :] * dt
    w_p = pj - pi - vi * dt - 0.5 * gravity[None, :] * dt * dt
    RiT = _rotation(c_i)  # R(n_i)^T as a matrix (F, 3, 3)
    r_v = _matvec(RiT, w_v) - dv_corr
    r_p = _matvec(RiT, w_p) - dp_corr

    # d(R(c) x)/dc = [R(X (x) conj(c)) + L(c (x) X) C][1:] on the tangent
    # of the unit sphere (the extension off it is projected out by Dn_i);
    # then d c_i / d n_i = C and the normalization: the velocity and
    # position rows at once
    X = torch.cat([torch.zeros((2 * F, 1), dtype=dtype, device=device),
                   torch.cat([w_v, w_p])], dim=1)  # (2F, 4)
    c2 = torch.cat([c_i, c_i])
    d_rot = (_right(_qmul(X, c2 * conj_sign)) + _left(_qmul(c2, X)) * conj_sign)[:, 1:, :]
    dr_dqi = (d_rot * conj_sign) @ torch.cat([Dn_i, Dn_i])  # (2F, 3, 4)
    drv_dqi, drp_dqi = dr_dqi[:F], dr_dqi[F:]

    z33 = torch.zeros((F, 3, 3), dtype=dtype, device=device)
    z34 = torch.zeros((F, 3, 4), dtype=dtype, device=device)
    # rows: (phi, v, p) x cols: (p 0:3 | q 3:7 | v 7:10 | bg 10:13 | ba 13:16);
    # the blocks -R_i^T, -dv_dbg, ... as one product with the signs
    J_i = torch.cat(
        [
            torch.cat([z33, dphi_dqi, z33, dphi_dbg, z33], dim=-1),
            torch.cat([z33, drv_dqi, RiT, factors.dv_dbg, factors.dv_dba], dim=-1),
            torch.cat([RiT, drp_dqi, RiT * dt[..., None], factors.dp_dbg, factors.dp_dba], dim=-1),
        ],
        dim=-2,
    ) * consts.sign_i  # (F, 9, 16)
    J_j = torch.cat(
        [
            torch.cat([z33, dphi_dqj, z33, z33, z33], dim=-1),
            torch.cat([z33, z34, RiT, z33, z33], dim=-1),
            torch.cat([RiT, z34, z33, z33, z33], dim=-1),
        ],
        dim=-2,
    )

    r = torch.cat([r_phi, r_v, r_p], dim=1)  # (F, 9)
    S = factors.sqrt_info
    return _matvec(S, r), S @ J_i, S @ J_j


def imu_residuals_and_jacobians_ad(
    positions, quaternions, velocities, biases,
    factors: PreintegratedImuFactor, gravity,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Autodiff oracle for :func:`imu_residuals_and_jacobians`: per factor,
    ``torch.func.jacfwd`` over the two packed states it touches, vmapped
    over the factors (tests only)."""
    x = torch.cat([positions, quaternions, velocities, biases], dim=1)
    ij = torch.tensor([0, 1], device=x.device)

    def one(xi, xj, f_k):
        # a 2-state micro-problem holding just this factor
        f01 = PreintegratedImuFactor(ij[:1], ij[1:], *(a[None] for a in f_k[2:]))

        def res(xi_, xj_):
            xs = torch.stack([xi_, xj_])
            return imu_residuals(xs[:, :3], xs[:, 3:7], xs[:, 7:10], xs[:, 10:16], f01, gravity)[0]

        Ji, Jj = torch.func.jacfwd(res, argnums=(0, 1))(xi, xj)
        return res(xi, xj), Ji, Jj

    return torch.func.vmap(one)(x[factors.i], x[factors.j], factors)


def np_imu_residual(xi, xj, arr: dict, gravity=GRAVITY) -> np.ndarray:
    """Numpy twin of :func:`imu_residuals` for ONE factor between packed
    states xi, xj ((16,) = [p, q(wxyz), v, b_g, b_a]); ``arr`` is an
    ``ImuPreintegrator.to_factor_arrays()`` dict. Host-side use only (the
    fixed-lag marginalization linearizes it by finite differences)."""

    def qexp(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.concatenate([[1.0], 0.5 * w])
        return np.concatenate([[np.cos(0.5 * th)], np.sin(0.5 * th) * w / th])

    def qlog(q):
        if q[0] < 0:
            q = -q
        vn = np.linalg.norm(q[1:])
        if vn < 1e-12:
            return 2.0 * q[1:] / max(q[0], 1e-12)
        return 2.0 * np.arctan2(vn, q[0]) * q[1:] / vn

    qconj, qmul = np_quat_conjugate, np_quat_multiply
    pi, qi, vi, bi = xi[:3], xi[3:7], xi[7:10], xi[10:16]
    pj, qj, vj = xj[:3], xj[3:7], xj[7:10]
    qi = qi / np.linalg.norm(qi)
    qj = qj / np.linalg.norm(qj)
    dbg = bi[:3] - arr["bias0"][:3]
    dba = bi[3:] - arr["bias0"][3:]
    dt = float(arr["dt"])
    g = np.asarray(gravity, np.float64)

    q_corr = qmul(arr["delta_q"], qexp(arr["dR_dbg"] @ dbg))
    dv_corr = arr["delta_v"] + arr["dv_dbg"] @ dbg + arr["dv_dba"] @ dba
    dp_corr = arr["delta_p"] + arr["dp_dbg"] @ dbg + arr["dp_dba"] @ dba

    Ri_T = np_quat_to_rotmat(qi).T
    r_phi = qlog(qmul(qconj(q_corr), qmul(qconj(qi), qj)))
    r_v = Ri_T @ (vj - vi - g * dt) - dv_corr
    r_p = Ri_T @ (pj - pi - vi * dt - 0.5 * g * dt * dt) - dp_corr
    return arr["sqrt_info"] @ np.concatenate([r_phi, r_v, r_p])
