"""Quaternion math for SE(3) pose manipulation, with the branch-exact
Jacobians of Exp and Log that the IMU factor uses, and the SE(2) rotation
of the planar solvers (PyTorch port of the JAX package's ``core/lie.py``),
and numpy twins of the quaternion product for host-side algebra.

All functions are dtype-polymorphic, batched over leading dims and
branch-free (small-angle branches become ``torch.where`` masks).

Quaternion convention: ``(w, x, y, z)`` (scalar first), matching Eigen's
``Quaterniond`` semantics used throughout the reference.

Parity target: ``so3_exp_quaternion`` reproduces the reference's
``ComputeQuaternion`` axis-angle -> quaternion map including its
small-angle branch at theta < 1e-6
(reference: mahalanobis_distance_minimizer.cc:20-33).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_SMALL_ANGLE = 1e-6


def skew(v: Tensor) -> Tensor:
    """Skew-symmetric (hat) matrix of a 3-vector; batched over leading dims
    (reference: the inline ``skew`` lambda in
    mahalanobis_distance_minimizer_analytic.cc:170-176)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_quaternion(w: Tensor) -> Tensor:
    """Axis-angle 3-vector -> unit quaternion (w, x, y, z).

    Small-angle branch (theta < 1e-6): q = (1, 0.5 * w), exactly as the
    reference's ComputeQuaternion (mahalanobis_distance_minimizer.cc:23-27).
    """
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    small = theta < _SMALL_ANGLE
    # Guard against 0/0 in the large-angle expression.
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * safe_theta
    sin_half_over_theta = torch.sin(half) / safe_theta
    qw = torch.where(small, torch.ones_like(theta), torch.cos(half))
    vec = torch.where(small, 0.5 * w, sin_half_over_theta * w)
    return torch.cat([qw, vec], dim=-1)


def quat_log_vec(q: Tensor) -> Tensor:
    """Unit quaternion (w, x, y, z) -> axis-angle 3-vector (inverse of
    :func:`so3_exp_quaternion`, matching its 1e-6 small-angle branch:
    w = 2 * vec / qw). Sign-normalizes to the shortest arc first."""
    q = torch.where(q[..., :1] < 0, -q, q)
    vec = q[..., 1:]
    vn = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
    small = vn < _SMALL_ANGLE
    theta = 2.0 * torch.atan2(vn, q[..., :1])
    safe_vn = torch.where(small, torch.ones_like(vn), vn)
    scale = torch.where(
        small, 2.0 / torch.clamp(q[..., :1], min=1e-12), theta / safe_vn
    )
    return scale * vec


def so3_exp_quaternion_jacobian(w: Tensor) -> Tensor:
    """d so3_exp_quaternion / dw: (..., 4, 3), branch for branch the
    derivative of :func:`so3_exp_quaternion` (small-angle branch included:
    d(1, w/2)/dw = [0; I/2]). Feeds the closed-form IMU-factor Jacobians
    (``ops/imu.py``)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    small = theta < _SMALL_ANGLE
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * safe_theta
    sin_half = torch.sin(half)
    u_hat = w / safe_theta  # (..., 3)
    # d qw / dw = -0.5 sin(theta/2) u_hat^T   (0 in the small branch)
    d_qw = torch.where(small, torch.zeros_like(w), -0.5 * sin_half * u_hat)
    # vec = s(theta) w, s = sin(theta/2)/theta:
    # d vec / dw = s I + s'(theta) w u_hat^T
    s = sin_half / safe_theta
    s_prime = 0.5 * torch.cos(half) / safe_theta - sin_half / (safe_theta**2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    d_vec_large = s[..., None] * eye + s_prime[..., None] * (
        w[..., :, None] * u_hat[..., None, :]
    )
    d_vec = torch.where(small[..., None], 0.5 * eye, d_vec_large)
    return torch.cat([d_qw[..., None, :], d_vec], dim=-2)


def quat_log_vec_jacobian(q: Tensor) -> Tensor:
    """d quat_log_vec / dq: (..., 3, 4), branch for branch the derivative
    of :func:`quat_log_vec` including the shortest-arc sign flip (the flip
    chains a global factor sign(qw); its switch point qw = 0 is pi
    rotations, where Log itself is discontinuous)."""
    one = torch.ones_like(q[..., :1])
    sign = torch.where(q[..., :1] < 0, -one, one)
    qs = sign * q
    w = qs[..., :1]
    vec = qs[..., 1:]
    vn_sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    vn = torch.sqrt(vn_sq)
    small = vn < _SMALL_ANGLE
    safe_vn = torch.where(small, torch.ones_like(vn), vn)
    safe_w = torch.clamp(w, min=1e-12)
    nrm_sq = w * w + vn_sq
    theta = 2.0 * torch.atan2(vn, w)
    v_hat = vec / safe_vn
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    # d f / d w = -2 vec / (w^2 + vn^2)      (small: -2 vec / w^2)
    d_w = torch.where(small, -2.0 * vec / safe_w**2, -2.0 * vec / nrm_sq)
    # d f / d vec = (theta/vn)(I - vh vh^T) + (2w/(w^2+vn^2)) vh vh^T
    # (small: 2/w I, the derivative of 2 vec / w)
    vvT = v_hat[..., :, None] * v_hat[..., None, :]
    d_v_large = (theta / safe_vn)[..., None] * (eye - vvT) + (
        2.0 * w / nrm_sq
    )[..., None] * vvT
    d_v = torch.where(small[..., None], (2.0 / safe_w)[..., None] * eye, d_v_large)
    return sign[..., None] * torch.cat([d_w[..., :, None], d_v], dim=-1)


def quat_multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a (x) b, both (..., 4) in (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_to_rotmat(q: Tensor) -> Tensor:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix; batched."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: Tensor) -> Tensor:
    """3x3 rotation matrix -> unit quaternion (w, x, y, z); batched.

    Branch-free Shepperd-style selection of the numerically best of the four
    candidate extractions (the trace formula alone loses precision near
    180-degree rotations); the first of equal scores wins, as ``argmax``
    picks it in both packages."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidates, each scaled by 4 q_k^2 (kept non-negative)
    qw_sq = torch.clamp(1.0 + tr, min=0.0)
    qx_sq = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy_sq = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz_sq = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    sw = 2.0 * torch.sqrt(qw_sq + 1e-30)
    sx = 2.0 * torch.sqrt(qx_sq + 1e-30)
    sy = 2.0 * torch.sqrt(qy_sq + 1e-30)
    sz = 2.0 * torch.sqrt(qz_sq + 1e-30)

    cand = torch.stack(
        [
            torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
            torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
            torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1),
            torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([qw_sq, qx_sq, qy_sq, qz_sq], dim=-1), dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(cand, -2, index)[..., 0, :])


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v (..., 3) by unit quaternion(s) q (..., 4)."""
    return (quat_to_rotmat(q) @ v[..., None])[..., 0]


def se3_apply(R: Tensor, t: Tensor, points: Tensor) -> Tensor:
    """Apply (R, t) to points (..., 3): R p + t."""
    return points @ R.mT + t


# Numpy twins for host-side quaternion algebra (wxyz), as in the JAX
# package's ``ops/relative_pose.py``.


def np_quat_left_matrix(a: np.ndarray) -> np.ndarray:
    """L(a) with L(a) b = a (x) b, batched over leading dims."""
    w, x, y, z = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    return np.stack(
        [
            np.stack([w, -x, -y, -z], -1),
            np.stack([x, w, -z, y], -1),
            np.stack([y, z, w, -x], -1),
            np.stack([z, -y, x, w], -1),
        ],
        -2,
    )


def np_quat_conjugate(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def np_quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.einsum("...ij,...j->...i", np_quat_left_matrix(a), b)


# SE(2) helpers for the 3-DoF planar solvers
# (reference: mahalanobis_distance_minimizer_analytic_3dof.cc).


def rot2(theta: Tensor) -> Tensor:
    """Angle (...) -> 2x2 rotation (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def angle_of_rot2(R2: Tensor) -> Tensor:
    return torch.atan2(R2[..., 1, 0], R2[..., 0, 0])
