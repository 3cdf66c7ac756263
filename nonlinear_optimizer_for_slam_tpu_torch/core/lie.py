"""Quaternion math for SE(3) pose manipulation, and the SE(2) rotation of
the planar solvers (PyTorch port of the part of the JAX package's
``core/lie.py`` that registration and the pose graph use), and numpy
twins of the quaternion product for host-side algebra.

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


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v (..., 3) by unit quaternion(s) q (..., 4)."""
    return (quat_to_rotmat(q) @ v[..., None])[..., 0]


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
