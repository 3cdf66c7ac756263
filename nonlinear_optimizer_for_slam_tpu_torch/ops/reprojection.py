"""Reprojection-error (PnP) factor: residuals, Jacobians and quadratic
evaluation — the ``"torch"`` backend (PyTorch port of the JAX package's
``ops/reprojection.py``; its ``"jnp"`` backend). Every function is batched
over leading dimensions: a batch of problems carries (B, N, ...) data and
(B, 3, 3) rotations; the intrinsics broadcast against (..., N).

Problem (reference: reprojection_error_minimizer/*): 3-D points X_i in the
reference frame, matched pixels p_i in the query frame; minimize over SE(3)
(R, t) the robustified sum of squared normalized-image-plane errors:

    Xw_i = R X_i + t
    r_i  = [Xw_x / Xw_z - (p_x - cx) / fx,
            Xw_y / Xw_z - (p_y - cy) / fy]                   (2,)
    J_i  = dpi/dXw * [ I | -R skew(X_i) ]                    (2, 6)

with dpi/dXw the 2x3 projection derivative carrying 1/z and -x/z^2 terms
(reference: reprojection_error_minimizer_analytic.cc:107-163).

Minimum-depth gating: the reference's scalar path zeroes J and r when
Xw_z < 0.03 (.._analytic.cc:111-123); here, as in the JAX package, a
multiplicative mask does it.

Precision: the contractions run in full float32 on float32 inputs (TF32
off, PyTorch's default), as the JAX package forces with
``highest_precision``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.losses import LossFunction
from .quadratic import quadratic_from_jacobians

Tensor = torch.Tensor

MIN_DEPTH = 0.03  # reference: reprojection_error_minimizer_analytic.cc:111


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics (reference: reprojection_error_minimizer/types.h:
    14-24). The fields are floats or tensors."""

    fx: object
    fy: object
    cx: object
    cy: object
    inv_fx: object
    inv_fy: object
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, width=0, height=0) -> "CameraIntrinsics":
        """``inv_fx = 1 / fx`` in the arguments' own precision (Python
        floats: float64), so a minimizer casts the reciprocal, not fx."""
        return CameraIntrinsics(fx, fy, cx, cy, 1.0 / fx, 1.0 / fy, width, height)


class ReprojectionData(NamedTuple):
    """SoA batch of 3D-2D correspondences
    (reference: reprojection_error_minimizer/types.h:26-29)."""

    local_points: Tensor  # (N, 3) X_i in the reference frame
    matched_pixels: Tensor  # (N, 2) p_i in the query frame
    mask: Tensor  # (N,) 1.0 = real correspondence, 0.0 = padding

    @property
    def num_factors(self) -> int:
        return self.local_points.shape[0]

    def pad_to(self, n: int) -> "ReprojectionData":
        cur = self.local_points.shape[0]
        if cur == n:
            return self
        extra = n - cur
        pad = lambda a: torch.cat(
            [a, a.new_zeros((extra,) + tuple(a.shape[1:]))], dim=0
        )
        return ReprojectionData(
            pad(self.local_points), pad(self.matched_pixels), pad(self.mask)
        )

    def astype(self, dtype) -> "ReprojectionData":
        return ReprojectionData(*(a.to(dtype) for a in self))


def residuals_and_jacobians(
    rotation: Tensor,
    translation: Tensor,
    data: ReprojectionData,
    intrinsics: CameraIntrinsics,
) -> Tuple[Tensor, Tensor]:
    """Batched (r (..., N, 2), J (..., N, 2, 6)) with the depth gate folded
    in as a mask."""
    R, t = rotation, translation
    X, p = data.local_points, data.matched_pixels

    Xw = X @ R.mT + t[..., None, :]  # (..., N, 3)
    zw = Xw[..., 2]
    in_front = zw >= MIN_DEPTH
    valid = in_front.to(Xw.dtype)
    safe_z = torch.where(in_front, zw, torch.ones_like(zw))
    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z

    proj = Xw[..., :2] * inv_z[..., None]  # (..., N, 2)
    matched = torch.stack(
        [
            intrinsics.inv_fx * (p[..., 0] - intrinsics.cx),
            intrinsics.inv_fy * (p[..., 1] - intrinsics.cy),
        ],
        dim=-1,
    )
    r = (proj - matched) * valid[..., None]

    # dpi/dXw (..., N, 2, 3)
    zero = torch.zeros_like(inv_z)
    dK = torch.stack(
        [
            torch.stack([inv_z, zero, -Xw[..., 0] * inv_z2], dim=-1),
            torch.stack([zero, inv_z, -Xw[..., 1] * inv_z2], dim=-1),
        ],
        dim=-2,
    )

    # R skew(X) columns via cross products with X; Rc[j] is column j of R
    x, y, z = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    Rc = [R[..., None, :, j] for j in range(3)]  # (..., 1, 3)
    col0 = Rc[1] * z - Rc[2] * y  # (..., N, 3)
    col1 = Rc[2] * x - Rc[0] * z
    col2 = Rc[0] * y - Rc[1] * x
    Rskew = torch.stack([col0, col1, col2], dim=-1)  # (..., N, 3, 3)

    J_rot = -torch.einsum("...ndk,...nkc->...ndc", dK, Rskew)  # (..., N, 2, 3)
    J = torch.cat([dK, J_rot], dim=-1) * valid[..., None, None]  # (..., N, 2, 6)
    return r, J


def residuals(
    rotation: Tensor,
    translation: Tensor,
    data: ReprojectionData,
    intrinsics: CameraIntrinsics,
) -> Tensor:
    r, _ = residuals_and_jacobians(rotation, translation, data, intrinsics)
    return r


def eval_quadratic(
    rotation: Tensor,
    translation: Tensor,
    data: ReprojectionData,
    intrinsics: CameraIntrinsics,
    loss: Optional[LossFunction],
) -> Tuple[Tensor, Tensor, Tensor]:
    """(H (..., 6, 6), g (..., 6), cost (...)) for the reprojection problem
    (the ``"torch"`` backend)."""
    r, J = residuals_and_jacobians(rotation, translation, data, intrinsics)
    return quadratic_from_jacobians(r, J, data.mask, loss)


def project_to_pixels(points: Tensor, intrinsics: CameraIntrinsics) -> Tensor:
    """Pinhole projection of camera-frame points to pixels
    (reference: reproj tests/simple_optimization_test.cc:144-158)."""
    inv_z = 1.0 / points[..., 2]
    return torch.stack(
        [
            intrinsics.fx * points[..., 0] * inv_z + intrinsics.cx,
            intrinsics.fy * points[..., 1] * inv_z + intrinsics.cy,
        ],
        dim=-1,
    )
