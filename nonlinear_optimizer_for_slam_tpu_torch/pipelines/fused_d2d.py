"""Device-resident D2D-NDT / GICP registration (PyTorch port of the JAX
package's ``pipelines/fused_d2d.py``): the whole outer loop (voxel
matching, GICP whitening, inner LM solves, outer convergence) runs on the
device, driven by the registrar's state machine
(``fused_registration._Machine``) in blocks of K LM steps with one host
read per block.

The host-loop ``registration.register_d2d_ndt`` recomputes the GICP
combined covariance W = (Sigma_map + R Sigma_scan R^T)^{-1} on the host
each outer iteration. Here the whitening is batched 3x3 work on the
device: a Cholesky factor C = L L^T of the combined covariance and its
closed-form inverse give S = L^{-1} with S^T S = C^{-1} = W, which is all
the objective reads (r = S e, the loss on |r|^2, H = J^T J). So the
symmetric inverse square root of the host loop is replaced without
changing the optimization problem.

Each match packs the whitened pairs once; with ``eval_backend="cuda"``
every LM step evaluates them with one launch of the maha6 kernel, with
``"torch"`` with the plain PyTorch factor code on the data in the
registrar's dtype, as the JAX program does.

Beyond the reference, which is strictly point-to-distribution; D2D follows
Stoyanov et al. IJRR'12 and Segal et al. RSS'09 (GICP).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import lie
from ..core.losses import LossFunction
from ..core.options import Options
from ..core.pose import Pose
from ..ops import cuda_kernels as ck
from ..ops import mahalanobis as maha_ops
from ..utils import tracing
from . import ndt as ndt_mod
from .fused_registration import FusedRegistrationResult, _Machine, _round_up
from .ndt import NdtMap
from .registration import OUTER_MAX_ITERATIONS, OUTER_TOLERANCE

Tensor = torch.Tensor


def _inv_lower3(L: Tensor) -> Tensor:
    """Closed-form inverse of batched 3x3 lower-triangular matrices,
    (..., 3, 3) -> (..., 3, 3): forward substitution unrolled."""
    l00 = L[..., 0, 0]
    l10, l11 = L[..., 1, 0], L[..., 1, 1]
    l20, l21, l22 = L[..., 2, 0], L[..., 2, 1], L[..., 2, 2]
    a = 1.0 / l00
    b = 1.0 / l11
    c = 1.0 / l22
    m10 = -l10 * a * b
    m20 = (l10 * l21 * b - l20) * a * c
    m21 = -l21 * b * c
    z = torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack([a, z, z], dim=-1),
            torch.stack([m10, b, z], dim=-1),
            torch.stack([m20, m21, c], dim=-1),
        ],
        dim=-2,
    )


class D2dRegistrar(_Machine):
    """Distribution-to-distribution registrar with device-resident map
    state.

    The map side (means and floored covariances) goes to the device once,
    at construction; each ``register`` call builds the scan's NDT summary
    on the host (``ndt.build_ndt_map`` at ``scan_voxel_resolution``,
    unquirked), pads it to a multiple of ``scan_pad_multiple`` with masked
    voxels, and runs the whole outer loop on the device. ``device``
    defaults to "cuda"; ``eval_backend`` to "cuda" (the maha6 kernel) on a
    CUDA device and "torch" (the plain version) otherwise.
    """

    def __init__(
        self,
        ndt_map: NdtMap,
        options: Options,
        loss: Optional[LossFunction] = None,
        scan_voxel_resolution: float = 0.5,
        search_radius: float = 1.0,
        max_outer_iterations: int = OUTER_MAX_ITERATIONS,
        outer_tolerance: float = OUTER_TOLERANCE,
        dtype: torch.dtype = torch.float32,
        scan_pad_multiple: int = 64,
        device="cuda",
        eval_backend: Optional[str] = None,
    ):
        self._init_machine(
            options, loss, max_outer_iterations, outer_tolerance, dtype, device, eval_backend
        )
        valid = ndt_map.valid_only()
        self.scan_voxel_resolution = scan_voxel_resolution
        self.scan_pad_multiple = scan_pad_multiple
        self._search_radius = torch.full((), search_radius, dtype=dtype, device=self.device)
        self.map_means = self._as_t(valid.means)  # (M, 3)
        self.map_covs = self._as_t(ndt_mod.voxel_covariances(valid))  # (M, 3, 3)
        # centroid centring for the expanded-form distance (the float32
        # cancellation guard of the matchers)
        self._centroid = torch.mean(self.map_means, dim=0)
        self._means_c = self.map_means - self._centroid
        self._means_sq = torch.sum(self._means_c * self._means_c, dim=1)  # (M,)

    def _as_t(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _scan_summary(self, local_points):
        """The scan's NDT summary, padded: (means (1, S, 3), covariances
        (1, S, 3, 3), identity on the padding, mask (1, S))."""
        scan_map = ndt_mod.build_ndt_map(
            np.asarray(local_points), self.scan_voxel_resolution, identity_moment=False
        ).valid_only()
        if scan_map.num_voxels == 0:
            raise ValueError(
                "D2dRegistrar: no valid scan voxel passed the count/"
                "eigenvalue tests — scan_voxel_resolution "
                f"({self.scan_voxel_resolution}) is too fine for the scan "
                "density (each voxel needs >= 5 points and lambda_max >= 0.01)"
            )
        means = np.asarray(scan_map.means)
        covs = ndt_mod.voxel_covariances(scan_map)
        S = means.shape[0]
        Sp = _round_up(S, self.scan_pad_multiple)
        if Sp != S:
            means = np.concatenate([means, np.zeros((Sp - S, 3))])
            covs = np.concatenate([covs, np.broadcast_to(np.eye(3), (Sp - S, 3, 3))])
        mask = (np.arange(Sp) < S).astype(np.float64)
        return self._as_t(means)[None], self._as_t(covs)[None], self._as_t(mask)[None]

    @tracing.traced("nls.register")
    def register(self, local_points, initial_pose: Pose) -> FusedRegistrationResult:
        return self.finalize(self.register_async(local_points, initial_pose))

    def register_async(self, local_points, initial_pose: Pose):
        """Run the machine and return its device tensors without the final
        copy to the host; pass them to :meth:`finalize`."""
        scan_means, scan_covs, scan_mask = self._scan_summary(local_points)
        t0 = self._as_t(initial_pose.translation)[None]
        q0 = self._as_t(initial_pose.quaternion())[None]
        operand = lambda t, q: self._match(scan_means, scan_covs, scan_mask, t, q)
        return self._drive(operand, t0, q0)

    def _match(self, scan_means, scan_covs, scan_mask, t, q):
        """Nearest map voxel per scan voxel (the first on a tie) and the
        GICP whitening at the current rotation, held fixed through the
        inner solve: packed maha6 rows for the kernel, else the
        ``MahalanobisData`` in the registrar's dtype."""
        R = lie.quat_to_rotmat(q)  # (1, 3, 3)
        warped = scan_means @ R.mT + t[:, None, :] - self._centroid  # (1, S, 3)
        d2 = (
            torch.sum(warped * warped, dim=-1, keepdim=True)
            - 2.0 * warped @ self._means_c.T
            + self._means_sq
        )  # (1, S, M)
        idx = torch.argmin(d2, dim=-1)  # (1, S)
        best = torch.gather(d2, -1, idx[..., None])[..., 0]
        mask = (best <= self._search_radius * self._search_radius).to(self.dtype) * scan_mask

        Rb = R[:, None]  # (1, 1, 3, 3)
        combined = self.map_covs[idx] + Rb @ scan_covs @ Rb.mT  # (1, S, 3, 3), SPD
        # cholesky_ex: a failed factor is NaN (as in the JAX program), and
        # nothing waits for the host
        L, info = torch.linalg.cholesky_ex(combined)
        L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
        data = maha_ops.MahalanobisData(
            points=scan_means,
            means=self.map_means[idx],
            sqrt_infos=_inv_lower3(L),  # S^T S = combined^{-1}
            mask=mask,
        )
        return ck.pack_maha6(data) if self.eval_backend == "cuda" else data
