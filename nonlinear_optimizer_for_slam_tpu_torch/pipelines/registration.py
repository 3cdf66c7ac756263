"""NDT scan-to-map registration: the outer ICP loop (PyTorch port of the JAX
package's ``pipelines/registration.py``: ``register_ndt``,
``register_d2d_ndt`` and ``register_point_to_plane``).

Mirrors the reference's OptimizePoseAnalytic* test functions
(mahalanobis tests/simple_optimization_test.cc:543-575): up to 10 outer
iterations of {match correspondences at current pose -> inner LM solve},
stopping when the pose delta drops below 1e-5 in both translation norm and
quaternion vector norm.

Host/device boundary: the map, the scan, matching and the inner LM solve
live on the minimizer's device; only the pose and the outer convergence
check ride on the host between outer iterations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import pose as pose_mod
from ..core.options import Options
from ..core.pose import Pose
from ..ops import mahalanobis
from ..solvers.minimizers import _MinimizerBase
from ..utils import tracing
from . import matching
from . import ndt as ndt_mod
from .ndt import NdtMap

OUTER_MAX_ITERATIONS = 10  # reference: tests/simple_optimization_test.cc:480
OUTER_TOLERANCE = 1e-5  # :565-568


@dataclasses.dataclass
class RegistrationResult:
    pose: Pose
    outer_iterations: int
    summaries: list  # per-outer-iteration inner Summary


@tracing.traced("nls.register")
def register_ndt(
    ndt_map: NdtMap,
    local_points: np.ndarray,
    initial_pose: Pose,
    minimizer: _MinimizerBase,
    options: Options,
    search_radius: float = 1.0,
    num_neighbors: int = 2,
    max_outer_iterations: int = OUTER_MAX_ITERATIONS,
    outer_tolerance: float = OUTER_TOLERANCE,
) -> RegistrationResult:
    """Full scan-to-map registration with re-matching per outer iteration,
    on ``minimizer.device`` in ``minimizer.dtype``."""
    valid = ndt_map.valid_only()
    as_t = lambda a: torch.as_tensor(
        np.asarray(a), dtype=minimizer.dtype, device=minimizer.device
    )
    means = as_t(valid.means)
    sqrt_infos = as_t(valid.sqrt_informations)
    points = as_t(local_points)
    points_mask = torch.ones(
        points.shape[0], dtype=minimizer.dtype, device=minimizer.device
    )

    match = lambda pose: matching.match_point_cloud(
        means, sqrt_infos, points, points_mask,
        as_t(pose.rotation), as_t(pose.translation),
        search_radius=search_radius, num_neighbors=num_neighbors,
    )
    return _outer_loop(
        match, minimizer, options, initial_pose, max_outer_iterations, outer_tolerance
    )


def _outer_loop(
    match, minimizer, options, initial_pose, max_outer_iterations, outer_tolerance
) -> RegistrationResult:
    """{match at the current pose -> inner solve} until the pose moves by
    less than ``outer_tolerance`` (reference :563-568)."""
    pose = initial_pose.copy()
    last_pose = pose.copy()
    summaries = []
    outer_iter = 0
    for outer_iter in range(max_outer_iterations):
        with tracing.span("nls.match"):
            data = match(pose)
        pose, summary = minimizer.solve(options, data, pose)
        summaries.append(summary)

        diff = pose.inverse() * last_pose
        dq = pose_mod.np_rotmat_to_quat(diff.rotation)
        if (
            np.linalg.norm(diff.translation) < outer_tolerance
            and np.linalg.norm(dq[1:]) < outer_tolerance
        ):
            break
        last_pose = pose.copy()

    return RegistrationResult(pose=pose, outer_iterations=outer_iter, summaries=summaries)


@tracing.traced("nls.register")
def register_d2d_ndt(
    ndt_map: NdtMap,
    local_points: np.ndarray,
    initial_pose: Pose,
    minimizer: _MinimizerBase,
    options: Options,
    scan_voxel_resolution: float = 0.5,
    search_radius: float = 1.0,
    max_outer_iterations: int = OUTER_MAX_ITERATIONS,
    outer_tolerance: float = OUTER_TOLERANCE,
) -> RegistrationResult:
    """Distribution-to-distribution (D2D) NDT / generalized-ICP
    registration: the scan is itself summarized as an NDT map and voxel
    GAUSSIANS are matched, not raw points (Stoyanov et al. IJRR'12 D2D-NDT;
    Segal et al. RSS'09 GICP). Beyond the reference, which is strictly
    point-to-distribution.

    Each matched pair contributes r = W^{1/2} (R mu_s + t - mu_m) with the
    GICP combined-covariance whitening W = (Sigma_m + R Sigma_s R^T)^{-1},
    recomputed on the host at the current rotation every outer iteration
    and held fixed through the inner LM solve. The inner problem is then
    ``MahalanobisData``, so ``minimizer`` (``MahalanobisDistanceMinimizer``:
    on the card its maha6 kernel) solves it unchanged.

    Voxel covariances come eigenvalue-floored from the map
    (``ndt.voxel_covariances``); the scan map is built unquirked
    (``identity_moment=False``) at ``scan_voxel_resolution``.
    """
    map_valid = ndt_map.valid_only()
    map_means = np.asarray(map_valid.means)
    map_covs = ndt_mod.voxel_covariances(map_valid)

    scan_map = ndt_mod.build_ndt_map(
        np.asarray(local_points), scan_voxel_resolution, identity_moment=False
    ).valid_only()
    if scan_map.num_voxels == 0:
        raise ValueError(
            "register_d2d_ndt: no valid scan voxel passed the count/"
            "eigenvalue tests — scan_voxel_resolution "
            f"({scan_voxel_resolution}) is too fine for the scan density "
            "(each voxel needs >= 5 points and lambda_max >= 0.01)"
        )
    scan_means = np.asarray(scan_map.means)  # local frame
    scan_covs = ndt_mod.voxel_covariances(scan_map)
    as_t = lambda a: torch.as_tensor(
        np.asarray(a), dtype=minimizer.dtype, device=minimizer.device
    )
    points = as_t(scan_means)

    def match(pose: Pose) -> mahalanobis.MahalanobisData:
        R = np.asarray(pose.rotation)
        warped = scan_means @ R.T + pose.translation
        # nearest mean on the host: both sets are small (hundreds)
        d2 = np.sum((warped[:, None, :] - map_means[None, :, :]) ** 2, axis=-1)
        idx = np.argmin(d2, axis=1)
        mask = (d2[np.arange(len(idx)), idx] <= search_radius * search_radius).astype(np.float64)
        # GICP whitening at the current rotation: the symmetric inverse
        # square root of Sigma_m + R Sigma_s R^T per pair
        combined = map_covs[idx] + np.einsum("ij,mjk,lk->mil", R, scan_covs, R)
        w, V = np.linalg.eigh(combined)
        inv_sqrt_w = 1.0 / np.sqrt(np.maximum(w, 1e-12))
        sqrt_infos = np.einsum("mik,mk,mjk->mij", V, inv_sqrt_w, V)
        return mahalanobis.MahalanobisData(
            points=points, means=as_t(map_means[idx]),
            sqrt_infos=as_t(sqrt_infos), mask=as_t(mask),
        )

    return _outer_loop(
        match, minimizer, options, initial_pose, max_outer_iterations, outer_tolerance
    )


@tracing.traced("nls.register")
def register_point_to_plane(
    ndt_map: NdtMap,
    local_points: np.ndarray,
    initial_pose: Pose,
    minimizer: _MinimizerBase,
    options: Options,
    search_radius: float = 1.0,
    max_flatness: float = 0.2,
    max_thickness: float = None,
    num_neighbors: int = 4,
    trim_distance: float = 0.3,
    max_outer_iterations: int = OUTER_MAX_ITERATIONS,
    outer_tolerance: float = OUTER_TOLERANCE,
) -> RegistrationResult:
    """Point-to-plane ICP against the NDT map's voxel planes, with the
    outer loop of :func:`register_ndt`.

    Each valid voxel whose flatness is at most ``max_flatness`` (and, when
    ``max_thickness`` is set, whose thickness is at most that, in meters;
    see ``ndt.voxel_normals``) contributes a plane; every scan point
    matches the best plane of its ``num_neighbors`` nearest in-radius
    voxels (``matching.match_point_to_plane``), trimmed at
    ``trim_distance``, and ``minimizer`` (typically
    ``PointToPlaneMinimizer``) solves each inner problem. For accurate
    planes build the map with ``identity_moment=False`` and gate with
    ``max_thickness`` (a few cm).
    """
    valid = ndt_map.valid_only()
    normals, flatness, thickness = ndt_mod.voxel_normals(valid)
    ok = flatness <= max_flatness
    if max_thickness is not None:
        ok &= thickness <= max_thickness
    as_t = lambda a: torch.as_tensor(
        np.asarray(a), dtype=minimizer.dtype, device=minimizer.device
    )
    means = as_t(valid.means)
    normals = as_t(normals)
    weights = as_t(ok.astype(np.float64))
    points = as_t(local_points)
    points_mask = torch.ones(
        points.shape[0], dtype=minimizer.dtype, device=minimizer.device
    )

    match = lambda pose: matching.match_point_to_plane(
        means, normals, weights, points, points_mask,
        as_t(pose.rotation), as_t(pose.translation),
        search_radius=search_radius, num_neighbors=num_neighbors,
        trim_distance=trim_distance,
    )
    return _outer_loop(
        match, minimizer, options, initial_pose, max_outer_iterations, outer_tolerance
    )
