"""Loop-closure detection (PyTorch port of the JAX package's
``pipelines/loop_closure.py``): propose revisit candidates from estimated
poses, verify them by scan-to-keyframe-map registration, and emit
pose-graph edges whitened by the registration's own uncertainty.

The reference has no loop-closure machinery: its pose-graph fixture plants
loop constraints by hand (pose_graph_optimizer/tests/
simple_optimization_test.cc:93-122). Every accepted edge carries
``sqrt_info = cholesky(J^T W J)`` at the verified pose
(``MahalanobisDistanceMinimizer.information``), so a backend weighs each
closure by how well the geometry constrains it.

Verification has two stages: a coarse D2D/GICP alignment
(``register_d2d_ndt``, hundreds of voxel pairs) corrects a drifted guess,
then point-to-NDT registration (``register_ndt``) refines it, judged on
the matched fraction and the size of the correction. On the card both
solve through the maha6 kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.losses import ExponentialLoss
from ..core.options import Options
from ..core.pose import Pose, np_rotmat_to_quat
from ..solvers.minimizers import MahalanobisDistanceMinimizer
from ..solvers.pose_graph import edge_information_to_world
from . import matching, ndt, registration


@dataclasses.dataclass
class LoopClosure:
    """A verified loop-closure edge: ``relative_pose`` is T_ref<-query
    (the query scan's pose in the reference keyframe's frame)."""

    reference_id: int
    query_id: int
    relative_pose: Pose
    sqrt_info: np.ndarray  # (6, 6) cholesky factor of the GN information
    matched_fraction: float
    final_cost: float
    correction: float  # |verified - guessed| translation, meters


@dataclasses.dataclass
class _Keyframe:
    pose: Pose
    ndt_map: "ndt.NdtMap"


class LoopClosureDetector:
    """Radius-gated loop proposal and registration-verified acceptance.

    ``candidate_radius`` is in the ESTIMATED frame (widen it with the
    expected drift). ``min_id_gap`` keeps odometry neighbours from passing
    as loops. Acceptance needs a registration inside
    ``max_translation_correction`` / ``max_rotation_correction`` of the
    guess and at least ``min_match_fraction`` of the query scan matched to
    the keyframe's map at the verified pose. ``device`` defaults to
    "cuda", where the registrations solve through the maha6 kernel.
    """

    def __init__(
        self,
        voxel_resolution: float = 1.0,
        candidate_radius: float = 1.0,
        min_id_gap: int = 10,
        search_radius: float = 1.0,
        max_translation_correction: float = 1.0,
        max_rotation_correction: float = 0.5,
        min_match_fraction: float = 0.5,
        coarse_d2d: bool = True,
        options: Optional[Options] = None,
        loss=None,
        dtype: torch.dtype = torch.float32,
        identity_moment: bool = True,
        device="cuda",
    ):
        self.voxel_resolution = voxel_resolution
        self.candidate_radius = candidate_radius
        self.min_id_gap = min_id_gap
        self.search_radius = search_radius
        self.max_translation_correction = max_translation_correction
        self.max_rotation_correction = max_rotation_correction
        self.min_match_fraction = min_match_fraction
        self.coarse_d2d = coarse_d2d
        self.options = options if options is not None else Options()
        self.loss = loss if loss is not None else ExponentialLoss()
        # keyframe maps default to the quirked (identity_moment=True)
        # build: its +I/count offset widens the basin of sparse scans
        self.identity_moment = identity_moment
        self.minimizer = MahalanobisDistanceMinimizer(
            dtype=dtype, device=device
        ).set_loss_function(self.loss)
        self._keyframes: Dict[int, _Keyframe] = {}

    def add_keyframe(self, keyframe_id: int, scan_points: np.ndarray, pose_estimate: Pose) -> None:
        """Register a keyframe: its scan (SENSOR frame) becomes an NDT map
        to verify later revisits against; ``pose_estimate`` is its current
        best world pose (see :meth:`update_pose`)."""
        m = ndt.build_ndt_map(
            np.asarray(scan_points, np.float64), self.voxel_resolution,
            identity_moment=self.identity_moment,
        )
        if int(m.valid.sum()) == 0:
            raise ValueError(
                f"add_keyframe({keyframe_id}): no valid NDT voxel (every "
                f"voxel needs >= 5 points and lambda_max >= 0.01 at "
                f"resolution {self.voxel_resolution}); a later detect() "
                "against an empty map cannot match anything"
            )
        self._keyframes[keyframe_id] = _Keyframe(pose_estimate.copy(), m)

    def update_pose(self, keyframe_id: int, pose_estimate: Pose) -> None:
        self._keyframes[keyframe_id].pose = pose_estimate.copy()

    def remove_keyframe(self, keyframe_id: int) -> None:
        """Drop a keyframe and its map (idempotent)."""
        self._keyframes.pop(keyframe_id, None)

    def keyframe_ids(self) -> List[int]:
        return sorted(self._keyframes)

    def detect(
        self,
        query_id: int,
        scan_points: np.ndarray,
        pose_estimate: Pose,
        eligible=None,
    ) -> Optional[LoopClosure]:
        """Try to close a loop for the query scan (SENSOR frame) at the
        current ``pose_estimate``: the nearest candidate that verifies
        wins, else None. ``eligible`` optionally restricts the keyframe ids
        tried (an ineligible nearer candidate must not shadow an eligible
        farther one)."""
        cands = []
        for kid, kf in self._keyframes.items():
            if abs(query_id - kid) < self.min_id_gap:
                continue
            if eligible is not None and kid not in eligible:
                continue
            d = np.linalg.norm(kf.pose.translation - pose_estimate.translation)
            if d <= self.candidate_radius:
                cands.append((d, kid))
        cands.sort()

        pts = np.asarray(scan_points, np.float64)
        for _, kid in cands:
            closure = self._verify(kid, query_id, pts, pose_estimate)
            if closure is not None:
                return closure
        return None

    def _verify(self, kid: int, query_id: int, pts: np.ndarray, est: Pose) -> Optional[LoopClosure]:
        kf = self._keyframes[kid]
        guess = kf.pose.inverse() * est  # T_ref<-query from the estimates

        pose = guess
        if self.coarse_d2d:
            try:
                pose = registration.register_d2d_ndt(
                    kf.ndt_map, pts, pose, self.minimizer, self.options,
                    scan_voxel_resolution=self.voxel_resolution / 2.0,
                    search_radius=self.search_radius,
                ).pose
            except ValueError:
                pass  # the scan is too sparse for the D2D level; go fine

        res = registration.register_ndt(
            kf.ndt_map, pts, pose, self.minimizer, self.options,
            search_radius=self.search_radius,
        )
        pose = res.pose

        # the correction against the odometry-chain guess
        diff = guess.inverse() * pose
        t_corr = float(np.linalg.norm(diff.translation))
        q_corr = np_rotmat_to_quat(diff.rotation)
        ang_corr = 2.0 * float(np.arctan2(np.linalg.norm(q_corr[1:]), abs(q_corr[0])))
        if t_corr > self.max_translation_correction or ang_corr > self.max_rotation_correction:
            return None

        # overlap and information at the verified pose (one more matching)
        valid = kf.ndt_map.valid_only()
        mini = self.minimizer
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=mini.dtype, device=mini.device)
        data = matching.match_point_cloud(
            as_t(valid.means), as_t(valid.sqrt_informations), as_t(pts),
            torch.ones(pts.shape[0], dtype=mini.dtype, device=mini.device),
            as_t(pose.rotation), as_t(pose.translation),
            search_radius=self.search_radius,
        )
        k = data.mask.shape[0] // pts.shape[0]
        per_point = data.mask.cpu().numpy().reshape(pts.shape[0], k)
        fraction = float(per_point.max(axis=1).mean())
        if fraction < self.min_match_fraction:
            return None

        final_cost = float(res.summaries[-1].final_cost)
        if not np.isfinite(final_cost):
            return None

        # the registration information is measurement-frame; the edge
        # residual's translation rows are world-frame
        H = edge_information_to_world(mini.information(data, pose), kf.pose.rotation)
        # a tiny jitter keeps cholesky alive on degenerate geometry
        L = np.linalg.cholesky(H + 1e-9 * np.eye(6))
        return LoopClosure(
            reference_id=kid,
            query_id=query_id,
            relative_pose=pose,
            sqrt_info=L.T,  # upper-triangular whitener, r' = S r
            matched_fraction=fraction,
            final_cost=final_cost,
            correction=t_corr,
        )
