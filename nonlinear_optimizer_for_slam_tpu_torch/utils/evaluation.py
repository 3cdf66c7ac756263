"""Trajectory evaluation: Umeyama alignment, ATE, RPE (a copy of the JAX
package's ``utils/evaluation.py`` on the port's own ``core/pose.py``).

The standard SLAM benchmark metrics (Sturm et al. IROS 2012, the
TUM-RGBD evaluation protocol; Umeyama TPAMI 1991 for the closed-form
similarity alignment). The reference repo has no evaluation tooling at
all: its tests print final poses for eyeballing; these utilities turn
any of this framework's solver outputs into the numbers SLAM papers
report. Host-side numpy on purpose: evaluation consumes solver OUTPUTS
(host arrays), and per-op device launches would only cost time here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.pose import Pose, np_quat_to_rotmat

__all__ = [
    "umeyama_alignment",
    "absolute_trajectory_error",
    "relative_pose_error",
]


def umeyama_alignment(
    src: np.ndarray,  # (N, 3) points to transform
    dst: np.ndarray,  # (N, 3) target points
    with_scale: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Closed-form least-squares similarity (or rigid) alignment
    (Umeyama, TPAMI 1991): returns ``(R, t, s)`` minimizing
    ``sum_i || s R src_i + t - dst_i ||^2``, with ``s = 1`` when
    ``with_scale=False``. Handles reflection-degenerate covariances via
    the determinant-sign correction of the original paper."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(f"need matching (N, 3) arrays, got {src.shape} vs {dst.shape}")
    n = src.shape[0]
    if n < 3:
        raise ValueError("need at least 3 point pairs")
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / n  # (3, 3)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = np.sum(xs * xs) / n
        s = float(np.trace(np.diag(d) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def _positions(traj, planar: bool = False) -> np.ndarray:
    """Accepts (N, 3) arrays, (N, >=3) state arrays (first 3 columns are
    taken as raw 3D position), or sequences of Pose. NOTE an (N, 3)
    array is interpreted as x/y/z — for the 2D xyt convention pass
    ``planar=True`` (through ``absolute_trajectory_error``) so the third
    column (heading, radians) is zeroed instead of scored as a
    z-coordinate."""
    if isinstance(traj, np.ndarray):
        if traj.ndim != 2:
            raise ValueError(f"trajectory array must be 2-D, got {traj.shape}")
        pos = np.asarray(traj[:, :3], np.float64)
    elif isinstance(traj[0], Pose):
        pos = np.stack([p.translation for p in traj]).astype(np.float64)
    else:
        pos = np.asarray(np.stack([np.asarray(p)[:3] for p in traj]), np.float64)
    if planar:
        pos = pos.copy()
        pos[:, 2] = 0.0
    return pos


def _stats(err: np.ndarray) -> Dict[str, float]:
    return dict(
        rmse=float(np.sqrt(np.mean(err * err))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        max=float(np.max(err)),
    )


def absolute_trajectory_error(
    estimated,
    ground_truth,
    align: bool = True,
    with_scale: bool = False,
    planar: bool = False,
) -> Dict[str, float]:
    """ATE (Sturm et al. 2012): per-pose translational error after an
    optional least-squares alignment of the estimate onto the ground
    truth (``with_scale=True`` for monocular/Sim(3) estimates). Inputs:
    (N, 3) position arrays or sequences of Pose, index-associated.
    Pass ``planar=True`` for SE(2) (N, 3) xyt trajectories so the
    heading column is excluded from the position error (otherwise the
    third column is scored as a z-coordinate). Returns ``{rmse, mean,
    median, max}`` in the ground truth's units, plus the alignment
    under keys ``scale`` (and implicitly rigid R, t applied) when
    ``align``."""
    est = _positions(estimated, planar=planar)
    gt = _positions(ground_truth, planar=planar)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")
    s = 1.0
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale=with_scale)
        est = s * est @ R.T + t
    err = np.linalg.norm(est - gt, axis=1)
    out = _stats(err)
    out["scale"] = float(s)
    return out


def _as_pose_list(traj) -> List[Pose]:
    if isinstance(traj, np.ndarray):
        if traj.shape[1] == 7:  # [t (3), q wxyz (4)]
            return [
                Pose(np_quat_to_rotmat(r[3:7] / np.linalg.norm(r[3:7])), r[:3].copy())
                for r in traj
            ]
        if traj.shape[1] == 3:  # 2D xyt
            out = []
            for r in traj:
                c, sn = np.cos(r[2]), np.sin(r[2])
                R = np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]])
                out.append(Pose(R, np.array([r[0], r[1], 0.0])))
            return out
        raise ValueError(
            f"pose array must be (N, 7) [t, q] or (N, 3) xyt, got {traj.shape}"
        )
    if isinstance(traj[0], Pose):
        return list(traj)
    return _as_pose_list(np.stack([np.asarray(p) for p in traj]))


def relative_pose_error(
    estimated,
    ground_truth,
    delta: int = 1,
) -> Dict[str, Dict[str, float]]:
    """RPE (Sturm et al. 2012): statistics of the per-step drift — the
    error of the estimated relative motion over a ``delta``-frame
    baseline vs the ground truth's. Inputs: sequences of Pose, (N, 7)
    [t, q_wxyz] arrays, or (N, 3) SE(2) xyt arrays. Returns
    ``{"translation": {rmse, ...} (units), "rotation": {rmse, ...}
    (radians)}`` — the frame-invariant metric (no alignment needed)."""
    est = _as_pose_list(estimated)
    gt = _as_pose_list(ground_truth)
    if len(est) != len(gt):
        raise ValueError(f"trajectory lengths differ: {len(est)} vs {len(gt)}")
    if not 1 <= delta < len(est):
        raise ValueError(f"delta must be in [1, {len(est) - 1}], got {delta}")
    t_err, r_err = [], []
    for i in range(len(est) - delta):
        rel_e = est[i].inverse() * est[i + delta]
        rel_g = gt[i].inverse() * gt[i + delta]
        d = rel_g.inverse() * rel_e
        t_err.append(np.linalg.norm(d.translation))
        cos_th = np.clip((np.trace(d.rotation) - 1.0) / 2.0, -1.0, 1.0)
        r_err.append(float(np.arccos(cos_th)))
    return dict(
        translation=_stats(np.asarray(t_err)),
        rotation=_stats(np.asarray(r_err)),
    )
