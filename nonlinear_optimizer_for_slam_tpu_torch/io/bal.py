"""BAL (Bundle Adjustment in the Large) problem file IO (a copy of the JAX
package's ``io/bal.py``: host numpy, shared by nothing).

Format (Agarwal et al., "Bundle Adjustment in the Large", ECCV 2010;
https://grail.cs.washington.edu/projects/bal/ — whitespace-separated
text, values may be one-per-line or space-separated):

    <num_cameras> <num_points> <num_observations>
    <camera_index_i> <point_index_i> <x_i> <y_i>      x num_observations
    <camera parameters, 9 per camera>                  x num_cameras
    <point parameters, 3 per point>                    x num_points

Camera block layout (the Snavely model): 3 Rodrigues rotation components,
3 translation components, focal length f, radial distortion k1, k2.
Projection convention: P = R * X + t, p = -P_xy / P_z (BAL looks down the
NEGATIVE z axis), predicted pixel = f * (1 + k1 r^2 + k2 r^4) * p with
r^2 = |p|^2, measured from the image center.

This reader exists so real BAL datasets drop straight into
``solvers.bal.solve_bal`` (the external-anchor path the reference realizes
through Ceres, pose_graph_optimizer_ceres.cc:15-69 pattern); the writer
round-trips synthetic problems for the offline anchor tests. Files written
by either package read in the other.
"""

from __future__ import annotations

import gzip
from typing import NamedTuple

import numpy as np


class BALProblem(NamedTuple):
    """A BAL problem instance (numpy, host-side)."""

    camera_params: np.ndarray  # (C, 9) float64 — [rodrigues(3), t(3), f, k1, k2]
    points: np.ndarray  # (P, 3) float64
    camera_indices: np.ndarray  # (O,) int32
    point_indices: np.ndarray  # (O,) int32
    observations: np.ndarray  # (O, 2) float64 observed pixels (center origin)

    @property
    def num_cameras(self) -> int:
        return self.camera_params.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_observations(self) -> int:
        return self.camera_indices.shape[0]


def _open(path, mode):
    if str(path).endswith(".gz"):  # BAL distributes .txt.bz2/.gz; support .gz
        return gzip.open(path, mode)
    return open(path, mode)


def read_bal(path) -> BALProblem:
    """Parse a BAL problem file (plain text or .gz)."""
    with _open(path, "rt") as f:
        tokens = f.read().split()
    it = iter(tokens)

    C, P, O = (int(next(it)) for _ in range(3))
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    obs = np.empty((O, 2), np.float64)
    for i in range(O):
        cam_idx[i] = int(next(it))
        pt_idx[i] = int(next(it))
        obs[i, 0] = float(next(it))
        obs[i, 1] = float(next(it))
    rest = np.fromiter((float(t) for t in it), np.float64)
    if rest.size != 9 * C + 3 * P:
        raise ValueError(
            f"BAL file has {rest.size} parameter values, expected "
            f"9*{C} + 3*{P} = {9 * C + 3 * P}"
        )
    cams = rest[: 9 * C].reshape(C, 9)
    pts = rest[9 * C :].reshape(P, 3)
    if O and (
        cam_idx.max() >= C
        or pt_idx.max() >= P
        or cam_idx.min() < 0
        or pt_idx.min() < 0
    ):
        # negative indices would silently wrap via fancy indexing
        raise ValueError("observation index out of range")
    return BALProblem(cams, pts, cam_idx, pt_idx, obs)


def write_bal(path, problem: BALProblem) -> None:
    """Write a BAL problem file (one value per line for the parameter
    block, matching the published files)."""
    C, P, O = (
        problem.num_cameras,
        problem.num_points,
        problem.num_observations,
    )
    with _open(path, "wt") as f:
        f.write(f"{C} {P} {O}\n")
        for i in range(O):
            f.write(
                f"{int(problem.camera_indices[i])} "
                f"{int(problem.point_indices[i])} "
                f"{problem.observations[i, 0]:.16e} "
                f"{problem.observations[i, 1]:.16e}\n"
            )
        for v in problem.camera_params.reshape(-1):
            f.write(f"{v:.16e}\n")
        for v in problem.points.reshape(-1):
            f.write(f"{v:.16e}\n")


def snavely_project(camera_params: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Reference (numpy, host) Snavely projection for one camera/point
    pair or broadcastable batches: returns predicted pixels (..., 2).

    Independent of the PyTorch implementation in solvers.bal (kept in sync
    by tests); used by the synthetic-problem generator.
    """
    rod = camera_params[..., 0:3]
    t = camera_params[..., 3:6]
    f = camera_params[..., 6:7]
    k1 = camera_params[..., 7:8]
    k2 = camera_params[..., 8:9]
    theta = np.linalg.norm(rod, axis=-1, keepdims=True)
    # Rodrigues rotation of X, small-angle safe
    small = theta < 1e-12
    axis = np.where(small, 0.0, rod / np.where(small, 1.0, theta))
    ct = np.cos(theta)
    st = np.sin(theta)
    dot = np.sum(axis * X, axis=-1, keepdims=True)
    cross = np.cross(np.broadcast_to(axis, X.shape), X)
    PX = ct * X + st * cross + (1.0 - ct) * dot * axis + t
    p = -PX[..., :2] / PX[..., 2:3]
    r2 = np.sum(p * p, axis=-1, keepdims=True)
    return f * (1.0 + k1 * r2 + k2 * r2 * r2) * p


def synthetic_bal_problem(
    num_cameras: int,
    num_points: int,
    observations_per_point: int = 4,
    pixel_noise: float = 1.0,
    camera_noise: float = 0.02,
    point_noise: float = 0.05,
    seed: int = 0,
) -> tuple[BALProblem, BALProblem]:
    """Generate a BAL-geometry synthetic problem: a ring of cameras at
    radius ~10 looking inward (down their -z, the BAL convention) at a
    point cloud in the unit-ish ball, Snavely-projected with a realistic
    focal length and mild radial distortion, with Gaussian pixel noise;
    the initial estimate perturbs cameras and points.

    Returns (noisy_problem, ground_truth_problem): the noisy one is what
    a solver sees, the ground-truth one gives the generating parameters
    (its reprojection cost is the pixel-noise floor, NOT zero).
    """
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.0, 2.0, size=(num_points, 3))

    cams = np.zeros((num_cameras, 9))
    for c in range(num_cameras):
        ang = 2.0 * np.pi * c / num_cameras
        center = np.array(
            [10.0 * np.cos(ang), 10.0 * np.sin(ang), 2.0 * np.sin(3 * ang)]
        )
        # camera looks at the origin along its -z (BAL convention):
        # build R whose rows are the camera axes; z axis points AWAY from
        # the scene so that P_z = (R X + t)_z < 0 for scene points
        z = center / np.linalg.norm(center)  # away from origin
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        t = -R @ center
        # Rodrigues from R
        cams[c, 0:3] = _rodrigues_from_matrix(R)
        cams[c, 3:6] = t
        cams[c, 6] = 800.0 + 50.0 * rng.standard_normal()
        cams[c, 7] = -1e-3 * rng.uniform(0.5, 1.5)
        cams[c, 8] = 1e-5 * rng.uniform(0.5, 1.5)

    # observations: each point seen by a random subset of cameras (the
    # random draws in the JAX package's order; the projections, which draw
    # nothing, in one batched call: the same arithmetic per observation)
    cam_idx, pt_idx, noise = [], [], []
    for j in range(num_points):
        seen = rng.choice(
            num_cameras,
            size=min(observations_per_point, num_cameras),
            replace=False,
        )
        for c in seen:
            cam_idx.append(c)
            pt_idx.append(j)
            noise.append(rng.standard_normal(2))
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    uv = snavely_project(cams[cam_idx], pts[pt_idx])
    obs = uv + pixel_noise * np.asarray(noise, np.float64).reshape(-1, 2)

    truth = BALProblem(cams.copy(), pts.copy(), cam_idx, pt_idx, obs)
    noisy_cams = cams.copy()
    noisy_cams[:, 0:6] += camera_noise * rng.standard_normal((num_cameras, 6))
    noisy_pts = pts + point_noise * rng.standard_normal(pts.shape)
    noisy = BALProblem(noisy_cams, noisy_pts, cam_idx, pt_idx, obs)
    return noisy, truth


def _rodrigues_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> Rodrigues vector (host-side, numpy)."""
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-12:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(theta))
    )
    return theta * w
