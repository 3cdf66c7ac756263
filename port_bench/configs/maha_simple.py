"""The maha-simple configuration: the upstream C++ test
``mahalanobis_distance_minimizer/tests/simple_optimization_test.cc``.

Its scene, made here from the sizes in ``maha_simple.json``: a room of
floor and four walls sampled on a 1 cm grid (954,605 points; the C++
loops' accumulated float64 stepping decides how many), an NDT map of 1 m
voxels (96 valid), and the scan: the room filtered to the first point of
each 10 cm voxel (9,356 points). Each item of the pool is that scan seen
from the test's true pose (yaw 0.1 rad, t = (-0.2, 0.123, 0.3) m) plus the
mix's drawn offsets, in the sensor's frame, registered from the identity.

Its entry points are the files of ``entries/maha_simple/``; each builds
its callable from the :class:`System` and wraps it in
:meth:`System.counted`.

The check registers the sampled scans again with the plain reference
(``reference/ndt.py``, float64, its own map from the same room) and
compares the pose and the final cost.
"""

from __future__ import annotations

import numpy as np

from harness.report import Check
from reference import ndt as ref_ndt


def _steps(start: float, stop: float, step: float) -> np.ndarray:
    """``for (x = start; x <= stop; x += step)`` in float64, as the C++
    test steps it."""
    out, x = [], float(start)
    while x <= stop:
        out.append(x)
        x += step
    return np.asarray(out)


def room_points(cfg: dict) -> np.ndarray:
    """The test's room (``simple_optimization_test.cc:170-204``): the floor,
    then the side walls interleaved, then the end walls interleaved."""
    r = cfg["room"]
    w, l, h, step = r["width"], r["length"], r["height"], r["point_step"]
    xs, ys, zs = _steps(-l / 2, l / 2, step), _steps(-w / 2, w / 2, step), _steps(0.0, h, step)
    fx, fy = np.meshgrid(xs, ys, indexing="ij")
    floor = np.stack([fx.ravel(), fy.ravel(), np.zeros(fx.size)], axis=1)
    wx, wz = np.meshgrid(xs, zs, indexing="ij")
    sides = np.empty((2 * wx.size, 3))
    sides[0::2] = np.stack([wx.ravel(), np.full(wx.size, -w / 2), wz.ravel()], axis=1)
    sides[1::2] = np.stack([wx.ravel(), np.full(wx.size, w / 2), wz.ravel()], axis=1)
    wy, wz2 = np.meshgrid(ys, zs, indexing="ij")
    ends = np.empty((2 * wy.size, 3))
    ends[0::2] = np.stack([np.full(wy.size, l / 2), wy.ravel(), wz2.ravel()], axis=1)
    ends[1::2] = np.stack([np.full(wy.size, -l / 2), wy.ravel(), wz2.ravel()], axis=1)
    return np.concatenate([floor, sides, ends])


def sensor_pose(cfg: dict, item: dict):
    """(R, t) of the scan's sensor: the true pose plus the item's offsets
    (yaw about z, then x, y, z)."""
    yaw = cfg["true_pose"]["yaw"] + item.get("yaw", 0.0)
    t = np.asarray(cfg["true_pose"]["translation"], np.float64) + [
        item.get("x", 0.0), item.get("y", 0.0), item.get("z", 0.0)]
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]), t


def scans(cfg: dict, items) -> tuple:
    """(room points, the scans of ``items`` in their sensors' frames)."""
    pts = room_points(cfg)
    world = ref_ndt.voxel_filter(pts, cfg["scan_filter"])
    local = []
    for item in items:
        R, t = sensor_pose(cfg, item)
        local.append((world - t) @ R)  # R^T (p - t)
    return pts, local


def rotation_gap(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle of Ra^T Rb, in radians (accurate near 0)."""
    return float(2.0 * np.arcsin(min(1.0, np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0)))))


def gaps(answers, refs) -> dict:
    """The widest gaps between answers (R, t, cost) and the reference's."""
    out = {"pose_gap_m": 0.0, "rot_gap_rad": 0.0, "cost_gap_rel": 0.0}
    for (R, t, cost), r in zip(answers, refs):
        out["pose_gap_m"] = max(out["pose_gap_m"], float(np.linalg.norm(t - r.translation)))
        out["rot_gap_rad"] = max(out["rot_gap_rad"], rotation_gap(R, r.rotation))
        gap = abs(cost - r.final_cost) / abs(r.final_cost)
        out["cost_gap_rel"] = max(out["cost_gap_rel"], gap if gap == gap else float("inf"))
    return out


def sample(window, plan, rng) -> list:
    """(request, position) pairs of the window's answers that the check
    compares: ``plan.check`` of them drawn from ``rng``; for batches at
    least one a position in the batch."""
    served = [r for r in window.requests if r.answers is not None]
    if not served:
        return []
    if plan.batch == 1:
        picks = rng.choice(len(served), size=min(plan.check, len(served)), replace=False)
        return [(served[i], 0) for i in sorted(picks)]
    per = max(1, plan.check // plan.batch)
    return [(served[int(rng.integers(len(served)))], j)
            for j in range(plan.batch) for _ in range(per)]


class System:
    """The port set up for one cell of this configuration: the room, its
    NDT map and the pool's scans, with what every entry point shares."""

    def __init__(self, cfg: dict, plan, device: str):
        import torch

        import nonlinear_optimizer_for_slam_tpu_torch as port
        from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels
        from nonlinear_optimizer_for_slam_tpu_torch.pipelines import ndt

        self.cfg, self.plan, self.device = cfg, plan, device
        self.port, self._torch, self._ck = port, torch, cuda_kernels
        self.points, self.local = scans(cfg, plan.items)
        self.ndt_map = ndt.build_ndt_map(self.points, cfg["map_resolution"])
        self.loss = port.ExponentialLoss(cfg["loss"]["c1"], cfg["loss"]["c2"])
        self.options = port.Options().replace(max_iterations=cfg["max_iterations"])
        self.identity = port.Pose.identity()
        self.rows = self.local[0].shape[0] * cfg["num_neighbors"]  # matched rows a scan
        self.matching = dict(search_radius=cfg["search_radius"], num_neighbors=cfg["num_neighbors"],
                             max_outer_iterations=cfg["max_outer_iterations"])

    def counted(self, serve):
        """``serve(scans)`` as an entry of pool indices, under the span
        ``pb.request``, its counters joined by the maha6 launches."""

        def entry(items):
            before = self._ck.LAUNCHES["maha6"]
            with self._torch.profiler.record_function("pb.request"):
                answers, counters = serve([self.local[i] for i in items])
            launches = self._ck.LAUNCHES["maha6"] - before
            counters.update(maha6_launches=launches,
                            maha6_factors=launches * self.rows * len(items),
                            maha6_problems=launches * len(items))
            return answers, counters

        return entry

    def release(self) -> None:
        self.ndt_map = None

    def check(self, window, rng, limits) -> list:
        picked = sample(window, self.plan, rng)
        ref_map = ref_ndt.build_map(self.points, self.cfg["map_resolution"])
        refs, answers, cache = [], [], {}
        for request, j in picked:
            item = request.items[j]
            if item not in cache:
                cache[item] = ref_ndt.register(ref_map, self.local[item])
            pose, cost = request.answers[j]
            answers.append((pose.rotation, pose.translation, float(cost)))
            refs.append(cache[item])
        found = gaps(answers, refs) if picked else {k: float("inf") for k in limits}
        return [Check(k, found[k], limits[k]) for k in limits]
