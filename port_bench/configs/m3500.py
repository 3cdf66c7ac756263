"""The M3500 configuration: Olson, Leonard and Teller's Manhattan world
(ICRA 2006): 3,500 SE(2) poses on a random walk in a 10 x 10 block grid,
odometry and loop closures to earlier poses in the same cell, a
dead-reckoned start, 5,453 edges as in the published file. The public
file is not in the repository; the graph is generated here from the
sizes in ``m3500.json``.

The walk and the closures kept (and so every edge's endpoints) come from
``topology_seed``; each item of the pool draws a ``noise_seed`` for the
measurement noise and the dead-reckoned start. Every item is then the
same graph to solve, with other measurements.

Its entry point is ``entries/m3500/solve.py``. Set-up writes each graph
as g2o under ``TMPDIR`` and loads it with
``io.g2o.load_pose_graph(solver="auto")`` (a ``PoseGraphOptimizer2D``).

The check solves each graph of the pool that the window served with the
plain reference (``reference/pose_graph_2d.py``, float64, its own chordal
start from the same file) and compares the poses and the final cost of
the window's last answer for that graph.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from harness.report import Check
from reference import pose_graph_2d as ref_pg

_DIRS = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])


def manhattan(cfg: dict, noise_seed: int):
    """(vertices (P, 3) dead-reckoned, edges [(i, j, (dx, dy, dth))],
    information (3, 3)): the bounded grid walk of ``topology_seed`` with
    90-degree turns; as loop closures, ``n_edges`` less the odometry drawn
    from the candidates (an earlier pose of the same cell at least
    ``closure_gap`` back, at most ``max_closures_per_pose`` a pose), every
    candidate where ``cfg`` has no ``n_edges``; and measurements with
    noise from ``noise_seed``."""
    walk = np.random.default_rng(cfg["topology_seed"])
    noise = np.random.default_rng(noise_seed)
    n, side, step = cfg["n_poses"], cfg["arena"], cfg["step"]
    s_t, s_r = cfg["sigma_translation"], cfg["sigma_rotation"]
    gt = np.zeros((n, 3))
    heading, cell, visits = 0, np.zeros(2), {}
    inside = lambda c: 0 <= c[0] <= side and 0 <= c[1] <= side
    for k in range(n):
        gt[k, :2] = cell * step
        gt[k, 2] = heading * (np.pi / 2.0)
        visits.setdefault((int(round(cell[0])), int(round(cell[1]))), []).append(k)
        u = walk.uniform()
        if u < cfg["turn_prob"] / 2:
            heading = (heading + 1) % 4
        elif u < cfg["turn_prob"]:
            heading = (heading - 1) % 4
        tries = 0
        while not inside(cell + _DIRS[heading]) and tries < 4:
            heading = (heading + 1) % 4
            tries += 1
        cell = cell + _DIRS[heading]

    def rel(i, j):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        d = gt[j, :2] - gt[i, :2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], ref_pg.wrap(gt[j, 2] - gt[i, 2])])

    def noisy(r):
        return r + np.array([noise.normal(0, s_t), noise.normal(0, s_t), noise.normal(0, s_r)])

    candidates = []
    for k in range(n):
        added = 0
        for j in visits.get((int(round(gt[k, 0] / step)), int(round(gt[k, 1] / step))), []):
            if k - j < cfg["closure_gap"] or added >= cfg["max_closures_per_pose"]:
                continue
            candidates.append((j, k))
            added += 1
    n_closures = cfg.get("n_edges", n - 1 + len(candidates)) - (n - 1)
    if not 0 <= n_closures <= len(candidates):
        raise ValueError(f"{cfg['n_edges']} edges: {len(candidates)} closure candidates")
    keep = np.sort(np.random.default_rng([cfg["topology_seed"], 1]).choice(
        len(candidates), size=n_closures, replace=False))
    edges, odometry = [], []
    for k in range(n - 1):
        odometry.append(noisy(rel(k, k + 1)))
        edges.append((k, k + 1, odometry[-1]))
    for c in keep:
        j, k = candidates[c]
        edges.append((j, k, noisy(rel(j, k))))
    est = np.zeros((n, 3))
    est[0] = gt[0]
    for k in range(1, n):
        m, (x, y, th) = odometry[k - 1], est[k - 1]
        c, s = np.cos(th), np.sin(th)
        est[k] = (x + c * m[0] - s * m[1], y + s * m[0] + c * m[1], ref_pg.wrap(th + m[2]))
    info = np.diag([1.0 / s_t**2, 1.0 / s_t**2, 1.0 / s_r**2])
    return est, edges, info


def write_g2o(path: str, vertices, edges, info) -> None:
    upper = " ".join(f"{info[a, b]:.9g}" for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))
    with open(path, "w") as f:
        for k, (x, y, th) in enumerate(vertices):
            f.write(f"VERTEX_SE2 {k} {x:.9g} {y:.9g} {th:.9g}\n")
        for i, j, (dx, dy, dth) in edges:
            f.write(f"EDGE_SE2 {i} {j} {dx:.9g} {dy:.9g} {dth:.9g} {upper}\n")
        f.write("FIX 0\n")


def gaps(answer, ref) -> dict:
    """Gaps between one answer (xyt (P, 3), cost) and the reference's."""
    xyt, cost = answer
    rxyt, rcost = ref
    return {
        "pose_gap_m": float(np.max(np.linalg.norm(xyt[:, :2] - rxyt[:, :2], axis=1))),
        "rot_gap_rad": float(np.max(np.abs(ref_pg.wrap(xyt[:, 2] - rxyt[:, 2])))),
        "cost_gap_rel": abs(cost - rcost) / abs(rcost) if cost == cost else float("inf"),
    }


def reference_solve(path: str):
    """The reference's (xyt, cost) of the g2o file at ``path``."""
    g = ref_pg.read_g2o(path)
    xyt, cost, _ = ref_pg.solve(g, ref_pg.chordal(g))
    return xyt, cost


class System:
    """The port set up for one cell of this configuration: one optimizer a
    graph of the pool, loaded from its g2o file."""

    def __init__(self, cfg: dict, plan, device: str, dtype=None):
        import torch

        import nonlinear_optimizer_for_slam_tpu_torch as port
        from nonlinear_optimizer_for_slam_tpu_torch.io import g2o

        self.cfg, self.torch = cfg, torch
        self.cuda = device == "cuda"
        self.options = port.Options().replace(max_iterations=cfg["max_iterations"])
        self._tmp = tempfile.TemporaryDirectory(prefix="pb_m3500_")
        self.paths, self.files, self.opts = [], [], []
        dtype = dtype or getattr(torch, cfg["dtype"])
        for k, item in enumerate(plan.items):
            vertices, edges, info = manhattan(cfg, item["noise_seed"])
            path = os.path.join(self._tmp.name, f"graph{k}.g2o")
            write_g2o(path, vertices, edges, info)
            opt = g2o.load_pose_graph(path, solver=cfg["solver"], device=device, dtype=dtype)
            self.paths.append(path)
            self.files.append({vid: opt.get_pose(vid) for vid in opt.pose_indices()})
            self.opts.append(opt)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def release(self) -> None:
        self.opts = None

    def check(self, window, rng, limits) -> list:
        last = {}
        for r in window.requests:
            if r.answers is not None:
                for k, answer in zip(r.items, r.answers):
                    last[k] = answer
        found = {name: 0.0 if last else float("inf") for name in limits}
        for k in sorted(last):
            xyt, cost = last[k]
            g = gaps((xyt, float(cost)), reference_solve(self.paths[k]))
            found = {name: max(found[name], g[name]) for name in limits}
        self._tmp.cleanup()
        return [Check(name, found[name], limits[name]) for name in limits]
