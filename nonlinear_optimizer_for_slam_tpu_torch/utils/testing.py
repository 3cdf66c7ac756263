"""Deterministic synthetic fixtures mirroring the reference test worlds (a
numpy copy of the NDT, reprojection and pose-graph parts of the JAX package's
``utils/testing.py``), the reference oracle traces, and a numpy emulation
of the one-pass kernels' order of summation (``csrc/onepass.cuh``).

The generators reproduce the C++ loops' accumulated floating-point stepping
(``for (x = a; x <= b; x += step)`` accumulates rounding error, which
determines how many grid samples are generated).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.pose import Pose
from ..ops.cuda_kernels import ONE_PASS_TILE
from ..ops.reprojection import CameraIntrinsics


def _accum_range(start: float, stop: float, step: float) -> np.ndarray:
    """Replicates C++ ``for (x = start; x <= stop; x += step)`` float64
    accumulation exactly."""
    values = []
    x = float(start)
    while x <= stop:
        values.append(x)
        x += step
    return np.asarray(values)


def generate_room_points(
    width: float = 5.0,
    length: float = 7.0,
    height: float = 2.5,
    point_step: float = 0.01,
) -> np.ndarray:
    """Synthetic room: floor + 4 walls on a 1 cm grid, ~954,605 points
    (reference: mahalanobis tests/simple_optimization_test.cc:170-204)."""
    xs = _accum_range(-length / 2.0, length / 2.0, point_step)
    ys = _accum_range(-width / 2.0, width / 2.0, point_step)
    zs = _accum_range(0.0, height, point_step)

    # floor (z = 0); C++ order: for x { for y }
    fx, fy = np.meshgrid(xs, ys, indexing="ij")
    floor = np.stack([fx.ravel(), fy.ravel(), np.zeros(fx.size)], axis=1)

    # left/right walls (y = -w/2 then +w/2, interleaved per (x, z))
    wx, wz = np.meshgrid(xs, zs, indexing="ij")
    n = wx.size
    lr = np.empty((2 * n, 3))
    lr[0::2] = np.stack([wx.ravel(), np.full(n, -width / 2.0), wz.ravel()], axis=1)
    lr[1::2] = np.stack([wx.ravel(), np.full(n, width / 2.0), wz.ravel()], axis=1)

    # front/back walls (x = +l/2 then -l/2, interleaved per (y, z))
    wy, wz2 = np.meshgrid(ys, zs, indexing="ij")
    m = wy.size
    fb = np.empty((2 * m, 3))
    fb[0::2] = np.stack([np.full(m, length / 2.0), wy.ravel(), wz2.ravel()], axis=1)
    fb[1::2] = np.stack([np.full(m, -length / 2.0), wy.ravel(), wz2.ravel()], axis=1)

    return np.concatenate([floor, lr, fb], axis=0)


def maha_true_pose() -> Pose:
    """Reference: tests/simple_optimization_test.cc:86-90."""
    return Pose.from_axis_angle(0.1, [0.0, 0.0, 1.0], [-0.2, 0.123, 0.3])


def maha_3dof6dof_true_pose() -> Pose:
    """The 3dof_6dof fixture's true pose: yaw 0.2 about z, planar offset."""
    return Pose.from_axis_angle(0.2, [0.0, 0.0, 1.0], [-0.15, 0.05, 0.0])


def generate_reprojection_fixture() -> Tuple[np.ndarray, np.ndarray, CameraIntrinsics, Pose]:
    """Planar 3D grid at z=3 projected into a 640x480 pinhole camera
    (reference: reproj tests/simple_optimization_test.cc:43-72,115-158).

    Returns (reference_points (N,3), matched_pixels (N,2), intrinsics,
    true_pose). Correspondences pair each reference point with the pixel of
    its warp into the query frame (true_pose^{-1})."""
    xs = _accum_range(-1.5, 1.5, 0.1)
    ys = _accum_range(-1.0, 1.0, 0.1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 3.0)], axis=1)

    intrinsics = CameraIntrinsics.create(525.0, 525.0, 320.0, 240.0, 640, 480)
    true_pose = Pose.from_axis_angle(0.1, [0.0, 0.0, 1.0], [-0.1, 0.123, -0.5])

    query = true_pose.inverse().apply(points)
    inv_z = 1.0 / query[:, 2]
    pixels = np.stack(
        [
            525.0 * query[:, 0] * inv_z + 320.0,
            525.0 * query[:, 1] * inv_z + 240.0,
        ],
        axis=1,
    )
    return points, pixels, intrinsics, true_pose


# Oracle traces of NDT registration on the full room fixture (copies of
# tests/test_trace_parity.py's constants): the reference sources compiled
# unmodified, with exact brute-force matching and ExponentialLoss(1, 1).
# (cost, inner iterations) per outer iteration; cost None where the
# reference prints its never-updated previous_cost.
ORACLE_SIMPLE_6DOF = {
    "trace": [(17450.5, 40), (17393.3, 40), (17492.4, 21), (17491.4, 2)],
    "outer": 3,
    "translation": [-0.196409882, 0.121409495, 0.304700223],
    "quat_xyzw": [-0.000103898, -0.001248329, 0.049971831, 0.998749842],
}
ORACLE_3DOF6DOF_6DOF = {
    "trace": [
        (17853.9, 40),
        (17536.2, 40),
        (17497.5, 32),
        (17491.4, 11),
        (None, 0),
    ],
    "outer": 4,
    "translation": [-0.145656518, 0.048385010, 0.004836333],
    "quat_xyzw": [-0.000165989, -0.001242575, 0.099826030, 0.995004117],
}
# The planar 3-DoF solver on the 3dof_6dof fixture. The reference's scalar
# 3-DoF solver drops the n % 4 tail correspondences (each costs at most 1.0
# under the exponential loss), so its costs are checked with cost_atol 4.0.
ORACLE_3DOF6DOF_3DOF = {
    "trace": [
        (17870.2, 40),
        (17630.2, 40),
        (17607.4, 21),
        (17599.3, 6),
        (None, 0),
    ],
    "outer": 4,
    "translation": [-0.150055931, -0.043362789, 0.0],
    "quat_xyzw": [0.0, 0.0, 0.099344065, 0.995053143],
}

# The reference's ReprojectionErrorMinimizerAnalytic on the fixture of
# generate_reprojection_fixture from the identity, ExponentialLoss(1, 1),
# default Options: (cost, lambda) per inner LM iteration, 12 significant
# digits. The reference's "COST:" print is previous_cost (it lags one
# iteration).
ORACLE_REPROJ = {
    "trace": [
        (3.55444881972, 1e-3),
        (0.0515859202783, 6e-4),
        (2.35978629949e-05, 3.6e-4),
        (3.42025160971e-07, 2.16e-4),
        (4.4035399771e-09, 1.296e-4),
        (2.33227881452e-11, 7.776e-5),
        (3.96349619791e-14, 4.6656e-5),
    ],
    "reported_cost": 2.33227881452e-11,
    "iterations": 6,
    "translation": [0.0872209073462274, -0.132368839193207, 0.500000000181493],
    "quat_wxyz": [
        0.99875026039451,
        2.38636198343075e-09,
        -5.42420928460359e-11,
        -0.0499791692798031,
    ],
}


def check_oracle(result, oracle, *, cost_atol: float = 0.1, pose_atol: float = 1e-6):
    """Raise AssertionError unless a ``RegistrationResult`` reproduces an
    oracle trace: every inner iteration count and the outer count exactly,
    every printed cost within ``cost_atol`` (0.1 is the quantum of the
    reference's 6-significant-figure print) and the pose within
    ``pose_atol``."""
    got = [(float(s.final_cost), int(s.iterations)) for s in result.summaries]
    exp = oracle["trace"]
    assert len(got) == len(exp), (got, exp)
    for (gc, gi), (ec, ei) in zip(got, exp):
        assert gi == ei, (got, exp)
        if ec is not None:
            np.testing.assert_allclose(gc, ec, atol=cost_atol, rtol=0)
    assert result.outer_iterations == oracle["outer"], (result.outer_iterations, oracle)
    np.testing.assert_allclose(
        result.pose.translation, oracle["translation"], atol=pose_atol
    )
    q = result.pose.quaternion()  # (w, x, y, z)
    q_ref = np.asarray(oracle["quat_xyzw"])
    np.testing.assert_allclose(q[1:], q_ref[:3], atol=pose_atol)
    np.testing.assert_allclose(q[0], q_ref[3], atol=pose_atol)


def check_reprojection_oracle(pose: Pose, summary, oracle, rtol: float = 1e-9):
    """Raise AssertionError unless a reprojection solve reproduces an
    oracle trace: the iteration count exactly, every recorded (cost,
    lambda) and the reported cost within ``rtol`` (1e-9 is about the
    12-digit print quantum) and the pose within 1e-9."""
    assert int(summary.iterations) == oracle["iterations"], (
        int(summary.iterations), oracle["iterations"]
    )
    cost = summary.records.cost.cpu().numpy()
    lam = summary.records.lam.cpu().numpy()
    for i, (ec, elam) in enumerate(oracle["trace"]):
        np.testing.assert_allclose(cost[i], ec, rtol=rtol, err_msg=f"cost {i}")
        np.testing.assert_allclose(lam[i], elam, rtol=rtol, err_msg=f"lambda {i}")
    np.testing.assert_allclose(
        float(summary.reported_cost), oracle["reported_cost"], rtol=rtol
    )
    np.testing.assert_allclose(pose.translation, oracle["translation"], atol=1e-9)
    np.testing.assert_allclose(pose.quaternion(), oracle["quat_wxyz"], atol=1e-9)


# Threads of a one-pass block and their warps (onepass.cuh: kThreads,
# kWarps); a thread adds ONE_PASS_TILE // ONE_PASS_THREADS lanes of a tile.
# The finishing block's lanes read the tile sums in batches of
# ONE_PASS_FINISH_BATCH (kFinishBatch).
ONE_PASS_THREADS = 256
ONE_PASS_WARPS = ONE_PASS_THREADS // 32
ONE_PASS_FINISH_BATCH = 8


def onepass_scatter_width(k_out: int) -> int:
    """The reduce-scatter's width: ``k_out`` padded to a power of two
    (onepass.cuh: ``scatter_width``)."""
    w = 1
    while w < k_out:
        w *= 2
    return w


def onepass_owner(k: int, width: int) -> int:
    """The lane that holds output ``k`` after the reduce-scatter
    (onepass.cuh: ``owner``)."""
    return k * (32 // width)


def onepass_reduce_scatter(v: np.ndarray) -> np.ndarray:
    """(..., 32 lanes, width) -> (..., 32): what each lane holds after the
    kernel's reduce-scatter, simulated lane by lane in ``v``'s dtype:
    halving rounds at offsets 16, 8, ... (a lane keeps its upper half iff
    lane & offset and adds its partner's copy of it), then a butterfly over
    the lanes that share a value."""
    lanes = np.arange(32)
    off = 16
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        upper = ((lanes & off) != 0)[:, None]
        lo, hi = v[..., :half], v[..., half:]
        keep = np.where(upper, hi, lo)
        send = np.where(upper, lo, hi)
        v = keep + send[..., lanes ^ off, :]
        off //= 2
    s = v[..., 0]
    while off >= 1:
        s = s + s[..., lanes ^ off]
        off //= 2
    return s


def onepass_emulate(terms: np.ndarray) -> np.ndarray:
    """(K, N) float32 per-factor terms of one problem -> (K,) float32, added
    one float32 addition at a time in the one-pass kernel's order
    (onepass.cuh, steps 1-4): a thread's lanes of a tile in index order, the
    warp reduce-scatter, the warps in order, then each output's tiles in 32
    lane chains joined by a butterfly. As ``add_tiles`` reads them, in both
    finishes: lane j takes tiles j, j + 32, ... in batches of 8 reads
    (j + 256 i + 32 u, u < 8), a read past the last tile giving +0, and a
    lane with no tile left adds no batch."""
    k_out, n = terms.shape
    width = onepass_scatter_width(k_out)
    owners = [onepass_owner(k, width) for k in range(k_out)]
    per_thread = ONE_PASS_TILE // ONE_PASS_THREADS
    tiles = -(-n // ONE_PASS_TILE)
    sums = np.zeros((k_out, tiles), np.float32)
    for t in range(tiles):
        idx = t * ONE_PASS_TILE + np.arange(ONE_PASS_TILE)
        chunk = np.zeros((k_out, ONE_PASS_TILE), np.float32)
        chunk[:, idx < n] = terms[:, idx[idx < n]]
        lanes = chunk.reshape(k_out, ONE_PASS_THREADS, per_thread)
        valid = (idx < n).reshape(ONE_PASS_THREADS, per_thread)
        acc = np.zeros((k_out, ONE_PASS_THREADS), np.float32)
        for j in range(per_thread):  # lanes >= N are skipped
            acc = np.where(valid[:, j], acc + lanes[:, :, j], acc)
        v = np.zeros((ONE_PASS_THREADS, width), np.float32)
        v[:, :k_out] = acc.T
        held = onepass_reduce_scatter(v.reshape(ONE_PASS_WARPS, 32, width))
        tile_sum = np.zeros(k_out, np.float32)
        for w in range(ONE_PASS_WARPS):
            tile_sum = tile_sum + held[w, owners]
        sums[:, t] = tile_sum
    lanes = np.arange(32)
    chain = np.zeros((k_out, 32), np.float32)
    per_batch = 32 * ONE_PASS_FINISH_BATCH
    reads = np.zeros((k_out, -(-tiles // per_batch) * per_batch), np.float32)
    reads[:, :tiles] = sums
    for t0 in range(0, reads.shape[1], per_batch):
        for u in range(ONE_PASS_FINISH_BATCH):
            chain = np.where(t0 + lanes < tiles, chain + reads[:, t0 + 32 * u + lanes], chain)
    off = 16
    while off >= 1:
        chain = chain + chain[:, lanes ^ off]
        off //= 2
    return chain[:, 0]


def generate_pose_graph_fixture() -> Tuple[List[Pose], List[Pose], list]:
    """80-pose rectangle trajectory with odometry + 4 loop closures, the
    last loop a deliberate identity-outlier
    (reference: pose-graph tests/simple_optimization_test.cc:19-122).

    Returns (true_poses, noisy_poses, constraints) where each constraint is
    a dict {reference_index, query_index, relative_pose, is_loop}."""
    poses = [Pose.identity() for _ in range(80)]
    step = 0.2
    x = y = z = 0.0
    for i in range(20):
        poses[i].translation = np.array([x, y, z])
        x += step
        z += step
    for i in range(20, 40):
        y += step
        z += step
        poses[i].translation = np.array([x, y, z])
    for i in range(40, 60):
        x -= step
        z -= step
        poses[i].translation = np.array([x, y, z])
    for i in range(60, 80):
        y -= step
        z -= step
        poses[i].translation = np.array([x, y, z])

    # Deterministic index-parity noise (reference :59-70).
    noise = 0.08
    noisy = [poses[0].copy()]
    for i in range(1, 80):
        p = poses[i].copy()
        k = i % 3
        p.translation = p.translation.copy()
        p.translation[k] += (1 if i % 2 else -1) * noise
        noisy.append(p)

    odometry_pairs = [(i, i + 1) for i in range(79)]
    loop_pairs = [(18, 21), (38, 42), (57, 61), (77, 2)]

    constraints = []
    for i0, i1 in odometry_pairs:
        rel = poses[i0].inverse() * poses[i1]
        constraints.append(
            dict(reference_index=i0, query_index=i1, relative_pose=rel, is_loop=False)
        )
    for i0, i1 in loop_pairs:
        rel = poses[i0].inverse() * poses[i1]
        constraints.append(
            dict(reference_index=i0, query_index=i1, relative_pose=rel, is_loop=True)
        )
    constraints[-1]["relative_pose"] = Pose.identity()  # the outlier (:121-122)

    return poses, noisy, constraints


def generate_sphere_g2o(
    n_rings: int = 25,
    per_ring: int = 100,
    radius: float = 50.0,
    s_t: float = 0.02,
    s_r: float = 0.005,
    seed: int = 11,
):
    """Sphere-world pose graph in g2o form (the classic ``sphere2500``
    benchmark construction: a spiral of poses over a sphere, odometry
    along the spiral, loop closures to the pose one ring below, vertex
    initialization by dead-reckoning the NOISY odometry so the initial
    guess carries the characteristic accumulated drift).

    Defaults produce 2,500 vertices and 4,899 edges — sphere2500 scale.
    Returns (G2oGraph, ground_truth_positions (N, 3) ndarray)."""
    from ..io.g2o import G2oEdge, G2oGraph

    rng = np.random.default_rng(seed)
    n = n_rings * per_ring
    # spiral over the sphere: elevation sweeps pole-to-pole, azimuth
    # wraps once per ring
    elev = np.linspace(-1.35, 1.35, n)
    azim = 2.0 * np.pi * np.arange(n) / per_ring
    pos = radius * np.stack(
        [np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)],
        axis=1,
    )
    # orientation: z along the outward normal, x along the direction of
    # travel (projected), y completing the frame
    gt: List[Pose] = []
    for k in range(n):
        zax = pos[k] / np.linalg.norm(pos[k])
        t = pos[min(k + 1, n - 1)] - pos[max(k - 1, 0)]
        xax = t - (t @ zax) * zax
        xax = xax / np.linalg.norm(xax)
        yax = np.cross(zax, xax)
        gt.append(Pose(np.stack([xax, yax, zax], axis=1), pos[k].copy()))

    def _exp(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    def noisy_rel(i, j, st, sr):
        rel = gt[i].inverse() * gt[j]
        return Pose(
            rel.rotation @ _exp(rng.normal(0, sr, 3)),
            rel.translation + rng.normal(0, st, 3),
        )

    info = np.zeros((6, 6))
    info[:3, :3] = (1.0 / s_t**2 / 25.0) * np.eye(3)
    info[3:, 3:] = (1.0 / s_r**2 / 25.0) * np.eye(3)

    graph = G2oGraph(dim=3)
    edges = []
    for k in range(n - 1):
        edges.append((k, k + 1, noisy_rel(k, k + 1, s_t, s_r)))
    for k in range(per_ring, n):  # one closure per pose to the ring below
        edges.append((k - per_ring, k, noisy_rel(k - per_ring, k, s_t, s_r)))
    for (i, j, rel) in edges:
        graph.edges.append(
            G2oEdge(
                i, j,
                np.concatenate([rel.translation, rel.quaternion()]),
                info.copy(),
            )
        )

    # dead-reckon the noisy ODOMETRY chain for the drifted initialization
    est = gt[0]
    graph.vertices[0] = np.concatenate([est.translation, est.quaternion()])
    for k in range(1, n):
        rel = edges[k - 1][2]  # odometry chain is edges[:n-1] in order
        est = Pose(
            est.rotation @ rel.rotation,
            est.translation + est.rotation @ rel.translation,
        )
        graph.vertices[k] = np.concatenate([est.translation, est.quaternion()])
    graph.fixed.add(0)
    return graph, pos


def generate_manhattan_g2o(
    n_poses: int = 3500,
    step: float = 1.0,
    s_t: float = 0.03,
    s_r: float = 0.01,
    turn_prob: float = 0.35,
    closure_gap: int = 20,
    max_closures_per_pose: int = 2,
    arena: Optional[int] = None,
    seed: int = 7,
):
    """Manhattan-world SE(2) pose graph in g2o form (the classic ``M3500``
    construction, Olson 2006: a random walk on a BOUNDED unit grid, whose
    bounded arena makes revisits and therefore loop closures dense, with
    90-degree turns, noisy odometry, loop closures to earlier poses that
    revisit the same cell, and vertices initialized by dead-reckoning the
    noisy odometry).

    ``arena``: grid side length in cells, default 10 (Olson's M3500 world
    is a 10x10-block city). Defaults produce 3,500 vertices and about
    10,000 edges: M3500 scale. Returns (G2oGraph(dim=2),
    ground_truth_xyt (N, 3) ndarray)."""
    from ..io.g2o import G2oEdge, G2oGraph

    rng = np.random.default_rng(seed)
    n = n_poses
    side = int(arena if arena is not None else 10)

    # bounded grid random walk: heading in {0, 1, 2, 3} * 90deg
    gt = np.zeros((n, 3))
    heading = 0
    cell = np.zeros(2)
    cell_log = {}  # (ix, iy) -> [pose ids]
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])

    def in_arena(c):
        return 0 <= c[0] <= side and 0 <= c[1] <= side

    for k in range(n):
        gt[k, :2] = cell * step
        gt[k, 2] = heading * (np.pi / 2.0)
        key = (int(round(cell[0])), int(round(cell[1])))
        cell_log.setdefault(key, []).append(k)
        u = rng.uniform()
        if u < turn_prob / 2:
            heading = (heading + 1) % 4
        elif u < turn_prob:
            heading = (heading - 1) % 4
        tries = 0
        while not in_arena(cell + dirs[heading]) and tries < 4:
            heading = (heading + 1) % 4
            tries += 1
        cell = cell + dirs[heading]

    def wrap(a):
        return (a + np.pi) % (2.0 * np.pi) - np.pi

    def rel_xyt(i, j):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        d = gt[j, :2] - gt[i, :2]
        return np.array(
            [c * d[0] + s * d[1], -s * d[0] + c * d[1], wrap(gt[j, 2] - gt[i, 2])]
        )

    def noisy(r):
        return r + np.array(
            [rng.normal(0, s_t), rng.normal(0, s_t), rng.normal(0, s_r)]
        )

    info = np.diag([1.0 / s_t**2, 1.0 / s_t**2, 1.0 / s_r**2])

    graph = G2oGraph(dim=2)
    odo = []
    for k in range(n - 1):
        m = noisy(rel_xyt(k, k + 1))
        odo.append(m)
        graph.edges.append(G2oEdge(k, k + 1, m, info.copy()))
    for k in range(n):
        key = (int(round(gt[k, 0] / step)), int(round(gt[k, 1] / step)))
        added = 0
        for j in cell_log.get(key, []):
            if k - j < closure_gap or added >= max_closures_per_pose:
                continue
            graph.edges.append(G2oEdge(j, k, noisy(rel_xyt(j, k)), info.copy()))
            added += 1

    # dead-reckon the noisy odometry for the drifted init
    est = gt[0].copy()
    graph.vertices[0] = est.copy()
    for k in range(1, n):
        m = odo[k - 1]
        c, s = np.cos(est[2]), np.sin(est[2])
        est = np.array(
            [est[0] + c * m[0] - s * m[1], est[1] + s * m[0] + c * m[1],
             wrap(est[2] + m[2])]
        )
        graph.vertices[k] = est.copy()
    graph.fixed.add(0)
    return graph, gt
