"""The plain references against hand-checked cases: the C++ test's oracle
trace on its room, small maps and graphs worked out by hand, and the port
on the CPU at small sizes."""

from __future__ import annotations

import numpy as np
import pytest

from configs import m3500 as m3500_cfg
from configs import maha_simple
from reference import ndt as ref_ndt
from reference import pose_graph_2d as ref_pg

ROOM = {"room": {"width": 5.0, "length": 7.0, "height": 2.5, "point_step": 0.01},
        "scan_filter": 0.1, "true_pose": {"yaw": 0.1, "translation": [-0.2, 0.123, 0.3]}}

# The C++ test compiled unmodified (exact search, ExponentialLoss(1, 1)):
# (final cost, iterations) of each inner solve, the outer count, the pose
# (the port's tests/test_trace_parity.py holds the same numbers).
ORACLE = {"trace": [(17450.5, 40), (17393.3, 40), (17492.4, 21), (17491.4, 2)], "outer": 3,
          "translation": [-0.196409882, 0.121409495, 0.304700223],
          "quat_xyzw": [-0.000103898, -0.001248329, 0.049971831, 0.998749842]}


def test_eigh3_is_an_eigendecomposition():
    rng = np.random.default_rng(3)
    for _ in range(50):
        a = rng.normal(size=(3, 3))
        A = a @ a.T + np.diag(rng.uniform(0, 1e-3, 3))
        lam, V = ref_ndt.eigh3(A)
        np.testing.assert_allclose(lam, np.linalg.eigvalsh(A), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(V.T @ V, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(A @ V, V * lam, atol=1e-10)


def test_map_of_a_hand_made_cloud():
    # 1,000 points in voxel (0, 0, 0) on a grid of 0.1 m steps, 4 points in
    # voxel (1, 0, 0): one valid voxel, its mean and its (floored)
    # eigenvalues those of the identity-seeded covariance
    g = (np.arange(10) + 0.5) * 0.1
    cube = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    few = np.array([[1.1, 0.1, 0.1], [1.2, 0.1, 0.1], [1.3, 0.2, 0.1], [1.4, 0.3, 0.1]])
    m = ref_ndt.build_map(np.concatenate([cube, few]), 1.0)
    assert m.means.shape == (1, 3)
    np.testing.assert_allclose(m.means[0], [0.5, 0.5, 0.5], atol=1e-12)
    var = np.var(g) + 1.0 / 1000  # the identity moment adds I / count
    info = m.sqrt_infos[0].T @ m.sqrt_infos[0]
    np.testing.assert_allclose(np.linalg.eigvalsh(info), np.full(3, 1.0 / var), rtol=1e-9)


def test_registration_reproduces_the_cpp_oracle_on_the_room():
    pts, (local,) = maha_simple.scans(ROOM, [{}])
    assert pts.shape == (954605, 3) and local.shape == (9356, 3)
    m = ref_ndt.build_map(pts, 1.0)
    assert m.means.shape == (96, 3)
    r = ref_ndt.register(m, local)
    assert [it for _, it in r.trace] == [it for _, it in ORACLE["trace"]]
    np.testing.assert_allclose([c for c, _ in r.trace], [c for c, _ in ORACLE["trace"]], atol=0.1)
    assert r.outer_iterations == ORACLE["outer"]
    np.testing.assert_allclose(r.translation, ORACLE["translation"], atol=1e-6)
    q = ref_ndt.rot_to_quat(r.rotation)
    np.testing.assert_allclose(np.r_[q[1:], q[0]], ORACLE["quat_xyzw"], atol=1e-6)
    # the control: bf16 rows in float32 lands millimetres away
    c = ref_ndt.register(m, local, bf16_rows=True)
    assert np.linalg.norm(c.translation - r.translation) > 5e-4


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 3.14159, -2.5e-3], np.float32)
    got = ref_ndt.bf16(x)
    np.testing.assert_array_equal(got[:3], [1.0, 1.0, 1.0 + 2**-6])
    assert abs(got[3] - 3.140625) < 1e-7 and abs(got[4] / -2.5e-3 - 1) < 2**-8


def _square(noise=0.0, seed=0):
    """Four poses on a 1 m square, odometry around it and one closure."""
    truth = np.array([[0, 0, 0], [1, 0, np.pi / 2], [1, 1, np.pi], [0, 1, -np.pi / 2]], float)
    rng = np.random.default_rng(seed)
    edges = []
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]:
        c, s = np.cos(truth[i, 2]), np.sin(truth[i, 2])
        d = truth[j, :2] - truth[i, :2]
        z = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                      ref_pg.wrap(truth[j, 2] - truth[i, 2])]) + noise * rng.normal(size=3)
        edges.append((i, j, z))
    return truth, edges


def test_pose_graph_reference_recovers_an_exact_square(tmp_path):
    truth, edges = _square()
    path = tmp_path / "square.g2o"
    m3500_cfg.write_g2o(str(path), truth + [[0, 0, 0], [0.3, -0.2, 0.4], [0.1, 0.2, -1], [0.5, 0, 2]],
                        edges, np.diag([100.0, 100.0, 400.0]))
    g = ref_pg.read_g2o(path)
    assert g.fixed.tolist() == [0] and len(g.i) == 5
    same = lambda a: np.max(np.abs(np.c_[a[:, :2] - truth[:, :2], ref_pg.wrap(a[:, 2] - truth[:, 2])]))
    assert same(ref_pg.chordal(g)) < 1e-8  # the file holds 9 digits
    xyt, cost, _ = ref_pg.solve(g, g.xyt)  # from a poor start
    assert same(xyt) < 1e-8 and cost < 1e-12


def test_generator_topology_is_the_ports_m3500():
    from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

    cfg = {"n_poses": 600, "arena": 10, "step": 1.0, "turn_prob": 0.35, "closure_gap": 20,
           "max_closures_per_pose": 2, "sigma_translation": 0.03, "sigma_rotation": 0.01,
           "topology_seed": 7}
    _, edges, info = m3500_cfg.manhattan(cfg, noise_seed=12)  # every candidate closure
    graph, _ = testing.generate_manhattan_g2o(n_poses=600, seed=7)
    pairs = lambda es: [(i, j) for i, j, _ in es]
    assert pairs(edges) == [(e.i, e.j) for e in graph.edges]
    np.testing.assert_allclose(info, graph.edges[0].information)
    # n_edges keeps the odometry and draws that many closures from them
    _, fewer, _ = m3500_cfg.manhattan(dict(cfg, n_edges=700), noise_seed=12)
    assert len(fewer) == 700 and pairs(fewer)[:599] == pairs(edges)[:599]
    assert set(pairs(fewer)) < set(pairs(edges))
    _, again, _ = m3500_cfg.manhattan(dict(cfg, n_edges=700), noise_seed=13)
    assert pairs(again) == pairs(fewer)  # the noise seed moves no edge


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_pose_graph_reference_against_the_port_on_the_cpu(tmp_path, solver):
    import torch

    from nonlinear_optimizer_for_slam_tpu_torch import Options
    from nonlinear_optimizer_for_slam_tpu_torch.io import g2o

    cfg = {"n_poses": 300, "arena": 5, "step": 1.0, "turn_prob": 0.35, "closure_gap": 20,
           "max_closures_per_pose": 2, "sigma_translation": 0.03, "sigma_rotation": 0.01,
           "topology_seed": 7}
    path = str(tmp_path / "w.g2o")
    m3500_cfg.write_g2o(path, *m3500_cfg.manhattan(cfg, noise_seed=5))
    opt = g2o.load_pose_graph(path, solver=solver, device="cpu", dtype=torch.float64)
    opt.initialize(method="chordal")
    summary, _ = opt.solve(Options().replace(max_iterations=500))
    got = np.stack([opt.get_pose(v) for v in opt.pose_indices()])
    gaps = m3500_cfg.gaps((got, float(summary.final_cost)), m3500_cfg.reference_solve(path))
    assert gaps["pose_gap_m"] < 1e-7 and gaps["rot_gap_rad"] < 1e-7
    assert gaps["cost_gap_rel"] < 1e-10
