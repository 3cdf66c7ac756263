"""The port's pose-landmark optimizers (``solvers/pose_landmark.py``) and
g2o landmark records (``io/g2o.py``) against the JAX package's.

First, on the port on the CPU in float64 with the same worlds and bounds:
the 17 tests of tests/test_pose_landmark.py (the closed-form observation
Jacobians against ``torch.func.jacfwd``, the scipy oracle, robust losses,
constants, the analytic covariance oracles, the rejected loop switch, and
the sparse solver and sparse marginals against the dense ones), the three
landmark tests of tests/test_g2o.py and the sparse-landmark warm restart
of tests/test_monotone_safeguard.py (float32).

Then parity with the JAX package, float64 on both sides, on registries
built from the same numpy inputs:

- the observation factors (3-D and 2-D, whitened, masked) and the numpy
  twin within 1e-12 of JAX's;
- ``solve()`` in 3-D and 2-D by dense and sparse (and the 3-D dense
  solve with Huber edge and observation losses): LM iteration counts
  equal, poses, landmarks and switches within 1e-8, final costs within
  rtol 1e-10;
- ``covariance`` and ``landmark_covariance`` by dense and sparse: every
  block within 1e-9 of the largest entry of JAX's block;
- a JAX registry carried across by ``interop.pose_landmark_from_reference``
  solves to JAX's solution (counts equal, poses 1e-8).
"""

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle, Options
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.io import g2o as g2o_io
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_landmark as tpl
from nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_graph import ConstraintType
from nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_landmark import (
    LandmarkObservations,
    LandmarkObservations2D,
    observation_residuals_and_jacobians,
    observation_residuals_and_jacobians_2d,
)

F64 = torch.float64
TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the solves are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def PLO(**kw):
    return tpl.PoseLandmarkOptimizer(device="cpu", **kw)


def PLO2(**kw):
    return tpl.PoseLandmark2DOptimizer(device="cpu", **kw)


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def _world(rng, P=8, M=25, radius=5.0):
    """Poses on a circle looking inward; landmarks in the interior."""
    gt_poses = [
        Pose(_rotz(th), np.array([radius * np.cos(th), radius * np.sin(th), 0.0]))
        for th in np.linspace(0, 2 * np.pi, P, endpoint=False)
    ]
    gt_lms = rng.uniform(-2.0, 2.0, size=(M, 3))
    obs = [(i, j, pose.rotation.T @ (gt_lms[j] - pose.translation))
           for i, pose in enumerate(gt_poses) for j in range(M)]
    return gt_poses, gt_lms, obs


def _world_2d(rng, P=10, M=15, radius=4.0):
    th = np.linspace(0, 2 * np.pi, P, endpoint=False)
    gt_poses = np.stack([radius * np.cos(th), radius * np.sin(th), _wrap(th + np.pi / 2)], 1)
    gt_lms = rng.uniform(-2.0, 2.0, size=(M, 2))
    obs = []
    for i in range(P):
        c, s = np.cos(gt_poses[i, 2]), np.sin(gt_poses[i, 2])
        Rt = np.array([[c, s], [-s, c]])
        for j in range(M):
            obs.append((i, j, Rt @ (gt_lms[j] - gt_poses[i, :2])))
    return gt_poses, gt_lms, obs


def _residual_3d(pose7, lm, z, S_, m):
    from nonlinear_optimizer_for_slam_tpu_torch.core import lie

    n = pose7[3:] / torch.linalg.norm(pose7[3:])
    r_ = lie.quat_to_rotmat(lie.quat_conjugate(n)) @ (lm - pose7[:3]) - z
    return (S_ @ r_) * m


def _residual_2d(pose3, lm, z, S_):
    c, s = torch.cos(pose3[2]), torch.sin(pose3[2])
    Rt = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
    return S_ @ (Rt @ (lm - pose3[:2]) - z)


# ---- tests/test_pose_landmark.py on the port ----------------------------------


def test_observation_jacobians_match_jacfwd(rng):
    P, M, O = 4, 6, 12
    pos, quat, lms = rng.normal(size=(P, 3)), rng.normal(size=(P, 4)), rng.normal(size=(M, 3))
    S = np.stack([np.triu(rng.normal(size=(3, 3))) + 3 * np.eye(3) for _ in range(O)])
    obs = LandmarkObservations(_t(rng.integers(0, P, O)), _t(rng.integers(0, M, O)),
                               _t(rng.normal(size=(O, 3))),
                               _t((rng.uniform(size=O) > 0.2).astype(float)), sqrt_info=_t(S))
    r, J_pose, J_lm = observation_residuals_and_jacobians(_t(pos), _t(quat), _t(lms), obs)
    for k in range(O):
        i, j = int(obs.pose_indices[k]), int(obs.landmark_indices[k])
        args = (_t(np.r_[pos[i], quat[i]]), _t(lms[j]), obs.measurements[k], _t(S[k]),
                obs.mask[k])
        np.testing.assert_allclose(r[k].numpy(), _residual_3d(*args).numpy(), atol=1e-12)
        Jp, Jl = torch.func.jacfwd(_residual_3d, argnums=(0, 1))(*args)
        np.testing.assert_allclose(J_pose[k].numpy(), Jp.numpy(), atol=1e-10)
        np.testing.assert_allclose(J_lm[k].numpy(), Jl.numpy(), atol=1e-10)


def test_recovers_world_from_noisy_init(rng):
    gt_poses, gt_lms, obs = _world(rng)
    opt = PLO()
    for i, p in enumerate(gt_poses):
        opt.set_pose(i, Pose(p.rotation, p.translation + (rng.normal(0, 0.2, 3) if i else 0.0)))
    opt.set_pose_constant(0)
    for j in range(len(gt_lms)):
        opt.set_landmark(j, gt_lms[j] + rng.normal(0, 0.3, 3))
    for i in range(len(gt_poses) - 1):
        opt.set_constraint(i, i + 1, gt_poses[i].inverse() * gt_poses[i + 1])
    for (i, j, z) in obs:
        opt.set_observation(i, j, z)
    summary, _ = opt.solve(Options().replace(max_iterations=100))
    assert float(summary.final_cost) < 1e-10
    for i, p in enumerate(gt_poses):
        np.testing.assert_allclose(opt.get_pose(i).translation, p.translation, atol=1e-5)
    for j in range(len(gt_lms)):
        np.testing.assert_allclose(opt.get_landmark(j), gt_lms[j], atol=1e-5)


def test_matches_scipy_oracle_with_noise(rng):
    """Noisy observations: the Schur-eliminated solve lands on the optimum
    of scipy least_squares over the same residual stack (poses ambient,
    landmarks free, pose 0 fixed)."""
    from scipy.optimize import least_squares

    gt_poses, gt_lms, obs = _world(rng, P=5, M=8)
    noisy_obs = [(i, j, z + rng.normal(0, 0.02, 3)) for (i, j, z) in obs[::2]]
    opt = PLO()
    for i, p in enumerate(gt_poses):
        opt.set_pose(i, Pose(p.rotation, p.translation + (rng.normal(0, 0.1, 3) if i else 0.0)))
    opt.set_pose_constant(0)
    init_poses = [opt.get_pose(i) for i in range(5)]
    for j in range(len(gt_lms)):
        opt.set_landmark(j, gt_lms[j] + rng.normal(0, 0.1, 3))
    init_lms = [opt.get_landmark(j) for j in range(8)]
    for (i, j, z) in noisy_obs:
        opt.set_observation(i, j, z)
    summary, _ = opt.solve(Options().replace(max_iterations=200))

    x0 = np.concatenate([np.concatenate([p.translation, p.quaternion()]) for p in init_poses]
                        + list(init_lms))
    free = np.ones(len(x0), bool)
    free[:7] = False

    def residual(xf):
        x = x0.copy()
        x[free] = xf
        rs = []
        for (i, j, z) in noisy_obs:
            p, q = x[7 * i: 7 * i + 3], x[7 * i + 3: 7 * i + 7]
            R = Pose.from_quat_trans(q / np.linalg.norm(q), p).rotation
            rs.append(R.T @ (x[35 + 3 * j: 38 + 3 * j] - p) - z)
        return np.concatenate(rs)

    res = least_squares(residual, x0[free], method="lm", xtol=1e-14, ftol=1e-14)
    scipy_cost = float(np.sum(res.fun ** 2))
    ours = float(summary.final_cost)
    assert ours <= scipy_cost * 1.01 + 1e-12, (ours, scipy_cost)


def test_robust_obs_loss_rejects_outlier(rng):
    gt_poses, gt_lms, obs = _world(rng, P=6, M=10)
    # DCS: zero weight past Phi, the outlier is excluded
    opt = PLO(obs_loss=port.DCSLoss(phi=1.0))
    for i, p in enumerate(gt_poses):
        opt.set_pose(i, Pose(p.rotation, p.translation + (rng.normal(0, 0.05, 3) if i else 0.0)))
    opt.set_pose_constant(0)
    for j in range(len(gt_lms)):
        opt.set_landmark(j, gt_lms[j] + rng.normal(0, 0.1, 3))
    for (i, j, z) in obs:
        opt.set_observation(i, j, z)
    opt.set_observation(3, 7, np.array([25.0, -31.0, 8.0]))  # gross outlier
    opt.solve(Options().replace(max_iterations=100))
    for j in range(len(gt_lms)):
        np.testing.assert_allclose(opt.get_landmark(j), gt_lms[j], atol=5e-3)


def test_constant_landmark_and_validation(rng):
    gt_poses, gt_lms, obs = _world(rng, P=4, M=5)
    opt = PLO()
    for i, p in enumerate(gt_poses):
        opt.set_pose(i, p)
    opt.set_pose_constant(0)
    anchor = gt_lms[0] + np.array([0.5, 0.0, 0.0])  # deliberately off
    for j in range(len(gt_lms)):
        opt.set_landmark(j, gt_lms[j] if j else anchor)
    opt.set_landmark_constant(0)
    for (i, j, z) in obs:
        opt.set_observation(i, j, z)
    opt.solve(Options().replace(max_iterations=50))
    np.testing.assert_allclose(opt.get_landmark(0), anchor, atol=1e-12)
    with pytest.raises(KeyError):
        opt.set_observation(99, 0, np.zeros(3))
    with pytest.raises(KeyError):
        opt.set_observation(0, 99, np.zeros(3))
    with pytest.raises(ValueError, match="no observations"):
        PLO().solve()


def test_2d_observation_jacobians_match_jacfwd(rng):
    P, M, O = 4, 6, 10
    xyt, lms = rng.normal(size=(P, 3)), rng.normal(size=(M, 2))
    S = np.stack([np.triu(rng.normal(size=(2, 2))) + 2 * np.eye(2) for _ in range(O)])
    obs = LandmarkObservations2D(_t(rng.integers(0, P, O)), _t(rng.integers(0, M, O)),
                                 _t(rng.normal(size=(O, 2))), torch.ones(O, dtype=F64),
                                 sqrt_info=_t(S))
    r, J_pose, J_lm = observation_residuals_and_jacobians_2d(_t(xyt), _t(lms), obs)
    for k in range(O):
        i, j = int(obs.pose_indices[k]), int(obs.landmark_indices[k])
        args = (_t(xyt[i]), _t(lms[j]), obs.measurements[k], _t(S[k]))
        np.testing.assert_allclose(r[k].numpy(), _residual_2d(*args).numpy(), atol=1e-12)
        Jp, Jl = torch.func.jacfwd(_residual_2d, argnums=(0, 1))(*args)
        np.testing.assert_allclose(J_pose[k].numpy(), Jp.numpy(), atol=1e-10)
        np.testing.assert_allclose(J_lm[k].numpy(), Jl.numpy(), atol=1e-10)


def _rel2d(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dp = b[:2] - a[:2]
    return [c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1], _wrap(b[2] - a[2])]


def test_2d_recovers_world(rng):
    gt_poses, gt_lms, obs = _world_2d(rng)
    opt = PLO2()
    for i in range(len(gt_poses)):
        opt.set_pose(i, gt_poses[i] + (
            np.concatenate([rng.normal(0, 0.1, 2), [rng.normal(0, 0.05)]]) if i else 0.0))
    opt.set_pose_constant(0)
    for j in range(len(gt_lms)):
        opt.set_landmark(j, gt_lms[j] + rng.normal(0, 0.2, 2))
    for i in range(len(gt_poses) - 1):
        opt.set_constraint(i, i + 1, _rel2d(gt_poses[i], gt_poses[i + 1]))
    for (i, j, z) in obs:
        opt.set_observation(i, j, z, sqrt_info=5.0)
    summary, _ = opt.solve(Options().replace(max_iterations=100))
    assert float(summary.final_cost) < 1e-10
    for j in range(len(gt_lms)):
        np.testing.assert_allclose(opt.get_landmark(j), gt_lms[j], atol=1e-5)
    for i in range(len(gt_poses)):
        np.testing.assert_allclose(opt.get_pose(i)[:2], gt_poses[i, :2], atol=1e-5)


def test_2d_landmark_g2o_file(tmp_path, rng):
    """VERTEX_XY / EDGE_SE2_XY files load into PoseLandmark2DOptimizer and
    solve; the writer round-trips the records."""
    gt_poses, gt_lms, obs = _world_2d(rng, P=6, M=8)
    g = g2o_io.G2oGraph(dim=2)
    for i in range(6):
        g.vertices[i] = gt_poses[i] + (np.concatenate([rng.normal(0, 0.1, 2), [0.02]]) if i else 0.0)
    for j in range(8):
        g.landmarks[500 + j] = gt_lms[j] + rng.normal(0, 0.2, 2)
    info3 = np.diag([100.0, 100.0, 400.0])
    for i in range(5):
        g.edges.append(g2o_io.G2oEdge(i, i + 1, np.array(_rel2d(gt_poses[i], gt_poses[i + 1])),
                                      info3))
    info2 = np.array([[30.0, 5.0], [5.0, 40.0]])
    for (i, j, z) in obs:
        g.landmark_edges.append(g2o_io.G2oEdge(i, 500 + j, z, info2))
    path = str(tmp_path / "lm2d.g2o")
    g2o_io.write_g2o(path, g)
    g2 = g2o_io.read_g2o(path)
    assert len(g2.landmarks) == 8 and len(g2.landmark_edges) == len(obs)
    np.testing.assert_allclose(g2.landmark_edges[0].information, info2, rtol=1e-6)
    opt = g2o_io.load_pose_graph(path, device="cpu")
    assert isinstance(opt, tpl.PoseLandmark2DOptimizer)
    opt.solve(Options().replace(max_iterations=100))
    for j in range(8):
        np.testing.assert_allclose(opt.get_landmark(500 + j), gt_lms[j], atol=1e-4)
    out = str(tmp_path / "lm2d_solved.g2o")
    g2o_io.save_pose_graph(out, opt, graph=g2)
    g3 = g2o_io.read_g2o(out)
    np.testing.assert_allclose(g3.landmarks[500], opt.get_landmark(500), atol=1e-6)


def test_np_observation_twin_matches_torch(rng):
    P, M, O = 5, 7, 14
    pos, quat, lms = rng.normal(size=(P, 3)), rng.normal(size=(P, 4)), rng.normal(size=(M, 3))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)  # the twin takes unit quaternions
    pi, li, meas = rng.integers(0, P, O), rng.integers(0, M, O), rng.normal(size=(O, 3))
    S = np.stack([np.triu(rng.normal(size=(3, 3))) + 3 * np.eye(3) for _ in range(O)])
    obs = LandmarkObservations(_t(pi), _t(li), _t(meas), torch.ones(O, dtype=F64), sqrt_info=_t(S))
    got = observation_residuals_and_jacobians(_t(pos), _t(quat), _t(lms), obs)
    twin = tpl.np_observation_jacobians(pos, quat, lms, pi, li, meas, S)
    for a, b in zip(twin, got):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-12)


def test_joint_covariance_analytic_oracle():
    """Two poses, two landmarks with known information: pose 1 hangs off
    the constant pose 0 by one whitened edge (translation covariance
    I/w^2); a landmark seen only from pose 0 has covariance I/u^2; one
    seen only from pose 1 inherits that pose's uncertainty."""
    w_t, w_r, u = 5.0, 20.0, 8.0
    opt = PLO()
    p0, p1 = Pose.identity(), Pose(np.eye(3), np.array([1.0, 0.0, 0.0]))
    opt.set_pose(0, p0)
    opt.set_pose(1, p1)
    opt.set_pose_constant(0)
    opt.set_constraint(0, 1, p0.inverse() * p1, sqrt_info=(w_t, w_r))
    opt.set_landmark(0, np.array([0.3, 0.4, 0.1]))
    opt.set_observation(0, 0, p0.rotation.T @ (opt.get_landmark(0) - p0.translation), sqrt_info=u)
    opt.set_landmark(1, np.array([1.5, -0.2, 0.3]))
    opt.set_observation(1, 1, p1.rotation.T @ (opt.get_landmark(1) - p1.translation), sqrt_info=u)
    opt.solve(Options().replace(max_iterations=30))
    cov_p = opt.covariance()
    np.testing.assert_allclose(cov_p[0], 0.0, atol=1e-12)
    np.testing.assert_allclose(cov_p[1][:3, :3], np.eye(3) / w_t ** 2, rtol=1e-6, atol=1e-10)
    cov_l = opt.landmark_covariance()
    np.testing.assert_allclose(cov_l[0], np.eye(3) / u ** 2, rtol=1e-6)
    v = opt.get_landmark(1) - p1.translation
    sk = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    expected = np.eye(3) / u ** 2 + np.eye(3) / w_t ** 2 + sk @ (np.eye(3) / w_r ** 2) @ sk.T
    np.testing.assert_allclose(cov_l[1], expected, rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="gauge-free"):
        free = PLO()
        free.set_pose(0, p0)
        free.set_landmark(0, np.zeros(3))
        free.set_observation(0, 0, np.zeros(3))
        free.covariance()


def test_2d_joint_covariance_analytic_oracle():
    w_t, w_r, u = 4.0, 10.0, 6.0
    opt = PLO2()
    opt.set_pose(0, [0.0, 0.0, 0.0])
    opt.set_pose(1, [1.0, 0.0, 0.0])
    opt.set_pose_constant(0)
    opt.set_constraint(0, 1, [1.0, 0.0, 0.0], sqrt_info=(w_t, w_r))
    opt.set_landmark(0, [0.3, 0.4])
    opt.set_observation(0, 0, [0.3, 0.4], sqrt_info=u)
    opt.set_landmark(1, [1.5, -0.2])
    opt.set_observation(1, 1, [0.5, -0.2], sqrt_info=u)  # only from pose 1
    opt.solve(Options().replace(max_iterations=30))
    cov_p = opt.covariance()
    np.testing.assert_allclose(cov_p[0], 0.0, atol=1e-12)
    np.testing.assert_allclose(cov_p[1][:2, :2], np.eye(2) / w_t ** 2, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(cov_p[1][2, 2], 1 / w_r ** 2, rtol=1e-6)
    cov_l = opt.landmark_covariance()
    np.testing.assert_allclose(cov_l[0], np.eye(2) / u ** 2, rtol=1e-6, atol=1e-12)
    v = opt.get_landmark(1) - np.array([1.0, 0.0])
    lever = np.array([-v[1], v[0]])
    expected = np.eye(2) / u ** 2 + np.eye(2) / w_t ** 2 + np.outer(lever, lever) / w_r ** 2
    np.testing.assert_allclose(cov_l[1], expected, rtol=1e-5, atol=1e-8)


def test_covariance_honors_rejected_loop_switch(rng):
    """A false loop closure that solve() switches off contributes ~no
    information to covariance(): the marginals match the same graph built
    without the loop edge."""
    gt_poses, gt_lms, obs = _world(rng, P=7, M=8)

    def build(with_false_loop):
        r = np.random.default_rng(3)
        o = PLO(switch_penalty=0.03)
        for i, p in enumerate(gt_poses):
            o.set_pose(i, Pose(p.rotation, p.translation + (r.normal(0, 0.03, 3) if i else 0.0)))
        o.set_pose_constant(0)
        for j in range(len(gt_lms)):
            o.set_landmark(j, gt_lms[j] + r.normal(0, 0.05, 3))
        for i in range(len(gt_poses) - 1):
            o.set_constraint(i, i + 1, gt_poses[i].inverse() * gt_poses[i + 1], sqrt_info=10.0)
        if with_false_loop:
            o.set_constraint(1, 5, Pose.identity(), ConstraintType.LOOP, sqrt_info=10.0)
        for (i, j, z) in obs[::3]:
            o.set_observation(i, j, z, sqrt_info=3.0)
        return o

    with_loop = build(True)
    _, sw = with_loop.solve(Options().replace(max_iterations=100))
    assert sw[0] < 0.1, sw  # the false loop switched off
    without = build(False)
    without.solve(Options().replace(max_iterations=100))
    c_with, c_without = with_loop.covariance(), without.covariance()
    for i in (3, 5, 6):
        np.testing.assert_allclose(c_with[i], c_without[i], rtol=0.05, atol=1e-8)
    assert with_loop.covariance()[3] is not None
    l1, l2 = with_loop.landmark_covariance(), with_loop.landmark_covariance()
    np.testing.assert_array_equal(l1[0], l2[0])


def _chain_world(seed, P, M, dim, rng_obs_scale=0.01, constant_landmark=None, cover=False):
    """The loop-closed random-walk worlds of tests/test_pose_landmark.py's
    sparse tests, as plain records: (poses, constraints, observations,
    landmarks) for either package's optimizer."""
    rng = np.random.default_rng(seed)
    if dim == 3:
        gt = np.cumsum(0.3 * rng.normal(size=(P, 3)), axis=0)
        lms = gt[rng.integers(0, P, M)] + rng.uniform(-2, 2, (M, 3))
        poses = [np.r_[gt[i] + (0.05 * rng.normal(size=3) if i else 0), 0.02 * i]
                 for i in range(P)]
        lm_init = [lms[j] + 0.1 * rng.normal(size=3) for j in range(M)]
        rel = lambda a, b: gt[b] - gt[a]
        body = lambda i, j: lms[j] - gt[i]
        near = lambda i, j: np.linalg.norm(lms[j] - gt[i]) < 3.0
    else:
        th = np.cumsum(rng.normal(0.05, 0.05, P))
        xy = np.cumsum(0.5 * np.stack([np.cos(th), np.sin(th)], 1), axis=0)
        gt = np.concatenate([xy, th[:, None]], 1)
        lms = xy[rng.integers(0, P, M)] + rng.uniform(-2, 2, (M, 2))
        poses = [gt[i] + (0.03 * rng.normal(size=3) if i else 0) for i in range(P)]
        lm_init = [lms[j] + 0.1 * rng.normal(size=2) for j in range(M)]
        rel = lambda a, b: np.array(_rel2d(gt[a], gt[b]))
        body = lambda i, j: np.array(_rel2d(gt[i], np.r_[lms[j], 0.0])[:2])
        near = lambda i, j: np.linalg.norm(lms[j] - gt[i, :2]) < 3.0
    constraints = [(i, i + 1, rel(i, i + 1), ConstraintType.ODOMETRY) for i in range(P - 1)]
    constraints.append((0, P - 1, rel(0, P - 1), ConstraintType.LOOP))
    observations, seen = [], np.zeros(M, bool)
    for j in range(M):
        for i in range(P):
            if (near(i, j) and rng.uniform() < 0.5) or (cover and not seen[j] and i == P - 1):
                observations.append((i, j, body(i, j) + rng_obs_scale * rng.normal(size=dim)))
                seen[j] = True
    return poses, constraints, observations, lm_init


def _build(world, dim, mod="port", constant_landmark=None, **kw):
    """An optimizer of either package over a _chain_world (3-D poses: yaw
    rotations about z)."""
    poses, constraints, observations, lm_init = world
    if mod == "port":
        opt = (PLO if dim == 3 else PLO2)(switch_penalty=0.03, **kw)
        P3 = Pose
    else:
        import nonlinear_optimizer_for_slam_tpu as nls
        from nonlinear_optimizer_for_slam_tpu.solvers import pose_landmark as jpl

        opt = (jpl.PoseLandmarkOptimizer if dim == 3 else jpl.PoseLandmark2DOptimizer)(
            switch_penalty=0.03, **kw)
        P3 = nls.Pose
    for i, p in enumerate(poses):
        opt.set_pose(i, P3(_rotz(p[3]), p[:3]) if dim == 3 else p)
    opt.set_pose_constant(0)
    for j, l in enumerate(lm_init):
        opt.set_landmark(j, l)
    if constant_landmark is not None:
        opt.set_landmark_constant(constant_landmark)
    for a, b, rel, kind in constraints:
        opt.set_constraint(a, b, P3(np.eye(3), rel) if dim == 3 else rel, kind)
    for i, j, z in observations:
        opt.set_observation(i, j, z, sqrt_info=10.0)
    return opt


def _state(opt, dim):
    ids = opt.pose_indices()
    if dim == 3:
        poses = np.stack([opt.get_pose(i).matrix() for i in ids])
    else:
        poses = np.stack([opt.get_pose(i) for i in ids])
    return poses, np.stack([opt.get_landmark(j) for j in opt.landmark_indices()])


def test_sparse_pose_solver_matches_dense():
    """pose_solver='sparse' (landmarks eliminated at observation level,
    the reduced pose system by the multifrontal factorization) is an exact
    drop-in for the dense path."""
    world = _chain_world(0, 40, 90, 3)
    dense, sparse = _build(world, 3), _build(world, 3, pose_solver="sparse")
    opts = Options().replace(max_iterations=40)
    sum_d, sw_d = dense.solve(opts)
    sum_s, sw_s = sparse.solve(opts)
    assert int(sum_s.iterations) == int(sum_d.iterations)
    np.testing.assert_allclose(float(sum_s.final_cost), float(sum_d.final_cost), rtol=1e-12)
    for a, b in zip(_state(sparse, 3), _state(dense, 3)):
        np.testing.assert_allclose(a, b, atol=1e-10)
    np.testing.assert_allclose(sw_s, sw_d, atol=1e-10)


def test_sparse_pose_solver_rejects_unknown():
    with pytest.raises(ValueError, match="pose_solver"):
        PLO(pose_solver="banded")


def test_sparse_pose_solver_2d_matches_dense():
    world = _chain_world(2, 50, 120, 2)
    dense, sparse = _build(world, 2), _build(world, 2, pose_solver="sparse")
    opts = Options().replace(max_iterations=40)
    sum_d, _ = dense.solve(opts)
    sum_s, _ = sparse.solve(opts)
    assert int(sum_s.iterations) == int(sum_d.iterations)
    np.testing.assert_allclose(float(sum_s.final_cost), float(sum_d.final_cost), rtol=1e-12)
    for a, b in zip(_state(sparse, 2), _state(dense, 2)):
        np.testing.assert_allclose(a, b, atol=1e-10)


@pytest.mark.parametrize("dim", [3, 2], ids=["se3", "se2"])
def test_sparse_marginals_match_dense_joint_inverse(dim):
    """covariance()/landmark_covariance(method='sparse') reproduce the
    dense joint inverse to float64 roundoff, a constant (gauge) landmark
    and landmarks seen from one pose included."""
    world = _chain_world(4 if dim == 3 else 9, 30 if dim == 3 else 40, 70 if dim == 3 else 60,
                         dim, cover=True)
    opt = _build(world, dim, constant_landmark=3 if dim == 3 else 2)
    opt.solve(Options().replace(max_iterations=30))
    cov_d, cov_s = opt.covariance(method="dense"), opt.covariance(method="sparse")
    for pi in cov_d:
        np.testing.assert_allclose(cov_s[pi], cov_d[pi], atol=1e-12)
    lm_d = opt.landmark_covariance(method="dense")
    lm_s = opt.landmark_covariance(method="sparse")
    for li in lm_d:
        np.testing.assert_allclose(lm_s[li], lm_d[li], atol=1e-12)
    c = 3 if dim == 3 else 2
    assert np.all(lm_d[c] == 0) and np.all(lm_s[c] == 0)
    assert opt._pick_cov_method("auto") == "dense"
    with pytest.raises(ValueError, match="covariance method"):
        opt.covariance(method="banded")


# ---- tests/test_g2o.py's landmark tests on the port ----------------------------


def test_landmark_slam_g2o_roundtrip_and_solve(tmp_path, rng):
    """VERTEX_TRACKXYZ / EDGE_SE3_TRACKXYZ records: write -> read ->
    PoseLandmarkOptimizer -> solve recovers the world -> save updates both
    poses and landmarks."""
    P, M = 6, 12
    true_poses = [
        Pose.from_axis_angle(2 * np.pi * k / P, [0, 0, 1],
                             [3 * np.cos(2 * np.pi * k / P), 3 * np.sin(2 * np.pi * k / P), 0.0])
        for k in range(P)
    ]
    true_lms = rng.uniform(-1.5, 1.5, size=(M, 3))
    g = g2o_io.G2oGraph(dim=3)
    for k, p in enumerate(true_poses):
        g.vertices[k] = np.concatenate([p.translation + (rng.normal(0, 0.1, 3) if k else 0.0),
                                        p.quaternion()])
    for j in range(M):
        g.landmarks[100 + j] = true_lms[j] + rng.normal(0, 0.2, 3)
    for k in range(P - 1):
        rel = true_poses[k].inverse() * true_poses[k + 1]
        g.edges.append(g2o_io.G2oEdge(k, k + 1, np.concatenate([rel.translation, rel.quaternion()]),
                                      np.eye(6) * 100.0))
    info3 = np.diag([50.0, 60.0, 70.0])
    for k, p in enumerate(true_poses):
        for j in range(M):
            g.landmark_edges.append(
                g2o_io.G2oEdge(k, 100 + j, p.rotation.T @ (true_lms[j] - p.translation), info3))
    path = str(tmp_path / "lm.g2o")
    g2o_io.write_g2o(path, g)
    g2 = g2o_io.read_g2o(path)
    assert len(g2.landmarks) == M and len(g2.landmark_edges) == P * M
    np.testing.assert_allclose(g2.landmark_edges[0].information, info3, rtol=1e-6)
    opt = g2o_io.load_pose_graph(path, device="cpu")
    assert isinstance(opt, tpl.PoseLandmarkOptimizer)
    opt.solve(Options().replace(max_iterations=100))
    for j in range(M):
        np.testing.assert_allclose(opt.get_landmark(100 + j), true_lms[j], atol=1e-4)
    for k, p in enumerate(true_poses):
        np.testing.assert_allclose(opt.get_pose(k).translation, p.translation, atol=1e-4)
    out = str(tmp_path / "lm_solved.g2o")
    g2o_io.save_pose_graph(out, opt, graph=g2)
    g3 = g2o_io.read_g2o(out)
    np.testing.assert_allclose(g3.landmarks[100], opt.get_landmark(100), atol=1e-6)
    np.testing.assert_allclose(g3.vertices[2][:3], opt.get_pose(2).translation, atol=1e-6)


def test_landmark_edge_offset_param_form(tmp_path):
    """EDGE_SE3_TRACKXYZ with the PARAMS_SE3OFFSET id token parses
    identically, and a FIX on a landmark holds the landmark."""
    p = tmp_path / "off.g2o"
    p.write_text(
        "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\nVERTEX_TRACKXYZ 5 1 2 3\n"
        "EDGE_SE3_TRACKXYZ 0 5 0 1 2 3 10 0 0 10 0 10\nFIX 0 5\n"
    )
    g = g2o_io.read_g2o(str(p))
    e = g.landmark_edges[0]
    assert (e.i, e.j) == (0, 5)
    np.testing.assert_allclose(e.measurement, [1.0, 2.0, 3.0])
    np.testing.assert_allclose(np.diag(e.information), [10, 10, 10])
    opt = g2o_io.load_pose_graph(str(p), device="cpu")
    assert opt._constant_poses == {0} and opt._constant_landmarks == {5}


def test_save_landmark_optimizer_without_graph(tmp_path):
    """save_pose_graph(path, opt) with no source graph writes vertices,
    landmarks, edges and observations for both landmark optimizers."""
    o3 = PLO()
    o3.set_pose(0, Pose.identity())
    o3.set_pose(1, Pose(np.eye(3), np.array([1.0, 0.0, 0.0])))
    o3.set_landmark(10, np.array([0.5, 0.5, 0.0]))
    o3.set_constraint(0, 1, Pose(np.eye(3), np.array([1.0, 0.0, 0.0])))
    o3.set_observation(0, 10, np.array([0.5, 0.5, 0.0]))
    p3 = str(tmp_path / "bare3.g2o")
    g2o_io.save_pose_graph(p3, o3)
    g3 = g2o_io.read_g2o(p3)
    assert g3.dim == 3 and len(g3.landmarks) == 1 and len(g3.landmark_edges) == 1
    o2 = PLO2()
    o2.set_pose(0, [0.0, 0.0, 0.0])
    o2.set_pose(1, [1.0, 0.0, 0.0])
    o2.set_landmark(10, [0.5, 0.5])
    o2.set_constraint(0, 1, [1.0, 0.0, 0.0])
    o2.set_observation(0, 10, [0.5, 0.5])
    p2 = str(tmp_path / "bare2.g2o")
    g2o_io.save_pose_graph(p2, o2)
    g2 = g2o_io.read_g2o(p2)
    assert g2.dim == 2 and len(g2.landmarks) == 1 and len(g2.landmark_edges) == 1


# ---- tests/test_monotone_safeguard.py's landmark case on the port ------------


def test_warm_restart_sparse_landmark_never_degrades():
    """Solve the float32 sparse-landmark world to convergence, perturb the
    solved state slightly and re-solve with the plateau stop on (the plan
    cached across the restart): the second solve returns a cost no worse
    than its own start, and keeps what the first solve reached."""
    rng = np.random.default_rng(11)
    P, M = 60, 180
    gt_pos = np.cumsum(0.3 * rng.normal(size=(P, 3)), axis=0)
    lms = gt_pos[rng.integers(0, P, M)] + rng.uniform(-2, 2, (M, 3))
    opt = PLO(switch_penalty=0.03, pose_solver="sparse", dtype=torch.float32)
    for i in range(P):
        opt.set_pose(i, Pose(np.eye(3), gt_pos[i] + (0.05 * rng.normal(size=3) if i else 0)))
    opt.set_pose_constant(0)
    for j in range(M):
        opt.set_landmark(j, lms[j] + 0.1 * rng.normal(size=3))
    for i in range(P - 1):
        opt.set_constraint(i, i + 1, Pose(np.eye(3), gt_pos[i + 1] - gt_pos[i]))
    opt.set_constraint(0, P - 1, Pose(np.eye(3), gt_pos[P - 1] - gt_pos[0]), ConstraintType.LOOP)
    for j in range(M):
        for i in range(P):
            if np.linalg.norm(lms[j] - gt_pos[i]) < 3.0 and rng.uniform() < 0.5:
                opt.set_observation(i, j, lms[j] - gt_pos[i] + 0.01 * rng.normal(size=3),
                                    sqrt_info=10.0)
    opts = Options().replace(max_iterations=60,
                             convergence_handle=ConvergenceHandle(relative_function_tolerance=1e-7))
    summary1, _ = opt.solve(opts)
    cost1 = float(summary1.final_cost)
    assert np.isfinite(cost1)
    plan = opt._sparse_cache[1][0]
    for i in range(1, opt.num_poses):
        p = opt.get_pose(i)
        opt.set_pose(i, Pose(p.rotation, p.translation + 1e-3 * rng.normal(size=3)))
    summary2, _ = opt.solve(opts)
    assert opt._sparse_cache[1][0] is plan  # the warm restart reused the plan
    init_cost2 = float(summary2.records.cost[0])
    final2 = float(summary2.final_cost)
    assert np.isfinite(final2)
    assert final2 <= init_cost2 * (1 + 1e-5) + 1e-10, (final2, init_cost2)
    assert final2 <= cost1 * 1.5 + 1e-10, (final2, cost1)


# ---- parity with the JAX package ---------------------------------------------


def test_observation_factors_match_jax(rng):
    import jax.numpy as jnp

    from nonlinear_optimizer_for_slam_tpu.solvers import pose_landmark as jpl

    P, M, O = 5, 7, 30
    pos, quat, lms = rng.normal(size=(P, 3)), rng.normal(size=(P, 4)), rng.normal(size=(M, 3))
    pi, li, meas = rng.integers(0, P, O), rng.integers(0, M, O), rng.normal(size=(O, 3))
    mask = (rng.uniform(size=O) > 0.2).astype(float)
    S3 = np.stack([np.triu(rng.normal(size=(3, 3))) + 3 * np.eye(3) for _ in range(O)])
    want = jpl.observation_residuals_and_jacobians(
        jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(lms),
        jpl.LandmarkObservations(jnp.asarray(pi, jnp.int32), jnp.asarray(li, jnp.int32),
                                 jnp.asarray(meas), jnp.asarray(mask), jnp.asarray(S3)))
    got = observation_residuals_and_jacobians(
        _t(pos), _t(quat), _t(lms), LandmarkObservations(_t(pi), _t(li), _t(meas), _t(mask), _t(S3)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    qu = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    for a, b in zip(tpl.np_observation_jacobians(pos, qu, lms, pi, li, meas, S3),
                    jpl.np_observation_jacobians(pos, qu, lms, pi, li, meas, S3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    xyt, l2, m2 = rng.normal(size=(P, 3)), rng.normal(size=(M, 2)), rng.normal(size=(O, 2))
    S2 = rng.uniform(1.0, 3.0, size=(O, 2))
    want = jpl.observation_residuals_and_jacobians_2d(
        jnp.asarray(xyt), jnp.asarray(l2),
        jpl.LandmarkObservations2D(jnp.asarray(pi, jnp.int32), jnp.asarray(li, jnp.int32),
                                   jnp.asarray(m2), jnp.asarray(mask), jnp.asarray(S2)))
    got = observation_residuals_and_jacobians_2d(
        _t(xyt), _t(l2), LandmarkObservations2D(_t(pi), _t(li), _t(m2), _t(mask), _t(S2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    pairs = [tpl.build_covis_pairs(pi, li), jpl.build_covis_pairs(pi, li)]
    for a, b in zip(*pairs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def parity_worlds():
    return {3: _chain_world(21, 24, 50, 3, cover=True), 2: _chain_world(22, 30, 50, 2, cover=True)}


CASES = [(3, "dense", False), (3, "sparse", False), (3, "dense", True), (2, "dense", False),
         (2, "sparse", False)]


@pytest.mark.parametrize("dim, solver, huber", CASES,
                         ids=["se3_dense", "se3_sparse", "se3_dense_huber", "se2_dense",
                              "se2_sparse"])
def test_solve_and_covariance_match_jax(parity_worlds, dim, solver, huber):
    """Both packages solve the same registry (float64): counts equal,
    poses, landmarks and switches within 1e-8; then both covariance
    methods within 1e-9 of each JAX block's largest entry."""
    from nonlinear_optimizer_for_slam_tpu.core import HuberLoss, Options as JOptions

    world = parity_worlds[dim]
    losses = lambda cls: dict(edge_loss=cls(0.5), obs_loss=cls(0.05)) if huber else {}
    mine = _build(world, dim, pose_solver=solver, **losses(port.HuberLoss))
    theirs = _build(world, dim, mod="jax", pose_solver=solver, **losses(HuberLoss))
    s_mine, sw_mine = mine.solve(Options().replace(max_iterations=30))
    s_theirs, sw_theirs = theirs.solve(JOptions().replace(max_iterations=30))
    assert int(s_mine.iterations) == int(s_theirs.iterations)
    np.testing.assert_allclose(float(s_mine.final_cost), float(s_theirs.final_cost), rtol=1e-10)
    for a, b in zip(_state(mine, dim), _state(theirs, dim)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_allclose(sw_mine, np.asarray(sw_theirs), rtol=0, atol=TOL)
    if huber:
        return
    for method in ("dense", "sparse"):
        for query in ("covariance", "landmark_covariance"):
            got = getattr(mine, query)(method=method)
            want = getattr(theirs, query)(method=method)
            assert sorted(got) == sorted(want)
            for k in want:
                scale = max(np.abs(want[k]).max(), 1e-300)
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9 * scale,
                                           err_msg=f"{method} {query} {k}")


def test_interop_carries_a_jax_registry(parity_worlds):
    """A JAX optimizer's registry (after one solve, so with learned loop
    switches) carried across by interop solves on to JAX's state."""
    from nonlinear_optimizer_for_slam_tpu.core import Options as JOptions

    theirs = _build(parity_worlds[3], 3, mod="jax")
    theirs.solve(JOptions().replace(max_iterations=3))
    state = dict(
        poses={i: theirs.get_pose(i).matrix() for i in theirs.pose_indices()},
        landmarks={j: theirs.get_landmark(j) for j in theirs.landmark_indices()},
        constant_poses=sorted(theirs._constant_poses),
        constant_landmarks=sorted(theirs._constant_landmarks),
        constraints=[dict(c, relative=c["relative_pose"].matrix()) for c in theirs.constraints()],
        observations=theirs.observations(),
        switch_penalty=theirs.switch_penalty, edge_loss=None, obs_loss=None,
        last_switches=theirs._last_switches,
    )
    mine = interop.pose_landmark_from_reference(state, device="cpu")
    np.testing.assert_allclose(mine.covariance(method="dense")[5],
                               theirs.covariance(method="dense")[5], rtol=0,
                               atol=1e-9 * np.abs(theirs.covariance(method="dense")[5]).max())
    s_mine, _ = mine.solve(Options().replace(max_iterations=30))
    s_theirs, _ = theirs.solve(JOptions().replace(max_iterations=30))
    assert int(s_mine.iterations) == int(s_theirs.iterations)
    for a, b in zip(_state(mine, 3), _state(theirs, 3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
