"""The port's IMU preintegration (``ops/imu.py``) and the two lie
Jacobians it rests on, against the JAX package.

First the 10 tests of tests/test_imu.py against the port, on the CPU in
float64 (the inertial solvers' default dtype), with the same fixtures and
bounds. Then parity with JAX:

- ``so3_exp_quaternion_jacobian`` and ``quat_log_vec_jacobian`` against
  JAX's (rtol 1e-12, atol 1e-15, float64) and against
  ``torch.func.jacfwd`` of ``so3_exp_quaternion`` / ``quat_log_vec``
  (rtol 1e-10, atol 1e-12), through the large-angle branch, the
  small-angle branch (theta, |vec| < 1e-6) and the ``qw < 0`` flip;
- ``ImuPreintegrator``'s arrays bitwise equal to JAX's (the same host
  numpy arithmetic);
- ``imu_residuals`` and ``imu_residuals_and_jacobians`` against JAX's
  (rtol 1e-12, atol 1e-9 on whitened Jacobian rows of about 1e3,
  1e-12 relative), and the closed form against the port's jacfwd oracle;
- ``np_imu_residual`` bitwise equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core import lie as jlie
from nonlinear_optimizer_for_slam_tpu.ops import imu as jimu
from nonlinear_optimizer_for_slam_tpu.solvers.inertial import (
    _pack_imu_factors as _jax_pack,
)
from nonlinear_optimizer_for_slam_tpu_torch.core import lie
from nonlinear_optimizer_for_slam_tpu_torch.core import Options
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose, np_rotmat_to_quat
from nonlinear_optimizer_for_slam_tpu_torch.ops import imu
from nonlinear_optimizer_for_slam_tpu_torch.ops.imu import (
    GRAVITY,
    ImuParams,
    ImuPreintegrator,
    PreintegratedImuFactor,
    imu_residuals,
)
from nonlinear_optimizer_for_slam_tpu_torch.solvers.inertial import (
    FixedLagInertialSmoother,
    InertialGraphOptimizer,
    _pack_imu_factors,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: every solve is many tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def Optimizer(**kw):
    return InertialGraphOptimizer(device="cpu", **kw)


def Smoother(lag, **kw):
    return FixedLagInertialSmoother(lag=lag, device="cpu", **kw)


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class Circle:
    """Analytic circular trajectory; yaw = heading + optional sinusoid
    (tests/test_imu.py's)."""

    def __init__(self, rho=2.0, omega=0.9, yaw_amp=0.0, yaw_freq=1.3):
        self.rho, self.omega = rho, omega
        self.yaw_amp, self.yaw_freq = yaw_amp, yaw_freq

    def pos(self, t):
        return self.rho * np.array([np.cos(self.omega * t), np.sin(self.omega * t), 0.0])

    def vel(self, t):
        return self.rho * self.omega * np.array(
            [-np.sin(self.omega * t), np.cos(self.omega * t), 0.0]
        )

    def acc(self, t):
        return -self.rho * self.omega**2 * np.array(
            [np.cos(self.omega * t), np.sin(self.omega * t), 0.0]
        )

    def rot(self, t):
        return _rotz(self.omega * t + np.pi / 2 + self.yaw_amp * np.sin(self.yaw_freq * t))

    def gyro(self, t):
        return np.array([
            0.0, 0.0,
            self.omega + self.yaw_amp * self.yaw_freq * np.cos(self.yaw_freq * t),
        ])

    def accel_meas(self, t, bias=np.zeros(3)):
        return self.rot(t).T @ (self.acc(t) - GRAVITY) + bias


def _integrate(traj, T, dt, bg=np.zeros(3), ba=np.zeros(3), seed=None, ng=0.0, na=0.0,
               cls=ImuPreintegrator, params_cls=ImuParams):
    pre = cls(params_cls())
    rng = np.random.default_rng(seed) if seed is not None else None
    t = 0.0
    while t < T - 1e-12:
        tm = t + 0.5 * dt  # midpoint sampling: O(dt^2) global error
        g = traj.gyro(tm) + bg
        a = traj.accel_meas(tm, ba)
        if rng is not None:
            g = g + rng.normal(0, ng, 3)
            a = a + rng.normal(0, na, 3)
        pre.integrate(g, a, dt)
        t += dt
    return pre


def _true_deltas(traj, T):
    R0 = traj.rot(0.0)
    dR = R0.T @ traj.rot(T)
    dv = R0.T @ (traj.vel(T) - traj.vel(0.0) - GRAVITY * T)
    dp = R0.T @ (traj.pos(T) - traj.pos(0.0) - traj.vel(0.0) * T - 0.5 * GRAVITY * T**2)
    return dR, dv, dp


# ---------------------------------------------------------------------------
# tests/test_imu.py's 10 tests, against the port
# ---------------------------------------------------------------------------


def test_preintegration_matches_analytic_trajectory():
    traj = Circle()
    T, dt = 2.0, 5e-5
    pre = _integrate(traj, T, dt)
    dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
    dR_t, dv_t, dp_t = _true_deltas(traj, T)
    np.testing.assert_allclose(dR, dR_t, atol=1e-7)
    np.testing.assert_allclose(dv, dv_t, atol=1e-4)
    np.testing.assert_allclose(dp, dp_t, atol=1e-4)
    assert pre.num_samples == int(round(T / dt))
    np.testing.assert_allclose(pre.dt, T, atol=1e-9)


def test_bias_correction_first_order():
    traj = Circle()
    T, dt = 1.5, 5e-4
    bg = np.array([2e-3, -1e-3, 3e-3])
    ba = np.array([-4e-3, 2e-3, 1e-3])
    pre0 = _integrate(traj, T, dt, bg=bg, ba=ba)
    dR_c, dv_c, dp_c = pre0.corrected(bg, ba)
    pre_true = ImuPreintegrator(ImuParams(), gyro_bias=bg, accel_bias=ba)
    t = 0.0
    while t < T - 1e-12:
        tm = t + 0.5 * dt
        pre_true.integrate(traj.gyro(tm) + bg, traj.accel_meas(tm, ba), dt)
        t += dt
    np.testing.assert_allclose(dR_c, pre_true.dR, atol=5e-5)
    np.testing.assert_allclose(dv_c, pre_true.dv, atol=5e-5)
    np.testing.assert_allclose(dp_c, pre_true.dp, atol=5e-5)


def test_covariance_psd_and_growth():
    traj = Circle()
    pre = ImuPreintegrator(ImuParams())
    traces = []
    t = 0.0
    dt = 1e-3
    for k in range(3000):
        pre.integrate(traj.gyro(t), traj.accel_meas(t), dt)
        t += dt
        if (k + 1) % 1000 == 0:
            ev = np.linalg.eigvalsh(pre.cov)
            assert ev.min() > -1e-18
            traces.append(np.trace(pre.cov))
    assert traces[0] < traces[1] < traces[2]
    S = pre.sqrt_information()
    np.testing.assert_allclose(S.T @ S @ pre.cov, np.eye(9), atol=1e-6)


def _factor_of(arr):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None]
    return PreintegratedImuFactor(
        torch.tensor([0]), torch.tensor([1]),
        t(arr["delta_q"]), t(arr["delta_v"]), t(arr["delta_p"]), t(arr["dt"]),
        t(arr["dR_dbg"]), t(arr["dv_dbg"]), t(arr["dv_dba"]), t(arr["dp_dbg"]),
        t(arr["dp_dba"]), t(arr["sqrt_info"]), t(arr["bias0"]),
    )


def test_residual_zero_on_consistent_states():
    traj = Circle()
    T, dt = 1.0, 2e-4
    pre = _integrate(traj, T, dt)
    arr = pre.to_factor_arrays()

    def pack(t):
        return traj.pos(t), np_rotmat_to_quat(traj.rot(t)), traj.vel(t), np.zeros(6)

    p0, q0, v0, b0 = pack(0.0)
    p1, q1, v1, b1 = pack(T)
    factors = _factor_of(arr)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))

    def res(p1_, v1_):
        return imu_residuals(
            f64(np.stack([p0, p1_])), f64(np.stack([q0, q1])), f64(np.stack([v0, v1_])),
            f64(np.stack([b0, b1])), factors, f64(GRAVITY),
        ).numpy()

    r0 = res(p1, v1)[0]
    S = arr["sqrt_info"]
    unwhite = np.linalg.solve(S, r0)
    np.testing.assert_allclose(unwhite, 0.0, atol=1e-3)  # discretization
    r_dp = np.linalg.solve(S, res(p1 + [0.01, 0, 0], v1)[0])
    assert np.abs(r_dp[6:9]).max() > 1e-3  # position block moves
    np.testing.assert_allclose(r_dp[0:6], unwhite[0:6], atol=1e-8)


def _biased_stream(traj, T_total, kf_dt, imu_dt, bg_true, ba_true, params, rng):
    n_kf = int(T_total / kf_dt) + 1
    sg = params.gyro_noise / np.sqrt(imu_dt)
    sa = params.accel_noise / np.sqrt(imu_dt)
    pres = []
    for k in range(n_kf - 1):
        pre = ImuPreintegrator(params)
        t = k * kf_dt
        while t < (k + 1) * kf_dt - 1e-9:
            tm = t + 0.5 * imu_dt
            pre.integrate(
                traj.gyro(tm) + bg_true + rng.normal(0, sg, 3),
                traj.accel_meas(tm, ba_true) + rng.normal(0, sa, 3),
                imu_dt,
            )
            t += imu_dt
        pres.append(pre)
    return n_kf, pres


def _dead_reckon(opt_or_sm, traj, pres, add):
    R, p, v = traj.rot(0.0), traj.pos(0.0), traj.vel(0.0)
    opt_or_sm.add_state(0, Pose(R, p), velocity=v)
    errs = []
    for k, pre in enumerate(pres):
        dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
        p = p + v * pre.dt + 0.5 * GRAVITY * pre.dt**2 + R @ dp
        v = v + GRAVITY * pre.dt + R @ dv
        R = R @ dR
        opt_or_sm.add_state(k + 1, Pose(R, p), velocity=v)
        if add is not None:
            add(k, pre)
        errs.append(p)
    return errs


def test_inertial_graph_gps_ins_smoothing():
    """tests/test_imu.py's GPS-INS smoothing at its sizes: 1 kHz IMU,
    keyframes every 0.5 s for 8 s, GPS fixes at 5 cm."""
    traj = Circle(rho=3.0, omega=0.6, yaw_amp=0.7)
    T_total, kf_dt, imu_dt = 8.0, 0.5, 0.001
    bg_true = np.array([2e-3, -1e-3, 3e-3])
    ba_true = np.array([3e-2, -2e-2, 1e-2])
    params = ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    rng = np.random.default_rng(0)
    n_kf, pres = _biased_stream(traj, T_total, kf_dt, imu_dt, bg_true, ba_true, params, rng)

    opt = Optimizer()
    ps = _dead_reckon(opt, traj, pres, None)
    dead_final = np.linalg.norm(ps[-1] - traj.pos((n_kf - 1) * kf_dt))

    opt.set_state_constant(0)
    gps_sigma = 0.05
    for k in range(n_kf):
        z = traj.pos(k * kf_dt) + rng.normal(0, gps_sigma, 3)
        opt.add_position_prior(k, z, sqrt_info=1.0 / gps_sigma)
    for k, pre in enumerate(pres):
        opt.add_imu_factor(k, k + 1, pre)
        opt.add_bias_walk(k, k + 1, sqrt_info=(1e4, 1e3))
    opt.add_bias_prior(0, np.zeros(6), sqrt_info=(10.0))

    summary = opt.solve(Options().replace(max_iterations=100))
    assert bool(summary.converged) or int(summary.iterations) > 10
    errs = [
        np.linalg.norm(opt.get_pose(k).translation - traj.pos(k * kf_dt))
        for k in range(n_kf)
    ]
    assert dead_final > 1.0, dead_final
    assert max(errs) < 0.1, (max(errs), dead_final)
    _, v_est, b_est = opt.get_state(n_kf // 2)
    np.testing.assert_allclose(b_est[:3], bg_true, atol=2e-3)
    np.testing.assert_allclose(b_est[3:], ba_true, atol=1.5e-2)
    np.testing.assert_allclose(v_est, traj.vel((n_kf // 2) * kf_dt), atol=0.05)


def test_bias_walk_sqrt_info_and_empty_factor_guard():
    params = ImuParams(gyro_bias_walk=1e-4, accel_bias_walk=1e-2)
    w = imu.bias_walk_sqrt_info(params, dt=0.25)
    np.testing.assert_allclose(w[:3], 1.0 / (1e-4 * 0.5))
    np.testing.assert_allclose(w[3:], 1.0 / (1e-2 * 0.5))
    with pytest.raises(ValueError, match="positive"):
        imu.bias_walk_sqrt_info(params, 0.0)
    with pytest.raises(ValueError, match="no samples"):
        ImuPreintegrator(ImuParams()).to_factor_arrays()


def test_gravity_parameter():
    g_ned = np.array([0.0, 0.0, 9.81])
    opt = Optimizer(gravity=g_ned)
    v = np.array([1.0, 0.0, 0.0])
    for k in range(3):
        opt.add_state(k, Pose(np.eye(3), v * 0.5 * k), velocity=v)
    for k in range(2):
        pre = ImuPreintegrator(ImuParams())
        for _ in range(100):
            pre.integrate(np.zeros(3), -g_ned, 0.005)
        opt.add_imu_factor(k, k + 1, pre)
        opt.add_bias_walk(k, k + 1, 1e3)
    opt.set_state_constant(0)
    opt.add_position_prior(2, np.array([1.0, 0.0, 0.0]), 100.0)
    s = opt.solve(Options().replace(max_iterations=50))
    assert bool(s.converged)
    np.testing.assert_allclose(opt.get_pose(2).translation, [1.0, 0.0, 0.0], atol=1e-3)


def _gps_ins_problem(rng_seed=0):
    """tests/test_imu.py's shared GPS-INS fixture: 6 s of 500 Hz IMU,
    keyframes every 0.5 s, GPS fixes at 5 cm."""
    traj = Circle(rho=3.0, omega=0.6, yaw_amp=0.7)
    T_total, kf_dt, imu_dt = 6.0, 0.5, 0.002
    bg_true = np.array([2e-3, -1e-3, 3e-3])
    ba_true = np.array([2e-2, -1e-2, 1e-2])
    params = ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    rng = np.random.default_rng(rng_seed)
    n_kf, pres = _biased_stream(traj, T_total, kf_dt, imu_dt, bg_true, ba_true, params, rng)
    gps = [traj.pos(k * kf_dt) + rng.normal(0, 0.05, 3) for k in range(n_kf)]
    return traj, kf_dt, n_kf, pres, gps


def _feed_smoother(sm, traj, kf_dt, n_kf, pres, gps):
    deep = Options().replace(max_iterations=200)
    R, p, v = traj.rot(0.0), traj.pos(0.0), traj.vel(0.0)
    sm.add_state(0, Pose(R, p), velocity=v)
    sm.add_position_prior(0, gps[0], 20.0)
    sm.add_bias_prior(0, np.zeros(6), 10.0)
    sm.update(deep)
    for k, pre in enumerate(pres):
        dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
        p = p + v * pre.dt + 0.5 * GRAVITY * pre.dt**2 + R @ dp
        v = v + GRAVITY * pre.dt + R @ dv
        R = R @ dR
        sm.add_state(k + 1, Pose(R, p), velocity=v)
        sm.add_imu_factor(k, k + 1, pre)
        sm.add_bias_walk(k, k + 1, (1e4, 1e3))
        sm.add_position_prior(k + 1, gps[k + 1], 20.0)
        s = sm.update(deep)
        pose_k, v, _ = sm.get_state(k + 1)
        R, p = pose_k.rotation, pose_k.translation
    return s


def _batch_solve(traj, n_kf, pres, gps):
    batch = Optimizer()

    def add(k, pre):
        batch.add_imu_factor(k, k + 1, pre)
        batch.add_bias_walk(k, k + 1, (1e4, 1e3))

    _dead_reckon(batch, traj, pres, add)
    batch.set_state_constant(0)
    for k in range(n_kf):
        batch.add_position_prior(k, gps[k], 20.0)
    batch.add_bias_prior(0, np.zeros(6), 10.0)
    batch.solve(Options().replace(max_iterations=200))
    return batch


def test_fixed_lag_inertial_no_marginalization_matches_batch():
    traj, kf_dt, n_kf, pres, gps = _gps_ins_problem()
    sm = Smoother(100)
    _feed_smoother(sm, traj, kf_dt, n_kf, pres, gps)
    assert sm.window == list(range(n_kf))
    batch = _batch_solve(traj, n_kf, pres, gps)
    for k in range(n_kf):
        np.testing.assert_allclose(
            sm.get_pose(k).translation, batch.get_pose(k).translation, atol=2e-4
        )
        np.testing.assert_allclose(sm.get_state(k)[1], batch.get_state(k)[1], atol=5e-3)


def test_fixed_lag_inertial_marginalization_tracks_batch():
    traj, kf_dt, n_kf, pres, gps = _gps_ins_problem()
    sm = Smoother(5)
    _feed_smoother(sm, traj, kf_dt, n_kf, pres, gps)
    assert len(sm.window) == 5
    frozen = sm.get_pose(2).translation.copy()
    batch = _batch_solve(traj, n_kf, pres, gps)
    for k in sm.window:
        d = np.linalg.norm(sm.get_pose(k).translation - batch.get_pose(k).translation)
        assert d < 0.02, (k, d)
    np.testing.assert_allclose(
        sm.get_state(sm.window[-1])[2], batch.get_state(n_kf - 1)[2], atol=5e-3
    )
    np.testing.assert_array_equal(sm.get_pose(2).translation, frozen)
    errs = [np.linalg.norm(sm.get_pose(k).translation - traj.pos(k * kf_dt)) for k in range(n_kf)]
    assert max(errs) < 0.12, max(errs)


def test_inertial_graph_pose_edges_fuse_with_imu():
    traj = Circle(rho=3.0, omega=0.6, yaw_amp=0.5)
    kf_dt, imu_dt, n_kf = 0.5, 0.002, 9
    params = ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    sg = params.gyro_noise / np.sqrt(imu_dt)
    sa = params.accel_noise / np.sqrt(imu_dt)

    def kf_pose(t):
        return Pose(traj.rot(t), traj.pos(t))

    def build(with_edges):
        opt = Optimizer()
        r = np.random.default_rng(4)
        for k in range(n_kf):
            t = k * kf_dt
            opt.add_state(
                k, Pose(traj.rot(t), traj.pos(t) + (r.normal(0, 0.1, 3) if k else 0.0)),
                velocity=traj.vel(t),
            )
        opt.set_state_constant(0)
        for k in range(n_kf - 1):
            pre = ImuPreintegrator(params)
            t = k * kf_dt
            while t < (k + 1) * kf_dt - 1e-9:
                tm = t + 0.5 * imu_dt
                pre.integrate(
                    traj.gyro(tm) + r.normal(0, sg, 3),
                    traj.accel_meas(tm) + r.normal(0, sa, 3),
                    imu_dt,
                )
                t += imu_dt
            opt.add_imu_factor(k, k + 1, pre)
            opt.add_bias_walk(k, k + 1, 1e4)
            if with_edges:
                rel = kf_pose(k * kf_dt).inverse() * kf_pose((k + 1) * kf_dt)
                opt.set_constraint(k, k + 1, rel, sqrt_info=(100.0, 100.0))
        for k in range(0, n_kf, 4):
            opt.add_position_prior(k, traj.pos(k * kf_dt) + r.normal(0, 0.2, 3), 5.0)
        opt.add_bias_prior(0, np.zeros(6), 10.0)
        opt.solve(Options().replace(max_iterations=150))
        return max(
            np.linalg.norm(opt.get_pose(k).translation - traj.pos(k * kf_dt))
            for k in range(n_kf)
        )

    err_no = build(False)
    err_with = build(True)
    assert err_with < 0.03, err_with
    assert err_with < 0.5 * err_no, (err_with, err_no)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _lie_inputs(rng):
    """Rotation vectors and quaternions through every branch: large
    angles, the small-angle branch (norms below 1e-6, exact zero
    included) and the qw < 0 flip."""
    w = np.concatenate([
        rng.normal(size=(6, 3)),
        1e-8 * rng.normal(size=(3, 3)),
        np.zeros((1, 3)),
        [[3e-7, -2e-7, 1e-7]],
    ])
    q = rng.normal(size=(6, 4))
    q[:, 0] = np.abs(q[:, 0])
    q[:3, 0] *= -1.0  # qw < 0: the shortest-arc flip
    q_small = np.concatenate([np.ones((3, 1)), 1e-8 * rng.normal(size=(3, 3))], axis=1)
    q_small[1] *= -1.0  # small vector part with qw < 0
    q = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True), q_small])
    return w, q


def test_lie_jacobians_match_jax_and_jacfwd(rng):
    w, q = _lie_inputs(rng)
    Jexp = lie.so3_exp_quaternion_jacobian(torch.as_tensor(w)).numpy()
    Jlog = lie.quat_log_vec_jacobian(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(
        Jexp, np.asarray(jlie.so3_exp_quaternion_jacobian(jnp.asarray(w))), rtol=1e-12, atol=1e-15
    )
    np.testing.assert_allclose(
        Jlog, np.asarray(jlie.quat_log_vec_jacobian(jnp.asarray(q))), rtol=1e-12, atol=1e-15
    )
    for k in range(w.shape[0]):
        ad = torch.func.jacfwd(lie.so3_exp_quaternion)(torch.as_tensor(w[k])).numpy()
        np.testing.assert_allclose(Jexp[k], ad, rtol=1e-10, atol=1e-12)
    for k in range(q.shape[0]):
        ad = torch.func.jacfwd(lie.quat_log_vec)(torch.as_tensor(q[k])).numpy()
        np.testing.assert_allclose(Jlog[k], ad, rtol=1e-10, atol=1e-12)
    # the branches really were taken
    assert (np.linalg.norm(w, axis=1) < 1e-6).sum() == 5
    assert (q[:, 0] < 0).sum() == 4


def _random_factor_dicts(rng, n_states):
    """tests/test_inertial_closed_form.py's random factors, for both
    packages' preintegrators from the same draws."""
    draws = []
    for _ in range(n_states - 1):
        bg, ba = 0.01 * rng.normal(size=3), 0.05 * rng.normal(size=3)
        samples = [(0.3 * rng.normal(size=3),
                    np.array([0.0, 0.0, 9.81]) + 0.5 * rng.normal(size=3)) for _ in range(20)]
        draws.append((bg, ba, samples))
    out = []
    for mod in (imu, jimu):
        facs = []
        for k, (bg, ba, samples) in enumerate(draws):
            pre = mod.ImuPreintegrator(mod.ImuParams(), bg, ba)
            for g_, a_ in samples:
                pre.integrate(g_, a_, 0.005)
            facs.append(dict(i=k, j=k + 1, **pre.to_factor_arrays()))
        out.append(facs)
    return out


def test_preintegrator_arrays_bitwise_jax(rng):
    traj = Circle(yaw_amp=0.4)
    kw = dict(bg=np.array([1e-3, 2e-3, -1e-3]), ba=np.array([1e-2, 0.0, -2e-2]),
              seed=5, ng=1e-3, na=1e-2)
    ours = _integrate(traj, 0.5, 1e-3, **kw).to_factor_arrays()
    theirs = _integrate(traj, 0.5, 1e-3, cls=jimu.ImuPreintegrator,
                        params_cls=jimu.ImuParams, **kw).to_factor_arrays()
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    np.testing.assert_array_equal(
        imu.bias_walk_sqrt_info(ImuParams(), 0.3), jimu.bias_walk_sqrt_info(jimu.ImuParams(), 0.3)
    )


def _states(rng, N, unit=False):
    p = rng.normal(size=(N, 3))
    q = rng.normal(size=(N, 4))  # non-unit ambient unless asked
    if unit:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = 0.3 * rng.normal(size=(N, 3))
    b = 0.02 * rng.normal(size=(N, 6))
    return p, q, v, b


def test_imu_residuals_and_jacobians_match_jax(rng):
    N = 6
    ours, theirs = _random_factor_dicts(rng, N)
    of = {k: k for k in range(N)}
    fac = _pack_imu_factors(ours, of, torch.float64)
    jfac = _jax_pack(theirs, of, jnp.float64)
    p, q, v, b = _states(rng, N)
    T = lambda a: torch.as_tensor(a)
    J = lambda a: jnp.asarray(a)
    g = GRAVITY
    r, Ji, Jj = imu.imu_residuals_and_jacobians(T(p), T(q), T(v), T(b), fac, T(g))
    jr, jJi, jJj = jimu.imu_residuals_and_jacobians(J(p), J(q), J(v), J(b), jfac, J(g))
    # whitened rows reach about 1e3: atol 1e-9 is 1e-12 of them
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), rtol=1e-12, atol=1e-9)
    r_plain = imu_residuals(T(p), T(q), T(v), T(b), fac, T(g))
    np.testing.assert_allclose(
        r_plain.numpy(), np.asarray(jimu.imu_residuals(J(p), J(q), J(v), J(b), jfac, J(g))),
        rtol=1e-12, atol=1e-9,
    )
    # the port's closed form against its own jacfwd oracle (the JAX test's
    # tolerance: atol 1e-8 on rows of about 1e3)
    r_ad, Ji_ad, Jj_ad = imu.imu_residuals_and_jacobians_ad(T(p), T(q), T(v), T(b), fac, T(g))
    np.testing.assert_allclose(r.numpy(), r_ad.numpy(), atol=1e-12)
    np.testing.assert_allclose(Ji.numpy(), Ji_ad.numpy(), atol=1e-8)
    np.testing.assert_allclose(Jj.numpy(), Jj_ad.numpy(), atol=1e-8)
    assert np.abs(Jj.numpy()[:, :, 10:]).max() == 0.0
    # the numpy twin, factor by factor, bitwise JAX's
    x = np.concatenate([p, q, v, b], axis=1)
    for k in range(N - 1):
        np.testing.assert_array_equal(
            imu.np_imu_residual(x[k], x[k + 1], ours[k]),
            jimu.np_imu_residual(x[k], x[k + 1], theirs[k]),
        )
