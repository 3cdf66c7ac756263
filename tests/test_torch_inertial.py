"""The port's inertial solvers (``solvers/inertial.py``) against their
oracles and the JAX package.

First the 5 tests of tests/test_inertial_closed_form.py against the port
(the closed-form solve against the ``torch.func.jacfwd`` oracle
``_inertial_solve_ad``, monkeypatched in under the same module-level
name), and tests/test_external_anchor.py's inertial scipy chi^2 anchor,
with their fixtures and bounds but one: the smoother's oracle test runs on
tests/test_imu.py's GPS-INS circle stream (its docstring says why). Then
parity with the JAX package, float64 on both sides:

- ``InertialGraphOptimizer.solve`` on the 8-keyframe fixture (IMU, bias
  walks, odometry edges, position, velocity and bias priors): LM
  iterations equal, every state within 1e-9, final cost rtol 1e-9;
  ``residual_vector`` within rtol 1e-12;
- ``FixedLagInertialSmoother`` on the circle stream, blocking (lag 4) and
  streaming with ``marginalize_every=4``, update by update: LM counts
  equal and the window states within 1e-9 after every update (the
  marginal priors are built on the host in float64 by the same numpy
  arithmetic, from window states that agree to rounding).
"""

import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core import Options as JOptions
from nonlinear_optimizer_for_slam_tpu.core.pose import Pose as JPose
from nonlinear_optimizer_for_slam_tpu.ops import imu as jimu
from nonlinear_optimizer_for_slam_tpu.solvers import inertial as jinertial
from nonlinear_optimizer_for_slam_tpu_torch.core import Options
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.ops import imu as imu_mod
from nonlinear_optimizer_for_slam_tpu_torch.ops.imu import GRAVITY, ImuParams, ImuPreintegrator
from nonlinear_optimizer_for_slam_tpu_torch.solvers import inertial as inertial_mod
from nonlinear_optimizer_for_slam_tpu_torch.solvers.inertial import (
    FixedLagInertialSmoother,
    InertialGraphOptimizer,
    _pack_imu_factors,
)

TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: every solve is many tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The two packages' registries, so one function fills either.
PORT = dict(Optimizer=lambda **kw: InertialGraphOptimizer(device="cpu", **kw),
            Smoother=lambda **kw: FixedLagInertialSmoother(device="cpu", **kw),
            Pose=Pose, Options=Options, imu=imu_mod)
JAX = dict(Optimizer=jinertial.InertialGraphOptimizer,
           Smoother=jinertial.FixedLagInertialSmoother,
           Pose=JPose, Options=JOptions, imu=jimu)


def _random_factors(rng, n_states):
    params = ImuParams()
    factors = []
    for k in range(n_states - 1):
        pre = ImuPreintegrator(params, 0.01 * rng.normal(size=3), 0.05 * rng.normal(size=3))
        for _ in range(20):
            pre.integrate(
                0.3 * rng.normal(size=3),
                np.array([0.0, 0.0, 9.81]) + 0.5 * rng.normal(size=3),
                0.005,
            )
        factors.append(dict(i=k, j=k + 1, **pre.to_factor_arrays()))
    return factors


# ---------------------------------------------------------------------------
# tests/test_inertial_closed_form.py's 5 tests, against the port
# ---------------------------------------------------------------------------


def test_imu_jacobians_match_autodiff():
    rng = np.random.default_rng(1)
    N = 6
    fac = _pack_imu_factors(_random_factors(rng, N), {k: k for k in range(N)}, torch.float64)
    T = lambda a: torch.as_tensor(a)
    p = T(rng.normal(size=(N, 3)))
    q = T(rng.normal(size=(N, 4)))  # non-unit ambient
    v = T(0.3 * rng.normal(size=(N, 3)))
    b = T(0.02 * rng.normal(size=(N, 6)))
    g = T(GRAVITY)
    r_cf, Ji_cf, Jj_cf = imu_mod.imu_residuals_and_jacobians(p, q, v, b, fac, g)
    r_ad, Ji_ad, Jj_ad = imu_mod.imu_residuals_and_jacobians_ad(p, q, v, b, fac, g)
    r_ref = imu_mod.imu_residuals(p, q, v, b, fac, g)
    np.testing.assert_allclose(r_cf.numpy(), r_ref.numpy(), atol=1e-12)
    np.testing.assert_allclose(r_cf.numpy(), r_ad.numpy(), atol=1e-12)
    # whitened rows reach ~1e3 magnitude: 1e-8 absolute is ~1e-11 relative
    np.testing.assert_allclose(Ji_cf.numpy(), Ji_ad.numpy(), atol=1e-8)
    np.testing.assert_allclose(Jj_cf.numpy(), Jj_ad.numpy(), atol=1e-8)
    assert np.abs(Jj_cf.numpy()[:, :, 10:]).max() == 0.0


def test_imu_jacobians_small_angle_branch():
    rng = np.random.default_rng(3)
    N = 3
    facs = _random_factors(rng, N)
    fac = _pack_imu_factors(facs, {k: k for k in range(N)}, torch.float64)
    p = torch.zeros((N, 3), dtype=torch.float64)
    q = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64).repeat(N, 1)
    v = torch.zeros((N, 3), dtype=torch.float64)
    b = torch.as_tensor(np.stack([f["bias0"] for f in facs] + [facs[-1]["bias0"]]))
    g = torch.as_tensor(GRAVITY)
    r_cf, Ji_cf, Jj_cf = imu_mod.imu_residuals_and_jacobians(p, q, v, b, fac, g)
    r_ad, Ji_ad, Jj_ad = imu_mod.imu_residuals_and_jacobians_ad(p, q, v, b, fac, g)
    np.testing.assert_allclose(Ji_cf.numpy(), Ji_ad.numpy(), atol=1e-8)
    np.testing.assert_allclose(Jj_cf.numpy(), Jj_ad.numpy(), atol=1e-8)


def _gps_ins_fixture(rng, n_kf=8, pkg=PORT):
    """Small GPS-INS graph exercising IMU + walk + edge + all priors
    (tests/test_inertial_closed_form.py's), in either package."""
    P, m = pkg["Pose"], pkg["imu"]
    opt = pkg["Optimizer"]()
    params = m.ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    vel = np.array([1.0, 0.2, 0.0])
    for k in range(n_kf):
        p = vel * 0.5 * k + 0.02 * rng.normal(size=3)
        opt.add_state(k, P(np.eye(3), p), velocity=vel + 0.05 * rng.normal(size=3))
    opt.set_state_constant(0)
    for k in range(n_kf - 1):
        pre = m.ImuPreintegrator(params)
        for _ in range(100):
            pre.integrate(1e-4 * rng.normal(size=3), -GRAVITY + 1e-3 * rng.normal(size=3), 0.005)
        opt.add_imu_factor(k, k + 1, pre)
        opt.add_bias_walk(k, k + 1, (1e4, 1e3))
        opt.set_constraint(k, k + 1, P(np.eye(3), vel * 0.5), sqrt_info=np.full(6, 10.0))
    for k in range(n_kf):
        opt.add_position_prior(k, vel * 0.5 * k, sqrt_info=20.0)
    opt.add_velocity_prior(0, vel, sqrt_info=10.0)
    opt.add_bias_prior(0, np.zeros(6), sqrt_info=10.0)
    return opt


def test_inertial_solve_matches_ad_oracle(monkeypatch):
    opts = Options().replace(max_iterations=60)
    opt_cf = _gps_ins_fixture(np.random.default_rng(7))
    s_cf = opt_cf.solve(opts)
    monkeypatch.setattr(inertial_mod, "_inertial_solve", inertial_mod._inertial_solve_ad)
    opt_ad = _gps_ins_fixture(np.random.default_rng(7))
    s_ad = opt_ad.solve(opts)
    np.testing.assert_allclose(float(s_cf.final_cost), float(s_ad.final_cost), rtol=1e-9, atol=1e-12)
    for k in range(opt_cf.num_states):
        p_cf, v_cf, b_cf = opt_cf.get_state(k)
        p_ad, v_ad, b_ad = opt_ad.get_state(k)
        np.testing.assert_allclose(p_cf.translation, p_ad.translation, atol=1e-8)
        np.testing.assert_allclose(p_cf.rotation, p_ad.rotation, atol=1e-8)
        np.testing.assert_allclose(v_cf, v_ad, atol=1e-8)
        np.testing.assert_allclose(b_cf, b_ad, atol=1e-8)


def _stream(n_kf=9, seed=11, pkg=PORT):
    """The closed-form tests' smoother stream: per keyframe (pose, velocity,
    preintegrator, position) from one seed, in either package."""
    rng = np.random.default_rng(seed)
    m, P = pkg["imu"], pkg["Pose"]
    params = m.ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    vel = np.array([1.0, 0.0, 0.1])
    out = []
    for k in range(1, n_kf):
        pre = m.ImuPreintegrator(params)
        for _ in range(100):
            pre.integrate(1e-4 * rng.normal(size=3), -GRAVITY + 1e-3 * rng.normal(size=3), 0.005)
        out.append((P(np.eye(3), vel * 0.5 * k + 0.01 * rng.normal(size=3)), vel, pre,
                    vel * 0.5 * k))
    return out


def _start(sm, pkg):
    sm.add_state(0, pkg["Pose"](np.eye(3), np.zeros(3)), velocity=np.array([1.0, 0.0, 0.1]))
    sm.add_position_prior(0, np.zeros(3), 20.0)


def _add_frame(sm, k, frame):
    pose, vel, pre, gps = frame
    sm.add_state(k, pose, velocity=vel)
    sm.add_imu_factor(k - 1, k, pre)
    sm.add_bias_walk(k - 1, k, (1e4, 1e3))
    sm.add_position_prior(k, gps, 20.0)


def _run_smoother(lag=4, n_kf=9, me=1, use_async=False, pkg=PORT):
    sm = pkg["Smoother"](lag=lag, marginalize_every=me)
    _start(sm, pkg)
    for k, frame in enumerate(_stream(n_kf, pkg=pkg), start=1):
        _add_frame(sm, k, frame)
        sm.update_async() if use_async else sm.update()
    sm.flush()
    return sm


def _circle_smoother(pkg=PORT, lag=4, me=1, use_async=False, check=None, frames=12):
    """The GPS-INS circle stream of tests/test_imu.py (500 Hz IMU, 5 cm GPS,
    ``frames`` keyframes after the first) through a smoother of either
    package, each keyframe
    predicted 1 cm off the truth; ``check(k, sm)`` runs after each
    blocking update, and after every third streamed one once flushed."""
    from test_torch_imu import _gps_ins_problem

    traj, kf_dt, n_kf, pres, gps = _gps_ins_problem()
    P = pkg["Pose"]
    sm = pkg["Smoother"](lag=lag, marginalize_every=me)
    sm.add_state(0, P(traj.rot(0.0), traj.pos(0.0)), velocity=traj.vel(0.0))
    sm.add_position_prior(0, gps[0], 20.0)
    sm.add_bias_prior(0, np.zeros(6), 10.0)
    sm.update()
    for k, pre in enumerate(pres[:frames], start=1):
        t = k * kf_dt
        sm.add_state(k, P(traj.rot(t), traj.pos(t) + 0.01), velocity=traj.vel(t))
        sm.add_imu_factor(k - 1, k, pre.to_factor_arrays())
        sm.add_bias_walk(k - 1, k, (1e4, 1e3))
        sm.add_position_prior(k, gps[k], 20.0)
        if use_async:
            sm.update_async()
            if k % 3:
                continue
            sm.flush()
        else:
            sm.update()
        if check is not None:
            check(k, sm)
    sm.flush()
    return sm


def test_fixed_lag_smoother_matches_ad_oracle(monkeypatch):
    """The marginal prior's closed form against the jacfwd oracle over a
    whole sliding-window run (lag 4, 8 updates, 5 marginalizations, the
    JAX test's lengths), within the JAX test's 1e-5.

    On the stream of the JAX test (``_run_smoother``: identity rotations,
    priors on position only) the LM trajectory is chaotic: within one
    update the cost jumps from 0.18 to 365 and back and steps reach a
    norm of 600, so two orderings of the same float64 arithmetic part
    after a few updates. There the port's closed form ends within 1.1e-6
    of JAX's closed form, JAX's closed form within 9e-7 of its oracle,
    and the port's oracle 2.4e-5 from both: the 1e-5 bound rests on which
    rounding the chaos amplifies. The circle stream converges steadily
    (every update within 1e-10 of JAX's, ``test_smoother_matches_jax``)."""
    sm_cf = _circle_smoother(frames=8)
    monkeypatch.setattr(inertial_mod, "_inertial_solve", inertial_mod._inertial_solve_ad)
    sm_ad = _circle_smoother(frames=8)
    assert sm_cf.window == sm_ad.window
    for k in sm_cf.window:
        p_cf, v_cf, b_cf = sm_cf.get_state(k)
        p_ad, v_ad, b_ad = sm_ad.get_state(k)
        np.testing.assert_allclose(p_cf.translation, p_ad.translation, atol=1e-5)
        np.testing.assert_allclose(v_cf, v_ad, atol=1e-5)
        np.testing.assert_allclose(b_cf, b_ad, atol=1e-5)


def test_inertial_update_async_matches_blocking():
    blocking = _run_smoother(me=1, use_async=False)
    streamed = _run_smoother(me=1, use_async=True)
    assert streamed.window == blocking.window
    for k in streamed.window:
        p_b, v_b, b_b = blocking.get_state(k)
        p_s, v_s, b_s = streamed.get_state(k)
        np.testing.assert_array_equal(p_s.translation, p_b.translation)
        np.testing.assert_array_equal(v_s, v_b)
        np.testing.assert_array_equal(b_s, b_b)
    amortized = _run_smoother(me=3, use_async=True)
    for k in amortized.window:
        np.testing.assert_allclose(
            amortized.get_state(k)[0].translation, blocking.get_state(k)[0].translation,
            atol=1e-3,
        )


# ---------------------------------------------------------------------------
# tests/test_external_anchor.py's inertial scipy anchor
# ---------------------------------------------------------------------------


def test_inertial_chi2_matches_scipy():
    """The port and scipy's TRF minimize the identical whitened residual
    stack (``residual_vector``) from the same dead-reckoned start and must
    reach the same chi^2 (rel 2e-2, the JAX test's bound)."""
    from scipy.optimize import least_squares

    from test_torch_imu import _gps_ins_problem

    traj, kf_dt, n_kf, pres, gps = _gps_ins_problem()
    opt = PORT["Optimizer"]()
    R, p, v = traj.rot(0.0), traj.pos(0.0), traj.vel(0.0)
    opt.add_state(0, Pose(R, p), velocity=v)
    for k, pre in enumerate(pres):
        dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
        p = p + v * pre.dt + 0.5 * GRAVITY * pre.dt**2 + R @ dp
        v = v + GRAVITY * pre.dt + R @ dv
        R = R @ dR
        opt.add_state(k + 1, Pose(R, p), velocity=v)
        opt.add_imu_factor(k, k + 1, pre)
        opt.add_bias_walk(k, k + 1, (1e4, 1e3))
    opt.set_state_constant(0)
    for k in range(n_kf):
        opt.add_position_prior(k, gps[k], 20.0)
    opt.add_bias_prior(0, np.zeros(6), 10.0)

    x0 = np.stack([
        np.concatenate([opt.get_pose(k).translation, opt.get_pose(k).quaternion(),
                        opt.get_state(k)[1], opt.get_state(k)[2]])
        for k in range(n_kf)
    ])
    chi2_init = opt.chi2(x0)
    opt.solve(Options().replace(max_iterations=200))
    chi2_ours = opt.chi2()

    N = n_kf
    free = np.ones((N, 16), bool)
    free[0, 0:7] = False
    idx_free = np.flatnonzero(free.reshape(-1))

    def unpack(z):
        x = x0.reshape(-1).copy()
        x[idx_free] = z
        return x.reshape(N, 16)

    def residuals(z):
        x = unpack(z)
        pin = np.sum(x[1:, 3:7] ** 2, axis=-1) - 1.0
        return np.concatenate([opt.residual_vector(x), pin])

    res = least_squares(
        residuals, x0.reshape(-1)[idx_free], method="trf", tr_solver="lsmr", x_scale="jac",
        ftol=1e-12, xtol=1e-12, gtol=1e-12, max_nfev=120,
    )
    x_sp = unpack(res.x)
    x_sp[:, 3:7] /= np.linalg.norm(x_sp[:, 3:7], axis=1, keepdims=True)
    chi2_scipy = opt.chi2(x_sp)
    assert chi2_ours < 0.2 * chi2_init, (chi2_ours, chi2_init)
    assert chi2_scipy < 0.2 * chi2_init
    assert chi2_ours == pytest.approx(chi2_scipy, rel=2e-2), (chi2_ours, chi2_scipy, chi2_init)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _packed_states(opt):
    return np.stack([
        np.concatenate([s[0].translation, s[0].quaternion(), s[1], s[2]])
        for s in (opt.get_state(k) for k in range(opt.num_states))
    ])


def test_optimizer_matches_jax():
    opts = dict(max_iterations=60)
    ours = _gps_ins_fixture(np.random.default_rng(7))
    theirs = _gps_ins_fixture(np.random.default_rng(7), pkg=JAX)
    x0 = _packed_states(ours)
    np.testing.assert_allclose(ours.residual_vector(), theirs.residual_vector(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours.chi2(x0), theirs.chi2(x0), rtol=1e-12)
    s = ours.solve(Options().replace(**opts))
    js = theirs.solve(JOptions().replace(**opts))
    assert int(s.iterations) == int(js.iterations)
    assert bool(s.converged) == bool(js.converged)
    np.testing.assert_allclose(float(s.final_cost), float(js.final_cost), rtol=TOL)
    np.testing.assert_allclose(_packed_states(ours), _packed_states(theirs), rtol=0, atol=TOL)


def _smoother_window(sm):
    return np.stack([sm._est[k] for k in sm._window])


@pytest.mark.parametrize("me,use_async", [(1, False), (4, True)], ids=["blocking", "every4"])
def test_smoother_matches_jax(me, use_async):
    """Update by update on the circle stream (lag 4): after every blocking
    update, and after every third streamed one once flushed, the same
    window, equal LM counts and the window states within 1e-9."""
    theirs = {}

    def record(k, sm):
        theirs[k] = (list(sm._window), int(sm.last_summary.iterations), _smoother_window(sm))

    def compare(k, sm):
        window, iterations, states = theirs[k]
        assert sm._window == window, k
        assert int(sm.last_summary.iterations) == iterations, k
        np.testing.assert_allclose(_smoother_window(sm), states, rtol=0, atol=TOL,
                                   err_msg=f"update {k}")

    _circle_smoother(JAX, me=me, use_async=use_async, check=record)
    ours = _circle_smoother(PORT, me=me, use_async=use_async, check=compare)
    assert len(ours._history) == 9  # every marginalization ran
    assert sorted(theirs) == (list(range(3, 13, 3)) if use_async else list(range(1, 13)))
