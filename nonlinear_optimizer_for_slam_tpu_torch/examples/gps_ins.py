"""GPS-INS smoothing demo: noisy and biased IMU at 1 kHz fused with 2 Hz
GPS position fixes over a figure-turning trajectory.

    python -m nonlinear_optimizer_for_slam_tpu_torch.examples.gps_ins [--device cuda|cpu]

Shows the full inertial stack: per-interval IMU preintegration
(``ops/imu.py``), keyframe states (p, q, v, b_g, b_a), bias random-walk
factors weighted from the datasheet densities, GPS priors, one BATCH
smoothing solve (``InertialGraphOptimizer``), and the ONLINE
``FixedLagInertialSmoother`` processing the same stream keyframe by
keyframe; then it prints dead-reckoning against batch and online error and
the recovered bias.
"""

import argparse
import time

import numpy as np

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.core import Options
from nonlinear_optimizer_for_slam_tpu_torch.core.device import resolve_device
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.ops.imu import (
    GRAVITY,
    ImuParams,
    ImuPreintegrator,
    bias_walk_sqrt_info,
)


def main(device="cuda"):
    device = resolve_device(device)
    rho, omega, yaw_amp, yaw_freq = 3.0, 0.6, 0.7, 1.3
    T_total, kf_dt, imu_dt = 8.0, 0.5, 0.001
    bg_true = np.array([2e-3, -1e-3, 3e-3])
    ba_true = np.array([3e-2, -2e-2, 1e-2])
    gps_sigma = 0.05
    params = ImuParams(gyro_noise=1e-4, accel_noise=1e-3)
    rng = np.random.default_rng(0)

    def pos(t):
        return rho * np.array([np.cos(omega * t), np.sin(omega * t), 0.0])

    def vel(t):
        return rho * omega * np.array([-np.sin(omega * t), np.cos(omega * t), 0.0])

    def acc(t):
        return -rho * omega**2 * np.array([np.cos(omega * t), np.sin(omega * t), 0.0])

    def rot(t):
        th = omega * t + np.pi / 2 + yaw_amp * np.sin(yaw_freq * t)
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def gyro(t):
        return np.array([0.0, 0.0, omega + yaw_amp * yaw_freq * np.cos(yaw_freq * t)])

    n_kf = int(T_total / kf_dt) + 1
    sg = params.gyro_noise / np.sqrt(imu_dt)
    sa = params.accel_noise / np.sqrt(imu_dt)

    print(f"simulating {n_kf} keyframes, {int(T_total/imu_dt)} IMU samples ...")
    pres = []
    for k in range(n_kf - 1):
        pre = ImuPreintegrator(params)
        t = k * kf_dt
        while t < (k + 1) * kf_dt - 1e-9:
            tm = t + 0.5 * imu_dt
            pre.integrate(
                gyro(tm) + bg_true + rng.normal(0, sg, 3),
                rot(tm).T @ (acc(tm) - GRAVITY) + ba_true + rng.normal(0, sa, 3),
                imu_dt,
            )
            t += imu_dt
        pres.append(pre)

    opt = nls.InertialGraphOptimizer(device=device)
    R, p, v = rot(0.0), pos(0.0), vel(0.0)
    opt.add_state(0, Pose(R, p), velocity=v)
    for k, pre in enumerate(pres):  # dead-reckoned init (zero bias)
        dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
        p = p + v * pre.dt + 0.5 * GRAVITY * pre.dt**2 + R @ dp
        v = v + GRAVITY * pre.dt + R @ dv
        R = R @ dR
        opt.add_state(k + 1, Pose(R, p), velocity=v)
    dead_err = np.linalg.norm(p - pos(T_total))

    opt.set_state_constant(0)  # pose gauge; velocity and bias stay free
    for k in range(n_kf):
        opt.add_position_prior(k, pos(k * kf_dt) + rng.normal(0, gps_sigma, 3), 1.0 / gps_sigma)
    for k, pre in enumerate(pres):
        opt.add_imu_factor(k, k + 1, pre)
        opt.add_bias_walk(k, k + 1, bias_walk_sqrt_info(params, pre.dt))
    opt.add_bias_prior(0, np.zeros(6), 10.0)

    t0 = time.perf_counter()
    summary = opt.solve(Options().replace(max_iterations=200))
    dt_ms = (time.perf_counter() - t0) * 1e3
    errs = [np.linalg.norm(opt.get_pose(k).translation - pos(k * kf_dt)) for k in range(n_kf)]
    _, v_est, b_est = opt.get_state(n_kf // 2)
    print(
        f"solved in {dt_ms:.0f} ms wall: iterations={int(summary.iterations)} "
        f"converged={bool(summary.converged)}"
    )
    print(f"dead-reckoned final error : {dead_err:.3f} m")
    print(f"batch max / mean error    : {max(errs):.3f} / {np.mean(errs):.3f} m")
    print(f"gyro bias  est {np.round(b_est[:3], 5)}  true {bg_true}")
    print(f"accel bias est {np.round(b_est[3:], 4)}  true {ba_true}")

    # ---- ONLINE: fixed-lag smoother over the same stream -------------
    sm = nls.FixedLagInertialSmoother(lag=6, device=device)
    R, p, v = rot(0.0), pos(0.0), vel(0.0)
    sm.add_state(0, Pose(R, p), velocity=v)
    sm.add_position_prior(0, pos(0.0) + rng.normal(0, gps_sigma, 3), 1.0 / gps_sigma)
    sm.add_bias_prior(0, np.zeros(6), 10.0)
    sm.update()
    online_errs = []
    t0 = time.perf_counter()
    for k, pre in enumerate(pres):
        dR, dv, dp = pre.corrected(np.zeros(3), np.zeros(3))
        p = p + v * pre.dt + 0.5 * GRAVITY * pre.dt**2 + R @ dp
        v = v + GRAVITY * pre.dt + R @ dv
        R = R @ dR
        sm.add_state(k + 1, Pose(R, p), velocity=v)
        sm.add_imu_factor(k, k + 1, pre)
        sm.add_bias_walk(k, k + 1, bias_walk_sqrt_info(params, pre.dt))
        sm.add_position_prior(
            k + 1, pos((k + 1) * kf_dt) + rng.normal(0, gps_sigma, 3), 1.0 / gps_sigma,
        )
        sm.update()
        pose_k, v, _ = sm.get_state(k + 1)
        R, p = pose_k.rotation, pose_k.translation
        online_errs.append(np.linalg.norm(p - pos((k + 1) * kf_dt)))
    dt_online = (time.perf_counter() - t0) * 1e3 / len(pres)
    print(
        f"online (lag=6) max error  : {max(online_errs):.3f} m, "
        f"{dt_online:.0f} ms/keyframe, window={sm.window}"
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
