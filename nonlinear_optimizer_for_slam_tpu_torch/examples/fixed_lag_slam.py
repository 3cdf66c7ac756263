"""Example: online SLAM with the fixed-lag smoother.

Simulates a robot driving two laps around a circle with noisy odometry
and periodic loop closures (plus one planted outlier loop). The smoother
keeps only a 15-pose window: older poses are marginalized into a dense
Gaussian prior, so each update solves a problem of constant size while
keeping absorbed loop information; the online counterpart of
``pose_graph_slam``'s batch solve.

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.fixed_lag_slam [--device cuda|cpu]
     ... --stream   # update_async + marginalize_every=4: the window solve
       runs every frame, the host's fetch, write-back and marginalization
       every 4th; reads (get_pose/loop_switches) flush first, so the
       printed estimates are always window MAPs
"""

import argparse
import time

import numpy as np

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stream = args.stream
    rng = np.random.default_rng(7)
    n_per_lap, laps, radius = 36, 2, 12.0
    n = n_per_lap * laps
    gt = [
        Pose(
            _rotz(2 * np.pi * k / n_per_lap),
            np.array(
                [
                    radius * np.cos(2 * np.pi * k / n_per_lap),
                    radius * np.sin(2 * np.pi * k / n_per_lap),
                    0.0,
                ]
            ),
        )
        for k in range(n)
    ]

    def rel(i, j):
        Ri, ti = gt[i].rotation, gt[i].translation
        return Pose(Ri.T @ gt[j].rotation, Ri.T @ (gt[j].translation - ti))

    def noisy(p, s_t, s_r):
        return Pose(
            p.rotation @ _exp_so3(rng.normal(0, s_r, 3)),
            p.translation + rng.normal(0, s_t, 3),
        )

    # Whitened edges: sqrt_info = 1/sigma of the MEASUREMENT noise, so
    # good loops pull at their true strength and covariance() reports
    # physical units. switch_penalty must then be calibrated in the
    # WHITENED residual scale: an inlier loop seen from a drifted window
    # has innovation chi ~ drift/sigma (~0.3 m / 5 mm = 60), so the
    # penalty must exceed that (100 here) to keep inliers switched on,
    # while a gross outlier (chi ~ 4000) still switches off. (With the
    # default metric-unit residuals the same logic gives the 0.03
    # default.)
    sm = nls.solvers.FixedLagSmoother(
        marginalize_every=4 if stream else 1,
        lag=15, switch_penalty=100.0, device=args.device)
    est = gt[0]
    dr = gt[0]  # open-loop dead reckoning for comparison
    dr_err = [0.0]
    frame_ms = []
    sm.add_pose(0, est)
    for k in range(1, n):
        odo = noisy(rel(k - 1, k), 0.02, 0.004)
        est = Pose(
            est.rotation @ odo.rotation,
            est.translation + est.rotation @ odo.translation,
        )
        dr = Pose(
            dr.rotation @ odo.rotation,
            dr.translation + dr.rotation @ odo.translation,
        )
        dr_err.append(np.linalg.norm(dr.translation - gt[k].translation))
        sm.add_pose(k, est)
        # whitened edges (sqrt_info = 1/sigma) so covariance() reports
        # physical units and loops weigh in proportion to their quality
        sm.add_odometry(k - 1, k, odo, sqrt_info=(1 / 0.02, 1 / 0.004))
        if k % 6 == 0 and k >= 10:
            sm.add_loop(
                k - 10, k, noisy(rel(k - 10, k), 0.005, 0.001),
                sqrt_info=(1 / 0.005, 1 / 0.001),
            )
        if k == 30:  # planted outlier: identity loop between far poses
            sm.add_loop(18, 30, Pose(np.eye(3), np.zeros(3)),
                        sqrt_info=(1 / 0.005, 1 / 0.001))
        t0 = time.perf_counter()
        if stream:
            sm.update_async()  # the host part runs every 4th frame
            if k % 4 == 0:
                # re-anchor the prediction to the MAP on flush frames
                # (the read forces the flush) — without this the inits
                # dead-reckon unboundedly, exactly the failure mode the
                # smoother exists to fix
                est = sm.get_pose(k)
        else:
            sm.update()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if not stream:
            est = sm.get_pose(k)  # feed-forward (a read would force a
            # flush every frame in stream mode — predictions carry it)
        if k == 30:
            s = sm.loop_switches()
            print(
                f"k=30: planted outlier loop switch -> {s[-1]:.4f} "
                f"(rejected); co-active good loops stay at "
                f"{np.round(s[:-1], 3).tolist()}"
            )

    sm.flush()
    err = [np.linalg.norm(sm.get_pose(i).translation - gt[i].translation) for i in range(n)]
    mode = "async stream (marginalize_every=4)" if stream else "blocking"
    print(f"{mode}: median per-frame update {np.median(frame_ms[5:]):.1f} ms")
    print(f"poses: {n}, window: {sm.window[0]}..{sm.window[-1]} ({len(sm.window)} active)")
    cov = sm.covariance([sm.window[-1]])[sm.window[-1]]
    sigma = np.sqrt(np.diag(cov))
    print(
        f"current-pose 1-sigma: translation {np.round(sigma[:3], 3).tolist()} m, "
        f"rotation {np.round(sigma[3:], 4).tolist()} rad"
    )
    print(
        f"trajectory error: smoother mean {np.mean(err):.3f} m / max {np.max(err):.3f} m"
        f"  vs dead-reckoning mean {np.mean(dr_err):.3f} m / max {np.max(dr_err):.3f} m"
    )


if __name__ == "__main__":
    main()
