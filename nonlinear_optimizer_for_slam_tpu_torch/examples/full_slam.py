"""Example: full online SLAM — NDT scan odometry frontend + fixed-lag
pose-graph backend, end to end.

Per frame:
  1. simulate a noisy lidar scan of the room world from the true pose;
  2. FRONTEND: register the scan against the previous scan's NDT map
     (scan-to-scan odometry, the device-resident ``NdtRegistrar``); it
     drifts;
  3. every few frames, keep the scan as a KEYFRAME; the
     LoopClosureDetector proposes revisits from ESTIMATED poses (no
     ground truth), verifies them coarse-D2D -> full registration with
     an overlap test, and yields the loop edge (switchable; one
     deliberately corrupted loop is planted to show rejection);
  4. BACKEND: feed whitened odometry/loop edges to the FixedLagSmoother
     (constant-size window solve + tangent-space marginalization).

Edge whitening is END-TO-END by default (``whitening="information"``):
every odometry edge is whitened by the registration's OWN Gauss-Newton
information ``NdtRegistrar.information`` (one extra matching per
frame) and every loop edge by the detector-reported
``closure.sqrt_info`` — no hand-calibrated scalar weights anywhere in
the graph. ``whitening="calibrated"`` keeps the scalar-weight variant
for comparison.

Scans are resampled to a fixed size and per-scan NDT maps are
bucket-padded (``map_pad_multiple``), so the registrars' device maps keep
one of a few shapes.

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.full_slam [--stream] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.core import ExponentialLoss, Options
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import (
    fused_registration,
    loop_closure,
    ndt,
)
from nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_graph import (
    edge_information_to_world,
    sqrt_info_from_information,
)
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def simulate_scan(rng, world, pose, n_points, noise=0.015):
    """Noisy fixed-size scan of the world in the robot frame."""
    idx = rng.choice(world.shape[0], n_points, replace=False)
    local = pose.inverse().apply(world[idx])
    return local + rng.normal(0.0, noise, local.shape)


def main(n_frames=48, n_scan=1500, keyframe_every=6, lag=None, verbose=True,
         whitening="information", stream=False, device="cuda"):
    """``stream=True`` (--stream on the CLI): the backend runs update_async
    with marginalize_every=2: a window solve every frame, the host's fetch
    and marginalization every second, and current-pose estimates between
    flushes from odometry chained on the last flushed estimate (reads
    flush, so keyframe and detector state is synced on flush frames only).
    Same factors, same switching; the published error is measured the same
    way. Returns (mean online error of lap 2 with SLAM, with raw odometry),
    in metres."""
    rng = np.random.default_rng(11)
    world = testing.generate_room_points(point_step=0.05)

    # ground-truth trajectory: two laps around a 1.5 m circle in the room
    n_per_lap = n_frames // 2
    if lag is None:
        # the window must span a full lap so that revisited keyframes are
        # still active when their loop closures arrive (a fixed-lag
        # smoother can only constrain poses inside the window)
        lag = n_per_lap + 2
    gt = [
        Pose(
            _rotz(2 * np.pi * k / n_per_lap),
            np.array(
                [1.5 * np.cos(2 * np.pi * k / n_per_lap),
                 1.5 * np.sin(2 * np.pi * k / n_per_lap),
                 0.3],
            ),
        )
        for k in range(n_frames)
    ]

    reg_options = Options().replace(max_iterations=20)
    loss = ExponentialLoss(c1=1.0, c2=1.0)

    def make_registrar(scan):
        m = ndt.build_ndt_map(scan, 1.0)
        return fused_registration.NdtRegistrar(
            m, reg_options, loss, map_pad_multiple=64,
            max_outer_iterations=8, device=device,
        )

    # backend: whitened edges; registration accuracy ~2-3 cm / ~10 mrad.
    # switch_penalty calibration (PoseGraphOptimizer docstring rule):
    # above the whitened inlier innovation and well below an outlier's
    # (a wrong loop hypothesis is >= the keyframe spacing ~1 m).
    #  - calibrated weights (t 1/0.02, rot 1/0.01): drift ~0.3 m ->
    #    chi ~ 15-25; outlier chi ~ 60-100; penalty 30.
    #  - information whitening: the registration's own J^T W J is ~2x
    #    (translation) / ~3x (rotation) stiffer than the calibrated
    #    scalars on this fixture (sigma_t ~ 1 cm, honest vs the measured
    #    ~1.7 cm registration error), so whitened chi scales ~4-9x ->
    #    penalty 100 (planted-outlier switch settles at ~0.07 while all
    #    real loops stay on; 150 also works but rejects less crisply).
    use_info = whitening == "information"
    if whitening not in ("information", "calibrated"):
        raise ValueError(f"unknown whitening mode {whitening!r}")
    ODO_W = (1 / 0.02, 1 / 0.01)
    LOOP_W = (1 / 0.02, 1 / 0.01)
    sm = nls.solvers.FixedLagSmoother(
        lag=lag, switch_penalty=100.0 if use_info else 30.0,
        marginalize_every=2 if stream else 1, device=device,
    )

    scans = {0: simulate_scan(rng, world, gt[0], n_scan)}
    registrars = {0: make_registrar(scans[0])}  # frame -> map of that scan
    keyframes = [0]
    est = gt[0]
    sm.add_pose(0, est)
    # loop-closure detection from ESTIMATED poses only (candidate radius
    # covers odometry drift; id gap keeps the current lap out)
    det = loop_closure.LoopClosureDetector(
        candidate_radius=1.5,  # must cover worst-case odometry drift
        max_translation_correction=1.5,  # ditto: the correction IS the drift
        min_id_gap=n_per_lap - 2,
        min_match_fraction=0.5,
        options=reg_options,
        loss=loss,
        device=device,
    )
    det.add_keyframe(0, scans[0], est)
    odo_chain = [gt[0]]  # raw dead-reckoned odometry chain
    last_odo_S = None
    online_err, online_err_od = [], []  # current-pose error at each k
    planted = None
    t_start = time.perf_counter()
    prev_rel = Pose(np.eye(3), np.zeros(3))
    for k in range(1, n_frames):
        scan = simulate_scan(rng, world, gt[k], n_scan)
        # frontend: odometry = registration against frame k-1's map,
        # seeded with a constant-velocity guess (last relative motion)
        res = registrars[k - 1].register(scan, prev_rel)
        rel = res.pose  # T_{k-1 <- k}
        prev_rel = rel

        p = odo_chain[-1]
        odo_chain.append(
            Pose(p.rotation @ rel.rotation,
                 p.translation + p.rotation @ rel.translation)
        )
        R_prev = est.rotation  # pose k-1 world-rotation estimate
        est = Pose(est.rotation @ rel.rotation,
                   est.translation + est.rotation @ rel.translation)
        sm.add_pose(k, est)
        if use_info:
            # end-to-end whitening: the registration's own information
            # at the converged pose (one extra matching),
            # conjugated into the world-frame residual convention by the
            # reference frame's rotation estimate (the raw measurement-
            # frame info would misrotate anisotropic axes by R_ref)
            odo_S = sqrt_info_from_information(
                edge_information_to_world(
                    registrars[k - 1].information(scan, rel), R_prev
                )
            )
            sm.add_odometry(k - 1, k, rel, sqrt_info=odo_S)
            last_odo_S = odo_S
        else:
            sm.add_odometry(k - 1, k, rel, sqrt_info=ODO_W)

        # loop closure: detector proposes from estimates, verifies by
        # coarse-D2D + full registration with an overlap test, and
        # reports the registration's own information — used directly as
        # the edge whitener in "information" mode
        # active_ids: a membership read that does not flush; a sm.window
        # read here would flush every frame and defeat the stream mode's
        # marginalize_every amortization
        closure = det.detect(k, scan, est, eligible=set(sm.active_ids))
        if closure is not None:
            sm.add_loop(closure.reference_id, k, closure.relative_pose,
                        sqrt_info=closure.sqrt_info if use_info else LOOP_W)
            if verbose:
                H = closure.sqrt_info.T @ closure.sqrt_info
                print(f"  loop {closure.reference_id} -> {k} "
                      f"(overlap {closure.matched_fraction:.2f}, "
                      f"correction {closure.correction * 1e3:.0f} mm, "
                      f"info trace {np.trace(H):.2e})")
        if k == n_per_lap + 3:
            # planted outlier: claims an exact-identity relative pose to
            # the farthest-away keyframe still in the window
            cands = [i for i in keyframes
                     if i in sm.active_ids and k - i > lag // 2]
            if cands:
                i = max(
                    cands,
                    key=lambda j: np.linalg.norm(
                        gt[j].translation - gt[k].translation
                    ),
                )
                # the false loop carries a plausible whitener (a real
                # wrong hypothesis would come with its own confident
                # registration information)
                sm.add_loop(i, k, Pose(np.eye(3), np.zeros(3)),
                            sqrt_info=last_odo_S if use_info else LOOP_W)
                planted = (i, k)
                if verbose:
                    print(f"  planted FALSE loop {i} -> {k}")

        if stream:
            sm.update_async()
            if k % 2 == 0 or k == n_frames - 1:
                est = sm.get_pose(k)  # read forces the flush
                for i in keyframes:
                    if i in sm.active_ids:
                        det.update_pose(i, sm.get_pose(i))
            # off-flush frames keep the odometry-chained prediction
        else:
            summary = sm.update()
            est = sm.get_pose(k)
            # keep the detector's keyframe poses in sync with the backend
            for i in keyframes:
                if i in sm.window:
                    det.update_pose(i, sm.get_pose(i))
        online_err.append(
            np.linalg.norm(est.translation - gt[k].translation)
        )
        online_err_od.append(
            np.linalg.norm(odo_chain[k].translation - gt[k].translation)
        )

        scans[k] = scan
        registrars[k] = make_registrar(scan)
        if k % keyframe_every == 0:
            keyframes.append(k)
            det.add_keyframe(k, scan, est)
        # drop registrars that can no longer be queried (bounded memory)
        for i in list(registrars):
            if i != k and i not in keyframes:
                del registrars[i]

        if planted and planted[1] == k:
            s = sm.loop_switches()
            if verbose:
                print(f"  planted loop switch after update: {s[-1]:.4f}")

    wall = time.perf_counter() - t_start
    # the metric that matters online: error of the CURRENT pose estimate
    # at the moment the robot would act on it (loops cannot repair poses
    # frozen before they arrived, so a whole-trajectory average mostly
    # measures the loop-free warm-up lap)
    second_lap = slice(n_per_lap, None)
    e_sm = np.array(online_err)[second_lap]
    e_od = np.array(online_err_od)[second_lap]
    if verbose:
        print(f"\n{n_frames} frames in {wall:.1f}s "
              f"({wall / (n_frames - 1) * 1e3:.0f} ms/frame incl. map builds)")
        print(f"online current-pose error (lap 2, loops active): "
              f"SLAM mean {e_sm.mean():.3f} m / max {e_sm.max():.3f} m   vs  "
              f"raw odometry mean {e_od.mean():.3f} m / max {e_od.max():.3f} m")
        cov = sm.covariance([n_frames - 1])[n_frames - 1]
        sigma = np.sqrt(np.diag(cov))
        print(f"final-pose 1-sigma: translation "
              f"{np.round(sigma[:3], 3).tolist()} m")
    return float(e_sm.mean()), float(e_od.mean())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(stream=args.stream, device=args.device)
