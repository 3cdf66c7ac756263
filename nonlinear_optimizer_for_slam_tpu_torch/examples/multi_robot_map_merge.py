"""Example: multi-robot map merge — two dead-reckoned trajectories fused
into one consistent global frame by inter-robot NDT registrations.

Robot A (counter-clockwise lap) and robot B (clockwise lap) each run
scan-to-scan NDT odometry (the device-resident ``NdtRegistrar``) in their OWN
odometry frames; B's global placement is unknown a priori. The merge:

  1. the robots start near each other, so B's first scan registers
     against A's first keyframe map from an identity guess — that single
     constraint places B's frame in the world (standard rendezvous
     initialization);
  2. every time the robots' paths cross again, B's current scan is
     registered against the nearest A keyframe map (seeded from current
     estimates, exactly like a loop-closure query) -> inter-robot edge;
  3. one joint pose graph over both trajectories — A's poses 0..N-1,
     B's poses N..2N-1, gauge = A's first pose, whitened odometry edges
     within each robot, switchable inter-robot edges — is solved by
     ``PoseGraphOptimizer`` (the reference's pose-graph module never
     composes with its own registration module; here they are one
     framework);
  4. a planted FALSE rendezvous match (identity relative pose between
     far-apart frames) demonstrates switchable-constraint rejection at
     the map-merge level.

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.multi_robot_map_merge [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from nonlinear_optimizer_for_slam_tpu_torch.core import ExponentialLoss, Options
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration, ndt
from nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_graph import (
    ConstraintType,
    PoseGraphOptimizer,
)
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def simulate_scan(rng, world, pose, n_points, noise=0.015):
    idx = rng.choice(world.shape[0], n_points, replace=False)
    local = pose.inverse().apply(world[idx])
    return local + rng.normal(0.0, noise, local.shape)


def _compose(p, rel):
    return Pose(p.rotation @ rel.rotation, p.translation + p.rotation @ rel.translation)


def main(n_frames=20, n_scan=900, keyframe_every=3, verbose=True, device="cuda"):
    rng = np.random.default_rng(5)
    world = testing.generate_room_points(point_step=0.05)

    # Ground truth: same circle, opposite directions, shared start
    # neighborhood. Yaw schedules mirror each other so that wherever the
    # paths cross the relative yaw is ~0 (rendezvous guesses stay inside
    # the registration basin).
    def gt_pose(robot, k):
        th = 2 * np.pi * k / n_frames
        if robot == "A":
            ang, yaw = th, th
        else:
            ang, yaw = -th, -th
        return Pose(
            _rotz(yaw),
            np.array(
                [1.5 * np.cos(ang), 1.5 * np.sin(ang), 0.3 + (0.0 if robot == "A" else 0.02)]
            ),
        )

    gt = {r: [gt_pose(r, k) for k in range(n_frames)] for r in ("A", "B")}
    # B starts offset from A (nearby, not identical)
    reg_options = Options().replace(max_iterations=20)
    loss = ExponentialLoss(c1=1.0, c2=1.0)

    def make_registrar(scan):
        return fused_registration.NdtRegistrar(
            ndt.build_ndt_map(scan, 1.0),
            reg_options,
            loss,
            map_pad_multiple=64,
            max_outer_iterations=8,
            device=device,
        )

    t0 = time.perf_counter()
    # ---- per-robot frontend: scans + dead-reckoned odometry ----
    scans, dead, odo_edges, registrars = {}, {}, {}, {}
    for r in ("A", "B"):
        scans[r] = [simulate_scan(rng, world, gt[r][k], n_scan) for k in range(n_frames)]
        registrars[r] = {0: make_registrar(scans[r][0])}
        # A's odometry frame is anchored at its (known) start pose — that
        # IS the world gauge; B's frame starts at ITS OWN origin (its
        # world placement is what the first rendezvous estimates).
        chain = [gt["A"][0].copy() if r == "A" else Pose.identity()]
        edges = []
        prev_rel = Pose.identity()
        for k in range(1, n_frames):
            res = registrars[r][k - 1].register(scans[r][k], prev_rel)
            prev_rel = res.pose
            edges.append((k - 1, k, res.pose))
            chain.append(_compose(chain[-1], res.pose))
            registrars[r][k] = make_registrar(scans[r][k])
            if r == "B":
                # only B's previous frame is ever queried again
                del registrars[r][k - 1]
        dead[r] = chain
        odo_edges[r] = edges

    # ---- inter-robot rendezvous registrations ----
    # first rendezvous: shared start, identity guess (B has no placement
    # yet — this one registration anchors B's frame in the world; A's
    # odometry frame IS the world gauge, A0 is the fixed pose)
    res0 = registrars["A"][0].register(scans["B"][0], Pose.identity())
    # world pose of B's odometry origin: through A0's (gauge) world pose
    t_b_world = _compose(dead["A"][0], res0.pose)

    inter = [(0, 0, res0.pose)]  # (ka, kb, T_{A_ka <- B_kb})
    last_kb = 0
    # A keyframe maps available for rendezvous queries
    a_keyframes = [k for k in range(n_frames) if k % keyframe_every == 0]
    for kb in range(3, n_frames):
        pb = gt["B"][kb].translation
        ka_best = min(
            a_keyframes,
            key=lambda ka: np.linalg.norm(gt["A"][ka].translation - pb),
        )
        if (
            np.linalg.norm(gt["A"][ka_best].translation - pb) < 0.8
            and kb - last_kb >= 4
        ):
            guess = (
                dead["A"][ka_best].inverse()
                * _compose(t_b_world, dead["B"][kb])
            )
            res = registrars["A"][ka_best].register(scans["B"][kb], guess)
            inter.append((ka_best, kb, res.pose))
            last_kb = kb
            if verbose:
                print(f"  rendezvous: A{ka_best} <- B{kb}")

    # ---- joint pose graph ----
    ODO_W = (1 / 0.02, 1 / 0.01)
    INTER_W = (1 / 0.02, 1 / 0.01)
    opt = PoseGraphOptimizer(switch_penalty=30.0, device=device)  # float64
    B_OFF = n_frames  # index offset of robot B's poses

    # initial values: A = its dead-reckoning (== world); B = dead-reckoning
    # placed by the FIRST rendezvous only (the naive merge baseline)
    naive_b = [_compose(t_b_world, dead["B"][k]) for k in range(n_frames)]
    for k in range(n_frames):
        opt.set_pose(k, dead["A"][k])
        opt.set_pose(B_OFF + k, naive_b[k])
    opt.set_pose_constant(0)
    for r, off in (("A", 0), ("B", B_OFF)):
        for i, j, rel in odo_edges[r]:
            opt.set_constraint(off + i, off + j, rel, sqrt_info=ODO_W)
    for ka, kb, rel in inter:
        opt.set_constraint(
            ka, B_OFF + kb, rel, ConstraintType.LOOP, sqrt_info=INTER_W
        )
    # each robot also closes its own lap: final scan vs its first keyframe
    for r, off in (("A", 0), ("B", B_OFF)):
        guess = dead[r][0].inverse() * dead[r][n_frames - 1]
        if r == "A":
            lres = registrars["A"][0].register(scans["A"][n_frames - 1], guess)
        else:
            lres = make_registrar(scans["B"][0]).register(
                scans["B"][n_frames - 1], guess
            )
        opt.set_constraint(
            off, off + n_frames - 1, lres.pose, ConstraintType.LOOP,
            sqrt_info=INTER_W,
        )
    # planted FALSE rendezvous: identity relative pose across the circle
    ka_f, kb_f = n_frames // 4, n_frames // 4
    opt.set_constraint(
        ka_f, B_OFF + kb_f, Pose.identity(), ConstraintType.LOOP, sqrt_info=INTER_W
    )
    if verbose:
        print(f"  planted FALSE rendezvous A{ka_f} <- B{kb_f}")

    summary, switches = opt.solve(Options().replace(max_iterations=100))
    wall = time.perf_counter() - t0

    def traj_err(get, robot, off=0):
        return np.array(
            [
                np.linalg.norm(get(k + off).translation - gt[robot][k].translation)
                for k in range(n_frames)
            ]
        )

    # the planted edge is the LAST loop constraint registered
    false_switch = float(switches[-1])
    e_naive = np.array(
        [
            np.linalg.norm(naive_b[k].translation - gt["B"][k].translation)
            for k in range(n_frames)
        ]
    )
    e_a = traj_err(opt.get_pose, "A")
    e_b = traj_err(opt.get_pose, "B", B_OFF)
    if verbose:
        print(
            f"\n2x{n_frames} frames merged in {wall:.1f}s "
            f"({len(inter)} rendezvous edges + 1 planted false)"
        )
        print(
            f"robot B position error: naive first-rendezvous alignment "
            f"mean {e_naive.mean():.3f} m / max {e_naive.max():.3f} m"
        )
        print(
            f"                        after joint merge            "
            f"mean {e_b.mean():.3f} m / max {e_b.max():.3f} m"
        )
        print(f"robot A after merge: mean {e_a.mean():.3f} m")
        print(f"planted false-rendezvous switch: {false_switch:.4f}")
    return float(e_b.mean()), float(e_naive.mean()), false_switch, switches


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
