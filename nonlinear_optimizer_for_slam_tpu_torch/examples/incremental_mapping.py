"""Example: incremental NDT mapping + scan-to-map odometry.

The mapping loop that the reference's ``UpdateNdtMap`` accumulation
semantics exist for (tests/simple_optimization_test.cc:236-280, a
caller-held voxel hash), run end to end:

  1. register each incoming scan against the GLOBAL NDT map accumulated so
     far (scan-to-map: the absolute pose comes straight out of the
     registration, no chain composition);
  2. accumulate the scan into the map at the estimated pose
     (``NdtMapAccumulator.add_scan``), growing voxel statistics in place;
  3. repeat. Map sizes are bucket-padded (``map_pad_multiple``), so the
     registrar's device map keeps one of a few shapes as the map grows.

Scan-to-map odometry has no per-frame error compounding: each pose is
measured against the whole accumulated world, so the error stays at the
single-registration level (~cm) where the scan-to-scan chain drifts
without bound. The comparison chain runs alongside to show exactly that.

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.incremental_mapping [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

from nonlinear_optimizer_for_slam_tpu_torch.core import ExponentialLoss, Options
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration, ndt
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def simulate_scan(rng, world, pose, n_points, noise=0.015):
    idx = rng.choice(world.shape[0], n_points, replace=False)
    local = pose.inverse().apply(world[idx])
    return local + rng.normal(0.0, noise, local.shape)


def main(n_frames=36, n_scan=1200, verbose=True, device="cuda"):
    rng = np.random.default_rng(7)
    world = testing.generate_room_points(point_step=0.05)

    # 1.5 laps around a circle: the second half revisits mapped space,
    # which is where scan-to-map shines (the map is already dense there)
    n_per_lap = (2 * n_frames) // 3
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

    options = Options().replace(max_iterations=20)
    loss = ExponentialLoss(c1=1.0, c2=1.0)

    def make_registrar(ndt_map):
        # map_pad_multiple buckets the growing map: registrations against
        # a bigger map keep the device map's shape until the bucket grows
        return fused_registration.NdtRegistrar(
            ndt_map, options, loss, map_pad_multiple=256,
            max_outer_iterations=8, device=device,
        )

    # the global map is seeded by the first scan at the (known) initial
    # pose: the usual SLAM convention that frame 0 defines the world frame
    acc = ndt.NdtMapAccumulator(1.0)
    scan0 = simulate_scan(rng, world, gt[0], n_scan)
    acc.add_scan(scan0, gt[0])

    est = [gt[0]]  # scan-to-map estimates
    chain = [gt[0]]  # scan-to-scan comparison chain
    prev_scan = scan0
    prev_rel = Pose(np.eye(3), np.zeros(3))
    err_map, err_chain = [], []
    n_compiles = 0
    last_padded = None
    t0 = time.perf_counter()
    for k in range(1, n_frames):
        scan = simulate_scan(rng, world, gt[k], n_scan)

        # scan-to-map: register against the global accumulated map,
        # seeded by a constant-velocity world-frame guess
        m = acc.to_map()
        reg = make_registrar(m)
        padded = reg.map.means_T.shape[1]  # the bucket the map landed in
        if padded != last_padded:
            n_compiles += 1
            last_padded = padded
        guess = Pose(
            est[-1].rotation @ prev_rel.rotation,
            est[-1].translation + est[-1].rotation @ prev_rel.translation,
        )
        pose_k = reg.register(scan, guess).pose
        prev_rel = Pose(
            est[-1].rotation.T @ pose_k.rotation,
            est[-1].rotation.T @ (pose_k.translation - est[-1].translation),
        )
        est.append(pose_k)
        acc.add_scan(scan, pose_k)  # the map grows at the ESTIMATED pose

        # scan-to-scan comparison chain (same machinery, the previous
        # scan's map only): the error compounds every hop
        rel = make_registrar(ndt.build_ndt_map(prev_scan, 1.0)).register(
            scan, Pose(np.eye(3), np.zeros(3))
        ).pose
        p = chain[-1]
        chain.append(
            Pose(p.rotation @ rel.rotation, p.translation + p.rotation @ rel.translation)
        )
        prev_scan = scan

        err_map.append(np.linalg.norm(pose_k.translation - gt[k].translation))
        err_chain.append(np.linalg.norm(chain[k].translation - gt[k].translation))

    wall = time.perf_counter() - t0
    e_m, e_c = np.array(err_map), np.array(err_chain)
    if verbose:
        print(f"{n_frames} frames in {wall:.1f}s "
              f"({wall / (n_frames - 1) * 1e3:.0f} ms/frame incl. map "
              f"rebuilds); map {acc.num_voxels} voxels, "
              f"{n_compiles} map-size buckets")
        print(f"scan-to-map   error: mean {e_m.mean():.3f} m / "
              f"final {e_m[-1]:.3f} m")
        print(f"scan-to-scan  error: mean {e_c.mean():.3f} m / "
              f"final {e_c[-1]:.3f} m (drift compounds)")
    return float(e_m.mean()), float(e_c.mean()), float(e_m[-1]), float(e_c[-1])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
