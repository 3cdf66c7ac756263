"""Example: serving-mode batched solving.

The reference solves one problem per ``Solve`` call; the port's serving
fast path is B independent problems in one batched LM
(``solvers/batched.py``), one kernel launch per LM iteration for the whole
batch. This example:

1. solves a batch of 64 PnP (reprojection) problems with ragged
   correspondence counts at once (``solve_reprojection_batch``, the reproj
   kernel), and
2. registers a batch of 8 LiDAR scans against one NDT map, full matching
   + inner LM + outer ICP per scan, in one run of the registrar's machine
   (``NdtRegistrar.register_batch``, the maha6 kernel).

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.serving_batch [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.core import ExponentialLoss, Options
from nonlinear_optimizer_for_slam_tpu_torch.core.device import resolve_device
from nonlinear_optimizer_for_slam_tpu_torch.ops import reprojection
from nonlinear_optimizer_for_slam_tpu_torch.ops.reprojection import CameraIntrinsics
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration, ndt
from nonlinear_optimizer_for_slam_tpu_torch.solvers import solve_reprojection_batch
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing


def batched_pnp(device="cuda"):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    B, n_pad = 64, 256
    intr = CameraIntrinsics.create(525.0, 525.0, 320.0, 240.0, 640, 480)
    loss = ExponentialLoss()

    pts_b = np.zeros((B, n_pad, 3))
    pix_b = np.zeros((B, n_pad, 2))
    mask_b = np.zeros((B, n_pad))
    true_poses = []
    for b in range(B):
        n = int(rng.integers(120, n_pad))  # ragged problem sizes
        pts = np.stack(
            [
                rng.uniform(-1.5, 1.5, n),
                rng.uniform(-1.0, 1.0, n),
                rng.uniform(2.5, 4.0, n),
            ],
            axis=1,
        )
        tp = nls.Pose.from_axis_angle(
            0.05 * rng.normal(), rng.normal(size=3), 0.1 * rng.normal(size=3)
        )
        q = tp.apply(pts)
        pts_b[b, :n] = pts
        pix_b[b, :n, 0] = 525 * q[:, 0] / q[:, 2] + 320
        pix_b[b, :n, 1] = 525 * q[:, 1] / q[:, 2] + 240
        mask_b[b, :n] = 1.0
        true_poses.append(tp)

    as_t = lambda a: torch.as_tensor(a, device=device)
    data = reprojection.ReprojectionData(as_t(pts_b), as_t(pix_b), as_t(mask_b))
    t0 = time.perf_counter()
    poses, iters, costs = solve_reprojection_batch(
        Options(), data, intr, [nls.Pose.identity()] * B, loss=loss, device=device
    )
    wall = (time.perf_counter() - t0) * 1e3
    err = max(
        np.linalg.norm(p.translation - tp.translation)
        for p, tp in zip(poses, true_poses)
    )
    print(
        f"batched PnP: {B} ragged problems in one dispatch "
        f"(incl. compile on first run): {wall:.1f} ms total = "
        f"{wall / B:.3f} ms/solve, max t_err {err:.2e}, "
        f"iters {int(iters.min())}-{int(iters.max())}"
    )


def batched_registration(device="cuda"):
    # 2 cm grid: a 5 cm room is too coarse for NDT voxel statistics; its
    # saturated exponential loss stalls registration at ~0.2 m
    pts = testing.generate_room_points(point_step=0.02)
    ndt_map = ndt.build_ndt_map(pts, 1.0)
    scan = ndt.filter_points(pts, 0.1)
    true_pose = testing.maha_true_pose()
    local = true_pose.inverse().apply(scan)

    registrar = fused_registration.NdtRegistrar(
        ndt_map, Options(), ExponentialLoss(), device=device
    )
    B = 8
    # ragged scan sizes: random subsamples keep the room geometry intact
    # (truncating the tail would drop whole walls and un-constrain axes)
    rng = np.random.default_rng(1)
    scans = [
        local[np.sort(rng.choice(len(local), len(local) - 800 * b, replace=False))]
        for b in range(B)
    ]
    t0 = time.perf_counter()
    results = registrar.register_batch(scans, [nls.Pose.identity()] * B)
    wall = (time.perf_counter() - t0) * 1e3
    err = max(
        np.linalg.norm(r.pose.translation - true_pose.translation)
        for r in results
    )
    print(
        f"batched registration: {B} scans x full ICP in one dispatch "
        f"(incl. compile on first run): {wall:.1f} ms total = "
        f"{wall / B:.2f} ms/scan, max t_err {err:.2e}"
    )


def main(device="cuda"):
    batched_pnp(device)
    batched_registration(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
