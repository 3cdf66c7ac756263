"""Example: 6-DoF NDT scan-to-map registration (the flagship pipeline).

Builds the reference benchmark world, registers a simulated scan with the
device-resident registrar (``NdtRegistrar``), and prints the trajectory of
inner LM counts and costs. With --objective p2p or --objective d2d the same
world runs through the point-to-plane or distribution-to-distribution
(GICP-style) pipeline instead, both beyond the reference, which is
point-to-NDT only.

The NDT map and the scan filter come from the native C++ builder
(``native.py``, built with g++ at first use); if it cannot be built, the
numpy builder of ``pipelines/ndt.py`` runs instead. The line
``map builder: ...`` says which ran.

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.ndt_registration
         [--objective maha|p2p|d2d] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.core import ExponentialLoss, Options
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import (
    fused_registration,
    ndt,
    registration,
)
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing


def build_world(points, identity_moment):
    """(NDT map, filtered scan, builder name): the native builder, or the
    numpy one if the native library does not build."""
    from nonlinear_optimizer_for_slam_tpu_torch import native

    try:
        native.load()
    except (OSError, RuntimeError) as exc:
        builder = f"numpy (native unavailable: {str(exc).splitlines()[0]})"
        return (ndt.build_ndt_map(points, 1.0, identity_moment=identity_moment),
                ndt.filter_points(points, 0.1), builder)
    return (native.build_ndt_map(points, 1.0, identity_moment=identity_moment),
            native.filter_points(points, 0.1), "native")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--objective", choices=["maha", "p2p", "d2d"], default="maha")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    objective, device = args.objective, args.device

    print("building world...")
    points = testing.generate_room_points(point_step=0.02)
    # p2p/d2d plane extraction wants the unbiased (identity_moment=False)
    # build; the mahalanobis path keeps the reference-parity default.
    ndt_map, scan, builder = build_world(points, identity_moment=objective == "maha")
    print(f"map builder: {builder}")

    true_pose = testing.maha_true_pose()
    local_scan = true_pose.inverse().apply(scan)
    print(f"{points.shape[0]} map points -> {int(ndt_map.valid.sum())} NDT voxels; "
          f"scan has {local_scan.shape[0]} points")

    if objective == "maha":
        registrar = fused_registration.NdtRegistrar(
            ndt_map, Options(), ExponentialLoss(c1=1.0, c2=1.0), device=device
        )
        run = lambda: registrar.register(local_scan, nls.Pose.identity())
    elif objective == "p2p":
        minimizer = nls.PointToPlaneMinimizer(device=device).set_loss_function(
            ExponentialLoss(c1=1.0, c2=1.0)
        )
        run = lambda: registration.register_point_to_plane(
            ndt_map, local_scan, nls.Pose.identity(), minimizer, Options(),
            max_thickness=0.05,
        )
    else:  # d2d
        minimizer = nls.MahalanobisDistanceMinimizer(device=device)
        run = lambda: registration.register_d2d_ndt(
            ndt_map, local_scan, nls.Pose.identity(), minimizer, Options()
        )

    t0 = time.perf_counter()
    result = run()
    print(f"first registration (incl. compile): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    result = run()
    print(f"warm registration: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    err = np.linalg.norm(result.pose.translation - true_pose.translation)
    print(f"estimated pose: {result.pose}")
    print(f"true pose:      {true_pose}")
    print(f"translation error: {err * 1e3:.2f} mm")
    if objective == "maha":
        print(f"outer iterations: {result.outer_iterations}, "
              f"inner LM iterations per outer: {result.inner_iterations.tolist()}")
        print(f"costs per outer iteration: {np.round(result.costs, 1).tolist()}")
    else:
        print(f"outer iterations: {result.outer_iterations}, "
              f"final cost: {float(result.summaries[-1].final_cost):.6f}")


if __name__ == "__main__":
    main()
