"""Example: SE(3) pose-graph optimization with outlier loop rejection.

Builds the reference's 80-pose rectangle fixture (79 odometry edges + 4
loop closures, the last one a deliberate identity-pose outlier), solves
with switchable constraints, and prints before/after errors and the
learned switch values.

Run: python -m nonlinear_optimizer_for_slam_tpu_torch.examples.pose_graph_slam [--device cuda|cpu]
"""

import argparse

import numpy as np

import nonlinear_optimizer_for_slam_tpu_torch as nls
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing


def main(device="cuda"):
    true_poses, noisy_poses, constraints = testing.generate_pose_graph_fixture()

    opt = nls.PoseGraphOptimizer(switch_penalty=0.03, device=device)
    for i, pose in enumerate(noisy_poses):
        opt.set_pose(i, pose)
    opt.set_pose_constant(0)  # gauge
    for c in constraints:
        opt.set_constraint(
            c["reference_index"],
            c["query_index"],
            c["relative_pose"],
            nls.ConstraintType.LOOP if c["is_loop"] else nls.ConstraintType.ODOMETRY,
        )

    err_before = max(
        np.linalg.norm(noisy_poses[i].translation - true_poses[i].translation)
        for i in range(80)
    )
    summary, switches = opt.solve()
    err_after = max(
        np.linalg.norm(opt.get_pose(i).translation - true_poses[i].translation)
        for i in range(80)
    )
    print(f"max translation error: {err_before * 1e3:.1f} mm -> {err_after * 1e3:.2f} mm")
    print(f"iterations: {int(summary.iterations)}, final cost: {float(summary.final_cost):.3e}")
    print(f"loop switches (last one is the planted outlier): {np.round(switches, 4).tolist()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
