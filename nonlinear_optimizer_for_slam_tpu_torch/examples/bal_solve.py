"""Solve a BAL (Bundle Adjustment in the Large) problem file.

    python -m nonlinear_optimizer_for_slam_tpu_torch.examples.bal_solve problem-49-7776-pre.txt
        [--max-iterations N] [--f32] [--landmark-chunk N] [--cpu]
        [--device cuda|cpu] [-o solved.txt]

Reads the standard BAL text format (Agarwal et al., ECCV 2010 -
https://grail.cs.washington.edu/projects/bal/; plain or .gz), solves the
Snavely 9-parameter model with the dense-Schur LM solver (solvers/bal.py),
prints the per-iteration cost trace in the Ceres convention
(0.5 sum |r|^2, directly comparable to Ceres' own simple_bundle_adjuster
logs on the same file), and optionally writes the solved problem back in
BAL format.

With no input file, generates a synthetic BAL-geometry problem at the
problem-49-7776 shape and solves that.

``--f32`` solves in single precision (float64 by default). ``--cpu`` is
``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

from nonlinear_optimizer_for_slam_tpu_torch.core import Options
from nonlinear_optimizer_for_slam_tpu_torch.io import bal as bal_io
from nonlinear_optimizer_for_slam_tpu_torch.solvers import bal as bal_solver


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=None,
                    help="BAL problem file (.txt or .txt.gz)")
    ap.add_argument("-o", "--output", default=None,
                    help="write the solved problem back in BAL format")
    ap.add_argument("--max-iterations", type=int, default=50)
    ap.add_argument("--f32", action="store_true", help="solve in float32")
    ap.add_argument("--landmark-chunk", type=int, default=None,
                    help="chunked Schur cross-term (memory O(chunk*C*27))")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    if args.input:
        problem = bal_io.read_bal(args.input)
        print(f"loaded {args.input}: {problem.num_cameras} cameras, "
              f"{problem.num_points} points, "
              f"{problem.num_observations} observations")
    else:
        print("no input file — generating a synthetic problem at the "
              "problem-49-7776 shape")
        problem, _ = bal_io.synthetic_bal_problem(
            num_cameras=49, num_points=7776, observations_per_point=4, seed=49,
        )

    dtype = torch.float32 if args.f32 else torch.float64
    opts = Options().replace(max_iterations=args.max_iterations)

    t0 = time.perf_counter()
    solved, summary = bal_solver.solve_bal(
        problem, opts, dtype=dtype, landmark_chunk=args.landmark_chunk, device=device
    )
    wall = time.perf_counter() - t0

    trace = summary.records.cost.cpu().numpy()
    trace = trace[np.isfinite(trace)]
    for i, c in enumerate(trace):
        print(f"  iter {i:3d}: cost {c:.6e}")
    print(f"final cost {bal_solver.bal_cost(solved, dtype=dtype, device=device):.6e} "
          f"(0.5*sum|r|^2, Ceres convention) in {int(summary.iterations)} "
          f"iterations, {wall:.1f}s wall "
          f"(converged={bool(summary.converged)})")

    if args.output:
        bal_io.write_bal(args.output, solved)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
