"""Solve a g2o pose-graph file and write the optimized graph back.

    python -m nonlinear_optimizer_for_slam_tpu_torch.examples.g2o_solve input.g2o
        [-o solved.g2o] [--solver auto|dense|cg|tridiag|banded|sparse]
        [--init chordal|spanning_tree] [--switchable-loops]
        [--unit-information] [--max-iterations N] [--rtol R]
        [--device cuda|cpu]

Works on the standard 2-D (VERTEX_SE2/EDGE_SE2) and 3-D
(VERTEX_SE3:QUAT/EDGE_SE3:QUAT) benchmark corpora: sphere2500, torus,
parking-garage, intel, M3500, ... Information matrices from the file
whiten the edges (full 6x6 / 3x3 supported); --switchable-loops turns
every non-consecutive edge into a Suenderhauf switchable constraint for
outlier rejection.

With no input file, generates a small noisy 3-D loop demo in the
temporary directory and solves that.
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from nonlinear_optimizer_for_slam_tpu_torch.core import Options
from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.io import g2o as g2o_io


def make_demo(path: str, P: int = 64, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    true = [
        Pose.from_axis_angle(
            2 * np.pi * k / P,
            [0, 0, 1],
            [10 * np.cos(2 * np.pi * k / P), 10 * np.sin(2 * np.pi * k / P), 0.0],
        )
        for k in range(P)
    ]
    g = g2o_io.G2oGraph(dim=3)
    drift = np.zeros(3)
    for k, p in enumerate(true):
        drift += rng.normal(0, 0.05, 3)
        g.vertices[k] = np.concatenate(
            [p.translation + (drift if k else 0.0), p.quaternion()]
        )
    info = np.zeros((6, 6))
    info[:3, :3] = 100 * np.eye(3)
    info[3:, 3:] = 400 * np.eye(3)
    for k in range(P):
        i, j = k, (k + 1) % P
        rel = true[i].inverse() * true[j]
        noisy_t = rel.translation + rng.normal(0, 0.01, 3)
        g.edges.append(
            g2o_io.G2oEdge(i, j, np.concatenate([noisy_t, rel.quaternion()]), info)
        )
    g2o_io.write_g2o(path, g)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument(
        "--solver",
        choices=["auto", "dense", "cg", "tridiag", "banded", "sparse"],
        default="auto",
    )
    ap.add_argument("--switchable-loops", action="store_true")
    ap.add_argument("--unit-information", action="store_true")
    ap.add_argument("--max-iterations", type=int, default=200)
    ap.add_argument(
        "--rtol", type=float, default=0.0,
        help="relative cost-plateau stop (3 consecutive iterations "
        "improving the best cost by less than this end the solve; "
        "try 1e-7 on large graphs where the reference's absolute "
        "tolerances can never fire). Default 0 = off, matching the "
        "library default and the reference's stopping policy exactly",
    )
    ap.add_argument(
        "--init", choices=["none", "spanning_tree", "chordal"],
        default="none",
        help="replace the file's vertex estimates with a spanning-tree "
        "or chordal initialization before solving (2-D and 3-D graphs)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    path = args.input
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "g2o_demo.g2o")
        print(f"no input given - writing demo graph to {path}")
        make_demo(path)

    graph = g2o_io.read_g2o(path)
    print(
        f"{path}: {graph.dim}-D, {len(graph.vertices)} vertices, "
        f"{len(graph.edges)} edges, fixed={sorted(graph.fixed) or '[first]'}"
    )

    kwargs = {"device": args.device}
    if graph.landmarks:
        if args.solver != "dense":
            print(
                f"note: --solver {args.solver} ignored — landmark-SLAM "
                f"solves use the Schur-complement linear path"
            )
    elif graph.dim == 3:
        kwargs["solver"] = args.solver
    elif args.solver in ("auto", "dense", "cg", "banded", "sparse"):
        kwargs["solver"] = args.solver
    else:
        print(
            f"note: --solver {args.solver} is 3-D only; using 'auto' "
            f"for this 2-D graph (2-D supports auto|dense|cg|banded|sparse)"
        )
        kwargs["solver"] = "auto"
    opt = g2o_io.load_pose_graph(
        path,
        switchable_loops=args.switchable_loops,
        unit_information=args.unit_information,
        **kwargs,
    )

    t0 = time.perf_counter()
    if args.init != "none":
        if graph.landmarks:
            print(f"note: --init {args.init} is pose-graph only; skipped")
        else:
            opt.initialize(method=args.init)
            print(f"{args.init} initialization: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    solve_opts = dataclasses.replace(
        Options().replace(max_iterations=args.max_iterations),
        convergence_handle=ConvergenceHandle(relative_function_tolerance=args.rtol),
    )
    if args.rtol > 0:
        print(
            f"note: --rtol {args.rtol:g} enables the beyond-reference "
            f"plateau stop — iteration counts/final costs will deviate "
            f"from the reference's fixed-tolerance policy"
        )
    summary, switches = opt.solve(solve_opts)
    dt = (time.perf_counter() - t0) * 1e3
    chosen = getattr(opt, "last_solver_choice", None)
    picked = f" solver={chosen}" if chosen and args.solver == "auto" else ""
    print(
        f"solved in {dt:.1f} ms wall: iterations={int(summary.iterations)} "
        f"final_cost={float(summary.final_cost):.6g} "
        f"converged={bool(summary.converged)}{picked}"
    )
    if args.switchable_loops and len(switches):
        off = int(np.sum(np.asarray(switches) < 0.5))
        print(f"loop switches: {len(switches)} total, {off} rejected")

    out = args.output or os.path.splitext(path)[0] + "_solved.g2o"
    g2o_io.save_pose_graph(out, opt, graph=graph)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
