"""The port's examples (``nonlinear_optimizer_for_slam_tpu_torch/examples/``)
on the CPU (``--device cpu``).

- ``g2o_solve`` in its no-input demo mode, as
  tests/test_examples_smoke.py::test_g2o_solve_demo runs the JAX one: it
  solves with solver="auto", reports the pick and writes the solved file.
- ``pose_graph_slam`` and ``hand_eye_calibration`` print, line for line,
  what the JAX examples print (both solve in float64 here: the port by
  default, the JAX package under the tests' x64 mode); so does
  ``gps_ins``, its two wall times aside.
- ``bal_solve`` with no file, on a small ``--max-iterations`` on the CPU,
  prints its per-iteration trace and its final cost, and writes the solved
  problem as a BAL file the JAX reader reads.
- Importing ``native``, ``solvers.fixed_lag``, the bundle adjustment, BAL,
  pose-landmark, inertial and Sim(3) modules with their IO and anchor, and
  every example module leaves no ``jax`` module loaded (in a fresh
  interpreter).

The heavier examples driven as libraries have files of their own:
tests/test_torch_incremental_mapping.py, tests/test_torch_multi_robot.py
and tests/test_torch_full_slam.py.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import tempfile

import pytest
import torch

from nonlinear_optimizer_for_slam_tpu_torch.examples import (
    bal_solve,
    g2o_solve,
    gps_ins,
    hand_eye_calibration,
    pose_graph_slam,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = (
    "bal_solve", "fixed_lag_slam", "full_slam", "g2o_solve", "gps_ins", "hand_eye_calibration",
    "incremental_mapping", "multi_robot_map_merge", "ndt_registration",
    "pose_graph_slam", "serving_batch",
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the solves are many tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example(name: str):
    """The JAX package's example module, loaded from examples/ (it runs
    on the tests' CPU JAX). An example that points JAX's compilation
    cache somewhere when imported has that setting undone."""
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py")
    )
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return module


def _printed(fn, *args, **kwargs) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


def test_g2o_solve_demo(tmp_path, monkeypatch):
    """No-input mode: writes the 64-pose loop demo (into this test's own
    temporary directory), solves it with solver="auto", reports the pick
    and writes the solved graph."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _printed(g2o_solve.main, [
        "-o", str(tmp_path / "solved.g2o"), "--max-iterations", "60", "--device", "cpu",
    ])
    assert "solved in" in out
    assert "solver=" in out  # auto reports its pick
    assert "converged=True" in out
    assert (tmp_path / "g2o_demo.g2o").exists()
    assert (tmp_path / "solved.g2o").exists()


def test_bal_solve_demo(tmp_path):
    """No-input mode on the CPU: the problem-49-7776-shaped synthetic
    problem, a short solve, its trace and final cost in the Ceres
    convention, and the solved file."""
    from nonlinear_optimizer_for_slam_tpu.io import bal as jbal_io

    out_path = tmp_path / "solved.txt"
    out = _printed(bal_solve.main, ["--max-iterations", "2", "--cpu", "-o", str(out_path)])
    assert "problem-49-7776 shape" in out
    assert "iter   0: cost" in out and "iter   1: cost" in out
    assert "final cost" in out and "Ceres convention" in out
    solved = jbal_io.read_bal(str(out_path))
    assert (solved.num_cameras, solved.num_points, solved.num_observations) == (49, 7776, 31104)


@pytest.mark.parametrize(
    "port_module, name",
    [(pose_graph_slam, "pose_graph_slam"), (hand_eye_calibration, "hand_eye_calibration")],
    ids=["pose_graph_slam", "hand_eye_calibration"],
)
def test_example_prints_what_the_jax_example_prints(port_module, name):
    theirs = _printed(_jax_example(name).main).splitlines()
    mine = _printed(port_module.main, device="cpu").splitlines()
    assert len(theirs) >= 3
    assert mine == theirs


def test_gps_ins_prints_what_the_jax_example_prints():
    """Line for line, with the batch solve's and the online update's wall
    times (``<n> ms``) left out: both packages solve in float64."""
    wall = lambda text: [re.sub(r"\d+ ms", "<n> ms", line) for line in text.splitlines()]
    theirs = wall(_printed(_jax_example("gps_ins").main))
    mine = wall(_printed(gps_ins.main, device="cpu"))
    assert len(theirs) == 7
    assert mine == theirs


def test_the_port_modules_import_no_jax():
    """In a fresh interpreter, the binding, the smoother, the bundle
    adjustment, BAL, pose-landmark, inertial and Sim(3) modules and every
    example import without loading jax or any module of the JAX
    package."""
    mods = ["nonlinear_optimizer_for_slam_tpu_torch.native",
            "nonlinear_optimizer_for_slam_tpu_torch.solvers.fixed_lag",
            "nonlinear_optimizer_for_slam_tpu_torch.solvers.bundle_adjustment",
            "nonlinear_optimizer_for_slam_tpu_torch.solvers.bal",
            "nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_landmark",
            "nonlinear_optimizer_for_slam_tpu_torch.solvers.inertial",
            "nonlinear_optimizer_for_slam_tpu_torch.solvers.sim3_graph",
            "nonlinear_optimizer_for_slam_tpu_torch.ops.imu",
            "nonlinear_optimizer_for_slam_tpu_torch.io.bal",
            "nonlinear_optimizer_for_slam_tpu_torch.utils.anchor_np",
            "nonlinear_optimizer_for_slam_tpu_torch.examples"]
    mods += [f"nonlinear_optimizer_for_slam_tpu_torch.examples.{e}" for e in EXAMPLES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'nonlinear_optimizer_for_slam_tpu'\n"
        "             or m.startswith('nonlinear_optimizer_for_slam_tpu.'))\n"
        "print(len(bad), bad[:5])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "0 []", proc.stdout
    assert sorted(e for e in os.listdir(os.path.join(
        REPO, "nonlinear_optimizer_for_slam_tpu_torch", "examples"))
        if e.endswith(".py") and e != "__init__.py") == sorted(f"{e}.py" for e in EXAMPLES)
