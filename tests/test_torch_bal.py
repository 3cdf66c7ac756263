"""The port's BAL IO and Snavely-model solver (``io/bal.py``,
``solvers/bal.py``, ``utils/anchor_np.py``) against the JAX package's.

First the 11 tests of tests/test_bal.py and the two BAL anchors of
tests/test_external_anchor.py (the final cost against scipy's
least_squares through the port's ``anchor_np``, rel 1e-4; the Jacobians
against torch.autograd of an independent residual, rtol 1e-8) on the
port, on the CPU in float64, with the same problems and bounds.

Then parity with the JAX package, float64 on both sides:

- ``synthetic_bal_problem`` generates exactly JAX's problem, and each
  package reads the file the other wrote (``write_bal`` text equal);
- ``snavely_residual`` and its Jacobians with respect to the camera and
  the point, at ordinary rotations and at rod = 0, within rtol 1e-12 of
  the largest entry of JAX's (``jax.jacfwd``);
- ``bal_cost`` within rtol 1e-12, and ``solve_bal`` dense, chunked
  (``landmark_chunk=37``) and iterative (80 PCG iterations): LM iteration
  counts equal, every recorded cost and the final cost within rtol 1e-10,
  cameras and points within 1e-8 of JAX's;
- a ``BALProblem`` carried across by ``interop`` is the same problem.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle, Options
from nonlinear_optimizer_for_slam_tpu_torch.io import bal as bal_io
from nonlinear_optimizer_for_slam_tpu_torch.solvers import bal as bal_solver
from nonlinear_optimizer_for_slam_tpu_torch.utils import anchor_np

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the solves are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def solve(problem, options=None, **kw):
    return bal_solver.solve_bal(problem, options, device="cpu", **kw)


def cost(problem):
    return bal_solver.bal_cost(problem, device="cpu")


@pytest.fixture(scope="module")
def problem_pair():
    return bal_io.synthetic_bal_problem(
        num_cameras=8, num_points=150, observations_per_point=4, seed=3
    )


# ---- tests/test_bal.py on the port -------------------------------------------


def test_bal_roundtrip(tmp_path, problem_pair):
    noisy, _ = problem_pair
    path = str(tmp_path / "prob.txt")
    bal_io.write_bal(path, noisy)
    back = bal_io.read_bal(path)
    assert back.num_cameras == noisy.num_cameras
    assert back.num_points == noisy.num_points
    assert back.num_observations == noisy.num_observations
    np.testing.assert_array_equal(back.camera_indices, noisy.camera_indices)
    np.testing.assert_array_equal(back.point_indices, noisy.point_indices)
    np.testing.assert_allclose(back.camera_params, noisy.camera_params, rtol=1e-15)
    np.testing.assert_allclose(back.points, noisy.points, rtol=1e-15)
    np.testing.assert_allclose(back.observations, noisy.observations, rtol=1e-15)


def test_bal_reader_rejects_malformed(tmp_path):
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("1 1 1\n0 0 1.0 2.0\n1.0 2.0\n")  # far too few params
    with pytest.raises(ValueError):
        bal_io.read_bal(path)


def test_snavely_torch_matches_numpy(problem_pair):
    """The PyTorch residual (solver) and the numpy projector (generator)
    are independent implementations of the same model."""
    noisy, _ = problem_pair
    cams = noisy.camera_params[noisy.camera_indices]
    pts = noisy.points[noisy.point_indices]
    want = bal_io.snavely_project(cams, pts)
    got = torch.func.vmap(bal_solver.snavely_residual)(
        torch.tensor(cams), torch.tensor(pts), torch.zeros((cams.shape[0], 2), dtype=F64)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_snavely_rodrigues_small_angle():
    """The small-angle branch: rotation by ~0 is the identity and the
    Jacobian is finite there, -skew(x)."""
    x = torch.tensor([0.3, -0.2, 1.4], dtype=F64)
    zero = torch.zeros(3, dtype=F64)
    np.testing.assert_allclose(bal_solver._rodrigues_rotate(zero, x).numpy(), x.numpy(),
                               rtol=1e-15)
    J = torch.func.jacfwd(bal_solver._rodrigues_rotate)(zero, x).numpy()
    assert np.all(np.isfinite(J))
    skew = np.array([[0, -1.4, -0.2], [1.4, 0, -0.3], [0.2, 0.3, 0]])
    np.testing.assert_allclose(J, -skew, atol=1e-6)


def test_solve_bal_converges(problem_pair):
    """The cost drops from the perturbed start to (near) the pixel-noise
    floor; the ground-truth cost bounds the achievable minimum from
    above."""
    noisy, truth = problem_pair
    c_init, c_truth = cost(noisy), cost(truth)
    solved, summary = solve(noisy, Options().replace(max_iterations=50))
    c_final = cost(solved)
    assert c_final < 0.05 * c_init
    assert c_final <= c_truth * (1.0 + 1e-6)
    assert int(summary.iterations) <= 50
    rec = summary.records.cost.numpy()
    rec = rec[np.isfinite(rec)]
    assert rec.size >= 2
    assert rec.min() <= c_init


def test_solve_bal_chunked_matches_dense(problem_pair):
    """The landmark-chunked cross term is the same math as the dense
    (C, P, 9, 3) product: same trajectory, same parameters."""
    noisy, _ = problem_pair
    opts = Options().replace(max_iterations=25)
    dense, dsum = solve(noisy, opts)
    chunked, csum = solve(noisy, opts, landmark_chunk=37)
    assert int(dsum.iterations) == int(csum.iterations)
    np.testing.assert_allclose(chunked.camera_params, dense.camera_params, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(chunked.points, dense.points, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(csum.records.cost.numpy(), dsum.records.cost.numpy(),
                               rtol=1e-10, equal_nan=True)


def test_solve_bal_auto_chunk_threshold(monkeypatch):
    """Auto chunk selection kicks in above the dense-cross budget and still
    solves (small problem, tiny budget; P above the 128-landmark chunk
    floor so that the chunked branch runs)."""
    noisy, _ = bal_io.synthetic_bal_problem(
        num_cameras=6, num_points=200, observations_per_point=3, seed=9
    )
    monkeypatch.setattr(bal_solver, "_DENSE_CROSS_BUDGET_BYTES", 64 * 1024)
    chunk = max(128, bal_solver._DENSE_CROSS_BUDGET_BYTES // (2 * 6 * 27 * 8))
    assert chunk < noisy.num_points, "fixture no longer forces chunking"
    solved, _ = solve(noisy, Options().replace(max_iterations=30))
    assert cost(solved) < 0.05 * cost(noisy)


def test_read_bal_rejects_negative_indices(tmp_path):
    """Negative observation indices raise instead of wrapping."""
    prob, _ = bal_io.synthetic_bal_problem(
        num_cameras=3, num_points=10, observations_per_point=2, seed=1
    )
    path = tmp_path / "neg.txt"
    bal_io.write_bal(path, prob)
    text = path.read_text().split("\n")
    parts = text[1].split()
    parts[0] = "-1"
    text[1] = " ".join(parts)
    path.write_text("\n".join(text))
    with pytest.raises(ValueError, match="out of range"):
        bal_io.read_bal(path)


def test_solve_bal_iterative_schur_matches_dense(problem_pair):
    """ITERATIVE_SCHUR reaches the dense-Schur final cost to rel 1e-6."""
    noisy, _ = problem_pair
    opts = Options().replace(max_iterations=40)
    dense, _ = solve(noisy, opts)
    it, _ = solve(noisy, opts, schur="iterative", schur_iterations=80)
    np.testing.assert_allclose(cost(it), cost(dense), rtol=1e-6)


def test_solve_bal_iterative_schur_rejects_unknown_mode(problem_pair):
    noisy, _ = problem_pair
    with pytest.raises(ValueError, match="schur"):
        solve(noisy, schur="sparse")


def test_bal_plateau_summary_and_best_state(problem_pair):
    """The monotone safeguard on the BAL loop: with the plateau stop on,
    plateau_stop and best_cost are reported, the returned state's cost is
    final_cost, and final_cost is the monotone best; default options
    leave the fields None."""
    noisy, _ = problem_pair
    _, s_plain = solve(noisy, Options().replace(max_iterations=5))
    assert s_plain.plateau_stop is None and s_plain.best_cost is None
    opts = dataclasses.replace(
        Options().replace(max_iterations=60),
        convergence_handle=ConvergenceHandle(
            gradient_tolerance=0.0, parameter_tolerance=0.0, relative_function_tolerance=1e-7,
        ),
    )
    solved, s = solve(noisy, opts)
    assert bool(s.converged)
    assert s.plateau_stop is not None and bool(s.plateau_stop)
    rec = s.records.cost.numpy()
    rec = rec[np.isfinite(rec)]
    assert float(s.best_cost) <= rec.min() * (1 + 1e-12)
    np.testing.assert_allclose(cost(solved), float(s.final_cost), rtol=1e-9)
    np.testing.assert_allclose(float(s.final_cost), float(s.best_cost), rtol=0)


# ---- tests/test_external_anchor.py's BAL anchors on the port -----------------


@pytest.fixture(scope="module")
def bal_problem():
    return bal_io.synthetic_bal_problem(
        num_cameras=8, num_points=150, observations_per_point=4, seed=7
    )


def test_bal_final_cost_matches_scipy(bal_problem):
    """The port's Schur/LM solver and scipy's trust-region solver (the
    port's ``anchor_np``) reach the same minimum of the same objective;
    both report 0.5 sum r^2."""
    noisy, _ = bal_problem
    solved, _ = solve(noisy, Options().replace(max_iterations=60))
    ours = cost(solved)
    theirs = float(anchor_np.scipy_solve_bal(noisy).cost)
    assert ours == pytest.approx(theirs, rel=1e-4), (ours, theirs)
    assert ours < 0.05 * cost(noisy)


def test_bal_jacobian_matches_torch(bal_problem):
    """The solver's Jacobians (``torch.func.jacfwd``, forward mode) against
    torch.autograd (reverse mode) of an independently written residual."""
    noisy, _ = bal_problem
    rng = np.random.default_rng(5)
    sel = rng.choice(noisy.num_observations, size=16, replace=False)

    def torch_residual(cam, pt, uv):
        rod, t = cam[0:3], cam[3:6]
        theta = torch.linalg.norm(rod)
        if float(theta.detach()) < 1e-12:
            Rx = pt
        else:
            axis = rod / theta
            Rx = (pt * torch.cos(theta) + torch.linalg.cross(axis, pt) * torch.sin(theta)
                  + axis * (axis @ pt) * (1.0 - torch.cos(theta)))
        P = Rx + t
        p = -P[:2] / P[2]
        r2 = p @ p
        return cam[6] * (1.0 + cam[7] * r2 + cam[8] * r2 * r2) * p - uv

    cams = torch.tensor(noisy.camera_params[noisy.camera_indices[sel]])
    pts = torch.tensor(noisy.points[noisy.point_indices[sel]])
    obs = torch.tensor(noisy.observations[sel])
    _, Jc, Jl = bal_solver._res_and_jac(cams, pts, obs)
    for o in range(len(sel)):
        Jc_t, Jl_t = torch.autograd.functional.jacobian(
            lambda c, x: torch_residual(c, x, obs[o]), (cams[o], pts[o])
        )
        np.testing.assert_allclose(Jc[o].numpy(), Jc_t.numpy(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(Jl[o].numpy(), Jl_t.numpy(), rtol=1e-8, atol=1e-10)


# ---- parity with the JAX package ---------------------------------------------


def test_generator_and_files_match_jax(tmp_path):
    from nonlinear_optimizer_for_slam_tpu.io import bal as jio

    for kw in (dict(num_cameras=8, num_points=150, observations_per_point=4, seed=3),
               dict(num_cameras=5, num_points=40, observations_per_point=3, seed=11)):
        for got, want in zip(bal_io.synthetic_bal_problem(**kw), jio.synthetic_bal_problem(**kw)):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    prob, _ = bal_io.synthetic_bal_problem(num_cameras=4, num_points=30, seed=2)
    mine, theirs = tmp_path / "port.txt.gz", tmp_path / "jax.txt.gz"
    bal_io.write_bal(str(mine), prob)
    jio.write_bal(str(theirs), jio.BALProblem(*prob))
    import gzip

    assert gzip.open(mine, "rt").read() == gzip.open(theirs, "rt").read()
    for a, b in zip(bal_io.read_bal(str(theirs)), jio.read_bal(str(mine))):
        assert np.array_equal(a, b)
    assert bal_io._rodrigues_from_matrix(np.eye(3)).tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("at_zero", [False, True], ids=["ordinary", "rod_zero"])
def test_residual_and_jacobians_match_jax(problem_pair, at_zero):
    import jax
    import jax.numpy as jnp

    from nonlinear_optimizer_for_slam_tpu.solvers import bal as jbal

    noisy, _ = problem_pair
    cams = noisy.camera_params[noisy.camera_indices].copy()
    if at_zero:
        cams[:, :3] = 0.0
    pts = noisy.points[noisy.point_indices]
    obs = noisy.observations
    want = jax.vmap(lambda c, x, o: (jbal.snavely_residual(c, x, o),
                                     *jax.jacfwd(jbal.snavely_residual, argnums=(0, 1))(c, x, o)))(
        jnp.asarray(cams), jnp.asarray(pts), jnp.asarray(obs))
    got = bal_solver._res_and_jac(torch.tensor(cams), torch.tensor(pts), torch.tensor(obs))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())


@pytest.mark.parametrize("kw", [dict(), dict(landmark_chunk=37),
                                dict(schur="iterative", schur_iterations=80)],
                         ids=["dense", "chunked", "iterative"])
def test_solve_bal_matches_jax(problem_pair, kw):
    from nonlinear_optimizer_for_slam_tpu.core import Options as JOptions
    from nonlinear_optimizer_for_slam_tpu.io import bal as jio
    from nonlinear_optimizer_for_slam_tpu.solvers import bal as jbal

    noisy, _ = problem_pair
    jprob = jio.BALProblem(*noisy)
    np.testing.assert_allclose(cost(noisy), jbal.bal_cost(jprob), rtol=1e-12)
    jsolved, jsum = jbal.solve_bal(jprob, JOptions().replace(max_iterations=25), **kw)
    solved, summary = solve(noisy, Options().replace(max_iterations=25), **kw)
    assert int(summary.iterations) == int(jsum.iterations)
    np.testing.assert_allclose(summary.records.cost.numpy(), np.asarray(jsum.records.cost),
                               rtol=1e-10, equal_nan=True)
    np.testing.assert_allclose(float(summary.final_cost), float(jsum.final_cost), rtol=1e-10)
    np.testing.assert_allclose(solved.camera_params, jsolved.camera_params, rtol=0, atol=1e-8)
    np.testing.assert_allclose(solved.points, jsolved.points, rtol=0, atol=1e-8)


def test_interop_carries_a_bal_problem(problem_pair):
    """A JAX ``BALProblem`` carried across by ``interop.from_reference``
    is the same problem (arrays equal, ``bal_cost`` rtol 1e-12 of JAX's)
    and goes back by ``to_reference`` exactly."""
    from nonlinear_optimizer_for_slam_tpu.io import bal as jio
    from nonlinear_optimizer_for_slam_tpu.solvers import bal as jbal
    from nonlinear_optimizer_for_slam_tpu_torch import interop

    jprob = jio.BALProblem(*problem_pair[0])
    state = interop.from_reference(
        bal_problem={f: np.asarray(v) for f, v in zip(jprob._fields, jprob)}, device="cpu"
    )
    for a, b in zip(state.bal_problem, jprob):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(cost(state.bal_problem), jbal.bal_cost(jprob), rtol=1e-12)
    back = interop.to_reference(state)["bal_problem"]
    for f, v in zip(jprob._fields, jprob):
        assert np.array_equal(back[f], v), f
