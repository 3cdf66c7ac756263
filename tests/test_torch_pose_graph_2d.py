"""The port's SE(2) pose graph (``PoseGraphOptimizer2D``, the SE(2) edge
factor, 2-D g2o files) against the JAX package's.

- ``se2_edge_residuals_and_jacobians`` equals JAX's (rtol 1e-12; switches,
  masks, diagonal and full sqrt-information) and ``torch.func.jacfwd`` of
  the port's own ``se2_edge_residual`` (atol 1e-12, as
  tests/test_pose_graph_2d.py holds JAX's); the angle wrap is atan2's at
  +-pi;
- the optimizer by dense, banded, sparse, cg and auto on the 40-pose
  square of tests/test_pose_graph_2d.py (an outlier loop included) and on
  ``generate_manhattan_g2o(n_poses=150, seed=5)`` (tests/test_pose_graph_2d
  .py::test_banded_2d_matches_dense), in float64 on the CPU: LM counts
  equal, poses and switches within 1e-8 of JAX's (CG 1e-6), final cost
  rtol 1e-10, and the same ``last_selection``; banded and sparse with
  ``HuberLoss(1.0)``;
- ``select_solver`` on M3500 (``generate_manhattan_g2o()`` defaults: 3,500
  poses, 10,109 edges) and the 10,000-pose city (``n_poses=10000,
  arena=17, seed=11``) through the optimizer's own plan (leaf 32, the
  dead-reckoned positions as cut coordinates) gives JAX's name and
  numbers: "sparse" on both. Host only, no LM iteration runs;
- 2-D g2o files: each package reads what the other wrote, ``load_pose_graph``
  builds JAX's optimizer (information folded into the sqrt factor) and
  ``save_pose_graph`` writes JAX's text;
- ``interop`` carries ``PoseGraph2DEdges`` and an SE(2) state both ways;
- the ValueErrors are JAX's (``covariance`` and ``solve_batch`` are held
  in tests/test_torch_covariance.py and tests/test_torch_pose_graph_batch.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core import HuberLoss as JHuber
from nonlinear_optimizer_for_slam_tpu.core import Options as JOptions
from nonlinear_optimizer_for_slam_tpu.io import g2o as jg2o
from nonlinear_optimizer_for_slam_tpu.solvers import multifrontal as jmf
from nonlinear_optimizer_for_slam_tpu.solvers import pose_graph as jpg
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.io import g2o as tg2o
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as tpg

TOL = 1e-8
TOL_CG = 1e-6
COST_RTOL = 1e-10
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def _rel(a, b):
    """relative (dx, dy, dtheta) of b in a's frame."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dp = b[:2] - a[:2]
    return np.array([c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1], _wrap(b[2] - a[2])])


@pytest.fixture(scope="module")
def square():
    """tests/test_pose_graph_2d.py's 40-pose square with heading, odometry
    and 2 loops (the second an outlier), as (noisy poses, constraints)."""
    rng = np.random.default_rng(11)
    poses = []
    x = y = th = 0.0
    for _ in range(4):
        for _ in range(10):
            poses.append(np.array([x, y, th]))
            x += 0.5 * np.cos(th)
            y += 0.5 * np.sin(th)
        th = _wrap(th + np.pi / 2)
    poses = np.stack(poses)
    noisy = poses.copy()
    noisy[1:, :2] += 0.05 * rng.normal(size=(39, 2))
    noisy[1:, 2] = _wrap(noisy[1:, 2] + 0.03 * rng.normal(size=39))
    constraints = [(i, i + 1, _rel(poses[i], poses[i + 1]), False, None) for i in range(39)]
    constraints.append((8, 12, _rel(poses[8], poses[12]), True, None))
    constraints.append((38, 2, np.zeros(3), True, None))  # outlier
    return noisy, constraints


@pytest.fixture(scope="module")
def manhattan150():
    """tests/test_pose_graph_2d.py::test_banded_2d_matches_dense's graph:
    loops are the edges spanning >= 20 poses, diagonal information."""
    g, _ = jtesting.generate_manhattan_g2o(n_poses=150, seed=5)
    noisy = np.stack([g.vertices[k] for k in sorted(g.vertices)])
    constraints = [(e.i, e.j, e.measurement, e.j - e.i >= 20, np.sqrt(np.diag(e.information)))
                   for e in g.edges]
    return noisy, constraints


def _build(module, graph, **kw):
    noisy, constraints = graph
    if module == "jax":
        opt, CT = jpg.PoseGraphOptimizer2D(**kw), jpg.ConstraintType
    else:
        opt, CT = tpg.PoseGraphOptimizer2D(device="cpu", **kw), tpg.ConstraintType
    for i in range(len(noisy)):
        opt.set_pose(i, noisy[i])
    opt.set_pose_constant(0)
    for a, b, rel, loop, w in constraints:
        opt.set_constraint(a, b, rel, CT.LOOP if loop else CT.ODOMETRY, sqrt_info=w)
    return opt


def _options(module, max_iterations):
    return (JOptions() if module == "jax" else port.Options()).replace(max_iterations=max_iterations)


def _solve_pair(graph, max_iterations, tol, loss=None, **kw):
    jopt = _build("jax", graph, edge_loss=None if loss is None else JHuber(loss), **kw)
    topt = _build("torch", graph, edge_loss=None if loss is None else port.HuberLoss(loss), **kw)
    js, jsw = jopt.solve(_options("jax", max_iterations))
    ts, tsw = topt.solve(_options("torch", max_iterations))
    assert int(ts.iterations) == int(js.iterations)
    assert bool(ts.converged) == bool(js.converged)
    np.testing.assert_allclose(float(ts.final_cost), float(js.final_cost), rtol=COST_RTOL)
    ids = jopt.pose_indices()
    assert topt.pose_indices() == ids
    got = np.stack([topt.get_pose(i) for i in ids])
    np.testing.assert_allclose(got, np.stack([jopt.get_pose(i) for i in ids]), rtol=0, atol=tol)
    np.testing.assert_allclose(tsw, np.asarray(jsw), rtol=0, atol=tol)
    assert np.all(np.abs(got[:, 2]) <= np.pi)
    assert getattr(topt, "last_solver_choice", None) == getattr(jopt, "last_solver_choice", None)
    assert getattr(topt, "last_selection", None) == getattr(jopt, "last_selection", None)
    return topt, ts, tsw


# ---- the SE(2) edge factor -------------------------------------------------------


def _random_edges(rng, P, E, sqrt_kind):
    ref = rng.integers(0, P, E)
    qry = (ref + 1 + rng.integers(0, P - 1, E)) % P
    sqrt_info = {"none": None, "diag": rng.uniform(1, 3, (E, 3)),
                 "full": np.triu(rng.normal(size=(E, 3, 3))) + 2 * np.eye(3)}[sqrt_kind]
    return dict(
        reference_indices=ref, query_indices=qry,
        relative_xyt=rng.normal(size=(E, 3)) * np.array([1.0, 1.0, 3.0]),
        is_loop=(rng.uniform(size=E) < 0.5).astype(float),
        mask=(rng.uniform(size=E) < 0.9).astype(float),
        sqrt_info=sqrt_info,
    )


@pytest.mark.parametrize("sqrt_kind", ["none", "diag", "full"])
def test_se2_factor_matches_jax(sqrt_kind):
    rng = np.random.default_rng(21)
    P, E = 9, 40
    xyt = rng.normal(size=(P, 3)) * np.array([1.0, 1.0, 3.0])
    fields = _random_edges(rng, P, E, sqrt_kind)
    switches = rng.uniform(0.2, 1.0, E)
    tedges = interop.from_reference(pose_graph_2d_edges=fields, device="cpu", dtype=F64).pose_graph_2d_edges
    jedges = jpg.PoseGraph2DEdges(**{
        k: None if v is None else jnp.asarray(v.astype(np.int32) if "indices" in k else v)
        for k, v in fields.items()
    })
    got = tpg.se2_edge_residuals_and_jacobians(torch.as_tensor(xyt), torch.as_tensor(switches), tedges, 0.05)
    want = jpg.se2_edge_residuals_and_jacobians(jnp.asarray(xyt), jnp.asarray(switches), jedges, 0.05)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


def test_se2_jacobians_match_jacfwd():
    """The closed-form blocks against ``torch.func.jacfwd`` of the port's
    per-edge ``se2_edge_residual`` with the switch and mask applied
    (tests/test_pose_graph_2d.py::test_se2_analytic_jacobians_match_autodiff)."""
    rng = np.random.default_rng(6)
    P, E, penalty = 6, 10, 0.05
    xyt = torch.as_tensor(rng.normal(size=(P, 3)))
    fields = _random_edges(rng, P, E, "none")
    edges = interop.from_reference(pose_graph_2d_edges=fields, device="cpu", dtype=F64).pose_graph_2d_edges
    switches = torch.as_tensor(rng.uniform(0.2, 1.0, E))
    r, J_ref, J_query, J_s = tpg.se2_edge_residuals_and_jacobians(xyt, switches, edges, penalty)
    for e in range(E):
        loop, m = bool(edges.is_loop[e] > 0), edges.mask[e]
        rel = edges.relative_xyt[e]

        def res(a, b, s):
            r3 = tpg.se2_edge_residual(a, b, rel)
            scaled = r3 * s if loop else r3
            pen = (1.0 - s) * penalty if loop else torch.zeros_like(s)
            return torch.cat([scaled, pen[None]]) * m

        a, b = xyt[edges.reference_indices[e]], xyt[edges.query_indices[e]]
        ja, jb, js = torch.func.jacfwd(res, argnums=(0, 1, 2))(a, b, switches[e])
        for got, want in ((r[e], res(a, b, switches[e])), (J_ref[e], ja), (J_query[e], jb), (J_s[e], js)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_angle_wrap_is_atan2():
    """The wrap of the angle row is atan2(sin, cos), JAX's, also at +-pi
    (a remainder would map +pi to -pi)."""
    zero = torch.zeros(3, dtype=F64)
    for dth in (np.pi, -np.pi, 3 * np.pi, 1e-17, 7.5):
        q = torch.tensor([0.0, 0.0, dth], dtype=F64)
        got = float(tpg.se2_edge_residual(zero, q, zero)[2])
        want = float(jpg.se2_edge_residual(jnp.zeros(3), jnp.asarray([0.0, 0.0, dth]), jnp.zeros(3))[2])
        assert got == want, (dth, got, want)


# ---- the optimizer against JAX's ----------------------------------------------------

CASES = [
    ("square", solver, penalty)
    for solver in ("dense", "banded", "sparse", "cg", "auto")
    for penalty in (0.03,)
] + [("manhattan150", solver, 0.03) for solver in ("dense", "banded", "sparse", "cg", "auto")]


@pytest.mark.parametrize("graph, solver, penalty", CASES)
def test_optimizer_matches_jax(square, manhattan150, graph, solver, penalty):
    g = {"square": square, "manhattan150": manhattan150}[graph]
    tol = TOL_CG if solver == "cg" else TOL
    topt, ts, tsw = _solve_pair(g, 60, tol, solver=solver, switch_penalty=penalty)
    if graph == "square":
        assert tsw[0] > 0.5 and tsw[1] < 0.1, tsw  # the outlier switches off
    if solver == "auto":
        assert topt.last_solver_choice == "dense"
    n = int(ts.iterations) + 1
    assert ts.final_cost.device.type == "cpu"
    assert not torch.isnan(ts.records.cost[:n]).any()


@pytest.mark.parametrize("solver", ["banded", "sparse"])
def test_huber_edge_loss_matches_jax(manhattan150, solver):
    _solve_pair(manhattan150, 60, TOL, loss=1.0, solver=solver, switch_penalty=0.03)


def test_sparse_matches_dense_in_the_port(manhattan150):
    """The port's sparse and dense paths on one graph: the same LM trace
    (counts equal, cost rtol 1e-10, poses 1e-9)."""
    out = {}
    for solver in ("dense", "sparse"):
        opt = _build("torch", manhattan150, solver=solver, switch_penalty=0.03)
        summary, sw = opt.solve(_options("torch", 60))
        out[solver] = (summary, sw, np.stack([opt.get_pose(i) for i in range(150)]))
    (sd, swd, pd), (ss, sws, ps) = out["dense"], out["sparse"]
    assert int(ss.iterations) == int(sd.iterations)
    np.testing.assert_allclose(float(ss.final_cost), float(sd.final_cost), rtol=COST_RTOL)
    np.testing.assert_allclose(ps, pd, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sws, swd, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kw", [dict(), dict(n_poses=10000, arena=17, seed=11)], ids=["m3500", "city10000"])
def test_auto_selects_sparse_on_city_graphs_like_jax(kw):
    """The optimizer's "auto" on M3500 and the 10,000-pose city builds its
    plan (leaf 32, positions as cut coordinates) and chooses JAX's family
    with JAX's numbers; the solve runs no LM iteration."""
    g, _ = jtesting.generate_manhattan_g2o(**kw)
    P = len(g.vertices)
    opt = tpg.PoseGraphOptimizer2D(solver="auto", device="cpu")
    for k in sorted(g.vertices):
        opt.set_pose(k, g.vertices[k])
    opt.set_pose_constant(0)
    for e in g.edges:
        opt.set_constraint(e.i, e.j, e.measurement)
    summary, _ = opt.solve(port.Options().replace(max_iterations=0))
    ref = np.array([e.i for e in g.edges], np.int64)
    qry = np.array([e.j for e in g.edges], np.int64)
    coords = np.stack([g.vertices[k][:2] for k in range(P)])
    want = jpg.select_solver(
        P, ref, qry, np.zeros(len(ref)), 3, allow_tridiag=False,
        plan_fn=lambda: jmf.symbolic(P, ref, qry, 3, coords=coords, leaf_size=32),
    )
    assert (opt.last_solver_choice, opt.last_selection) == want
    assert want[0] == "sparse" and int(summary.iterations) == 0
    assert (P, len(ref)) == ((3500, 10109) if not kw else (10000, 28920))


# ---- 2-D g2o files, interop, errors ---------------------------------------------------


def test_g2o_round_trip_load_and_save_match_jax(tmp_path):
    g, _ = jtesting.generate_manhattan_g2o(n_poses=150, seed=5)
    g.edges[3].information = np.array([[400.0, 12.0, 3.0], [12.0, 900.0, -5.0], [3.0, -5.0, 1e4]])
    jpath, tpath = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    jg2o.write_g2o(jpath, g)
    tg2o.write_g2o(tpath, tg2o.read_g2o(jpath))
    assert open(jpath).read() == open(tpath).read()
    for switchable in (False, True):
        topt = tg2o.load_pose_graph(tpath, device="cpu", switchable_loops=switchable, loop_closure_gap=20)
        jopt = jg2o.load_pose_graph(jpath, switchable_loops=switchable, loop_closure_gap=20)
        assert isinstance(topt, tpg.PoseGraphOptimizer2D)
        assert topt.pose_indices() == jopt.pose_indices() and topt._constant == jopt._constant
        assert topt.switch_penalty == jopt.switch_penalty
        for i in jopt.pose_indices():
            assert np.array_equal(topt.get_pose(i), jopt.get_pose(i))
        for a, b in zip(topt.constraints(), jopt.constraints(), strict=True):
            assert (a["reference_index"], a["query_index"], a["type"]) == (
                b["reference_index"], b["query_index"], b["type"])
            assert np.array_equal(a["relative_xyt"], b["relative_xyt"])
            assert np.array_equal(a["sqrt_info"], b["sqrt_info"])
    for graph in (None, g):
        tout, jout = tmp_path / "to.g2o", tmp_path / "jo.g2o"
        tg2o.save_pose_graph(str(tout), topt, graph)
        jg2o.save_pose_graph(str(jout), jopt, graph)
        assert tout.read_text() == jout.read_text()


def test_interop_carries_se2_edges_and_state():
    rng = np.random.default_rng(8)
    fields = _random_edges(rng, 7, 11, "full")
    state = dict(xyt=rng.normal(size=(7, 3)), switches=rng.uniform(size=3))
    ps = interop.from_reference(pose_graph_2d_edges=fields, pose_graph_2d_state=state,
                                device="cpu", dtype=F64)
    assert isinstance(ps.pose_graph_2d_edges, tpg.PoseGraph2DEdges)
    assert ps.pose_graph_2d_edges.reference_indices.dtype == torch.int64
    back = interop.to_reference(ps)
    assert set(back) == {"pose_graph_2d_edges", "pose_graph_2d_state"}
    for k, v in fields.items():
        assert np.array_equal(back["pose_graph_2d_edges"][k], v), k
    for k, v in state.items():
        assert np.array_equal(back["pose_graph_2d_state"][k], v), k


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_unported_parts_raise_and_errors_match_jax(square):
    opt = _build("torch", square)
    for kw in (dict(solver="tridiag"), dict(cg_precond="bogus")):
        assert _error(lambda: tpg.PoseGraphOptimizer2D(device="cpu", **kw)) == _error(
            lambda: jpg.PoseGraphOptimizer2D(**kw))
    empty = {"torch": tpg.PoseGraphOptimizer2D(device="cpu"), "jax": jpg.PoseGraphOptimizer2D()}
    for o in empty.values():
        o.set_pose(0, np.zeros(3))
    assert _error(empty["torch"].solve) == _error(empty["jax"].solve)
    assert _error(lambda: opt.set_constraint(0, 1, np.zeros(3), sqrt_info=np.ones(4))) == _error(
        lambda: _build("jax", square).set_constraint(0, 1, np.zeros(3), sqrt_info=np.ones(4)))
    with pytest.raises(ValueError, match="self-constraint"):
        opt.set_constraint(3, 3, np.zeros(3))
    with pytest.raises(KeyError):
        opt.set_pose_constant(999)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpg.PoseGraphOptimizer2D()
