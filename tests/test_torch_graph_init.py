"""The port's pose-graph initializers (``solvers/graph_init.py``) and
``initialize()`` against the JAX package's.

- ``spanning_tree_init`` (the 80-pose fixture, odometry-first and in edge
  order) and ``spanning_tree_init_2d`` (a 150-pose Manhattan world) equal
  JAX's exactly (the same host BFS);
- ``chordal_init`` (a 120-pose 3-D chain with loops, two anchors) and
  ``chordal_init_2d`` (the Manhattan world) in float64 within 1e-9 of
  JAX's, with the anchors returned bit for bit; ``_project_so3`` within
  1e-12 of JAX's (cuSOLVER and LAPACK may pick other singular-vector signs;
  U D V^T does not depend on them);
- ``initialize()`` on both optimizers, every method, with and without
  loops: within 1e-9 of JAX's in float64 (the 3-D default, float32 CG, as
  JAX's: within 1e-4);
- ``initialize(method="chordal")`` then the sparse solve on
  ``generate_manhattan_g2o(n_poses=400, seed=3)`` read back from a g2o
  file: the bounds of tests/test_pose_graph_2d.py::
  test_manhattan_world_g2o_roundtrip_and_solve (max error < 0.15 of the
  dead-reckoned start's, mean error < 0.1 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.io import g2o as jg2o
from nonlinear_optimizer_for_slam_tpu.solvers import graph_init as jgi
from nonlinear_optimizer_for_slam_tpu.solvers import pose_graph as jpg
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_quat_to_rotmat, np_rotmat_to_quat
from nonlinear_optimizer_for_slam_tpu_torch.io import g2o as tg2o
from nonlinear_optimizer_for_slam_tpu_torch.solvers import graph_init as tgi
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as tpg

TOL = 1e-9  # float64 chordal against JAX
TOL_F32 = 1e-4  # the 3-D default: float32 CG in both packages


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture_edges():
    _, noisy, constraints = jtesting.generate_pose_graph_fixture()
    ref = np.array([c["reference_index"] for c in constraints], np.int32)
    qry = np.array([c["query_index"] for c in constraints], np.int32)
    rel_t = np.stack([c["relative_pose"].translation for c in constraints])
    rel_q = np.stack([c["relative_pose"].quaternion() for c in constraints])
    is_loop = np.array([1.0 if c["is_loop"] else 0.0 for c in constraints])
    return noisy, ref, qry, rel_t, rel_q, is_loop


def _chain_3d():
    """120 poses with random rotations, odometry and 30 loops; poses 0 and
    70 anchored at their true values."""
    rng = np.random.default_rng(12)
    P = 120
    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.stack([np_quat_to_rotmat(qi) for qi in q])
    t = np.cumsum(rng.normal(size=(P, 3)), axis=0)
    pairs = [(i, i + 1) for i in range(P - 1)]
    pairs += [tuple(sorted(rng.choice(P, 2, replace=False))) for _ in range(30)]
    ref = np.array([a for a, _ in pairs], np.int32)
    qry = np.array([b for _, b in pairs], np.int32)
    noise = lambda s: s * rng.normal(size=3)
    small = lambda: np_quat_to_rotmat(np.concatenate([[1.0], noise(0.01)]) / np.sqrt(1 + 1e-4))
    rel_R = [R[a].T @ R[b] @ small() for a, b in pairs]
    rel_q = np.stack([np_rotmat_to_quat(r) for r in rel_R])
    rel_t = np.stack([R[a].T @ (t[b] - t[a]) + noise(0.05) for a, b in pairs])
    anchors = {0: (R[0], t[0]), 70: (R[70], t[70])}
    return ref, qry, rel_q, rel_t, P, anchors


def _manhattan(n_poses=150, seed=5):
    g, gt = jtesting.generate_manhattan_g2o(n_poses=n_poses, seed=seed)
    ref = np.array([e.i for e in g.edges], np.int32)
    qry = np.array([e.j for e in g.edges], np.int32)
    rel = np.stack([e.measurement for e in g.edges])
    is_loop = (qry - ref >= 20).astype(np.float64)
    return g, gt, ref, qry, rel, is_loop


@pytest.mark.parametrize("priority", [True, False])
def test_spanning_tree_matches_jax_exactly(priority):
    noisy, ref, qry, rel_t, rel_q, is_loop = _fixture_edges()
    anchors = {0: (noisy[0].rotation, noisy[0].translation)}
    kw = dict(edge_priority=is_loop if priority else None)
    got = tgi.spanning_tree_init(ref, qry, rel_q, rel_t, 80, anchors, **kw)
    want = jgi.spanning_tree_init(ref, qry, rel_q, rel_t, 80, anchors, **kw)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g, w)
    g, _, ref, qry, rel, is_loop = _manhattan()
    anchors = {0: g.vertices[0], 75: g.vertices[75]}
    got = tgi.spanning_tree_init_2d(ref, qry, rel, 150, anchors, **kw)
    assert np.array_equal(got, jgi.spanning_tree_init_2d(ref, qry, rel, 150, anchors, **kw))


def test_chordal_init_matches_jax():
    ref, qry, rel_q, rel_t, P, anchors = _chain_3d()
    t, q = tgi.chordal_init(ref, qry, rel_q, rel_t, P, anchors, device="cpu")
    jt, jq = jgi.chordal_init(ref, qry, rel_q, rel_t, P, anchors, dtype=jnp.float64)
    np.testing.assert_allclose(t, jt, rtol=0, atol=TOL)
    np.testing.assert_allclose(q, jq, rtol=0, atol=TOL)
    for a, (Ra, ta) in anchors.items():
        assert np.array_equal(t[a], ta)
        assert np.array_equal(q[a], jq[a])
    # float32 CG in both packages
    t32, q32 = tgi.chordal_init(ref, qry, rel_q, rel_t, P, anchors, dtype=torch.float32, device="cpu")
    jt32, jq32 = jgi.chordal_init(ref, qry, rel_q, rel_t, P, anchors, dtype=jnp.float32)
    np.testing.assert_allclose(t32, jt32, rtol=0, atol=TOL_F32 * np.abs(jt).max())
    np.testing.assert_allclose(q32, jq32, rtol=0, atol=TOL_F32)


def test_chordal_init_2d_matches_jax():
    g, _, ref, qry, rel, _ = _manhattan()
    anchors = {0: g.vertices[0]}
    got = tgi.chordal_init_2d(ref, qry, rel, 150, anchors, device="cpu")
    want = jgi.chordal_init_2d(ref, qry, rel, 150, anchors)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.array_equal(got[0], g.vertices[0])


def test_project_so3_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 3, 3))
    X[:8] = -np.eye(3) + 0.1 * rng.normal(size=(8, 3, 3))  # det(U V^T) = -1
    got = tgi._project_so3(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgi._project_so3(jnp.asarray(X))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-12)


def _fixture_optimizers():
    noisy, ref, qry, rel_t, rel_q, is_loop = _fixture_edges()
    _, _, constraints = jtesting.generate_pose_graph_fixture()
    out = {}
    for module in ("jax", "torch"):
        if module == "jax":
            opt, Pose = jpg.PoseGraphOptimizer(switch_penalty=0.03), nls.Pose
        else:
            opt, Pose = tpg.PoseGraphOptimizer(switch_penalty=0.03, device="cpu"), port.Pose
        for i, p in enumerate(noisy):
            opt.set_pose(i, Pose(p.rotation, p.translation))
        opt.set_pose_constant(0)
        for c in constraints:
            rel = c["relative_pose"]
            opt.set_constraint(c["reference_index"], c["query_index"],
                               Pose(rel.rotation, rel.translation), int(c["is_loop"]))
        out[module] = opt
    return out


@pytest.mark.parametrize("method, include_loops, f64", [
    ("chordal", True, True), ("chordal", False, True), ("chordal", True, False),
    ("spanning_tree", True, True), ("spanning_tree", False, True),
])
def test_initialize_3d_matches_jax(method, include_loops, f64):
    opts = _fixture_optimizers()
    kw = dict(method=method, include_loops=include_loops)
    if method == "chordal" and f64:
        opts["jax"].initialize(init_dtype=jnp.float64, **kw)
        opts["torch"].initialize(init_dtype=torch.float64, **kw)
    else:
        opts["jax"].initialize(**kw)
        opts["torch"].initialize(**kw)
    tol = TOL if f64 else TOL_F32
    for i in range(80):
        got, want = opts["torch"].get_pose(i), opts["jax"].get_pose(i)
        np.testing.assert_allclose(got.translation, want.translation, rtol=0, atol=tol)
        np.testing.assert_allclose(got.rotation, want.rotation, rtol=0, atol=tol)


@pytest.mark.parametrize("method, include_loops", [
    ("chordal", True), ("chordal", False), ("spanning_tree", True),
])
def test_initialize_2d_matches_jax(method, include_loops):
    g, _, ref, qry, rel, is_loop = _manhattan()
    out = {}
    for module in ("jax", "torch"):
        opt = (jpg.PoseGraphOptimizer2D() if module == "jax"
               else tpg.PoseGraphOptimizer2D(device="cpu"))
        for k in sorted(g.vertices):
            opt.set_pose(k, g.vertices[k])
        opt.set_pose_constant(0)
        for a, b, m, loop in zip(ref, qry, rel, is_loop):
            opt.set_constraint(int(a), int(b), m, int(loop))
        opt.initialize(method=method, include_loops=include_loops)
        out[module] = np.stack([opt.get_pose(k) for k in range(150)])
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=TOL)


def test_initialize_rejects_unknown_method():
    opts = _fixture_optimizers()
    messages = []
    for opt in (opts["torch"], opts["jax"]):
        with pytest.raises(ValueError) as info:
            opt.initialize(method="bogus")
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_manhattan_chordal_then_sparse_solve(tmp_path):
    """The M3500 flow at 400 poses: g2o file -> load_pose_graph ->
    initialize(method="chordal") -> the sparse solve, under the bounds of
    tests/test_pose_graph_2d.py::test_manhattan_world_g2o_roundtrip_and_solve
    (whose JAX run goes through CG)."""
    g, gt = jtesting.generate_manhattan_g2o(n_poses=400, seed=3)
    assert sum(1 for e in g.edges if e.j - e.i >= 20) > 50
    path = str(tmp_path / "manhattan.g2o")
    jg2o.write_g2o(path, g)
    opt = tg2o.load_pose_graph(path, solver="sparse", device="cpu")
    init_err = max(np.linalg.norm(g.vertices[k][:2] - gt[k, :2]) for k in g.vertices)
    opt.initialize(method="chordal")
    summary, _ = opt.solve(port.Options().replace(max_iterations=80))
    errs = [np.linalg.norm(opt.get_pose(k)[:2] - gt[k, :2]) for k in range(len(gt))]
    assert opt.last_solver_choice == "sparse"
    assert init_err > 1.0, init_err  # the fixture genuinely drifts
    assert max(errs) < 0.15 * init_err, (max(errs), init_err)
    assert np.mean(errs) < 0.1, np.mean(errs)
    assert np.isfinite(float(summary.final_cost))
