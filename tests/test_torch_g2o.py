"""The port's g2o IO, pose-graph fixtures and pose-graph interop against
the JAX package.

- ``generate_pose_graph_fixture``, ``generate_sphere_g2o`` (full size
  and 5 rings of 20) and ``generate_manhattan_g2o`` (M3500, the
  10,000-pose city, 400 poses) generate exactly what the JAX copies
  generate;
- ``write_g2o`` and ``read_g2o`` round-trip a small sphere and a 3-D file
  with full information matrices, fixed vertices and landmark records:
  each package reads what the other wrote, equal to 9 significant digits
  (the ``%.9g`` of the format), and the two writers write the same text;
  2-D files read alike;
- ``load_pose_graph`` builds the same optimizer as JAX's (poses,
  constraint types and whitening, gauge, switch penalty) with and without
  ``switchable_loops`` and ``unit_information``; a 2-D file loads into
  JAX's ``PoseGraphOptimizer2D`` and a 2-D file with landmark records
  into a ``PoseLandmark2DOptimizer`` like JAX's; ``save_pose_graph``
  writes JAX's text;
- ``interop`` carries ``PoseGraphEdges`` (sqrt_info None, diagonal, full)
  and a pose-graph state onto the device and back exactly.
"""

import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.io import g2o as jg2o
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.io import g2o as tg2o
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing as ttesting


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_graphs_equal(a, b, rtol=0.0):
    assert a.dim == b.dim and a.fixed == b.fixed
    assert sorted(a.vertices) == sorted(b.vertices)
    for k in a.vertices:
        np.testing.assert_allclose(a.vertices[k], b.vertices[k], rtol=rtol, atol=0)
    assert sorted(a.landmarks) == sorted(b.landmarks)
    for k in a.landmarks:
        np.testing.assert_allclose(a.landmarks[k], b.landmarks[k], rtol=rtol, atol=0)
    for ea, eb in ((x, y) for es in ("edges", "landmark_edges")
                   for x, y in zip(getattr(a, es), getattr(b, es), strict=True)):
        assert (ea.i, ea.j) == (eb.i, eb.j)
        np.testing.assert_allclose(ea.measurement, eb.measurement, rtol=rtol, atol=0)
        np.testing.assert_allclose(ea.information, eb.information, rtol=rtol, atol=0)


def test_pose_graph_fixture_is_the_jax_fixture():
    got, want = ttesting.generate_pose_graph_fixture(), jtesting.generate_pose_graph_fixture()
    for g_poses, w_poses in zip(got[:2], want[:2]):
        for a, b in zip(g_poses, w_poses, strict=True):
            assert np.array_equal(a.rotation, b.rotation)
            assert np.array_equal(a.translation, b.translation)
    for a, b in zip(got[2], want[2], strict=True):
        assert (a["reference_index"], a["query_index"], a["is_loop"]) == (
            b["reference_index"], b["query_index"], b["is_loop"])
        assert np.array_equal(a["relative_pose"].matrix(), b["relative_pose"].matrix())


@pytest.mark.parametrize("kw", [{}, dict(n_rings=5, per_ring=20)])
def test_sphere_generator_is_the_jax_generator(kw):
    (got, got_gt), (want, want_gt) = ttesting.generate_sphere_g2o(**kw), jtesting.generate_sphere_g2o(**kw)
    assert np.array_equal(got_gt, want_gt)
    _assert_graphs_equal(got, want)
    if not kw:
        assert (len(got.vertices), len(got.edges)) == (2500, 4899)


@pytest.fixture(scope="module")
def full_info_graph(rng):
    """A 3-D graph with random full information matrices, a FIX record,
    and landmark records."""
    g = jg2o.G2oGraph(dim=3)
    for k in range(6):
        q = rng.normal(size=4)
        g.vertices[k] = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 1), (0, 3)]:
        q = rng.normal(size=4)
        A = rng.normal(size=(6, 6))
        g.edges.append(jg2o.G2oEdge(
            i, j, np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)]), A @ A.T + np.eye(6)
        ))
    g.fixed.update({0, 2})
    return g


def test_round_trip_against_jax(tmp_path, full_info_graph, rng):
    small, _ = jtesting.generate_sphere_g2o(n_rings=5, per_ring=20)
    landmarks = jg2o.G2oGraph(dim=3, vertices=dict(full_info_graph.vertices))
    landmarks.landmarks[100] = rng.normal(size=3)
    B = rng.normal(size=(3, 3))
    landmarks.landmark_edges.append(jg2o.G2oEdge(1, 100, rng.normal(size=3), B @ B.T + np.eye(3)))
    for name, graph in (("sphere", small), ("full_info", full_info_graph), ("landmarks", landmarks)):
        jpath, tpath = tmp_path / f"{name}_jax.g2o", tmp_path / f"{name}_torch.g2o"
        jg2o.write_g2o(str(jpath), graph)
        tg2o.write_g2o(str(tpath), tg2o.G2oGraph(
            graph.dim, dict(graph.vertices),
            [tg2o.G2oEdge(e.i, e.j, e.measurement, e.information) for e in graph.edges],
            set(graph.fixed), dict(graph.landmarks),
            [tg2o.G2oEdge(e.i, e.j, e.measurement, e.information) for e in graph.landmark_edges],
        ))
        assert tpath.read_text() == jpath.read_text()
        _assert_graphs_equal(tg2o.read_g2o(str(jpath)), jg2o.read_g2o(str(jpath)))
        _assert_graphs_equal(tg2o.read_g2o(str(tpath)), graph, rtol=1e-8)


def test_two_dimensional_files_read_alike_and_do_not_load(tmp_path):
    """2-D files read alike and load into JAX's PoseGraphOptimizer2D (the
    SE(2) optimizer is ported; before it was, they did not load); a 2-D
    file with landmark records loads into a PoseLandmark2DOptimizer with
    JAX's records (the pose-landmark optimizers are ported; before they
    were, it raised NotImplementedError)."""
    path = tmp_path / "planar.g2o"
    path.write_text(
        "VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0.1\nVERTEX_SE2 2 2 0.1 0.2\n"
        "EDGE_SE2 0 1 1 0 0.1 10 0 0 10 0 100\nEDGE_SE2 1 2 1 0.1 0.1 10 0 0 10 0 100\nFIX 0\n"
    )
    _assert_graphs_equal(tg2o.read_g2o(str(path)), jg2o.read_g2o(str(path)))
    topt = tg2o.load_pose_graph(str(path), device="cpu")
    jopt = jg2o.load_pose_graph(str(path))
    assert type(topt).__name__ == type(jopt).__name__ == "PoseGraphOptimizer2D"
    for i in range(3):
        assert np.array_equal(topt.get_pose(i), jopt.get_pose(i))
    for a, b in zip(topt.constraints(), jopt.constraints(), strict=True):
        assert np.array_equal(a["sqrt_info"], b["sqrt_info"])
    landmarks = tmp_path / "landmarks.g2o"
    landmarks.write_text(path.read_text() + "VERTEX_XY 7 1 2\nEDGE_SE2_XY 1 7 0 2 1 0 1\n")
    topt = tg2o.load_pose_graph(str(landmarks), device="cpu")
    jopt = jg2o.load_pose_graph(str(landmarks))
    assert type(topt).__name__ == type(jopt).__name__ == "PoseLandmark2DOptimizer"
    assert np.array_equal(topt.get_landmark(7), jopt.get_landmark(7))
    for a, b in zip(topt.observations(), jopt.observations(), strict=True):
        assert (a["pose_index"], a["landmark_index"]) == (b["pose_index"], b["landmark_index"])
        assert np.array_equal(a["measurement"], b["measurement"])
        assert np.array_equal(a["sqrt_info"], b["sqrt_info"])
    bad = tmp_path / "bad.g2o"
    bad.write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\nEDGE_SE3:QUAT 0 1 1 2 3\n")
    with pytest.raises(ValueError, match="malformed EDGE_SE3:QUAT"):
        tg2o.read_g2o(str(bad))


@pytest.mark.parametrize("kw", [dict(), dict(n_poses=10000, arena=17, seed=11),
                                dict(n_poses=400, seed=3)], ids=["m3500", "city10000", "n400"])
def test_manhattan_generator_is_the_jax_generator(kw):
    got, got_truth = ttesting.generate_manhattan_g2o(**kw)
    want, want_truth = jtesting.generate_manhattan_g2o(**kw)
    _assert_graphs_equal(got, want)
    assert np.array_equal(got_truth, want_truth)


def _optimizer_record(opt):
    ids = opt.pose_indices()
    poses = [(opt.get_pose(i).rotation, opt.get_pose(i).translation) for i in ids]
    cons = [
        (c["reference_index"], c["query_index"], c["type"], c["sqrt_info"],
         c["relative_pose"].rotation, c["relative_pose"].translation)
        for c in opt.constraints()
    ]
    return ids, poses, cons, sorted(opt._constant), opt.switch_penalty


@pytest.mark.parametrize("switchable", [False, True])
@pytest.mark.parametrize("unit", [False, True])
def test_load_pose_graph_matches_jax(tmp_path, full_info_graph, switchable, unit):
    small, _ = jtesting.generate_sphere_g2o(n_rings=5, per_ring=20)
    for name, graph in (("sphere", small), ("full_info", full_info_graph)):
        path = str(tmp_path / f"{name}.g2o")
        jg2o.write_g2o(path, graph)
        kw = dict(switchable_loops=switchable, unit_information=unit)
        got = _optimizer_record(tg2o.load_pose_graph(path, device="cpu", **kw))
        want = _optimizer_record(jg2o.load_pose_graph(path, **kw))
        assert got[0] == want[0] and got[3] == want[3] and got[4] == want[4]
        for (ra, ta), (rb, tb) in zip(got[1], want[1], strict=True):
            assert np.array_equal(ra, rb) and np.array_equal(ta, tb)
        for a, b in zip(got[2], want[2], strict=True):
            assert a[:3] == b[:3]
            assert (a[3] is None) == (b[3] is None)
            for x, y in zip(a[3:], b[3:]):
                if x is not None:
                    assert np.array_equal(x, y)
        assert any(c[2] == 1 for c in got[2]) == switchable


def test_save_pose_graph_matches_jax(tmp_path, full_info_graph):
    path = str(tmp_path / "in.g2o")
    jg2o.write_g2o(path, full_info_graph)
    topt = tg2o.load_pose_graph(path, device="cpu")
    jopt = jg2o.load_pose_graph(path)
    for graph in (None, full_info_graph):
        tout, jout = tmp_path / "t.g2o", tmp_path / "j.g2o"
        tg2o.save_pose_graph(str(tout), topt, graph)
        jg2o.save_pose_graph(str(jout), jopt, graph)
        assert tout.read_text() == jout.read_text()


@pytest.mark.parametrize("kind", ["none", "diag", "full"])
def test_interop_carries_pose_graph_edges_and_state(rng, kind):
    E, P, L = 11, 7, 3
    sqrt_info = {"none": None, "diag": rng.uniform(1, 2, (E, 6)), "full": rng.normal(size=(E, 6, 6))}[kind]
    edges = dict(
        reference_indices=rng.integers(0, P, E).astype(np.int32),
        query_indices=rng.integers(0, P, E).astype(np.int32),
        relative_translations=rng.normal(size=(E, 3)),
        relative_quaternions=rng.normal(size=(E, 4)),
        is_loop=(rng.uniform(size=E) < 0.3).astype(np.float64),
        mask=np.ones(E),
        sqrt_info=sqrt_info,
    )
    state = dict(positions=rng.normal(size=(P, 3)), quaternions=rng.normal(size=(P, 4)),
                 switches=rng.uniform(size=L))
    port_state = interop.from_reference(
        pose_graph_edges=edges, pose_graph_state=state, device="cpu", dtype=torch.float64
    )
    e = port_state.pose_graph_edges
    assert e.reference_indices.dtype == torch.int64 and e.relative_translations.dtype == torch.float64
    assert (e.sqrt_info is None) == (sqrt_info is None)
    back = interop.to_reference(port_state)
    for k, v in edges.items():
        if v is None:
            assert back["pose_graph_edges"][k] is None
        else:
            assert np.array_equal(back["pose_graph_edges"][k], v), k
    for k, v in state.items():
        assert np.array_equal(back["pose_graph_state"][k], v), k
    assert set(back) == {"pose_graph_edges", "pose_graph_state"}
