"""The port's nested-dissection multifrontal Cholesky
(``solvers/multifrontal.py``) against the JAX package's.

- ``symbolic`` builds JAX's plan: every field the port keeps (the
  depths' shapes and index maps, the edge orientation, the row buffer),
  equal array for array, and the same ``stats()``; on the random block
  systems of tests/test_pose_graph_sparse.py (a 16 x 16 grid with chords
  under the coordinate and the RCM cuts, a chain with chords at d = 7, a
  single-leaf tree, duplicate edges), the 80-pose fixture's SE(3) graph and
  a 150-pose Manhattan world. ``accumulate_rounds`` equals JAX's exactly.
- ``factor``/``solve_factored``/``solve`` in float64 against JAX's
  ``solve`` and a dense numpy solve (rtol 1e-9, atol 1e-11 of the
  solution, the JAX tests' tolerance), one factor serving several
  right-hand sides, full (P, d, d) diagonal blocks; ``edge_matvec``
  against the dense product (rtol 1e-12).
- a system that is not positive definite gives a NaN solution and does not
  raise; the plan's device index maps are built once per device.
- ``mesh=`` with a world of one (no process group) gives the unsharded
  factor and solution bit for bit; worlds of 2 and 4 are held in
  tests/test_torch_sharded.py, the selected inverse in
  tests/test_torch_covariance.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.solvers import multifrontal as jmf
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
from nonlinear_optimizer_for_slam_tpu_torch.solvers import multifrontal as tmf

RTOL, ATOL = 1e-9, 1e-11  # tests/test_pose_graph_sparse.py


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_block_system(P, extra_edges, d, seed, grid=None):
    """tests/test_pose_graph_sparse.py::_random_block_system: a grid (or a
    chain) plus random chords, random PSD edge blocks, a positive diagonal
    and the dense matrix they assemble to."""
    rng = np.random.default_rng(seed)
    ea, eb = [], []
    if grid is not None:
        n = grid
        for i in range(n):
            for j in range(n):
                if i + 1 < n:
                    ea.append(i * n + j)
                    eb.append((i + 1) * n + j)
                if j + 1 < n:
                    ea.append(i * n + j)
                    eb.append(i * n + j + 1)
    else:
        for i in range(P - 1):
            ea.append(i)
            eb.append(i + 1)
    for _ in range(extra_edges):
        a, b = rng.integers(0, P, 2)
        if a != b:
            ea.append(int(a))
            eb.append(int(b))
    ea, eb = np.array(ea), np.array(eb)
    return (ea, eb) + _blocks(ea, eb, P, d, rng)


def _blocks(ea, eb, P, d, rng):
    E = len(ea)
    J = rng.normal(size=(E, d + 1, 2 * d))
    B_aa = np.einsum("eri,erj->eij", J[:, :, :d], J[:, :, :d])
    B_bb = np.einsum("eri,erj->eij", J[:, :, d:], J[:, :, d:])
    B_ab = np.einsum("eri,erj->eij", J[:, :, :d], J[:, :, d:])
    diag = rng.uniform(0.5, 2.0, size=(P, d))
    b = rng.normal(size=(P, d))
    H = np.zeros((P * d, P * d))
    for e in range(E):
        a_, b_ = ea[e], eb[e]
        H[a_ * d:(a_ + 1) * d, a_ * d:(a_ + 1) * d] += B_aa[e]
        H[b_ * d:(b_ + 1) * d, b_ * d:(b_ + 1) * d] += B_bb[e]
        H[a_ * d:(a_ + 1) * d, b_ * d:(b_ + 1) * d] += B_ab[e]
        H[b_ * d:(b_ + 1) * d, a_ * d:(a_ + 1) * d] += B_ab[e].T
    H += np.diag(diag.ravel())
    return B_aa, B_bb, B_ab, diag, b, H


def _grid_coords(n):
    return np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).reshape(
        n * n, 2).astype(float)


def _duplicate_edges():
    """tests/test_pose_graph_sparse.py::test_multifrontal_duplicate_edges:
    two constraints between the same pose pair accumulate."""
    ea, eb = np.array([0, 1, 0, 0]), np.array([1, 2, 1, 2])
    return (ea, eb) + _blocks(ea, eb, 3, 2, np.random.default_rng(4))


# name -> (P, d, system, symbolic keyword arguments)
SYSTEMS = {
    "grid_coords": (256, 3, lambda: _random_block_system(256, 40, 3, seed=0, grid=16),
                    dict(coords=_grid_coords(16), leaf_size=16)),
    "grid_rcm": (256, 3, lambda: _random_block_system(256, 40, 3, seed=0, grid=16),
                 dict(leaf_size=16)),
    "chain_d7": (60, 7, lambda: _random_block_system(60, 25, 7, seed=4), dict(leaf_size=8)),
    "single_leaf": (6, 2, lambda: _random_block_system(6, 3, 2, seed=3), dict(leaf_size=16)),
    "duplicates": (3, 2, _duplicate_edges, dict(leaf_size=2)),
}


def _plans(P, d, ea, eb, **kw):
    return tmf.symbolic(P, ea, eb, d, **kw), jmf.symbolic(P, ea, eb, d, **kw)


def _assert_plans_equal(tp, jp):
    assert (tp.P, tp.d, tp.E, tp.tot_row) == (jp.P, jp.d, jp.E, jp.tot_row)
    assert np.array_equal(tp.swap, jp.swap) and np.array_equal(tp.rhs_idx, jp.rhs_idx)
    assert tp.num_levels == jp.num_levels and tp.stats() == jp.stats()
    for td, jd in zip(tp.depths, jp.depths, strict=True):
        for field in td._fields:
            got, want = getattr(td, field), getattr(jd, field)
            if isinstance(got, np.ndarray):
                assert got.dtype == want.dtype and np.array_equal(got, want), field
            else:
                assert got == want, field


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_symbolic_plan_matches_jax(name):
    P, d, system, kw = SYSTEMS[name]
    ea, eb = system()[:2]
    tp, jp = _plans(P, d, ea, eb, **kw)
    _assert_plans_equal(tp, jp)
    if name == "single_leaf":
        assert tp.num_levels == 1


@pytest.mark.parametrize("graph", ["fixture_se3", "manhattan_se2"])
def test_pose_graph_plans_match_jax(graph):
    """The plans the optimizers build: the 80-pose fixture at d = 7, leaf
    16 with its noisy positions as cut coordinates, and a 150-pose
    Manhattan world at d = 3, leaf 32 with its dead-reckoned (x, y)."""
    if graph == "fixture_se3":
        _, noisy, constraints = jtesting.generate_pose_graph_fixture()
        ea = np.array([c["reference_index"] for c in constraints])
        eb = np.array([c["query_index"] for c in constraints])
        coords = np.stack([p.translation for p in noisy])
        P, d, leaf = 80, 7, 16
    else:
        g, _ = jtesting.generate_manhattan_g2o(n_poses=150, seed=5)
        ea = np.array([e.i for e in g.edges])
        eb = np.array([e.j for e in g.edges])
        coords = np.stack([g.vertices[k][:2] for k in range(150)])
        P, d, leaf = 150, 3, 32
    _assert_plans_equal(*_plans(P, d, ea, eb, coords=coords, leaf_size=leaf))
    tr, jr = tmf.accumulate_rounds(P, ea, eb), jmf.accumulate_rounds(P, ea, eb)
    assert tr.dtype == jr.dtype and np.array_equal(tr, jr)


def test_memory_guard_matches_jax():
    """The 4-byte padded-front guard vetoes the same plans in both
    packages, with the same message."""
    ea, eb = _random_block_system(256, 40, 3, seed=0, grid=16)[:2]
    errors = []
    for mf in (tmf, jmf):
        with pytest.raises(ValueError) as info:
            mf.symbolic(256, ea, eb, 3, leaf_size=16, max_front_bytes=1000)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "solver='cg'" in errors[0]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jax_solve(plan, *arrays):
    """JAX's multifrontal.solve, compiled once (eagerly it dispatches op by
    op and takes tens of seconds here)."""
    return np.asarray(jax.jit(lambda *a: jmf.solve(plan, *a))(*map(jnp.asarray, arrays)))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_solve_matches_jax_and_dense(name):
    P, d, system, kw = SYSTEMS[name]
    ea, eb, B_aa, B_bb, B_ab, diag, b, H = system()
    tp, jp = _plans(P, d, ea, eb, **kw)
    x = tmf.solve(tp, *_t(ea, eb, B_aa, B_bb, B_ab, diag, b)).numpy()
    x_dense = np.linalg.solve(H, b.ravel()).reshape(P, d)
    x_jax = _jax_solve(jp, ea, eb, B_aa, B_bb, B_ab, diag, b)
    np.testing.assert_allclose(x, x_dense, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x, x_jax, rtol=RTOL, atol=ATOL)
    assert x.dtype == np.float64


def test_factor_serves_several_right_hand_sides():
    ea, eb, B_aa, B_bb, B_ab, diag, _, H = _random_block_system(60, 25, 2, seed=4)
    plan = tmf.symbolic(60, ea, eb, 2, leaf_size=8)
    fact = tmf.factor(plan, *_t(B_aa, B_bb, B_ab, diag))
    assert all(L.dtype == torch.float64 for L, _ in fact)
    rng = np.random.default_rng(1)
    for _ in range(3):
        rhs = rng.normal(size=(60, 2))
        x = tmf.solve_factored(plan, fact, torch.as_tensor(rhs)).numpy()
        np.testing.assert_allclose(x, np.linalg.solve(H, rhs.ravel()).reshape(60, 2),
                                   rtol=RTOL, atol=ATOL)


def test_full_diagonal_blocks_match_jax():
    """``diag`` as (P, d, d) per-vertex blocks (the Schur-reduced
    landmark system's form) against JAX and the dense solve."""
    ea, eb, B_aa, B_bb, B_ab, diag, b, H = _random_block_system(40, 15, 3, seed=7)
    rng = np.random.default_rng(5)
    G = rng.normal(size=(40, 3, 3))
    blocks = np.einsum("pij,pkj->pik", G, G) + np.eye(3)
    Hb = H - np.diag(diag.ravel())
    for i in range(40):
        Hb[3 * i:3 * i + 3, 3 * i:3 * i + 3] += blocks[i]
    tp, jp = _plans(40, 3, ea, eb, leaf_size=8)
    x = tmf.solve(tp, *_t(ea, eb, B_aa, B_bb, B_ab, blocks, b)).numpy()
    x_jax = _jax_solve(jp, ea, eb, B_aa, B_bb, B_ab, blocks, b)
    np.testing.assert_allclose(x, np.linalg.solve(Hb, b.ravel()).reshape(40, 3), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x, x_jax, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [3, 7])
def test_edge_matvec_matches_dense_and_jax(d):
    ea, eb, B_aa, B_bb, B_ab, diag, _, H = _random_block_system(40, 15, d, seed=7)
    x = np.random.default_rng(2).normal(size=(40, d))
    y = tmf.edge_matvec(*_t(ea, eb, B_aa, B_bb, B_ab, diag, x)).numpy()
    y_jax = np.asarray(jmf.edge_matvec(*map(jnp.asarray, (ea, eb, B_aa, B_bb, B_ab, diag, x))))
    np.testing.assert_allclose(y, (H @ x.ravel()).reshape(40, d), rtol=1e-12)
    np.testing.assert_allclose(y, y_jax, rtol=1e-12)


def test_not_positive_definite_gives_nan_without_raising():
    """A front that Cholesky cannot factor: NaN everywhere in the step (the
    LM guard's signal), as JAX's NaN factor gives; nothing raises."""
    ea, eb, B_aa, B_bb, B_ab, diag, b, _ = _random_block_system(256, 40, 3, seed=0, grid=16)
    plan = tmf.symbolic(256, ea, eb, 3, coords=_grid_coords(16), leaf_size=16)
    diag = diag.copy()
    diag[17] = -1e6
    x = tmf.solve(plan, *_t(ea, eb, B_aa, B_bb, B_ab, diag, b))
    assert torch.isnan(x).all()


def test_device_maps_are_built_once_per_device():
    ea, eb, B_aa, B_bb, B_ab, diag, b, _ = _random_block_system(60, 25, 2, seed=4)
    plan = tmf.symbolic(60, ea, eb, 2, leaf_size=8)
    assert not plan._device_maps
    tmf.solve(plan, *_t(ea, eb, B_aa, B_bb, B_ab, diag, b))
    maps = plan._device_maps[torch.device("cpu")]
    tmf.solve(plan, *_t(ea, eb, B_aa, B_bb, B_ab, diag, b))
    assert list(plan._device_maps) == [torch.device("cpu")]
    assert plan._device_maps[torch.device("cpu")] is maps


def test_unported_parts_raise():
    from nonlinear_optimizer_for_slam_tpu_torch.parallel import make_factor_mesh

    ea, eb, B_aa, B_bb, B_ab, diag, b, _ = _random_block_system(6, 3, 2, seed=3)
    plan = tmf.symbolic(6, ea, eb, 2, leaf_size=16)
    mesh = make_factor_mesh(device="cpu")
    for (L_m, W_m), (L, W) in zip(tmf.factor(plan, *_t(B_aa, B_bb, B_ab, diag), mesh=mesh),
                                  tmf.factor(plan, *_t(B_aa, B_bb, B_ab, diag))):
        assert torch.equal(L_m, L) and torch.equal(W_m, W)
    args = _t(ea, eb, B_aa, B_bb, B_ab, diag, b)
    assert torch.equal(tmf.solve(plan, *args, mesh=mesh), tmf.solve(plan, *args))
