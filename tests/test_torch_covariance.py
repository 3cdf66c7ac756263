"""The port's marginal covariances against the JAX package's, in float64 on
the CPU: ``PoseGraphOptimizer.covariance`` and
``PoseGraphOptimizer2D.covariance`` by dense, banded, sparse and auto, and
the multifrontal selected inverse (``selected_inverse_diag``,
``selected_inverse_pairs``).

Mirrored from the JAX package's tests, each on the same inputs:
- tests/test_covariance.py: the finite-difference oracle on an exact
  chain (:102, :243 with whitened edges), a loop closure shrinking the
  end pose's marginal (:122), the gauge requirement (:140), banded against
  dense on a loop-closed chain with learned switches (:375, and its SE(2)
  twin :415 with sparse), banded refusing priors (:402);
- tests/test_pose_graph_2d.py:187, the SE(2) oracle with whitened edges;
- tests/test_pose_graph_sparse.py:326 (the selected inverse against a
  dense inverse), :345 (sparse against dense on the 80-pose fixture) and
  :502 (pairwise blocks, and a pair outside the filled pattern refused).

Every block of the port equals JAX's within rtol 1e-9 (entries near zero
within 1e-9 of the block's largest entry; the JAX package's
sparse path is compared through its dense path, which its own test holds
the sparse path to; its eager selected inverse compiles for tens of
seconds on the CPU); the port's dense, banded and sparse blocks agree with
each other within rtol 1e-9 (the JAX tests' atol where they give one); the
ValueErrors are JAX's word for word. Also priors (dense), ``HuberLoss``
and "auto" past 500 poses (banded).
"""

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.core import HuberLoss as JHuber
from nonlinear_optimizer_for_slam_tpu.solvers import multifrontal as jmf
from nonlinear_optimizer_for_slam_tpu.solvers import pose_graph as jpg
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
import jax.numpy as jnp
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.solvers import multifrontal as tmf
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as tpg

RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rodrigues(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _rot_log(R):
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 0.5 * v if th < 1e-9 else th / (2.0 * np.sin(th)) * v


def _fd_covariance(poses, edges, fixed=(0,)):
    """tests/test_covariance.py's oracle: the GN information by central
    differences of a rotation-matrix residual (Rodrigues, right
    perturbation; no code shared with the quaternion closed forms) with
    per-edge diagonal whitening w6; edges are (i, j, (R_rel, t_rel), w6)."""
    n = len(poses)
    free = [k for k in range(n) if k not in fixed]
    col = {k: 6 * i for i, k in enumerate(free)}

    def residuals(x):
        ps, Rs = [], []
        for k in range(n):
            dp, dth = (x[col[k]:col[k] + 3], x[col[k] + 3:col[k] + 6]) if k in col else (
                np.zeros(3), np.zeros(3))
            ps.append(poses[k][1] + dp)
            Rs.append(poses[k][0] @ _rodrigues(dth))
        out = []
        for (i, j, (R_rel, t_rel), w6) in edges:
            out.append(w6[:3] * (ps[j] - ps[i] - Rs[i] @ t_rel))
            out.append(w6[3:] * _rot_log(Rs[j].T @ Rs[i] @ R_rel))
        return np.concatenate(out)

    dim = 6 * len(free)
    J = np.zeros((6 * len(edges), dim))
    for c in range(dim):
        e = np.zeros(dim)
        e[c] = 1e-6
        J[:, c] = (residuals(e) - residuals(-e)) / 2e-6
    S = np.linalg.inv(J.T @ J)
    out = {k: np.zeros((6, 6)) for k in fixed}
    for k in free:
        out[k] = S[col[k]:col[k] + 6, col[k]:col[k] + 6]
    return out


def _chain(n):
    """tests/test_covariance.py's chain: poses at k x, small distinct
    rotations, exact constraints. Returns ([(R, t)], rel(i, j))."""
    rng = np.random.default_rng(5)
    poses = [(_rodrigues(rng.normal(0, 0.1, 3)), np.array([float(k), 0.3 * k, 0.0]))
             for k in range(n)]

    def rel(i, j):
        (Ri, ti), (Rj, tj) = poses[i], poses[j]
        return Ri.T @ Rj, Ri.T @ (tj - ti)

    return poses, rel


def _opt(module, **kw):
    if module == "jax":
        return jpg.PoseGraphOptimizer(**kw), nls.Pose, jpg.ConstraintType
    return tpg.PoseGraphOptimizer(device="cpu", **kw), port.Pose, tpg.ConstraintType


def _chain_graph(module, n, loops=(), constant=True, sqrt_info=None, **kw):
    poses, rel = _chain(n)
    opt, Pose, CT = _opt(module, **kw)
    for i, (R, t) in enumerate(poses):
        opt.set_pose(i, Pose(R, t))
    if constant:
        opt.set_pose_constant(0)
    for k in range(1, n):
        opt.set_constraint(k - 1, k, Pose(*rel(k - 1, k)), CT.ODOMETRY, sqrt_info=sqrt_info)
    for i, j in loops:
        opt.set_constraint(i, j, Pose(*rel(i, j)), CT.LOOP)
    return opt


def _assert_blocks(got, want, rtol=RTOL, atol=0.0, label=""):
    """Every block within ``rtol`` of itself, entries near zero within
    ``rtol`` of the block's largest entry (plus ``atol``)."""
    assert sorted(got) == sorted(want)
    for k in want:
        scale = rtol * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol + scale,
                                   err_msg=f"{label} pose {k}")


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


# ---- tests/test_covariance.py ------------------------------------------------


def test_batch_chain_fd_oracle():
    n = 7
    poses, rel = _chain(n)
    cov = _chain_graph("torch", n).covariance()
    oracle = _fd_covariance(poses, [(k - 1, k, rel(k - 1, k), np.ones(6)) for k in range(1, n)])
    np.testing.assert_allclose(cov[0], np.zeros((6, 6)), atol=1e-12)
    for k in range(1, n):
        np.testing.assert_allclose(cov[k], oracle[k], rtol=1e-5, atol=1e-6)
    _assert_blocks(cov, _chain_graph("jax", n).covariance(), atol=1e-15)


def test_batch_loop_reduces_uncertainty():
    n = 7
    _, rel = _chain(n)
    after = {}
    for m in ("jax", "torch"):
        _, Pose, CT = _opt(m)
        opt = _chain_graph(m, n)
        before = opt.covariance([n - 1])[n - 1]
        opt.set_constraint(0, n - 1, Pose(*rel(0, n - 1)), CT.LOOP)
        opt.solve()
        after[m] = opt.covariance([n - 1])[n - 1]
        if m == "torch":
            assert np.trace(after[m]) < 0.6 * np.trace(before)
            assert np.linalg.eigvalsh(0.5 * (after[m] + after[m].T)).min() > -1e-10
    _assert_blocks({0: after["torch"]}, {0: after["jax"]})


def test_covariance_is_float64_at_any_solve_dtype():
    """The marginals are float64 whatever the optimizer's dtype (the JAX
    package linearizes on the host in float64): a float32 optimizer gives
    the float64 one's blocks bit for bit, SE(3) and SE(2)."""
    n = 7
    loops = [(0, 5)]
    got = _chain_graph("torch", n, loops=loops, dtype=torch.float32).covariance()
    want = _chain_graph("torch", n, loops=loops).covariance()
    _assert_blocks(got, want, rtol=0.0)
    opts = {}
    for dtype in (torch.float32, torch.float64):
        opt = tpg.PoseGraphOptimizer2D(dtype=dtype, device="cpu")
        for i in range(n):
            opt.set_pose(i, np.array([i * 1.0, 0.1 * i, 0.05 * i]))
        opt.set_pose_constant(0)
        for i in range(n - 1):
            opt.set_constraint(i, i + 1, np.array([1.0, 0.1, 0.05]))
        opts[dtype] = opt.covariance(method="banded")
    _assert_blocks(opts[torch.float32], opts[torch.float64], rtol=0.0)


def test_covariance_errors_match_jax():
    """tests/test_covariance.py:140 (the gauge) and :402 (banded and sparse
    refuse priors), with the other ValueErrors of covariance()."""
    opts = {}
    for m in ("jax", "torch"):
        free = _chain_graph(m, 3, constant=False)
        priors = _chain_graph(m, 7, constant=False, switch_penalty=0.03)
        priors.set_prior(0, _opt(m)[1](*_chain(7)[0][0]))
        empty, Pose, _ = _opt(m)
        empty.set_pose(0, Pose.identity())
        empty.set_pose_constant(0)
        lone = _chain_graph(m, 4)  # pose 9 has no constraint: singular
        lone.set_pose(9, Pose.identity())
        opts[m] = dict(
            gauge=lambda o=free: o.covariance(),
            banded_priors=lambda o=priors: o.covariance(method="banded"),
            sparse_priors=lambda o=priors: o.covariance(method="sparse"),
            method=lambda o=lone: o.covariance(method="bogus"),
            empty=lambda o=empty: o.covariance(),
            singular=lambda o=lone: o.covariance(),
        )
    for name in opts["jax"]:
        assert _error(opts["torch"][name]) == _error(opts["jax"][name]), name
    assert "banded" in _error(opts["torch"]["banded_priors"])


def test_weighted_covariance_physical_units():
    n = 6
    poses, rel = _chain(n)
    w6 = np.array([50.0] * 3 + [250.0] * 3)  # 2 cm / 4 mrad
    cov = _chain_graph("torch", n, sqrt_info=(50.0, 250.0)).covariance()
    oracle = _fd_covariance(poses, [(k - 1, k, rel(k - 1, k), w6) for k in range(1, n)])
    for k in range(1, n):
        np.testing.assert_allclose(cov[k], oracle[k], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(np.sqrt(cov[1][0, 0]), 0.02, rtol=1e-6)
    _assert_blocks(cov, _chain_graph("jax", n, sqrt_info=(50.0, 250.0)).covariance(), atol=1e-20)


def test_banded_selected_inverse_matches_dense():
    """tests/test_covariance.py:375: a 40-pose chain with three loops,
    solved at switch penalty 0.03 (learned switches, a gauge pose); the
    port's dense, banded and sparse blocks against each other and JAX's
    dense and banded."""
    n = 40
    loops = [(0, n // 2), (5, n - 3), (n // 3, 2 * n // 3)]
    got, want = {}, {}
    for m, out in (("torch", got), ("jax", want)):
        opt = _chain_graph(m, n, loops=loops, switch_penalty=0.03)
        opt.solve()
        for method in ("dense", "banded") + (("sparse",) if m == "torch" else ()):
            out[method] = opt.covariance(method=method)
    for method in ("dense", "banded"):
        _assert_blocks(got[method], want[method], atol=1e-15, label=method)
    _assert_blocks(got["banded"], got["dense"], atol=1e-12, label="banded vs dense")
    _assert_blocks(got["sparse"], got["dense"], atol=1e-12, label="sparse vs dense")


# ---- SE(2) -------------------------------------------------------------------


def test_banded_selected_inverse_matches_dense_2d():
    """tests/test_covariance.py:415: a loop-closed 50-pose SE(2) chain with
    switches; JAX's dense and banded against the port's, and the port's
    three methods against each other."""
    rng = np.random.default_rng(8)
    n = 50
    th = np.cumsum(rng.normal(0.05, 0.05, n))
    xy = np.cumsum(0.5 * np.stack([np.cos(th), np.sin(th)], 1), axis=0)
    gt = np.concatenate([xy, th[:, None]], 1)
    start = gt + np.concatenate([np.zeros((1, 3)), 0.02 * rng.normal(size=(n - 1, 3))])

    def rel(i, j):
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        d = gt[j, :2] - gt[i, :2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         (gt[j, 2] - gt[i, 2] + np.pi) % (2 * np.pi) - np.pi])

    got, want = {}, {}
    for m, out in (("torch", got), ("jax", want)):
        opt = (tpg.PoseGraphOptimizer2D(switch_penalty=0.03, device="cpu") if m == "torch"
               else jpg.PoseGraphOptimizer2D(switch_penalty=0.03))
        for i in range(n):
            opt.set_pose(i, start[i])
        opt.set_pose_constant(0)
        for i in range(n - 1):
            opt.set_constraint(i, i + 1, rel(i, i + 1))
        for (i, j) in [(0, n // 2), (10, n - 5)]:
            opt.set_constraint(i, j, rel(i, j), tpg.ConstraintType.LOOP)
        opt.solve()
        for method in ("dense", "banded", "auto") + (("sparse",) if m == "torch" else ()):
            out[method] = opt.covariance(method=method)
    for method in ("dense", "banded", "auto"):
        _assert_blocks(got[method], want[method], atol=1e-15, label=method)
    _assert_blocks(got["banded"], got["dense"], atol=1e-10, label="banded vs dense")
    _assert_blocks(got["sparse"], got["dense"], atol=1e-10, label="sparse vs dense")


def test_2d_weighted_edges_and_covariance_fd_oracle():
    """tests/test_pose_graph_2d.py:187: whitened SE(2) edges against a
    central-difference GN oracle built from an independent residual."""
    n = 6
    xyt = np.stack([np.array([k * 1.0, 0.2 * k, 0.1 * k]) for k in range(n)])

    def rel(i, j):
        c, s = np.cos(xyt[i, 2]), np.sin(xyt[i, 2])
        d = xyt[j, :2] - xyt[i, :2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], xyt[j, 2] - xyt[i, 2]])

    w3 = np.array([20.0, 20.0, 100.0])
    covs = {}
    for m in ("jax", "torch"):
        opt = tpg.PoseGraphOptimizer2D(device="cpu") if m == "torch" else jpg.PoseGraphOptimizer2D()
        for i in range(n):
            opt.set_pose(i, xyt[i])
        opt.set_pose_constant(0)
        for k in range(1, n):
            opt.set_constraint(k - 1, k, rel(k - 1, k), sqrt_info=(20.0, 100.0))
        covs[m] = opt.covariance()

    def residuals(x):
        p = xyt.copy()
        p[1:] += x.reshape(n - 1, 3)
        out = []
        for k in range(1, n):
            c, s = np.cos(p[k - 1, 2]), np.sin(p[k - 1, 2])
            d = p[k, :2] - p[k - 1, :2]
            m = rel(k - 1, k)
            out.append(w3 * np.array([c * d[0] + s * d[1] - m[0], -s * d[0] + c * d[1] - m[1],
                                      p[k, 2] - p[k - 1, 2] - m[2]]))
        return np.concatenate(out)

    dim = 3 * (n - 1)
    J = np.zeros((dim, dim))
    for c_ in range(dim):
        e = np.zeros(dim)
        e[c_] = 1e-6
        J[:, c_] = (residuals(e) - residuals(-e)) / 2e-6
    Sigma = np.linalg.inv(J.T @ J)
    for k in range(1, n):
        np.testing.assert_allclose(covs["torch"][k], Sigma[3 * (k - 1):3 * k, 3 * (k - 1):3 * k],
                                   rtol=1e-5, atol=1e-12)
    _assert_blocks(covs["torch"], covs["jax"], atol=1e-20)


def test_2d_covariance_errors_match_jax():
    opts = {}
    for m in ("jax", "torch"):
        make = (lambda: tpg.PoseGraphOptimizer2D(device="cpu")) if m == "torch" else jpg.PoseGraphOptimizer2D
        empty, free, lone = make(), make(), make()
        for o in (empty, free, lone):
            o.set_pose(0, np.zeros(3))
            o.set_pose(1, np.ones(3))
        empty.set_pose_constant(0)
        free.set_constraint(0, 1, np.ones(3))
        lone.set_pose(2, np.zeros(3))  # no constraint: singular
        lone.set_pose_constant(0)
        lone.set_constraint(0, 1, np.ones(3))
        opts[m] = dict(method=lambda o=free: o.covariance(method="bogus"),
                       empty=lambda o=empty: o.covariance(),
                       gauge=lambda o=free: o.covariance(),
                       singular=lambda o=lone: o.covariance(method="dense"))
    for name in opts["jax"]:
        assert _error(opts["torch"][name]) == _error(opts["jax"][name]), name


# ---- the 80-pose fixture: sparse, Huber, priors ------------------------------


@pytest.fixture(scope="module")
def fixture():
    return jtesting.generate_pose_graph_fixture()


def _fixture_graph(module, fixture, prior=False, **kw):
    _, noisy, constraints = fixture
    opt, Pose, CT = _opt(module, **kw)
    for i, p in enumerate(noisy):
        opt.set_pose(i, Pose(p.rotation, p.translation))
    if prior:
        opt.set_prior(0, Pose(noisy[0].rotation, noisy[0].translation), sqrt_info=(100.0, 300.0))
    else:
        opt.set_pose_constant(0)
    for c in constraints:
        rp = c["relative_pose"]
        opt.set_constraint(c["reference_index"], c["query_index"], Pose(rp.rotation, rp.translation),
                           CT.LOOP if c["is_loop"] else CT.ODOMETRY)
    return opt


@pytest.mark.parametrize("loss", [None, 1.0], ids=["plain", "huber"])
def test_sparse_covariance_matches_dense(fixture, loss):
    """tests/test_pose_graph_sparse.py:345 on the 80-pose fixture (loops,
    learned switches, a gauge pose), with and without ``HuberLoss(1.0)``:
    the port's sparse and banded blocks against its dense ones, and its
    dense and banded against JAX's."""
    got, want = {}, {}
    for m, out in (("torch", got), ("jax", want)):
        edge_loss = None if loss is None else (port.HuberLoss(loss) if m == "torch" else JHuber(loss))
        opt = _fixture_graph(m, fixture, switch_penalty=0.03, edge_loss=edge_loss)
        opt.solve()
        for method in ("dense", "banded") + (("sparse", "auto") if m == "torch" else ()):
            out[method] = opt.covariance(method=method)
    for method in ("dense", "banded"):
        _assert_blocks(got[method], want[method], atol=1e-15, label=method)
    for method in ("banded", "sparse", "auto"):
        _assert_blocks(got[method], got["dense"], atol=1e-12, label=f"{method} vs dense")


def test_dense_covariance_with_priors_matches_jax(fixture):
    """A prior anchors the gauge instead of a constant pose: the dense
    path's tangent-chart prior block; "auto" takes dense."""
    got, want = {}, {}
    for m, out in (("torch", got), ("jax", want)):
        opt = _fixture_graph(m, fixture, prior=True, switch_penalty=0.03)
        opt.solve()
        out["auto"] = opt.covariance(list(range(0, 80, 7)))
    _assert_blocks(got["auto"], want["auto"], atol=1e-15)
    assert all(np.linalg.eigvalsh(b).min() > 0 for b in got["auto"].values())


def test_auto_past_500_poses_is_banded_and_matches_jax():
    """Past 500 poses "auto" takes the banded recurrence (its panels pass
    the memory guard); a 600-pose chain with three loops at its exact
    state, edges whitened to 1 m and 1/30 rad. (At unit information, 1 rad
    an edge, the marginals reach 7e5 and the two float64 recurrences, the
    port's and JAX's host numpy, part at 2e-9 of a block.)"""
    n = 600
    loops = [(0, 300), (100, 500), (250, 590)]
    got = _chain_graph("torch", n, loops=loops, sqrt_info=(1.0, 30.0))
    want = _chain_graph("jax", n, loops=loops, sqrt_info=(1.0, 30.0))
    ids = list(range(0, n, 37))
    _assert_blocks(got.covariance(ids), want.covariance(ids), atol=1e-15)
    _assert_blocks(got.covariance(ids, method="banded"), got.covariance(ids), rtol=0, atol=0)


# ---- the multifrontal selected inverse (tests/test_pose_graph_sparse.py) ---


def _system(P, extra, d, seed, grid=None):
    """A random SPD block system on a chain (or an n x n grid) plus random
    edges, with its dense matrix: (ea, eb, B_aa, B_bb, B_ab, diag, H)."""
    rng = np.random.default_rng(seed)
    ea, eb = [], []
    if grid is not None:
        for i in range(grid):
            for j in range(grid):
                if i + 1 < grid:
                    ea.append(i * grid + j)
                    eb.append((i + 1) * grid + j)
                if j + 1 < grid:
                    ea.append(i * grid + j)
                    eb.append(i * grid + j + 1)
    else:
        ea, eb = list(range(P - 1)), list(range(1, P))
    for _ in range(extra):
        a, b = rng.integers(0, P, 2)
        if a != b:
            ea.append(int(min(a, b)))
            eb.append(int(max(a, b)))
    ea, eb = np.asarray(ea), np.asarray(eb)
    J = rng.normal(size=(len(ea), d + 1, 2 * d))
    B_aa = np.einsum("eri,erj->eij", J[:, :, :d], J[:, :, :d]) + 3 * np.eye(d)
    B_bb = np.einsum("eri,erj->eij", J[:, :, d:], J[:, :, d:]) + 3 * np.eye(d)
    B_ab = np.einsum("eri,erj->eij", J[:, :, :d], J[:, :, d:])
    diag = rng.uniform(0.5, 2.0, size=(P, d))
    H = np.diag(diag.ravel())
    for e, (a, b) in enumerate(zip(ea, eb)):
        H[a * d:(a + 1) * d, a * d:(a + 1) * d] += B_aa[e]
        H[b * d:(b + 1) * d, b * d:(b + 1) * d] += B_bb[e]
        H[a * d:(a + 1) * d, b * d:(b + 1) * d] += B_ab[e]
        H[b * d:(b + 1) * d, a * d:(a + 1) * d] += B_ab[e].T
    return ea, eb, B_aa, B_bb, B_ab, diag, H


def _diag_of(Sigma, P, d):
    return np.stack([Sigma[i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(P)])


def _factor(plan, B_aa, B_bb, B_ab, diag):
    return tmf.factor(plan, *(torch.as_tensor(a) for a in (B_aa, B_bb, B_ab, diag)))


@pytest.mark.parametrize("grid,leaf", [(12, 12), (16, 8)])
def test_multifrontal_selected_inverse_matches_dense(grid, leaf):
    """tests/test_pose_graph_sparse.py:326: the per-vertex diagonal blocks
    of A^{-1} on a grid with extra edges, its tolerance (rtol 1e-9, atol
    1e-12); the sweep never leaves the factor's dtype."""
    P, d = grid * grid, 3
    ea, eb, B_aa, B_bb, B_ab, diag, H = _system(P, 25, d, seed=2, grid=grid)
    plan = tmf.symbolic(P, ea, eb, d, leaf_size=leaf)
    assert plan.num_levels > 2
    got = tmf.selected_inverse_diag(plan, _factor(plan, B_aa, B_bb, B_ab, diag))
    assert got.dtype == torch.float64 and got.shape == (P, d, d)
    np.testing.assert_allclose(got.numpy(), _diag_of(np.linalg.inv(H), P, d), rtol=1e-9, atol=1e-12)


def test_selected_inverse_single_leaf_matches_jax():
    """One front, no boundary (P <= leaf_size), as
    tests/test_pose_graph_sparse.py's single-leaf case: the port against
    JAX's selected_inverse_diag and the dense inverse."""
    P, d = 6, 2
    ea, eb, B_aa, B_bb, B_ab, diag, H = _system(P, 3, d, seed=3)
    plan = tmf.symbolic(P, ea, eb, d, leaf_size=16)
    assert plan.num_levels == 1
    got = tmf.selected_inverse_diag(plan, _factor(plan, B_aa, B_bb, B_ab, diag)).numpy()
    jplan = jmf.symbolic(P, ea, eb, d, leaf_size=16)
    jfact = jmf.factor(jplan, *(jnp.asarray(a) for a in (B_aa, B_bb, B_ab, diag)))
    np.testing.assert_allclose(got, np.asarray(jmf.selected_inverse_diag(jplan, jfact)),
                               rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(got, _diag_of(np.linalg.inv(H), P, d), rtol=1e-9, atol=1e-12)


def test_selected_inverse_pairs_matches_dense():
    """tests/test_pose_graph_sparse.py:502: diagonal and requested
    off-diagonal blocks for pairs that are edges of the symbolic graph
    (either orientation) against the dense inverse (atol 1e-9); a pair
    outside the filled pattern is refused with JAX's text; the vertex
    lookup is cached on the plan."""
    P, d = 40, 3
    ea, eb, B_aa, B_bb, B_ab, diag, H = _system(P, 30, d, seed=1)
    Sig = np.linalg.inv(H)
    plan = tmf.symbolic(P, ea, eb, d, leaf_size=4)
    fact = _factor(plan, B_aa, B_bb, B_ab, diag)
    pa = np.concatenate([ea, eb[::3]])
    pb = np.concatenate([eb, ea[::3]])
    diag_blk, pair_blk = tmf.selected_inverse_pairs(plan, fact, pa, pb)
    np.testing.assert_allclose(diag_blk.numpy(), _diag_of(Sig, P, d), atol=1e-9)
    want = np.stack([Sig[a * d:(a + 1) * d, b * d:(b + 1) * d] for a, b in zip(pa, pb)])
    np.testing.assert_allclose(pair_blk.numpy(), want, atol=1e-9)
    slots = plan._vertex_slots
    assert slots is not None and tmf.selected_inverse_pairs(plan, fact, [], [])[1].shape == (0, d, d)
    assert plan._vertex_slots is slots
    assert not ((ea == 0) & (eb == P - 1)).any()
    jplan = jmf.symbolic(P, ea, eb, d, leaf_size=4)
    # JAX refuses the pair on the host, before it reads the factor
    assert _error(lambda: tmf.selected_inverse_pairs(plan, fact, [0], [P - 1])) == _error(
        lambda: jmf.selected_inverse_pairs(jplan, None, np.array([0]), np.array([P - 1])))
