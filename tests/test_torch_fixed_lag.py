"""The port's fixed-lag smoother (``solvers/fixed_lag.py``) against the
JAX package's.

First the 15 tests of tests/test_fixed_lag.py against the port, on the
CPU in float64 (the smoother's default dtype), with the same fixtures and
bounds; the JAX test of constant shapes (few compiled window programs)
becomes the port's: few device buffer pairs (one per shape bucket).

Then parity with the JAX smoother, float64 on both sides, on one stream
(the 26-pose circle, lag 10, loops every 10 frames, whitened edges):

- blocking updates: the LM count of every update equal; after every
  update the window poses and switches within 1e-9, and the marginal
  prior's support and linearization point equal and the quadratic it
  defines (S^T S, S^T c, c^T c) within 1e-9 of its scale;
- ``update_async`` with ``marginalize_every=1``: bit for bit the port's
  ``update`` (a mirrored test above);
- ``marginalize_every=3``: the amortized stream within 1e-9 of JAX's;
- one update started from the JAX smoother's state mid-stream, carried
  across by ``interop.fixed_lag_from_reference``, within 1e-9.
"""

import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core.pose import Pose as JPose
from nonlinear_optimizer_for_slam_tpu.solvers.fixed_lag import FixedLagSmoother as JaxSmoother
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import Pose
from nonlinear_optimizer_for_slam_tpu_torch.ops.relative_pose import (
    PoseGraphEdges,
    edge_residuals_and_jacobians,
    np_edge_residuals_and_jacobians,
)
from nonlinear_optimizer_for_slam_tpu_torch.solvers.fixed_lag import FixedLagSmoother
from nonlinear_optimizer_for_slam_tpu_torch.solvers.pose_graph import (
    ConstraintType,
    PoseGraphOptimizer,
)

TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: every window solve is many tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def Smoother(lag, **kw):
    return FixedLagSmoother(lag, device="cpu", **kw)


def _rotz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _circle_fixture(n=30, radius=8.0, s_t=0.03, s_r=0.005, seed=3):
    """Ground-truth circle, noisy odometry, loop closures every 10 frames
    (tests/test_fixed_lag.py's fixture)."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = [
        Pose(_rotz(th), np.array([radius * np.cos(th), radius * np.sin(th), 0.0]))
        for th in theta
    ]

    def rel(i, j):
        Ri, ti = gt[i].rotation, gt[i].translation
        return Pose(Ri.T @ gt[j].rotation, Ri.T @ (gt[j].translation - ti))

    def noisy(p, st, sr):
        return Pose(
            p.rotation @ _exp_so3(rng.normal(0, sr, 3)),
            p.translation + rng.normal(0, st, 3),
        )

    odo = [noisy(rel(i, i + 1), s_t, s_r) for i in range(n - 1)]
    loops = {k: noisy(rel(k - 8, k), s_t / 3, s_r / 3) for k in range(10, n, 10)}
    return gt, odo, loops


def _compose(p, d):
    return Pose(p.rotation @ d.rotation, p.translation + p.rotation @ d.translation)


def _dead_reckon(gt0, odo):
    poses = [gt0]
    for d in odo:
        poses.append(_compose(poses[-1], d))
    return poses


def _run_smoother(lag, gt, odo, loops, feed_forward=True, **kw):
    n = len(gt)
    sm = Smoother(lag=lag, switch_penalty=0.03, **kw)
    est = gt[0]
    sm.add_pose(0, est)
    for k in range(1, n):
        est = _compose(est, odo[k - 1])
        sm.add_pose(k, est)
        sm.add_odometry(k - 1, k, odo[k - 1])
        if k in loops:
            sm.add_loop(k - 8, k, loops[k])
        sm.update()
        if feed_forward:
            est = sm.get_pose(k)
    return sm


def _run_batch(gt, odo, loops):
    n = len(gt)
    dr = _dead_reckon(gt[0], odo)
    opt = PoseGraphOptimizer(switch_penalty=0.03, device="cpu")
    for i in range(n):
        opt.set_pose(i, dr[i])
    opt.set_pose_constant(0)
    for k in range(1, n):
        opt.set_constraint(k - 1, k, odo[k - 1], ConstraintType.ODOMETRY)
    for k, lp in loops.items():
        opt.set_constraint(k - 8, k, lp, ConstraintType.LOOP)
    opt.solve()
    return opt


# ---------------------------------------------------------------------------
# tests/test_fixed_lag.py, against the port
# ---------------------------------------------------------------------------


def test_numpy_twin_matches_torch_linearization():
    """The host marginalization uses the device solve's linearization: the
    numpy twin reproduces the torch closed form."""
    rng = np.random.default_rng(11)
    P, E = 6, 9
    pos = rng.normal(0, 2.0, (P, 3))
    quat = rng.normal(0, 1.0, (P, 4)) + np.array([2.0, 0, 0, 0])
    sw = rng.uniform(0.1, 1.0, E)
    ref = rng.integers(0, P, E)
    qry = (ref + 1 + rng.integers(0, P - 1, E)) % P
    rel_t = rng.normal(0, 1.0, (E, 3))
    rel_q = rng.normal(0, 1.0, (E, 4)) + np.array([2.0, 0, 0, 0])
    rel_q /= np.linalg.norm(rel_q, axis=1, keepdims=True)
    is_loop = (rng.uniform(size=E) > 0.5).astype(np.float64)
    t = lambda a: torch.as_tensor(a)
    edges = PoseGraphEdges(t(ref), t(qry), t(rel_t), t(rel_q), t(is_loop),
                           torch.ones(E, dtype=torch.float64))
    got_t = edge_residuals_and_jacobians(t(pos), t(quat), t(sw), edges, 0.03)
    got_n = np_edge_residuals_and_jacobians(pos, quat, sw, ref, qry, rel_t, rel_q, is_loop, 0.03)
    for a, b in zip(got_n, got_t):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-13)


def test_no_marginalization_matches_batch():
    """lag >= N: nothing is marginalized, and the last update solves the
    batch problem (same gauge, same edges)."""
    gt, odo, loops = _circle_fixture(n=18)
    sm = _run_smoother(lag=50, gt=gt, odo=odo, loops=loops)
    assert sm.window == list(range(18))
    opt = _run_batch(gt, odo, loops)
    for i in range(18):
        np.testing.assert_allclose(sm.get_pose(i).translation, opt.get_pose(i).translation, atol=5e-6)
        np.testing.assert_allclose(sm.get_pose(i).rotation, opt.get_pose(i).rotation, atol=5e-6)


def test_marginalization_exact_at_optimum():
    """At a converged joint optimum the marginal's gradient is zero, so
    marginalizing 12 poses (a loop edge and its switch among them) and
    solving again leaves every window pose where it was."""
    gt, odo, loops = _circle_fixture(n=20)
    sm = Smoother(lag=100, switch_penalty=0.03, max_iterations=200)
    est = gt[0]
    sm.add_pose(0, est)
    for k in range(1, 20):
        est = _compose(est, odo[k - 1])
        sm.add_pose(k, est)
        sm.add_odometry(k - 1, k, odo[k - 1])
        if k in loops:
            sm.add_loop(k - 8, k, loops[k])
    sm.update()
    before = {i: sm.get_pose(i).translation.copy() for i in sm.window}
    sm.lag = 8
    sm.update()  # marginalizes poses 0..11, with loop (2, 10) and its switch
    assert sm.window == list(range(12, 20))
    moved = max(np.linalg.norm(sm.get_pose(i).translation - before[i]) for i in sm.window)
    assert moved < 1e-5, moved


def test_marginalized_smoother_tracks_batch():
    """A finite lag on a low-noise fixture stays close to the full-history
    MAP and beats dead reckoning."""
    gt, odo, loops = _circle_fixture(n=30, s_t=0.006, s_r=0.001)
    sm = _run_smoother(lag=12, gt=gt, odo=odo, loops=loops)
    assert sm.window == list(range(18, 30))
    opt = _run_batch(gt, odo, loops)
    for i in sm.window:
        d = np.linalg.norm(sm.get_pose(i).translation - opt.get_pose(i).translation)
        assert d < 0.05, (i, d)
    dr = _dead_reckon(gt[0], odo)
    err_sm = np.mean([np.linalg.norm(sm.get_pose(i).translation - gt[i].translation)
                      for i in sm.window])
    err_dr = np.mean([np.linalg.norm(dr[i].translation - gt[i].translation) for i in sm.window])
    assert err_sm < err_dr


def test_marginalized_poses_are_frozen():
    gt, odo, loops = _circle_fixture(n=24)
    sm = Smoother(lag=8, switch_penalty=0.03)
    sm.add_pose(0, gt[0])
    est = gt[0]
    snapshot = {}
    for k in range(1, 24):
        est = _compose(est, odo[k - 1])
        sm.add_pose(k, est)
        sm.add_odometry(k - 1, k, odo[k - 1])
        sm.update()
        est = sm.get_pose(k)
        for i in range(k + 1):
            if i not in sm.window and i not in snapshot:
                snapshot[i] = sm.get_pose(i).translation.copy()
    assert snapshot
    for i, t in snapshot.items():
        np.testing.assert_array_equal(sm.get_pose(i).translation, t)


def test_outlier_loop_switched_off_in_window():
    """A wildly wrong loop closure inside the window is switched off while
    a good loop stays on."""
    gt, odo, _ = _circle_fixture(n=14, s_t=0.01, s_r=0.002)
    sm = Smoother(lag=14, switch_penalty=0.03)
    est = gt[0]
    sm.add_pose(0, est)
    for k in range(1, 14):
        est = _compose(est, odo[k - 1])
        sm.add_pose(k, est)
        sm.add_odometry(k - 1, k, odo[k - 1])
        sm.update()
        est = sm.get_pose(k)
    Ri, ti = gt[3].rotation, gt[3].translation
    sm.add_loop(3, 13, Pose(Ri.T @ gt[13].rotation, Ri.T @ (gt[13].translation - ti)))
    sm.add_loop(2, 9, Pose(np.eye(3), np.zeros(3)))  # the planted outlier
    sm.update()
    s_good, s_bad = sm.loop_switches()
    assert s_good > 0.8, s_good
    assert s_bad < 0.2, s_bad


def test_marginalization_absorbs_switch_variables():
    """Loops whose endpoints leave the window go with their switches."""
    gt, odo, loops = _circle_fixture(n=30)
    sm = _run_smoother(lag=10, gt=gt, odo=odo, loops=loops)
    assert len(sm.loop_switches()) <= 1


def test_api_validation():
    sm = Smoother(lag=5)
    with pytest.raises(ValueError):
        Smoother(lag=1)
    with pytest.raises(ValueError):
        Smoother(lag=3, marginalize_every=0)
    sm.add_pose(0, Pose(np.eye(3), np.zeros(3)))
    with pytest.raises(ValueError):
        sm.add_pose(2, Pose(np.eye(3), np.zeros(3)))  # a gap
    sm.add_pose(1, Pose(np.eye(3), np.ones(3)))
    with pytest.raises(KeyError):
        sm.add_odometry(1, 7, Pose(np.eye(3), np.zeros(3)))
    with pytest.raises(ValueError):
        sm.add_odometry(1, 1, Pose(np.eye(3), np.zeros(3)))


def test_update_without_edges_is_trivially_converged():
    sm = Smoother(lag=4)
    sm.add_pose(0, Pose(np.eye(3), np.zeros(3)))
    summary = sm.update()
    assert bool(summary.converged)
    np.testing.assert_array_equal(sm.get_pose(0).translation, np.zeros(3))


def test_constant_shape_buffer_reuse():
    """A long stream reuses a handful of device buffer pairs (padded pose
    count, bucketed edge, loop and prior-support shapes), one per bucket
    combination, not one per update: the counterpart of the JAX test's
    few compiled window programs."""
    gt, odo, loops = _circle_fixture(n=40)
    sm = _run_smoother(lag=12, gt=gt, odo=odo, loops=loops)
    assert len(sm._uploads) <= 6, sorted(sm._uploads)


def test_realistic_noise_matches_batch_and_converges():
    """On realistic odometry noise every update converges and the window
    estimates reach batch-MAP quality; a planted identity-pose outlier
    loop leaves the trajectory as it was."""
    gt, odo, loops = _circle_fixture(n=40, s_t=0.02, s_r=0.004, seed=11)
    opt = _run_batch(gt, odo, loops)
    errs = {}
    for outlier in (False, True):
        sm = Smoother(lag=14, switch_penalty=0.03)
        est = gt[0]
        sm.add_pose(0, est)
        for k in range(1, 40):
            est = _compose(est, odo[k - 1])
            sm.add_pose(k, est)
            sm.add_odometry(k - 1, k, odo[k - 1])
            if k in loops:
                sm.add_loop(k - 8, k, loops[k])
            if outlier and k == 25:
                sm.add_loop(15, 25, Pose(np.eye(3), np.zeros(3)))
            s = sm.update()
            assert bool(s.converged), f"update k={k} did not converge"
            est = sm.get_pose(k)
        errs[outlier] = np.array(
            [np.linalg.norm(sm.get_pose(i).translation - gt[i].translation) for i in range(40)]
        )
    batch_err = np.array(
        [np.linalg.norm(opt.get_pose(i).translation - gt[i].translation) for i in range(40)]
    )
    assert errs[False].mean() < 1.5 * batch_err.mean() + 0.05
    np.testing.assert_allclose(errs[True], errs[False], atol=0.05)


def test_matrix_sqrt_info_through_marginalization():
    """A diagonal whitening given as (6,) vectors and as (6, 6) matrices
    gives the same trajectories, through the window solves and the
    marginalization."""
    gt, odo, loops = _circle_fixture(n=22)
    w_odo = np.array([20.0, 20.0, 20.0, 60.0, 60.0, 60.0])
    w_loop = np.array([50.0, 50.0, 50.0, 150.0, 150.0, 150.0])

    def run(as_matrix):
        sw = (lambda v: np.diag(v)) if as_matrix else (lambda v: v)
        sm = Smoother(lag=8, switch_penalty=3.0)
        est = gt[0]
        sm.add_pose(0, est)
        for k in range(1, len(gt)):
            est = _compose(est, odo[k - 1])
            sm.add_pose(k, est)
            sm.add_odometry(k - 1, k, odo[k - 1], sqrt_info=sw(w_odo))
            if k in loops:
                sm.add_loop(k - 8, k, loops[k], sqrt_info=sw(w_loop))
            s = sm.update()
            assert bool(s.converged)
            est = sm.get_pose(k)
        return sm

    sm_vec, sm_mat = run(False), run(True)
    for i in range(22):
        np.testing.assert_allclose(sm_mat.get_pose(i).translation,
                                   sm_vec.get_pose(i).translation, atol=1e-8)
        np.testing.assert_allclose(sm_mat.get_pose(i).rotation,
                                   sm_vec.get_pose(i).rotation, atol=1e-8)


def test_update_async_bit_identical_to_blocking():
    """``update_async`` with ``marginalize_every=1`` defers the fetch,
    write-back and marginalization; the same solve runs on the same
    inputs, so every estimate, switch and frozen pose is bit for bit the
    blocking stream's."""
    gt, odo, loops = _circle_fixture(n=26)

    def run(async_mode):
        sm = Smoother(lag=8, switch_penalty=0.03)
        est = gt[0]
        sm.add_pose(0, est)
        for k in range(1, len(gt)):
            est = _compose(est, odo[k - 1])
            sm.add_pose(k, est)
            sm.add_odometry(k - 1, k, odo[k - 1])
            if k in loops:
                sm.add_loop(k - 8, k, loops[k])
            if async_mode:
                sm.update_async()
            else:
                sm.update()
        sm.flush()
        return sm

    blocking, streaming = run(False), run(True)
    assert streaming.window == blocking.window
    for k in range(len(gt)):
        ps, pb = streaming.get_pose(k), blocking.get_pose(k)
        np.testing.assert_array_equal(ps.translation, pb.translation)
        np.testing.assert_array_equal(ps.rotation, pb.rotation)
    np.testing.assert_array_equal(streaming.loop_switches(), blocking.loop_switches())
    s_b, s_s = blocking.last_summary, streaming.last_summary
    assert int(s_b.iterations) == int(s_s.iterations)
    assert float(s_b.final_cost) == float(s_s.final_cost)


def test_update_async_flushes_on_reads_and_edges():
    """A pending update is applied before any dependent operation: the
    window read flushes, and an edge to a pose the pending marginalization
    removed raises as on the blocking path."""
    gt, odo, loops = _circle_fixture(n=14)
    sm = Smoother(lag=4, switch_penalty=0.03)
    est = gt[0]
    sm.add_pose(0, est)
    for k in range(1, 9):
        est = _compose(est, odo[k - 1])
        sm.add_pose(k, est)
        sm.add_odometry(k - 1, k, odo[k - 1])
        sm.update_async()
    assert 3 not in sm.window
    with pytest.raises(KeyError):
        sm.add_odometry(3, 8, odo[3])


def test_amortized_streaming_tracks_blocking():
    """``marginalize_every=4`` tracks the blocking stream (both publish
    window MAPs of the same factors) and freezes every marginalized pose."""
    gt, odo, loops = _circle_fixture(n=30)

    def run(me):
        sm = Smoother(lag=8, switch_penalty=0.03, marginalize_every=me)
        est = gt[0]
        sm.add_pose(0, est)
        for k in range(1, len(gt)):
            est = _compose(est, odo[k - 1])
            sm.add_pose(k, est)
            sm.add_odometry(k - 1, k, odo[k - 1])
            if k in loops and (k - 8) in sm._est:
                sm.add_loop(k - 8, k, loops[k])
            sm.update_async()
        sm.flush()
        return sm

    blocking, amortized = run(1), run(4)
    assert amortized.window == blocking.window
    for k in range(len(gt)):
        np.testing.assert_allclose(amortized.get_pose(k).translation,
                                   blocking.get_pose(k).translation, atol=0.05)
    for k in range(len(gt)):
        if k not in amortized.window:
            assert k in amortized._history


# ---------------------------------------------------------------------------
# parity with the JAX smoother, float64
# ---------------------------------------------------------------------------

W_ODO = (1 / 0.03, 1 / 0.005)
W_LOOP = (1 / 0.01, 1 / 0.002)


def _state(sm) -> dict:
    """A smoother's state as numpy (the fields of either package's
    smoother, which has the same private layout)."""
    prior = sm._prior
    return dict(
        window=list(sm._window),
        est={k: np.array(v) for k, v in sm._est.items()},
        history={k: np.array(v) for k, v in sm._history.items()},
        odom=[tuple(e) for e in sm._odom],
        loops=[dict(l) for l in sm._loops],
        prior=None if prior is None else tuple(prior),
        gauge=sm._gauge,
    )


def _assert_states_close(mine: dict, theirs: dict, what: str):
    assert mine["window"] == theirs["window"], what
    assert sorted(mine["history"]) == sorted(theirs["history"]), what
    for k in theirs["est"]:
        np.testing.assert_allclose(mine["est"][k], theirs["est"][k], rtol=0, atol=TOL,
                                   err_msg=f"{what}: pose {k}")
    for k in theirs["history"]:
        np.testing.assert_allclose(mine["history"][k], theirs["history"][k], rtol=0, atol=TOL,
                                   err_msg=f"{what}: frozen pose {k}")
    np.testing.assert_allclose([l["switch"] for l in mine["loops"]],
                               [l["switch"] for l in theirs["loops"]], rtol=0, atol=TOL,
                               err_msg=f"{what}: switches")
    assert (mine["prior"] is None) == (theirs["prior"] is None), what
    if theirs["prior"] is not None:
        (ids_m, S_m, x_m, c_m), (ids_t, S_t, x_t, c_t) = mine["prior"], theirs["prior"]
        assert list(ids_m) == list(ids_t), what
        np.testing.assert_allclose(x_m, x_t, rtol=0, atol=TOL, err_msg=f"{what}: prior x_lin")
        # S = w^1/2 V^T and c = w^-1/2 V^T g hold eigh's basis, which is
        # free inside a degenerate eigenspace (two LAPACK calls on inputs
        # 1e-12 apart pick different ones); the prior r_p = S dphi + c is
        # the quadratic they define: S^T S, S^T c and c^T c, each within
        # 1e-9 of its largest entry
        for a, b, name in ((S_m.T @ S_m, S_t.T @ S_t, "S^T S"), (S_m.T @ c_m, S_t.T @ c_t, "S^T c"),
                           (c_m @ c_m, c_t @ c_t, "c^T c")):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(np.abs(b).max(), 1.0),
                                       err_msg=f"{what}: prior {name}")


def _stream(sm, P, gt, odo, loops, frames, mode="update", on_update=None):
    """Feed frames of the circle stream: odometry and loops whitened, the
    prediction fed forward from the smoother's estimate on update frames."""
    est = sm.get_pose(frames[0] - 1) if frames[0] > 1 else gt[0]
    for k in frames:
        est = _compose(est, odo[k - 1])
        sm.add_pose(k, P(est.rotation, est.translation))
        sm.add_odometry(k - 1, k, P(odo[k - 1].rotation, odo[k - 1].translation),
                        sqrt_info=W_ODO)
        if k in loops and (k - 8) in sm.active_ids:
            sm.add_loop(k - 8, k, P(loops[k].rotation, loops[k].translation),
                        sqrt_info=W_LOOP)
        if mode == "update":
            summary = sm.update()
            if on_update is not None:
                on_update(k, summary)
            est = sm.get_pose(k)
        else:
            sm.update_async()
    return sm


def _start(cls, P, gt, **kw):
    sm = cls(lag=10, switch_penalty=0.03, **kw)
    sm.add_pose(0, P(gt[0].rotation, gt[0].translation))
    return sm


@pytest.fixture(scope="module")
def circle():
    return _circle_fixture(n=26)


def test_blocking_stream_matches_jax(circle):
    """Every update: the LM count equal, the window, switches and prior
    within 1e-9 of the JAX smoother's."""
    gt, odo, loops = circle
    frames = range(1, len(gt))

    def record(store):
        def on_update(k, summary):
            store[k] = int(summary.iterations)
        return on_update

    jsm = _start(JaxSmoother, JPose, gt)
    tsm = _start(FixedLagSmoother, Pose, gt, device="cpu")
    counts_j, counts_t = {}, {}
    for k in frames:
        _stream(jsm, JPose, gt, odo, loops, [k], on_update=record(counts_j))
        _stream(tsm, Pose, gt, odo, loops, [k], on_update=record(counts_t))
        _assert_states_close(_state(tsm), _state(jsm), f"update {k}")
    assert counts_t == counts_j
    assert max(counts_t.values()) > 0 and tsm._prior is not None


def test_amortized_stream_matches_jax(circle):
    """``marginalize_every=3``: the amortized stream (a solve every frame,
    the host part every third) within 1e-9 of JAX's."""
    gt, odo, loops = circle
    jsm = _start(JaxSmoother, JPose, gt, marginalize_every=3)
    tsm = _start(FixedLagSmoother, Pose, gt, marginalize_every=3, device="cpu")
    frames = list(range(1, len(gt)))
    _stream(jsm, JPose, gt, odo, loops, frames, mode="async")
    _stream(tsm, Pose, gt, odo, loops, frames, mode="async")
    assert tsm._pending is not None
    jsm.flush()
    tsm.flush()
    _assert_states_close(_state(tsm), _state(jsm), "amortized")
    assert int(tsm.last_summary.iterations) == int(jsm.last_summary.iterations)
    np.testing.assert_allclose(float(tsm.last_summary.final_cost),
                               float(jsm.last_summary.final_cost), rtol=1e-12)


def test_update_from_a_carried_jax_state(circle):
    """A JAX smoother mid-stream (prior, loops and history present) carried
    into the port by ``interop``: the next update of each within 1e-9, with
    equal LM counts."""
    gt, odo, loops = circle
    jsm = _start(JaxSmoother, JPose, gt)
    _stream(jsm, JPose, gt, odo, loops, list(range(1, 21)))
    state = _state(jsm)
    assert state["prior"] is not None and state["history"] and state["loops"]
    tsm = interop.fixed_lag_from_reference(state, lag=10, switch_penalty=0.03, device="cpu")
    _assert_states_close(_state(tsm), state, "carried")
    counts = []
    for sm, P in ((jsm, JPose), (tsm, Pose)):
        _stream(sm, P, gt, odo, loops, [21],
                on_update=lambda k, s: counts.append(int(s.iterations)))
    assert counts[0] == counts[1]
    _assert_states_close(_state(tsm), _state(jsm), "after the carried update")
