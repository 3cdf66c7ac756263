"""The port's batched pose-graph solves (``PoseGraphOptimizer.solve_batch``
and ``PoseGraphOptimizer2D.solve_batch``) against the port's own serial
``solve()`` and the JAX package's ``solve_batch``, mirroring the five
tests of tests/test_pose_graph_batch.py in float64 on the CPU:

- every batched instance reproduces the port's individual ``solve()`` on
  its own measurements and start: LM counts equal, poses within 1e-9
  (switches 1e-8 in SE(2), as the JAX test holds them), and JAX's
  ``solve_batch`` on the same inputs: counts equal, poses within 1e-8;
- omitted per-instance inputs broadcast the graph's own state;
- the validation errors are JAX's, word for word;
- the Monte-Carlo oracle: 768 resampled-measurement solves scatter as the
  port's ``covariance()`` predicts, to JAX's bounds (Frobenius 0.25, each
  diagonal ratio in (0.75, 1.3)), and that covariance equals JAX's (rtol
  1e-9).
"""

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.core import Options as JOptions
from nonlinear_optimizer_for_slam_tpu.solvers import pose_graph as jpg
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.core.pose import np_axis_angle_to_quat, np_quat_to_rotmat
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as tpg

POSE_TOL = 1e-9
JAX_TOL = 1e-8
SIGMA_T, SIGMA_R = 0.03, 0.02
SQRT_INFO = np.array([1.0 / SIGMA_T, 1.0 / SIGMA_R])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quat_mul(a, q):
    """Hamilton product, wxyz (numpy, batched on leading dims)."""
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _ring_world(P=10, loops=((0, 5), (2, 7))):
    """tests/test_pose_graph_batch.py's ring trajectory with chord
    closures and exact measurements: (positions, rotations, pairs,
    (t_rel, R_rel) per pair)."""
    pos = np.stack(
        [np.array([np.cos(2 * np.pi * i / P), np.sin(2 * np.pi * i / P), 0.05 * i])
         for i in range(P)]
    )
    rots = [_rz(2 * np.pi * i / P) for i in range(P)]
    pairs = [(i, i + 1) for i in range(P - 1)] + [tuple(l) for l in loops]
    rels = [(rots[i].T @ (pos[j] - pos[i]), rots[i].T @ rots[j]) for i, j in pairs]
    return pos, rots, pairs, rels


def _build(module, pos, rots, pairs, rels, init_noise=0.0, seed=0, **kw):
    if module == "jax":
        opt, Pose, CT = jpg.PoseGraphOptimizer(**kw), nls.Pose, jpg.ConstraintType
    else:
        opt, Pose, CT = tpg.PoseGraphOptimizer(device="cpu", **kw), port.Pose, tpg.ConstraintType
    rng = np.random.default_rng(seed)
    for i in range(len(pos)):
        dp = init_noise * rng.standard_normal(3) if i else np.zeros(3)
        opt.set_pose(i, Pose(rots[i], pos[i] + dp))
    opt.set_pose_constant(0)
    for (i, j), (t, R) in zip(pairs, rels):
        opt.set_constraint(i, j, Pose(R, t), CT.ODOMETRY, sqrt_info=SQRT_INFO)
    return opt


def _perturb_measurements(rels, rng):
    """tests/test_pose_graph_batch.py's noise model: t_rel += N(0,
    sigma_t^2 I), q_rel (x)= exp(N(0, sigma_r^2 I))."""
    t = np.stack([r[0] for r in rels])
    q = np.stack([port.Pose(r[1], r[0]).quaternion() for r in rels])
    t = t + SIGMA_T * rng.standard_normal(t.shape)
    dq = np.stack([np_axis_angle_to_quat(w) for w in SIGMA_R * rng.standard_normal(t.shape)])
    return t, _quat_mul(q, dq)


def _state(opt, P):
    return (np.stack([opt.get_pose(i).translation for i in range(P)]),
            np.stack([opt.get_pose(i).quaternion() for i in range(P)]))


def _same_quat(a, b, atol):
    """Quaternions equal up to the sign gauge."""
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * s, b, atol=atol)


def test_batch_instances_match_individual_solves():
    pos, rots, pairs, rels = _ring_world()
    P = len(pos)
    rng = np.random.default_rng(7)
    B = 3
    draws = [_perturb_measurements(rels, rng) for _ in range(B)]
    individual = []
    for b, (t, q) in enumerate(draws):
        noisy = [(tk, np_quat_to_rotmat(qk / np.linalg.norm(qk))) for tk, qk in zip(t, q)]
        one = _build("torch", pos, rots, pairs, noisy, init_noise=0.05, seed=b)
        summary, _ = one.solve(port.Options().replace(max_iterations=50))
        individual.append(_state(one, P) + (int(summary.iterations),))
    init_p = np.stack([
        np.stack([pos[i] + (0.05 * np.random.default_rng(b).standard_normal(3) if i else 0.0)
                  for i in range(P)])
        for b in range(B)
    ])
    init_q = np.broadcast_to(
        np.stack([port.Pose(rots[i], pos[i]).quaternion() for i in range(P)]), (B, P, 4))
    inputs = dict(initial_positions=init_p, initial_quaternions=init_q,
                  relative_translations=np.stack([d[0] for d in draws]),
                  relative_quaternions=np.stack([d[1] for d in draws]))
    bpos, bquat, bsw, bsum = _build("torch", pos, rots, pairs, rels).solve_batch(
        options=port.Options().replace(max_iterations=50), **inputs)
    jpos, jquat, _, jsum = _build("jax", pos, rots, pairs, rels).solve_batch(
        options=JOptions().replace(max_iterations=50), **inputs)
    assert bpos.shape == (B, P, 3) and bquat.shape == (B, P, 4) and bsw.shape == (B, 0)
    assert bsum.iterations.shape == (B,) and bsum.records.cost.shape == (B, 50)
    for b in range(B):
        ref_p, ref_q, ref_it = individual[b]
        np.testing.assert_allclose(bpos[b], ref_p, atol=POSE_TOL)
        _same_quat(bquat[b], ref_q, POSE_TOL)
        assert int(bsum.iterations[b]) == ref_it
    np.testing.assert_array_equal(bsum.iterations, np.asarray(jsum.iterations))
    np.testing.assert_allclose(bpos, jpos, atol=JAX_TOL)
    _same_quat(bquat, jquat, JAX_TOL)
    np.testing.assert_allclose(bsum.final_cost, np.asarray(jsum.final_cost), rtol=1e-8, atol=1e-14)
    # distinct noise draws converge to distinct optima
    assert np.abs(bpos[0] - bpos[1]).max() > 1e-4


def test_batch_default_broadcast_matches_solve():
    pos, rots, pairs, rels = _ring_world()
    opts = port.Options().replace(max_iterations=50)
    opt = _build("torch", pos, rots, pairs, rels, init_noise=0.08, seed=3)
    ref = _build("torch", pos, rots, pairs, rels, init_noise=0.08, seed=3)
    summary, _ = ref.solve(opts)
    bpos, _, _, bsum = opt.solve_batch(batch_size=2, options=opts)
    for b in range(2):
        np.testing.assert_allclose(bpos[b], _state(ref, len(pos))[0], atol=POSE_TOL)
        assert int(bsum.iterations[b]) == int(summary.iterations)


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_batch_validation():
    pos, rots, pairs, rels = _ring_world()
    opts = {m: _build(m, pos, rots, pairs, rels) for m in ("jax", "torch")}
    calls = [
        dict(),
        dict(batch_size=2, initial_positions=np.zeros((3, len(pos), 3))),
        dict(initial_positions=np.zeros((2, 3, 3))),
        dict(batch_size=2, relative_quaternions=np.zeros((2, 4, 4))),
    ]
    for kw in calls:
        assert _error(lambda: opts["torch"].solve_batch(**kw)) == _error(
            lambda: opts["jax"].solve_batch(**kw))
    for m, Pose, make in (("jax", nls.Pose, jpg.PoseGraphOptimizer),
                          ("torch", port.Pose, lambda **k: tpg.PoseGraphOptimizer(device="cpu", **k))):
        cg = make(solver="cg")
        cg.set_pose(0, Pose.identity())
        cg.set_pose(1, Pose.identity())
        cg.set_constraint(0, 1, Pose.identity())
        empty = make()
        empty.set_pose(0, Pose.identity())
        big = make(solver="auto")
        for i in range(900):
            big.set_pose(i, Pose.identity())
        opts[m] = (cg, empty, big)
    for k in range(3):
        assert _error(lambda: opts["torch"][k].solve_batch(batch_size=2)) == _error(
            lambda: opts["jax"][k].solve_batch(batch_size=2))
    assert "dense" in _error(lambda: opts["torch"][0].solve_batch(batch_size=2))
    assert "no constraints" in _error(lambda: opts["torch"][1].solve_batch(batch_size=2))


def test_monte_carlo_ensemble_matches_covariance():
    """The statistical oracle of tests/test_pose_graph_batch.py at its B =
    768 and its bounds: resampled-measurement solves from the true state
    scatter with the Gauss-Newton covariance."""
    pos, rots, pairs, rels = _ring_world(P=8, loops=((0, 4),))
    P = len(pos)
    opt = _build("torch", pos, rots, pairs, rels)
    opt.solve(port.Options().replace(max_iterations=30))  # exact: stays at truth
    cov = opt.covariance()
    jopt = _build("jax", pos, rots, pairs, rels)
    jopt.solve(JOptions().replace(max_iterations=30))
    jcov = jopt.covariance()
    for i in range(P):
        np.testing.assert_allclose(cov[i], jcov[i], rtol=1e-9, atol=1e-15)

    B = 768
    rng = np.random.default_rng(42)
    ts = np.empty((B, len(rels), 3))
    qs = np.empty((B, len(rels), 4))
    for b in range(B):
        ts[b], qs[b] = _perturb_measurements(rels, rng)
    bpos, bquat, _, bsum = opt.solve_batch(
        relative_translations=ts, relative_quaternions=qs,
        options=port.Options().replace(max_iterations=30))
    assert np.all(bsum.converged)
    true_q = np.stack([port.Pose(rots[i], pos[i]).quaternion() for i in range(P)])
    for i in (3, P - 1):  # mid-chain and chain-end marginals
        dp = bpos[:, i, :] - pos[i]
        qi = bquat[:, i, :] * np.sign(bquat[:, i, :1])
        conj = true_q[i] * np.array([1.0, -1.0, -1.0, -1.0])
        dth = 2.0 * _quat_mul(np.broadcast_to(conj, qi.shape), qi)[:, 1:]
        x = np.concatenate([dp, dth], axis=1)
        x = x - x.mean(axis=0)
        sample = (x.T @ x) / (B - 1)
        err = np.linalg.norm(sample - cov[i]) / np.linalg.norm(cov[i])
        assert err < 0.25, f"pose {i}: ensemble-vs-GN covariance off by {err:.3f}"
        diag_ratio = np.diag(sample) / np.diag(cov[i])
        assert np.all(diag_ratio > 0.75) and np.all(diag_ratio < 1.3), diag_ratio


def _ring_2d(module, gt, noisy, rels_e):
    P = len(gt)
    if module == "jax":
        opt, CT = jpg.PoseGraphOptimizer2D(switch_penalty=1.0), jpg.ConstraintType
    else:
        opt, CT = tpg.PoseGraphOptimizer2D(switch_penalty=1.0, device="cpu"), tpg.ConstraintType
    for k in range(P):
        opt.set_pose(k, noisy[k])
    opt.set_pose_constant(0)
    for e in range(P - 1):
        opt.set_constraint(e, e + 1, rels_e[e])
    opt.set_constraint(0, P // 2, rels_e[P - 1], CT.LOOP)
    return opt


def test_2d_solve_batch_matches_individual_solves():
    """tests/test_pose_graph_batch.py's SE(2) ring (24 poses, one loop, B =
    4 measurement realizations): each lane equals the port's individual
    solve (counts equal, poses within 1e-9, switches 1e-8) and JAX's
    batch."""
    rng = np.random.default_rng(9)
    P = 24
    ang = 2 * np.pi * np.arange(P) / P
    gt = np.stack([5 * np.cos(ang), 5 * np.sin(ang), np.arctan2(np.cos(ang), -np.sin(ang))], 1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        dp = b[:2] - a[:2]
        return np.array([c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1],
                         np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))])

    rel0 = np.stack([rel(gt[k], gt[k + 1]) for k in range(P - 1)] + [rel(gt[0], gt[P // 2])])
    noisy = gt + np.concatenate(
        [0.1 * rng.standard_normal((P, 2)), 0.05 * rng.standard_normal((P, 1))], axis=1)
    noisy[0] = gt[0]
    B = 4
    rels = rel0[None] + 1e-3 * rng.standard_normal((B,) + rel0.shape)
    init_b = np.broadcast_to(noisy, (B, P, 3))
    opts = port.Options().replace(max_iterations=100)
    xyt_b, sw_b, summary = _ring_2d("torch", gt, noisy, rel0).solve_batch(
        initial_xyt=init_b, relative_xyt=rels, options=opts)
    jxyt, jsw, jsum = _ring_2d("jax", gt, noisy, rel0).solve_batch(
        initial_xyt=init_b, relative_xyt=rels, options=JOptions().replace(max_iterations=100))
    assert xyt_b.shape == (B, P, 3) and sw_b.shape == (B, 1)
    for b in range(B):
        single = _ring_2d("torch", gt, noisy, rels[b])
        s, sw = single.solve(opts)
        ref = np.stack([single.get_pose(k) for k in single.pose_indices()])
        np.testing.assert_allclose(xyt_b[b], ref, atol=POSE_TOL)
        np.testing.assert_allclose(sw_b[b], sw, atol=1e-8)
        assert int(summary.iterations[b]) == int(s.iterations)
    np.testing.assert_array_equal(summary.iterations, np.asarray(jsum.iterations))
    np.testing.assert_allclose(xyt_b, jxyt, atol=JAX_TOL)
    np.testing.assert_allclose(sw_b, jsw, atol=JAX_TOL)
    pv = tpg.PoseGraphOptimizer2D(solver="cg", device="cpu")
    pj = jpg.PoseGraphOptimizer2D(solver="cg")
    for o in (pv, pj):
        o.set_pose(0, np.zeros(3))
    assert _error(lambda: pv.solve_batch(batch_size=2)) == _error(lambda: pj.solve_batch(batch_size=2))
    bad = _ring_2d("torch", gt, noisy, rel0)
    jbad = _ring_2d("jax", gt, noisy, rel0)
    for kw in (dict(), dict(initial_xyt=np.zeros((2, 3, 3))), dict(batch_size=3, relative_xyt=rels)):
        assert _error(lambda: bad.solve_batch(**kw)) == _error(lambda: jbad.solve_batch(**kw))
