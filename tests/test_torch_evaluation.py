"""The port's ``utils/evaluation.py`` (Umeyama alignment, ATE, RPE) against
the JAX package's, mirroring tests/test_evaluation.py: every case runs
both copies on the same numpy inputs and their outputs agree within rtol
1e-12 (and each keeps the JAX test's own bounds). The end-to-end case
solves ``generate_manhattan_g2o(n_poses=300, seed=9)`` through the port's
g2o writer and reader and its banded SE(2) path on the CPU, and the
port's ATE of the solved graph equals JAX's ATE of the same arrays.
"""

import os

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.utils import evaluation as jev
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.io import g2o as tg2o
from nonlinear_optimizer_for_slam_tpu_torch.utils import evaluation as tev
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing as ttesting

RTOL = 1e-12


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _same(got, want):
    """Nested dicts, tuples or arrays of both copies within RTOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)


def test_umeyama_recovers_exact_similarity(rng):
    src = rng.normal(size=(40, 3))
    R_true = _random_rotation(rng)
    t_true = rng.normal(size=3)
    dst = 2.37 * src @ R_true.T + t_true
    R, t, s = tev.umeyama_alignment(src, dst, with_scale=True)
    np.testing.assert_allclose(R, R_true, atol=1e-12)
    np.testing.assert_allclose(t, t_true, atol=1e-11)
    assert s == pytest.approx(2.37, rel=1e-12)
    _same((R, t, s), jev.umeyama_alignment(src, dst, with_scale=True))
    dst_r = src @ R_true.T + t_true
    R2, _, s2 = tev.umeyama_alignment(src, dst_r, with_scale=False)
    np.testing.assert_allclose(R2, R_true, atol=1e-12)
    assert s2 == 1.0
    _same(tev.umeyama_alignment(src, dst_r), jev.umeyama_alignment(src, dst_r))


def test_umeyama_reflection_guard(rng):
    src = rng.normal(size=(30, 3))
    src[:, 2] *= 1e-9  # squash to a plane
    dst = src @ _random_rotation(rng).T
    R, t, s = tev.umeyama_alignment(src, dst)
    assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-9)
    np.testing.assert_allclose(src @ R.T + t, dst, atol=1e-8)
    _same((R, t, s), jev.umeyama_alignment(src, dst))


def test_ate_zero_after_alignment_and_scale(rng):
    gt = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    est = 0.5 * gt @ _random_rotation(rng).T + np.array([4.0, -2.0, 1.0])
    out = tev.absolute_trajectory_error(est, gt, align=True, with_scale=True)
    assert out["rmse"] < 1e-10
    assert out["scale"] == pytest.approx(2.0, rel=1e-10)
    raw = tev.absolute_trajectory_error(est, gt, align=False)
    assert raw["rmse"] > 1.0
    _same(raw, jev.absolute_trajectory_error(est, gt, align=False))
    # the aligned errors are roundoff (1e-15): hold them to the scale
    want = jev.absolute_trajectory_error(est, gt, align=True, with_scale=True)
    assert out["scale"] == pytest.approx(want["scale"], rel=RTOL)
    for k in ("rmse", "mean", "median", "max"):
        assert abs(out[k] - want[k]) < 1e-12 * np.abs(gt).max()


def test_rpe_invariant_to_global_transform(rng):
    n = 30
    poses = []
    p = np.zeros(3)
    for _ in range(n):
        p = p + rng.normal(size=3)
        poses.append((_random_rotation(rng), p.copy()))
    g = (_random_rotation(rng), np.array([5.0, 6.0, -7.0]))
    noise = rng.normal(0, 0.05, (n, 3))
    for module, Pose, ev in (("torch", port.Pose, tev), ("jax", nls.Pose, jev)):
        gt = [Pose(R, t) for R, t in poses]
        est = [Pose(*g) * pk for pk in gt]
        est_noisy = [Pose(pk.rotation, pk.translation + dn) for pk, dn in zip(est, noise)]
        if module == "torch":
            out = ev.relative_pose_error(est, gt, delta=1)
            assert out["translation"]["rmse"] < 1e-10 and out["rotation"]["rmse"] < 1e-6
            noisy = ev.relative_pose_error(est_noisy, gt, delta=1)
            assert 0.02 < noisy["translation"]["rmse"] < 0.3
        else:
            _same(noisy, ev.relative_pose_error(est_noisy, gt, delta=1))


def test_input_formats_and_validation(rng):
    xyt = np.stack([np.array([k * 1.0, 0.1 * k, 0.05 * k]) for k in range(10)])
    xyt_noisy = xyt + 0.01 * rng.normal(size=xyt.shape)
    out = tev.relative_pose_error(xyt, xyt, delta=2)
    assert out["translation"]["rmse"] < 1e-12
    _same(tev.relative_pose_error(xyt_noisy, xyt, delta=2),
          jev.relative_pose_error(xyt_noisy, xyt, delta=2))
    tq = np.zeros((10, 7))
    tq[:, 0] = np.arange(10)
    tq[:, 3] = 1.0  # identity quaternions
    assert tev.relative_pose_error(tq, tq)["rotation"]["max"] < 1e-12
    tq_noisy = tq + 0.01 * rng.normal(size=tq.shape)
    _same(tev.relative_pose_error(tq_noisy, tq), jev.relative_pose_error(tq_noisy, tq))
    bad = [
        lambda ev: ev.relative_pose_error(tq, tq[:5]),
        lambda ev: ev.relative_pose_error(tq, tq, delta=10),
        lambda ev: ev.umeyama_alignment(np.zeros((2, 3)), np.zeros((2, 3))),
        lambda ev: ev.absolute_trajectory_error(np.zeros((4, 3)), np.zeros((5, 3))),
        lambda ev: ev.relative_pose_error(np.zeros((4, 5)), np.zeros((4, 5))),
    ]
    for call in bad:
        with pytest.raises(ValueError) as got:
            call(tev)
        with pytest.raises(ValueError) as want:
            call(jev)
        assert str(got.value) == str(want.value)


def test_solved_graph_scores_better_than_drift(tmp_path):
    """The Manhattan fixture (300 poses) through the port's g2o path and
    banded solve collapses its dead-reckoned ATE, as the JAX test asks."""
    g, gt = ttesting.generate_manhattan_g2o(n_poses=300, seed=9)
    gt3 = np.concatenate([gt[:, :2], np.zeros((len(gt), 1))], axis=1)
    init3 = np.stack([np.array([g.vertices[k][0], g.vertices[k][1], 0.0]) for k in range(len(gt))])
    path = os.path.join(tmp_path, "manhattan300.g2o")
    tg2o.write_g2o(path, g)
    opt = tg2o.load_pose_graph(path, dtype=torch.float64, solver="banded", device="cpu")
    opt.solve(port.Options().replace(max_iterations=60))
    est3 = np.stack([np.concatenate([opt.get_pose(k)[:2], [0.0]]) for k in range(len(gt))])
    ate_init = tev.absolute_trajectory_error(init3, gt3)
    ate_solved = tev.absolute_trajectory_error(est3, gt3)
    assert ate_solved["rmse"] < 0.2 * ate_init["rmse"], (ate_solved, ate_init)
    _same(ate_solved, jev.absolute_trajectory_error(est3, gt3))


def test_ate_planar_excludes_heading(rng):
    xy = np.cumsum(rng.normal(size=(40, 2)), axis=0)
    theta = rng.uniform(-np.pi, np.pi, size=(40, 1))
    est = np.concatenate([xy, theta], axis=1)  # exact positions, noisy heading
    gt = np.concatenate([xy, np.zeros((40, 1))], axis=1)
    out = tev.absolute_trajectory_error(est, gt, align=False, planar=True)
    assert out["rmse"] < 1e-12
    raw = tev.absolute_trajectory_error(est, gt, align=False)
    assert raw["rmse"] > 0.1
    _same(raw, jev.absolute_trajectory_error(est, gt, align=False))
    _same(tev.absolute_trajectory_error(est, gt, planar=True, with_scale=True),
          jev.absolute_trajectory_error(est, gt, planar=True, with_scale=True))
