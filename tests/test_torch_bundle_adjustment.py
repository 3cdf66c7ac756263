"""The port's bundle adjustment (``solvers/bundle_adjustment.py``) against
the JAX package's.

First the 8 tests of tests/test_bundle_adjustment.py on the port, on the
CPU in float64 (the adjuster's default dtype), with the same rigs and
bounds (each test draws its rig from a seed of its own). The JAX test of
the sharded solve on the 8-device virtual mesh becomes the port's on a
two-process gloo world: counts equal to the unsharded solve, poses within
1e-8, landmarks within 1e-7, final cost within rtol 1e-10 plus 1e-12 of
the first iteration's cost (the solve converges to a cost near 1e-12, at
the rounding floor of the sums, where the two orders of summation differ
relatively by about 2e-10), and the two ranks' results bitwise equal.

Then parity with the JAX package, float64 on both sides, on the same
numpy inputs:

- ``_inv3x3`` within rtol 1e-12 of JAX's (and of ``numpy.linalg.inv``);
- ``_observation_residuals_jacobians`` (r, J_c, J_l and the depth gate,
  with observations behind the camera and masked ones) within rtol 1e-12
  of the largest entry;
- ``BundleAdjuster.solve`` in the flat one-shot, flat chunked
  (``landmark_chunk=97``) and grouped layouts, with and without
  ``HuberLoss``: LM iteration counts equal, poses and landmarks within
  1e-8, final costs within rtol 1e-8 (plus 1e-20 absolute: a converged
  cost is near 1e-12, at the rounding floor of the sums);
- a ``BAData``, ``BAParams`` and intrinsics carried across by
  ``interop`` give JAX's factor values and go back exactly.
"""

import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import parallel
from nonlinear_optimizer_for_slam_tpu_torch.core.options import ConvergenceHandle
from nonlinear_optimizer_for_slam_tpu_torch.ops.reprojection import CameraIntrinsics
from nonlinear_optimizer_for_slam_tpu_torch.solvers import bundle_adjustment as tba
from nonlinear_optimizer_for_slam_tpu_torch.solvers.bundle_adjustment import (
    BAData,
    BAParams,
    BundleAdjuster,
)

TOL = 1e-8
INTR = CameraIntrinsics.create(525.0, 525.0, 320.0, 240.0, 640, 480)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the solves are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def Adjuster(**kw):
    return BundleAdjuster(device="cpu", **kw)


def _project(pose, landmarks):
    pc = pose.inverse().apply(landmarks)  # camera frame
    uv = np.stack([525.0 * pc[:, 0] / pc[:, 2] + 320.0, 525.0 * pc[:, 1] / pc[:, 2] + 240.0], 1)
    vis = ((pc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < 640)
           & (uv[:, 1] >= 0) & (uv[:, 1] < 480))
    return uv, vis


def _data(cam_idx, lm_idx, pixels):
    return BAData(np.array(cam_idx, np.int64), np.array(lm_idx, np.int64), np.stack(pixels),
                  np.ones(len(cam_idx)))


def _make_rig(rng, num_cameras=8, num_landmarks=300, noise=0.05):
    """tests/test_bundle_adjustment.py's arc rig: cameras on an arc looking
    at a landmark cloud; the solved poses map WORLD -> CAMERA (the inverse
    of the camera-in-world pose); two cameras kept exact for the gauge."""
    landmarks = np.stack([rng.uniform(-2, 2, num_landmarks), rng.uniform(-1.5, 1.5, num_landmarks),
                          rng.uniform(4.0, 8.0, num_landmarks)], axis=1)
    true_poses = [
        port.Pose.from_axis_angle(0.05 * (i - num_cameras / 2), [0, 1.0, 0],
                                  np.array([0.4 * i - 1.6, 0.05 * i, 0.0]))
        for i in range(num_cameras)
    ]
    cam_idx, lm_idx, pixels = [], [], []
    for ci, pose in enumerate(true_poses):
        uv, vis = _project(pose, landmarks)
        for li in np.nonzero(vis)[0]:
            cam_idx.append(ci)
            lm_idx.append(li)
            pixels.append(uv[li])
    solver_true = [p.inverse() for p in true_poses]
    noisy = [solver_true[0].copy(), solver_true[1].copy()]
    for p in solver_true[2:]:
        dp = port.Pose.from_axis_angle(noise * rng.normal(), rng.normal(size=3),
                                       noise * rng.normal(size=3))
        noisy.append(p * dp)
    noisy_lms = landmarks + noise * rng.normal(size=landmarks.shape)
    return _data(cam_idx, lm_idx, pixels), solver_true, noisy, landmarks, noisy_lms


def _orbit_rig(rng, num_cameras, num_landmarks):
    """tests/test_bundle_adjustment.py's orbit rig: cameras on a ring, every
    one looking at the landmark cloud at the center, ~50 % of the visible
    landmarks observed."""
    landmarks = np.stack([rng.uniform(-2, 2, num_landmarks), rng.uniform(-2, 2, num_landmarks),
                          rng.uniform(-1.5, 1.5, num_landmarks)], axis=1)
    world_from_cam = []
    for ci in range(num_cameras):
        ang = 2.0 * np.pi * ci / num_cameras
        center = np.array([8.0 * np.cos(ang), 8.0 * np.sin(ang), 0.3 * np.sin(3 * ang)])
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        world_from_cam.append(port.Pose(np.stack([x, np.cross(z, x), z], axis=1), center))
    cam_idx, lm_idx, pixels = [], [], []
    for ci, pose in enumerate(world_from_cam):
        uv, vis = _project(pose, landmarks)
        vis &= rng.uniform(size=num_landmarks) < 0.5
        for li in np.nonzero(vis)[0]:
            cam_idx.append(ci)
            lm_idx.append(li)
            pixels.append(uv[li])
    solver_true = [p.inverse() for p in world_from_cam]
    noisy = [solver_true[0].copy(), solver_true[1].copy()]
    for p in solver_true[2:]:
        dp = port.Pose.from_axis_angle(0.01 * rng.normal(), rng.normal(size=3),
                                       0.03 * rng.normal(size=3))
        noisy.append(p * dp)
    noisy_lms = landmarks + 0.03 * rng.normal(size=landmarks.shape)
    return _data(cam_idx, lm_idx, pixels), solver_true, noisy, landmarks, noisy_lms


def _solve(adjuster, opts, data, poses, lms):
    return adjuster.solve(opts, data, INTR, poses, lms, fixed_cameras=(0, 1))


# ---- tests/test_bundle_adjustment.py on the port ---------------------------


def test_ba_recovers_rig():
    data, true_poses, noisy, true_lms, noisy_lms = _make_rig(np.random.default_rng(1))
    poses, lms, summary = _solve(Adjuster(), port.Options().replace(max_iterations=60), data,
                                 noisy, noisy_lms)
    assert float(summary.final_cost) < 1e-10, float(summary.final_cost)
    for est, true in zip(poses, true_poses):
        np.testing.assert_allclose(est.translation, true.translation, atol=1e-5)
        np.testing.assert_allclose(est.rotation, true.rotation, atol=1e-5)
    np.testing.assert_allclose(lms, true_lms, atol=1e-4)
    np.testing.assert_allclose(poses[0].translation, noisy[0].translation, atol=1e-12)


def test_ba_robust_loss_downweights_outliers():
    rng = np.random.default_rng(2)
    data, true_poses, noisy, _, noisy_lms = _make_rig(rng)
    # corrupt 2% of observations with gross pixel errors
    pixels = data.pixels.copy()
    n_out = max(1, pixels.shape[0] // 50)
    out_ids = rng.choice(pixels.shape[0], n_out, replace=False)
    pixels[out_ids] += rng.uniform(80, 150, size=(n_out, 2))
    data = data._replace(pixels=pixels)
    opts = port.Options().replace(max_iterations=60)

    def run(loss):
        poses, _, _ = _solve(Adjuster().set_loss_function(loss), opts, data, noisy, noisy_lms)
        return max(np.linalg.norm(e.translation - t.translation) for e, t in zip(poses, true_poses))

    err_trivial = run(None)
    err_huber = run(port.HuberLoss(threshold=0.01))
    # Huber downweights outliers, it does not reject them
    assert err_huber < 0.5 * err_trivial, (err_huber, err_trivial)
    assert err_huber < 0.05, err_huber


def test_schur_step_equals_dense_step():
    """On a tiny problem the damped Schur step (the solver's own step at
    lambda = 1e-3) equals the step of the full dense (6C + 3M) normal
    equations."""
    data, _, noisy, _, noisy_lms = _make_rig(np.random.default_rng(3), num_cameras=3,
                                             num_landmarks=25)
    C, M = 3, 25
    f64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    params = BAParams(f64(np.stack([p.translation for p in noisy])),
                      f64(np.stack([p.quaternion() for p in noisy])), f64(noisy_lms))
    tdata = BAData(torch.tensor(data.camera_indices), torch.tensor(data.landmark_indices),
                   f64(data.pixels), f64(data.mask))
    intr = CameraIntrinsics(*(f64(v) for v in INTR[:6]), INTR.width, INTR.height)
    r, J_c, J_l, _ = tba._observation_residuals_jacobians(params, tdata, intr)
    r, J_c, J_l = r.numpy(), J_c.numpy(), J_l.numpy()
    lam = 1e-3
    dim = 6 * C + 3 * M
    J = np.zeros((r.shape[0], 2, dim))
    for o, (ci, li) in enumerate(zip(data.camera_indices, data.landmark_indices)):
        J[o, :, 6 * ci: 6 * ci + 6] = J_c[o]
        J[o, :, 6 * C + 3 * li: 6 * C + 3 * li + 3] = J_l[o]
    Jm = J.reshape(-1, dim)
    H = Jm.T @ Jm
    g = Jm.T @ r.reshape(-1)
    Hd = H + lam * H * np.eye(dim) + 1e-8 * np.diag(np.r_[np.zeros(6 * C), np.ones(3 * M)])
    delta_dense = np.linalg.solve(Hd, -g)

    free = torch.ones(C, dtype=torch.float64)
    step = tba._flat_schur_step(tdata, intr, None, free, C, M)
    dc, dl, _, _, _ = step(params, torch.tensor(lam, dtype=torch.float64))
    np.testing.assert_allclose(dc.numpy().ravel(), delta_dense[: 6 * C], rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(dl.numpy().ravel(), delta_dense[6 * C:], rtol=1e-6, atol=1e-10)


def _rank_main(rank: int, world: int, work_dir: str) -> None:
    """One rank of the two-process world: the sharded solve of
    :func:`_sharded_case`, written to ``rank{rank}.npz``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(work_dir, "rdv"),
                                world_size=world, rank=rank)
        try:
            mesh = parallel.make_global_factor_mesh(device="cpu")
            np.savez(os.path.join(work_dir, f"rank{rank}.npz"), **_sharded_case(mesh))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _sharded_case(mesh) -> dict:
    data, _, noisy, _, noisy_lms = _make_rig(np.random.default_rng(4), num_cameras=5,
                                             num_landmarks=100)
    out = {}
    for name, chunk in (("one_shot", "auto"), ("chunked", 13)):
        poses, lms, s = _solve(Adjuster(mesh=mesh, landmark_chunk=chunk),
                               port.Options().replace(max_iterations=25), data, noisy, noisy_lms)
        out[f"{name}/poses"] = np.stack([p.matrix() for p in poses])
        out[f"{name}/landmarks"] = lms
        out[f"{name}/iterations"] = int(s.iterations)
        out[f"{name}/final_cost"] = float(s.final_cost)
        out[f"{name}/first_cost"] = float(s.records.cost[0])
    return out


def test_sharded_ba_matches_single_device(tmp_path):
    """Landmark-sharded BA over a two-process gloo world (the landmarks'
    second half on rank 1; one-shot and chunked cross terms) equals the
    unsharded solve, and the ranks hold the same bits."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    want = _sharded_case(None)
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
    errors = [open(tmp_path / f).read() for f in os.listdir(tmp_path) if f.endswith(".err")]
    assert not errors, "\n".join(errors)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in want:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    for name in ("one_shot", "chunked"):
        got = ranks[0]
        assert int(got[f"{name}/iterations"]) == want[f"{name}/iterations"]
        np.testing.assert_allclose(got[f"{name}/poses"], want[f"{name}/poses"], atol=1e-8)
        np.testing.assert_allclose(got[f"{name}/landmarks"], want[f"{name}/landmarks"], atol=1e-7)
        np.testing.assert_allclose(float(got[f"{name}/final_cost"]), want[f"{name}/final_cost"],
                                   rtol=1e-10, atol=1e-12 * want[f"{name}/first_cost"])


def test_chunked_schur_matches_one_shot():
    """The landmark-chunked cross-term accumulation equals the one-shot
    (M, C, 6, 3) product, chunk boundaries at awkward offsets included."""
    data, _, noisy, _, noisy_lms = _make_rig(np.random.default_rng(5))
    opts = port.Options().replace(max_iterations=15)
    p1, l1, s1 = _solve(Adjuster(landmark_chunk=None, layout="flat"), opts, data, noisy, noisy_lms)
    # 300 landmarks / chunk 97 -> 4 chunks, the last one ragged
    p2, l2, s2 = _solve(Adjuster(landmark_chunk=97, layout="flat"), opts, data, noisy, noisy_lms)
    assert int(s1.iterations) == int(s2.iterations)
    np.testing.assert_allclose(l2, l1, atol=1e-8)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.translation, a.translation, atol=1e-8)
        np.testing.assert_allclose(b.rotation, a.rotation, atol=1e-8)


def test_grouped_layout_matches_flat():
    """The track-major (grouped) layout follows the flat layout's LM
    trajectory: same iteration count, cost, poses and landmarks, with and
    without Huber."""
    data, _, noisy, _, noisy_lms = _make_rig(np.random.default_rng(6))
    opts = port.Options().replace(max_iterations=20)
    p1, l1, s1 = _solve(Adjuster(layout="flat"), opts, data, noisy, noisy_lms)
    p2, l2, s2 = _solve(Adjuster(layout="grouped"), opts, data, noisy, noisy_lms)
    assert int(s1.iterations) == int(s2.iterations)
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(l2, l1, atol=1e-7)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.translation, a.translation, atol=1e-7)
        np.testing.assert_allclose(b.rotation, a.rotation, atol=1e-7)
    huber = port.HuberLoss(0.01)
    _, _, sf = _solve(Adjuster(layout="flat").set_loss_function(huber), opts, data, noisy,
                      noisy_lms)
    _, _, sg = _solve(Adjuster(layout="grouped").set_loss_function(huber), opts, data, noisy,
                      noisy_lms)
    assert int(sf.iterations) == int(sg.iterations)
    np.testing.assert_allclose(float(sg.final_cost), float(sf.final_cost), rtol=1e-8, atol=1e-12)


def test_ba_medium_rig_chunked():
    """40 cameras x 2,000 landmarks through the chunked path: converges
    and recovers the rig."""
    data, true_poses, noisy, _, noisy_lms = _orbit_rig(np.random.default_rng(7), 40, 2000)
    counts = np.bincount(data.camera_indices, minlength=40)
    assert counts.min() > 100  # every camera well-constrained
    poses, _, summary = _solve(Adjuster(landmark_chunk=256, layout="flat"),
                               port.Options().replace(max_iterations=40), data, noisy, noisy_lms)
    err = max(np.linalg.norm(p.translation - tp.translation) for p, tp in zip(poses, true_poses))
    assert err < 1e-4, err
    assert float(summary.final_cost) < 1e-6


def test_ba_plateau_summary_fields():
    """The monotone safeguard on the BA loop: plateau solves report
    plateau_stop and best_cost, final_cost == best_cost on a plateau exit;
    default options leave the fields None."""
    data, _, noisy, _, noisy_lms = _make_rig(np.random.default_rng(8))
    ba = Adjuster()
    _, _, s_plain = _solve(ba, port.Options().replace(max_iterations=5), data, noisy, noisy_lms)
    assert s_plain.plateau_stop is None and s_plain.best_cost is None
    opts = port.Options().replace(
        max_iterations=80,
        convergence_handle=ConvergenceHandle(
            gradient_tolerance=0.0, parameter_tolerance=0.0, relative_function_tolerance=1e-9
        ),
    )
    _, _, s = _solve(ba, opts, data, noisy, noisy_lms)
    assert bool(s.converged)
    assert s.plateau_stop is not None
    if bool(s.plateau_stop):
        np.testing.assert_allclose(float(s.final_cost), float(s.best_cost), rtol=0)


# ---- parity with the JAX package ---------------------------------------------


def test_inv3x3_matches_jax():
    import jax.numpy as jnp

    from nonlinear_optimizer_for_slam_tpu.solvers import bundle_adjustment as jba

    rng = np.random.default_rng(9)
    A = rng.normal(size=(64, 3, 3))
    V = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(3)
    got = tba._inv3x3(torch.tensor(V)).numpy()
    np.testing.assert_allclose(got, np.asarray(jba._inv3x3(jnp.asarray(V))), rtol=1e-12)
    np.testing.assert_allclose(got, np.linalg.inv(V), rtol=1e-10)


def test_observation_residuals_jacobians_match_jax():
    """Residuals, both Jacobians and the depth gate on random cameras and
    points, some behind the camera or under the 0.03 depth gate, some
    masked."""
    import jax.numpy as jnp

    from nonlinear_optimizer_for_slam_tpu.ops.reprojection import CameraIntrinsics as JIntr
    from nonlinear_optimizer_for_slam_tpu.solvers import bundle_adjustment as jba

    rng = np.random.default_rng(10)
    C, M, O = 5, 40, 200
    q = rng.normal(size=(C, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    arrays = dict(t=rng.normal(size=(C, 3)), q=q,
                  lms=rng.normal(size=(M, 3)) + np.array([0.0, 0.0, 3.0]))
    arrays["lms"][:6] *= -1.0  # some behind the camera
    cam = rng.integers(0, C, O)
    lm = rng.integers(0, M, O)
    px = rng.uniform(0, 640, size=(O, 2))
    mask = (rng.uniform(size=O) > 0.1).astype(float)
    want = jba._observation_residuals_jacobians(
        jba.BAParams(*(jnp.asarray(arrays[k]) for k in ("t", "q", "lms"))),
        jba.BAData(jnp.asarray(cam, jnp.int32), jnp.asarray(lm, jnp.int32), jnp.asarray(px),
                   jnp.asarray(mask)),
        JIntr(*(jnp.asarray(v) for v in INTR[:6]), INTR.width, INTR.height),
    )
    f64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    got = tba._observation_residuals_jacobians(
        BAParams(*(f64(arrays[k]) for k in ("t", "q", "lms"))),
        BAData(torch.tensor(cam), torch.tensor(lm), f64(px), f64(mask)),
        CameraIntrinsics(*(f64(v) for v in INTR[:6]), INTR.width, INTR.height),
    )
    assert 0 < float(np.sum(np.asarray(want[3]))) < O  # the gate and the mask bite
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())


@pytest.fixture(scope="module")
def parity_rig():
    return _make_rig(np.random.default_rng(11))


@pytest.mark.parametrize("layout, chunk", [("flat", None), ("flat", 97), ("grouped", "auto")],
                         ids=["flat_one_shot", "flat_chunk97", "grouped"])
@pytest.mark.parametrize("huber", [False, True], ids=["trivial", "huber"])
def test_solve_matches_jax(parity_rig, layout, chunk, huber):
    import jax.numpy as jnp

    import nonlinear_optimizer_for_slam_tpu as nls
    from nonlinear_optimizer_for_slam_tpu.core import HuberLoss, Options
    from nonlinear_optimizer_for_slam_tpu.ops.reprojection import CameraIntrinsics as JIntr
    from nonlinear_optimizer_for_slam_tpu.solvers import bundle_adjustment as jba

    data, _, noisy, _, noisy_lms = parity_rig
    jdata = jba.BAData(jnp.asarray(data.camera_indices, jnp.int32),
                       jnp.asarray(data.landmark_indices, jnp.int32),
                       jnp.asarray(data.pixels), jnp.asarray(data.mask))
    jposes = [nls.Pose(p.rotation, p.translation) for p in noisy]
    jintr = JIntr.create(525.0, 525.0, 320.0, 240.0, 640, 480)
    jp, jl, js = jba.BundleAdjuster(landmark_chunk=chunk, layout=layout).set_loss_function(
        HuberLoss(0.01) if huber else None
    ).solve(Options().replace(max_iterations=20), jdata, jintr, jposes, noisy_lms,
            fixed_cameras=(0, 1))
    tp, tl, ts = _solve(
        Adjuster(landmark_chunk=chunk, layout=layout).set_loss_function(
            port.HuberLoss(0.01) if huber else None),
        port.Options().replace(max_iterations=20), data, noisy, noisy_lms,
    )
    assert int(ts.iterations) == int(js.iterations)
    np.testing.assert_allclose(float(ts.final_cost), float(js.final_cost), rtol=1e-8, atol=1e-20)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.translation, b.translation, rtol=0, atol=TOL)
        np.testing.assert_allclose(a.rotation, b.rotation, rtol=0, atol=TOL)


def test_interop_carries_ba_state(parity_rig):
    """A JAX ``BAData``, ``BAParams`` and ``CameraIntrinsics`` carried across
    by ``interop.from_reference`` give the observation factor JAX's values
    (1e-12 of the largest entry) and go back by ``to_reference`` exactly."""
    import jax.numpy as jnp

    from nonlinear_optimizer_for_slam_tpu.ops.reprojection import CameraIntrinsics as JIntr
    from nonlinear_optimizer_for_slam_tpu.solvers import bundle_adjustment as jba
    from nonlinear_optimizer_for_slam_tpu_torch import interop

    data, _, noisy, _, noisy_lms = parity_rig
    jdata = jba.BAData(jnp.asarray(data.camera_indices, jnp.int32),
                       jnp.asarray(data.landmark_indices, jnp.int32),
                       jnp.asarray(data.pixels), jnp.asarray(data.mask))
    jparams = jba.BAParams(jnp.asarray(np.stack([p.translation for p in noisy])),
                           jnp.asarray(np.stack([p.quaternion() for p in noisy])),
                           jnp.asarray(noisy_lms))
    jintr = JIntr.create(525.0, 525.0, 320.0, 240.0, 640, 480)
    as_np = lambda t: {f: np.asarray(v) for f, v in zip(t._fields, t)}
    state = interop.from_reference(
        ba_data=as_np(jdata), ba_params=as_np(jparams),
        intrinsics=dict(fx=525.0, fy=525.0, cx=320.0, cy=240.0, width=640, height=480),
        device="cpu", dtype=torch.float64,
    )
    intr = CameraIntrinsics(*(torch.tensor(float(v), dtype=torch.float64)
                              for v in state.intrinsics[:6]), 640, 480)
    got = tba._observation_residuals_jacobians(state.ba_params, state.ba_data, intr)
    want = jba._observation_residuals_jacobians(jparams, jdata, JIntr(
        *(jnp.asarray(v) for v in jintr[:6]), jintr.width, jintr.height))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())
    back = interop.to_reference(state)
    for key, ref in (("ba_data", jdata), ("ba_params", jparams)):
        for f, v in zip(ref._fields, ref):
            assert np.array_equal(back[key][f], np.asarray(v)), (key, f)
