"""The port's slice as a whole: the planar 3-DoF NDT minimizer and the
reprojection (PnP) minimizer.

- ``MahalanobisDistanceMinimizer3DOF`` through ``register_ndt``, the port
  against the JAX package on the coarse room (``point_step=0.05``), float32
  and float64: the same outer count, every inner cost within rtol 1e-5, the
  pose within 1e-5 (two pipelines that sum in different orders), and z,
  roll and pitch of the input pose passed through untouched;
- the kernel's packed path (backend "cuda" through the plain versions on
  the CPU) against the "torch" backend, for both minimizers;
- planar priors (with the yaw wrap) and the reprojection minimizer, port
  against JAX; ``ReprojectionErrorMinimizer`` in float64 reproduces
  ``ORACLE_REPROJ`` (every (cost, lambda) within rtol 1e-9, 6 iterations,
  the pose within 1e-9);
- ``information``, the device rules, and ``interop`` for the reprojection
  problem.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.ops import mahalanobis as jmaha
from nonlinear_optimizer_for_slam_tpu.ops import reprojection as jreproj
from nonlinear_optimizer_for_slam_tpu.pipelines import ndt as jndt
from nonlinear_optimizer_for_slam_tpu.pipelines import registration as jreg
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops import reprojection as treproj
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import matching, ndt
from nonlinear_optimizer_for_slam_tpu_torch.solvers import minimizers
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

JDTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny ops, which
    more threads only slow down, most of all when test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coarse_planar():
    """The room at 5 cm, its NDT map from both packages (the port's copy of
    ``build_ndt_map`` equals the JAX one bit for bit:
    tests/test_torch_registration.py), and the scan at the 3dof_6dof
    fixture's true pose."""
    pts = testing.generate_room_points(point_step=0.05)
    tmap, jmap = ndt.build_ndt_map(pts, 1.0), jndt.build_ndt_map(pts, 1.0)
    local = testing.maha_3dof6dof_true_pose().inverse().apply(ndt.filter_points(pts, 0.1))
    return tmap, jmap, local


@pytest.fixture(scope="module")
def reproj_fixture():
    """The reference PnP fixture from both packages (the same numbers)."""
    pts, pix, intr, true_pose = testing.generate_reprojection_fixture()
    jpts, jpix, jintr, jtrue = jtesting.generate_reprojection_fixture()
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(pix, jpix)
    assert tuple(intr) == tuple(jintr)
    np.testing.assert_array_equal(true_pose.matrix(), jtrue.matrix())
    return pts, pix, intr, true_pose


def _tilted_start():
    """A start off the plane: z 0.02 m and a small roll and pitch, which the
    planar solver must pass through untouched."""
    return port.Pose.from_axis_angle(0.01, [1.0, -0.5, 0.0], [0.0, 0.0, 0.02])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_planar_registration_matches_jax(coarse_planar, dtype):
    tmap, jmap, local = coarse_planar
    start = _tilted_start()
    jm = nls.MahalanobisDistanceMinimizer3DOF(backend="jnp", dtype=JDTYPE[dtype])
    jm.set_loss_function(nls.ExponentialLoss(1.0, 1.0))
    jstart = nls.Pose(start.rotation, start.translation)
    jres = jreg.register_ndt(jmap, local, jstart, jm, nls.Options())
    tm = port.MahalanobisDistanceMinimizer3DOF(dtype=dtype, device="cpu").set_loss_function(
        port.ExponentialLoss(1.0, 1.0)
    )
    assert tm.backend == "torch"
    tres = port.register_ndt(tmap, local, start, tm, port.Options())

    assert tres.outer_iterations == jres.outer_iterations
    assert [int(s.iterations) for s in tres.summaries] == [int(s.iterations) for s in jres.summaries]
    np.testing.assert_allclose(
        [float(s.final_cost) for s in tres.summaries],
        [float(s.final_cost) for s in jres.summaries],
        rtol=1e-5,
    )
    np.testing.assert_allclose(tres.pose.translation, jres.pose.translation, atol=1e-5)
    np.testing.assert_allclose(tres.pose.rotation, jres.pose.rotation, atol=1e-5)
    # z, roll and pitch of the input pose pass through, bit for bit
    assert tres.pose.translation[2] == start.translation[2]
    np.testing.assert_array_equal(tres.pose.rotation[2], start.rotation[2])
    np.testing.assert_array_equal(tres.pose.rotation[:2, 2], start.rotation[:2, 2])
    truth = testing.maha_3dof6dof_true_pose()
    assert np.linalg.norm(tres.pose.translation[:2] - truth.translation[:2]) < 0.05


def _first_planar_data(coarse_planar, dtype):
    tmap, _, local = coarse_planar
    valid = tmap.valid_only()
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    return matching.match_point_cloud(
        as_t(valid.means), as_t(valid.sqrt_informations), as_t(local),
        torch.ones(local.shape[0], dtype=dtype), torch.eye(3, dtype=dtype),
        torch.zeros(3, dtype=dtype),
    )


def test_planar_kernel_path_matches_torch_backend(coarse_planar):
    """One planar solve through the kernel's compact packed path, which on
    the CPU runs the maha3c plain version, against the "torch" backend: the
    same float32 objective in the Gram form and row by row (rtol 1e-4 on
    the costs, 1e-5 on the pose)."""
    data = _first_planar_data(coarse_planar, torch.float32)
    data = data.pad_to(((data.num_factors + 1023) // 1024) * 1024)
    t0, theta0 = torch.zeros(2), torch.tensor(0.0)
    loss = port.ExponentialLoss(1.0, 1.0)
    ck.reset_launches()
    out = {
        b: minimizers._maha3_solve(t0, theta0, data, loss, None, port.Options(), b)
        for b in ("cuda", "torch")
    }
    assert ck.LAUNCHES["maha3c"] == 0  # CPU tensors take the plain version
    (pk, sk), (pt, st) = out["cuda"], out["torch"]
    assert int(sk.iterations) == int(st.iterations) > 5
    np.testing.assert_allclose(sk.records.cost.numpy(), st.records.cost.numpy(), rtol=1e-4)
    torch.testing.assert_close(pk.translation, pt.translation, rtol=0, atol=1e-5)
    torch.testing.assert_close(pk.theta, pt.theta, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["translation", "yaw_wrap"])
def test_planar_priors_match_jax(coarse_planar, case):
    """A strong translation prior pins (x, y) (tests/test_minimizers.py:
    328-336); a yaw prior given as the negated quaternion, whose yaw
    2 atan2(q_z, q_w) lies 2 pi away, acts only through the wrapped
    residual. Port against JAX, float64."""
    data = _first_planar_data(coarse_planar, torch.float64)
    jdata = jmaha.MahalanobisData(*(jnp.asarray(a.numpy()) for a in data))
    if case == "translation":
        prior = dict(translation=[0.4, 0.4, 0.0], translation_weight=1e9)
    else:
        q = port.Pose.from_axis_angle(0.25, [0.0, 0.0, 1.0]).quaternion()
        prior = dict(rotation=-q, rotation_weight=2e4)
    tm = port.MahalanobisDistanceMinimizer3DOF(dtype=torch.float64, device="cpu")
    jm = nls.MahalanobisDistanceMinimizer3DOF(dtype=jnp.float64)
    tm.set_loss_function(port.ExponentialLoss(1.0, 1.0))
    jm.set_loss_function(nls.ExponentialLoss(1.0, 1.0))
    tpose, tsum = tm.set_prior_constraints(**prior).solve(port.Options(), data, port.Pose.identity())
    jpose, jsum = jm.set_prior_constraints(**prior).solve(nls.Options(), jdata, nls.Pose.identity())
    assert int(tsum.iterations) == int(jsum.iterations)
    np.testing.assert_allclose(float(tsum.final_cost), float(jsum.final_cost), rtol=1e-9)
    np.testing.assert_allclose(tpose.translation, jpose.translation, atol=1e-9)
    np.testing.assert_allclose(tpose.rotation, jpose.rotation, atol=1e-9)
    if case == "translation":
        np.testing.assert_allclose(tpose.translation[:2], [0.4, 0.4], atol=1e-4)
    else:
        # the prior pulls the yaw towards 0.25 (the fixture's own minimum is
        # near 0.2); unwrapped, the 2 pi residual would throw it far off
        yaw = np.arctan2(tpose.rotation[1, 0], tpose.rotation[0, 0])
        assert 0.15 < yaw < 0.3


def _reproj_data(fixture, dtype):
    pts, pix, _, _ = fixture
    return treproj.ReprojectionData(
        torch.as_tensor(pts, dtype=dtype), torch.as_tensor(pix, dtype=dtype),
        torch.ones(pts.shape[0], dtype=dtype),
    )


def _jax_reproj_data(fixture, dtype):
    pts, pix, _, _ = fixture
    return jreproj.ReprojectionData(
        jnp.asarray(pts, dtype), jnp.asarray(pix, dtype), jnp.ones(pts.shape[0], dtype)
    )


def _reproj_minimizer(dtype, **kw):
    return port.ReprojectionErrorMinimizer(dtype=dtype, device="cpu", **kw).set_loss_function(
        port.ExponentialLoss(1.0, 1.0)
    )


def test_reprojection_oracle_f64(reproj_fixture):
    _, _, intr, true_pose = reproj_fixture
    m = _reproj_minimizer(torch.float64)
    assert m.backend == "torch"
    pose, summary = m.solve(
        port.Options(), _reproj_data(reproj_fixture, torch.float64), intr, port.Pose.identity()
    )
    testing.check_reprojection_oracle(pose, summary, testing.ORACLE_REPROJ, rtol=1e-9)
    inv = pose.inverse()
    np.testing.assert_allclose(inv.translation, true_pose.translation, atol=1e-6)


def test_reprojection_f32_matches_jax(reproj_fixture):
    _, _, intr, true_pose = reproj_fixture
    jm = nls.ReprojectionErrorMinimizer(dtype=jnp.float32).set_loss_function(
        nls.ExponentialLoss(1.0, 1.0)
    )
    jpose, jsum = jm.solve(
        nls.Options(), _jax_reproj_data(reproj_fixture, jnp.float32), intr, nls.Pose.identity()
    )
    tpose, tsum = _reproj_minimizer(torch.float32).solve(
        port.Options(), _reproj_data(reproj_fixture, torch.float32), intr, port.Pose.identity()
    )
    assert int(tsum.iterations) == int(jsum.iterations)
    np.testing.assert_allclose(tpose.translation, jpose.translation, atol=1e-5)
    np.testing.assert_allclose(tpose.quaternion(), jpose.quaternion(), atol=1e-5)
    assert np.linalg.norm(tpose.inverse().translation - true_pose.translation) < 1e-4


def test_reprojection_kernel_path_matches_torch_backend(reproj_fixture):
    """The PnP solve through the reproj kernel's packed path (its plain
    version on the CPU) against the "torch" backend, float32."""
    _, _, intr, _ = reproj_fixture
    m = _reproj_minimizer(torch.float32)
    data = _reproj_data(reproj_fixture, torch.float32).pad_to(1024)
    t0, q0 = torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0])
    loss = port.ExponentialLoss(1.0, 1.0)
    ck.reset_launches()
    out = {
        b: minimizers._reproj_solve(
            t0, q0, data, m._intrinsics(intr), loss, None, port.Options(), b
        )
        for b in ("cuda", "torch")
    }
    assert ck.LAUNCHES["reproj"] == 0
    (pk, sk), (pt, st) = out["cuda"], out["torch"]
    assert int(sk.iterations) == int(st.iterations) >= 5
    n = int(st.iterations)
    np.testing.assert_allclose(sk.records.cost[:n].numpy(), st.records.cost[:n].numpy(), rtol=1e-4)
    torch.testing.assert_close(pk.translation, pt.translation, rtol=0, atol=1e-5)
    torch.testing.assert_close(pk.quaternion, pt.quaternion, rtol=0, atol=1e-5)


def test_reprojection_information_matches_jax(reproj_fixture):
    """PnP uncertainty (tests/test_minimizers.py:402-436): the port's
    information at the solved pose equals the JAX one and is SPD."""
    _, _, intr, _ = reproj_fixture
    pose = port.Pose.from_quat_trans(
        np.asarray(testing.ORACLE_REPROJ["quat_wxyz"]), np.asarray(testing.ORACLE_REPROJ["translation"])
    )
    for tdtype in (torch.float32, torch.float64):
        m = _reproj_minimizer(tdtype)
        H = m.information(_reproj_data(reproj_fixture, tdtype), intr, pose)
        jm = nls.ReprojectionErrorMinimizer(dtype=JDTYPE[tdtype]).set_loss_function(
            nls.ExponentialLoss(1.0, 1.0)
        )
        jH = jm.information(
            _jax_reproj_data(reproj_fixture, JDTYPE[tdtype]), intr,
            nls.Pose(pose.rotation, pose.translation),
        )
        assert H.shape == (6, 6) and H.dtype == np.float64
        np.linalg.cholesky(H)
        # float32: two sums of 630 terms in different orders, so each entry
        # within 1e-5 of the largest (entries span three decades)
        scale = 1e-5 if tdtype == torch.float32 else 1e-10
        np.testing.assert_allclose(H, jH, rtol=scale, atol=scale * np.abs(jH).max())


@pytest.mark.parametrize(
    "cls", [port.MahalanobisDistanceMinimizer3DOF, port.ReprojectionErrorMinimizer]
)
def test_cuda_backend_and_default_device(cls):
    with pytest.raises(ValueError):
        cls(backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        cls(backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


def test_interop_round_trip_reprojection(reproj_fixture, rng):
    """JAX reprojection data and intrinsics -> numpy -> the port -> numpy
    again, and the port evaluates the carried problem as JAX does."""
    pts, pix, _, _ = reproj_fixture
    jintr = jreproj.CameraIntrinsics.create(500.0, 510.0, 321.5, 239.5, 640, 480)
    jdata = jreproj.ReprojectionData(
        jnp.asarray(pts), jnp.asarray(pix), jnp.asarray((rng.uniform(size=pts.shape[0]) > 0.2) * 1.0)
    )
    inputs = dict(
        reprojection_data={f: np.asarray(getattr(jdata, f)) for f in jreproj.ReprojectionData._fields},
        intrinsics={f: getattr(jintr, f) for f in ("fx", "fy", "cx", "cy", "width", "height")},
    )
    state = interop.from_reference(**inputs, device="cpu", dtype=torch.float64)
    assert state.data is None and state.reprojection_data.local_points.dtype == torch.float64
    assert tuple(state.intrinsics) == tuple(jintr)
    back = interop.to_reference(state)
    for name, value in inputs["reprojection_data"].items():
        np.testing.assert_array_equal(back["reprojection_data"][name], value, err_msg=name)
    assert back["intrinsics"] == inputs["intrinsics"]
    assert interop.from_reference(**back, device="cpu").intrinsics == state.intrinsics

    pose = nls.Pose.from_axis_angle(0.2, [0.3, -1.0, 0.5], [0.1, -0.2, 0.4])
    loss_t, loss_j = port.HuberLoss(0.01), nls.core.losses.HuberLoss(0.01)
    got = treproj.eval_quadratic(
        torch.as_tensor(pose.rotation), torch.as_tensor(pose.translation),
        state.reprojection_data, state.intrinsics, loss_t,
    )
    want = jreproj.eval_quadratic(
        jnp.asarray(pose.rotation), jnp.asarray(pose.translation), jdata, jintr, loss_j
    )
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
