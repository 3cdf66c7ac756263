"""The port's slice as a whole: host-driven NDT registration.

- float64 ``register_ndt`` with the "torch" backend on the full published
  fixture reproduces the reference oracle traces (6-DoF, and the planar
  3-DoF minimizer with cost atol 4.0), with the rules of
  tests/test_trace_parity.py: every inner and outer iteration count exact,
  every printed cost within 0.1 (the reference's print quantum), the pose
  within 1e-6;
- the port and the JAX package, float32, on the coarse room
  (``point_step=0.05``): the same outer count, costs within rtol 1e-5 and
  poses within 1e-5 (two float32 pipelines that sum in different orders;
  measured apart by under 1e-7);
- the kernel's packed path (backend "cuda" through the plain version on
  the CPU) against the "torch" backend;
- ``interop``, the device default, and the rule that the port never
  imports JAX or the JAX package.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.ops import mahalanobis as jmaha
from nonlinear_optimizer_for_slam_tpu.pipelines import ndt as jndt
from nonlinear_optimizer_for_slam_tpu.pipelines import registration as jreg
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis as tmaha
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import matching, ndt
from nonlinear_optimizer_for_slam_tpu_torch.solvers import minimizers
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "nonlinear_optimizer_for_slam_tpu_torch"


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
def full_world():
    """The published fixture at full scale: 954,605-point room, 1 m NDT
    voxels, 0.1 m scan filter, built by the port's numpy copy."""
    pts = testing.generate_room_points()
    assert pts.shape[0] == 954605
    ndt_map = ndt.build_ndt_map(pts, 1.0)
    assert ndt_map.counts.shape[0] == 96 and int(ndt_map.valid.sum()) == 96
    scan = ndt.filter_points(pts, 0.1)
    assert scan.shape[0] == 9356
    return ndt_map, scan


@pytest.fixture(scope="module")
def coarse_world():
    """The room at 5 cm, built by both packages (which must agree bit for
    bit: the port's NDT code is a copy)."""
    pts = testing.generate_room_points(point_step=0.05)
    np.testing.assert_array_equal(pts, jtesting.generate_room_points(point_step=0.05))
    tmap, jmap = ndt.build_ndt_map(pts, 1.0), jndt.build_ndt_map(pts, 1.0)
    for f in dataclasses.fields(ndt.NdtMap):
        np.testing.assert_array_equal(getattr(tmap, f.name), getattr(jmap, f.name))
    scan = ndt.filter_points(pts, 0.1)
    np.testing.assert_array_equal(scan, jndt.filter_points(pts, 0.1))
    local = testing.maha_true_pose().inverse().apply(scan)
    return tmap, jmap, local


def _minimizer_f64(cls=port.MahalanobisDistanceMinimizer):
    return cls(dtype=torch.float64, device="cpu").set_loss_function(
        port.ExponentialLoss(1.0, 1.0)
    )


@pytest.mark.parametrize(
    "oracle,true_pose,minimizer_cls,cost_atol",
    [
        (testing.ORACLE_SIMPLE_6DOF, testing.maha_true_pose(),
         port.MahalanobisDistanceMinimizer, 0.1),
        (testing.ORACLE_3DOF6DOF_6DOF, testing.maha_3dof6dof_true_pose(),
         port.MahalanobisDistanceMinimizer, 0.1),
        # 4.0: the reference's scalar 3-DoF solver drops the n % 4 tail
        # correspondences, up to 1.0 of cost each (tests/test_trace_parity.py:
        # 182-184); counts and pose stay exact
        (testing.ORACLE_3DOF6DOF_3DOF, testing.maha_3dof6dof_true_pose(),
         port.MahalanobisDistanceMinimizer3DOF, 4.0),
    ],
    ids=["simple_6dof", "3dof6dof_6dof", "3dof6dof_3dof"],
)
def test_oracle_parity(full_world, oracle, true_pose, minimizer_cls, cost_atol):
    ndt_map, scan = full_world
    local = true_pose.inverse().apply(scan)
    res = port.register_ndt(
        ndt_map, local, port.Pose.identity(), _minimizer_f64(minimizer_cls), port.Options()
    )
    testing.check_oracle(res, oracle, cost_atol=cost_atol, pose_atol=1e-6)


def test_oracle_constants_are_the_reference_tests():
    import test_trace_parity as tp

    assert testing.ORACLE_SIMPLE_6DOF == tp.ORACLE_SIMPLE_6DOF
    assert testing.ORACLE_3DOF6DOF_6DOF == tp.ORACLE_3DOF6DOF_6DOF
    assert testing.ORACLE_3DOF6DOF_3DOF == tp.ORACLE_3DOF6DOF_3DOF
    assert testing.ORACLE_REPROJ == tp.ORACLE_REPROJ
    tp3 = nls.Pose.from_axis_angle(0.2, [0.0, 0.0, 1.0], [-0.15, 0.05, 0.0])
    np.testing.assert_array_equal(testing.maha_3dof6dof_true_pose().matrix(), tp3.matrix())
    np.testing.assert_array_equal(testing.maha_true_pose().matrix(), jtesting.maha_true_pose().matrix())


def test_f32_registration_matches_jax(coarse_world):
    tmap, jmap, local = coarse_world
    jm = nls.MahalanobisDistanceMinimizer(backend="jnp", dtype=jnp.float32)
    jm.set_loss_function(nls.ExponentialLoss(1.0, 1.0))
    jres = jreg.register_ndt(jmap, local, nls.Pose.identity(), jm, nls.Options())
    tm = port.MahalanobisDistanceMinimizer(device="cpu").set_loss_function(
        port.ExponentialLoss(1.0, 1.0)
    )
    assert tm.backend == "torch" and tm.dtype == torch.float32
    tres = port.register_ndt(tmap, local, port.Pose.identity(), tm, port.Options())
    assert tres.outer_iterations == jres.outer_iterations
    np.testing.assert_allclose(
        [float(s.final_cost) for s in tres.summaries],
        [float(s.final_cost) for s in jres.summaries],
        rtol=1e-5,
    )
    np.testing.assert_allclose(tres.pose.translation, jres.pose.translation, atol=1e-5)
    np.testing.assert_allclose(tres.pose.quaternion(), jres.pose.quaternion(), atol=1e-5)
    t_err = np.linalg.norm(tres.pose.translation - testing.maha_true_pose().translation)
    assert t_err < 0.05


def test_matching_matches_jax(coarse_world, rng):
    tmap, _, local = coarse_world
    valid = tmap.valid_only()
    pose = nls.Pose.from_axis_angle(0.05, rng.normal(size=3), 0.1 * rng.normal(size=3))
    from nonlinear_optimizer_for_slam_tpu.pipelines import matching as jmatching

    want = jmatching.match_point_cloud(
        jnp.asarray(valid.means), jnp.asarray(valid.sqrt_informations), jnp.asarray(local),
        jnp.ones(local.shape[0]), jnp.asarray(pose.rotation), jnp.asarray(pose.translation),
    )
    got = matching.match_point_cloud(
        torch.as_tensor(valid.means), torch.as_tensor(valid.sqrt_informations),
        torch.as_tensor(local), torch.ones(local.shape[0], dtype=torch.float64),
        torch.as_tensor(pose.rotation), torch.as_tensor(pose.translation),
    )
    assert float(got.mask.sum()) > 0.9 * local.shape[0]
    for a, b in zip(got, want):  # the same neighbors, in the same order
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kernel_path_matches_torch_backend(full_world):
    """One inner solve through the kernel's packed path, which on the CPU
    runs the kernel's plain version, against the "torch" backend: the same
    float32 math summed in different orders (rtol 1e-4 on the cost, 1e-5
    on the pose)."""
    ndt_map, scan = full_world
    valid = ndt_map.valid_only()
    local = testing.maha_true_pose().inverse().apply(scan)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    data = matching.match_point_cloud(
        f32(valid.means), f32(valid.sqrt_informations), f32(local),
        torch.ones(local.shape[0]), torch.eye(3), torch.zeros(3),
    ).pad_to(19456)
    t0, q0 = torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0])
    loss = port.ExponentialLoss(1.0, 1.0)
    ck.reset_launches()
    out = {
        b: minimizers._maha6_solve(t0, q0, data, loss, None, port.Options(), b)
        for b in ("cuda", "torch")
    }
    assert ck.LAUNCHES["maha6"] == 0  # CPU tensors take the plain version
    (pk, sk), (pt, st) = out["cuda"], out["torch"]
    assert int(sk.iterations) == int(st.iterations) == 40
    np.testing.assert_allclose(sk.records.cost.numpy(), st.records.cost.numpy(), rtol=1e-4)
    torch.testing.assert_close(pk.translation, pt.translation, rtol=0, atol=1e-5)
    torch.testing.assert_close(pk.quaternion, pt.quaternion, rtol=0, atol=1e-5)


def test_cuda_backend_needs_a_cuda_device():
    with pytest.raises(ValueError):
        port.MahalanobisDistanceMinimizer(backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        port.MahalanobisDistanceMinimizer(backend="pallas", device="cpu")


def test_interop_round_trip(coarse_world, rng):
    """JAX objects -> numpy -> the port's objects -> numpy again, and the
    port evaluates the carried data as JAX does."""
    _, jmap, _ = coarse_world
    n = 64
    jdata = jmaha.MahalanobisData(
        jnp.asarray(rng.normal(size=(n, 3))), jnp.asarray(rng.normal(size=(n, 3))),
        jnp.asarray(rng.normal(size=(n, 3, 3))), jnp.asarray(np.ones(n)),
    )
    jpose = nls.Pose.from_axis_angle(0.3, [1.0, 2.0, 3.0], [0.1, 0.2, 0.3])
    jloss = nls.core.losses.HuberLoss(0.7)
    jopts = nls.Options(max_iterations=12).replace(
        linear_solver_type=nls.LinearSolverType.DENSE_QR
    )
    inputs = dict(
        ndt_map={f.name: np.asarray(getattr(jmap, f.name)) for f in dataclasses.fields(jmap)},
        data={f: np.asarray(getattr(jdata, f)) for f in jmaha.MahalanobisData._fields},
        pose={"rotation": np.asarray(jpose.rotation), "translation": np.asarray(jpose.translation)},
        loss=(type(jloss).__name__, dataclasses.asdict(jloss)),
        options=dataclasses.asdict(jopts),
    )
    state = interop.from_reference(**inputs, device="cpu", dtype=torch.float64)
    assert isinstance(state.loss, port.HuberLoss) and state.loss.threshold == 0.7
    assert state.options.max_iterations == 12
    assert state.options.linear_solver_type == port.LinearSolverType.DENSE_QR
    assert state.data.points.dtype == torch.float64

    back = interop.to_reference(state)
    for key in ("ndt_map", "data", "pose"):
        for name, value in inputs[key].items():
            np.testing.assert_array_equal(back[key][name], value, err_msg=f"{key}.{name}")
    assert back["loss"] == inputs["loss"]
    opts = dict(inputs["options"])
    opts["minimizer_type"] = opts["minimizer_type"].name
    opts["linear_solver_type"] = opts["linear_solver_type"].name
    assert back["options"] == opts
    assert interop.from_reference(**back, device="cpu").options == state.options

    H1, g1, c1 = tmaha.eval_quadratic(
        torch.as_tensor(state.pose.rotation), torch.as_tensor(state.pose.translation),
        state.data, state.loss,
    )
    H2, g2, c2 = jmaha.eval_quadratic(
        jnp.asarray(jpose.rotation), jnp.asarray(jpose.translation), jdata, jloss
    )
    np.testing.assert_allclose(H1.numpy(), np.asarray(H2), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g1.numpy(), np.asarray(g2), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(c1), float(c2), rtol=1e-10)


def test_default_device_is_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.MahalanobisDistanceMinimizer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.from_reference(pose={"rotation": np.eye(3), "translation": np.zeros(3)})
    packed = torch.zeros(1, 16, 8)
    code, ab = ck.maha6_loss_ab(None, "cpu")
    params = ck.maha6_params(torch.eye(3)[None], torch.zeros(1, 3), ab)
    ck.maha6_partials(params, packed, code)  # the CPU asks for nothing


def test_port_import_does_not_import_jax():
    code = (
        "import sys; import nonlinear_optimizer_for_slam_tpu_torch as p; "
        "import nonlinear_optimizer_for_slam_tpu_torch.interop; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'nonlinear_optimizer_for_slam_tpu' "
        "or m.startswith('nonlinear_optimizer_for_slam_tpu.')]; "
        "assert not bad, bad; print('clean')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|nonlinear_optimizer_for_slam_tpu(?!_torch)\b)",
    re.MULTILINE,
)


def test_port_sources_import_no_jax():
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 15
    offenders = {
        str(p.relative_to(REPO)): _FORBIDDEN.findall(p.read_text()) for p in sources
    }
    offenders = {k: v for k, v in offenders.items() if v}
    assert not offenders, offenders
