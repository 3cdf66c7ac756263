"""The port's native binding (``nonlinear_optimizer_for_slam_tpu_torch/native.py``)
and ``HybridRegistrar`` / ``_packed_lm_solve``.

- The 9 tests of tests/test_native.py against the port's numpy copy
  (``pipelines/ndt.py``) and the port's device matching and registrars,
  at the same tolerances; the same parity caveat holds (the row-scaled
  sqrt-information is basis-dependent on degenerate voxels, so matrix
  parity is asked only where the eigenvalues are well separated).
- The port's binding and the JAX package's, built from the same sources,
  write bitwise equal ``build_ndt_map`` results and ``match_and_pack``
  buffers on the same inputs (``num_threads=1``). The JAX binding is
  built by its own Makefile in a private copy of ``native/`` under the
  test's tmp dir, unless this worker has loaded it already: building in
  ``native/`` itself would race with the JAX tests that build there.
- Four processes load the port's library from one empty build directory at
  once, and all get ABI 2.
- ``_packed_lm_solve`` (6-DoF and planar) against the JAX one on one
  shared buffer, and ``HybridRegistrar.register`` against the JAX
  ``HybridRegistrar`` on the reduced room (point_step 0.02), at
  tests/test_torch_fused_registration.py's tolerances: costs rtol 1e-5,
  poses 1e-5, outer counts equal. The JAX side runs its Pallas kernels in
  interpret mode, as its own tests do on the CPU; the port side runs the
  plain versions of its kernels.
"""

import os
import shutil
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu import native as jnative
from nonlinear_optimizer_for_slam_tpu.pipelines import fused_registration as jfr
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import native
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration as tfr
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import matching, ndt, registration
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the registrations run thousands of tiny ops,
    which more threads only slow down when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def room():
    """The reduced room (point_step 0.02, as tests/test_native.py:163): the
    native map and the native-filtered scan."""
    pts = testing.generate_room_points(point_step=0.02)
    return native.build_ndt_map(pts, 1.0), native.filter_points(pts, 0.1)


@pytest.fixture(scope="module")
def jax_binding(tmp_path_factory):
    """The JAX package's ``native`` module with its library loaded: the one
    this worker has loaded already, or one built by the JAX binding's own
    ``ensure_built`` (its Makefile) in a private copy of ``native/``."""
    saved = (jnative._NATIVE_DIR, jnative._SO_PATH, jnative._lib)
    if jnative._lib is None:
        private = tmp_path_factory.mktemp("jax_native")
        for f in ("Makefile", "ndt_builder.cc", "eigh3.cc"):
            shutil.copy(os.path.join(REPO, "native", f), private / f)
        jnative._NATIVE_DIR = str(private)
        jnative._SO_PATH = str(private / "libnls_native.so")
        jnative.load()
    yield jnative
    jnative._NATIVE_DIR, jnative._SO_PATH, jnative._lib = saved


def _match_order(m_a, m_b, resolution=1.0):
    ka = [tuple(np.floor(mu / resolution).astype(int)) for mu in m_a.means]
    kb = [tuple(np.floor(mu / resolution).astype(int)) for mu in m_b.means]
    assert set(ka) == set(kb)
    bi = {k: i for i, k in enumerate(kb)}
    return np.array([bi[k] for k in ka])


# ---------------------------------------------------------------------------
# tests/test_native.py, against the port
# ---------------------------------------------------------------------------


def test_filter_points_exact(rng):
    pts = rng.uniform(-5, 5, size=(20000, 3))
    np.testing.assert_allclose(native.filter_points(pts, 0.3), ndt.filter_points(pts, 0.3))


def test_ndt_map_invariants_random_cloud(rng):
    pts = rng.uniform(-4, 4, size=(50000, 3))
    m_np = ndt.build_ndt_map(pts, 1.0)
    m_nat = native.build_ndt_map(pts, 1.0)
    order = _match_order(m_np, m_nat)
    np.testing.assert_allclose(m_nat.means[order], m_np.means, atol=1e-10)
    np.testing.assert_array_equal(m_nat.counts[order], m_np.counts)
    np.testing.assert_array_equal(m_nat.valid[order], m_np.valid)
    # the information eigenvalues are the floored 1/lambda: basis-invariant
    e_np = np.sort(np.linalg.eigvalsh(m_np.informations), axis=1)
    e_nat = np.sort(np.linalg.eigvalsh(m_nat.informations[order]), axis=1)
    np.testing.assert_allclose(e_nat, e_np, rtol=1e-8)


def test_ndt_map_exact_on_nondegenerate_voxels(rng):
    # an anisotropic cloud: well-separated eigenvalues in every voxel
    base = rng.normal(size=(40000, 3)) * np.array([0.45, 0.25, 0.1])
    offsets = rng.integers(-3, 3, size=(40000, 3)).astype(float)
    pts = base + offsets + 0.5
    m_np = ndt.build_ndt_map(pts, 1.0)
    m_nat = native.build_ndt_map(pts, 1.0)
    order = _match_order(m_np, m_nat)
    sep = []
    for i in range(m_np.num_voxels):
        ev = np.linalg.eigvalsh(np.linalg.inv(m_np.informations[i]))
        sep.append(np.min(np.diff(np.sort(ev)) / np.max(ev)) > 1e-3)
    sep = np.array(sep)
    assert sep.sum() > 0
    np.testing.assert_allclose(
        m_nat.informations[order][sep], m_np.informations[sep], rtol=1e-6, atol=1e-8
    )


def test_room_world_registration_with_native_map(room):
    """The native map drives the port's registration to the true pose."""
    m_nat, scan = room
    true_pose = testing.maha_true_pose()
    local = true_pose.inverse().apply(scan)
    minimizer = port.MahalanobisDistanceMinimizer(device="cpu").set_loss_function(
        port.ExponentialLoss()
    )
    res = registration.register_ndt(m_nat, local, port.Pose.identity(), minimizer, port.Options())
    assert np.linalg.norm(res.pose.translation - true_pose.translation) < 0.03


def test_native_speedup():
    """The native builder beats the numpy copy (it is the reference's
    performance-motivated C++ component)."""
    pts = np.random.default_rng(0).uniform(-5, 5, size=(500000, 3))
    native.load()
    t0 = time.perf_counter()
    ndt.build_ndt_map(pts, 1.0)
    t_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.build_ndt_map(pts, 1.0)
    t_nat = time.perf_counter() - t0
    assert t_nat < t_np, (t_nat, t_np)


def test_match_and_pack_parity_with_device_matching(rng):
    """The native matcher's buffer equals the port's matching + packing on
    the active (unmasked) lanes; the masks are identical."""
    M, N = 96, 1000
    means = rng.uniform(-4, 4, (M, 3))
    S = rng.normal(size=(M, 3, 3))
    pts = rng.uniform(-4, 4, (N, 3))
    R, t = np.eye(3), np.array([0.1, -0.2, 0.3])
    packed_nat = native.match_and_pack(pts, R, t, means, S, 1.5, 2, 4096)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    data = matching.match_point_cloud(
        f32(means), f32(S), f32(pts), torch.ones(N), f32(R), f32(t),
        search_radius=1.5, num_neighbors=2,
    )
    packed_dev = ck.pack_maha6(data).numpy()  # (16, N k)
    np.testing.assert_array_equal(packed_nat[:, 2 * N:], 0.0)  # the zero tail
    np.testing.assert_array_equal(packed_nat[15, : 2 * N], packed_dev[15])
    both = packed_nat[15, : 2 * N] > 0
    np.testing.assert_allclose(packed_nat[:, : 2 * N][:, both], packed_dev[:, both], atol=1e-6)


def test_hybrid_registrar_matches_fused(room):
    """The host-matching hybrid pipeline lands on the pose of the
    device-resident registrar."""
    m_nat, scan = room
    true_pose = testing.maha_true_pose()
    local = true_pose.inverse().apply(scan)
    opts, loss = port.Options(), port.ExponentialLoss()
    fused = port.NdtRegistrar(m_nat, opts, loss, device="cpu").register(local, port.Pose.identity())
    hybrid = port.HybridRegistrar(m_nat, opts, loss, num_threads=1, device="cpu").register(
        local, port.Pose.identity()
    )
    np.testing.assert_allclose(hybrid.pose.translation, fused.pose.translation, atol=1e-4)
    np.testing.assert_allclose(hybrid.pose.rotation, fused.pose.rotation, atol=1e-4)
    assert np.linalg.norm(hybrid.pose.translation - true_pose.translation) < 0.03


def test_ndt_map_identity_moment_flag(rng):
    """identity_moment=False is bit for bit the numpy copy in serial mode,
    and the two modes differ by exactly the reference's +I/count
    covariance offset."""
    pts = rng.uniform(-4, 4, size=(30000, 3))
    m_np = ndt.build_ndt_map(pts, 1.0, identity_moment=False)
    m_nat = native.build_ndt_map(pts, 1.0, identity_moment=False, num_threads=1)
    order = _match_order(m_np, m_nat)
    np.testing.assert_allclose(m_nat.means[order], m_np.means, rtol=0, atol=0)
    np.testing.assert_array_equal(m_nat.counts[order], m_np.counts)
    np.testing.assert_allclose(
        m_nat.sqrt_informations[order], m_np.sqrt_informations, rtol=0, atol=0
    )
    m_q = ndt.build_ndt_map(pts, 1.0, identity_moment=True)
    cov_q = ndt.voxel_covariances(m_q)
    cov_u = ndt.voxel_covariances(m_np)
    # voxels whose eigenvalues are unfloored in both builds (flooring
    # breaks the clean +I/count relation)
    well = (m_np.counts >= 30) & m_np.valid
    sep = [
        np.allclose(cov_q[i] - cov_u[i], np.eye(3) / m_np.counts[i], atol=1e-9)
        for i in np.where(well)[0][:20]
    ]
    assert sep and all(sep)


def test_ndt_map_threaded_merge_keeps_quirk(rng):
    """The threads' partial maps merge with exactly ONE +I moment offset
    per voxel in the quirked build, voxels absent from thread 0's partial
    included."""
    a = rng.uniform(0.0, 2.0, size=(6000, 3))
    b = rng.uniform(10.0, 12.0, size=(6000, 3))
    pts = np.concatenate([a, b])  # the thread chunks follow the position
    m1 = native.build_ndt_map(pts, 1.0, num_threads=1)
    m4 = native.build_ndt_map(pts, 1.0, num_threads=4)
    order = _match_order(m1, m4)
    np.testing.assert_array_equal(m4.counts[order], m1.counts)
    c1 = ndt.voxel_covariances(m1)
    c4 = ndt.voxel_covariances(m4)[order]
    np.testing.assert_allclose(c4, c1, atol=1e-9)


# ---------------------------------------------------------------------------
# the binding itself
# ---------------------------------------------------------------------------


def test_bindings_write_bitwise_equal_results(jax_binding, rng):
    """Same sources, same flags: the port's library and the JAX package's
    give the same bits for ``build_ndt_map`` and ``match_and_pack``."""
    pts = rng.uniform(-4, 4, size=(30000, 3))
    for moment in (True, False):
        a = native.build_ndt_map(pts, 1.0, num_threads=1, identity_moment=moment)
        b = jax_binding.build_ndt_map(pts, 1.0, num_threads=1, identity_moment=moment)
        for f in ("means", "sqrt_informations", "informations", "counts", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(native.filter_points(pts, 0.2), jax_binding.filter_points(pts, 0.2))
    valid = a.valid_only()
    scan = rng.uniform(-4, 4, size=(3000, 3))
    R = testing.maha_true_pose().rotation
    t = np.array([0.2, -0.1, 0.05])
    for k, lanes in ((2, 6000), (3, 9004)):
        mine = native.match_and_pack(scan, R, t, valid.means, valid.sqrt_informations,
                                     1.0, k, lanes, num_threads=1)
        theirs = jax_binding.match_and_pack(scan, R, t, valid.means, valid.sqrt_informations,
                                            1.0, k, lanes, num_threads=1)
        np.testing.assert_array_equal(mine.view(np.uint32), theirs.view(np.uint32))


def test_four_processes_load_from_an_empty_build_dir(tmp_path):
    """The build is race-free: four processes start on an empty build
    directory at once; each loads a library of ABI 2, one library file
    is left and no temporary file."""
    build = tmp_path / "build"
    code = (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
        "from nonlinear_optimizer_for_slam_tpu_torch import native; "
        "native.BUILD_DIR = Path(sys.argv[2]); "
        "lib = native.load(); print(lib.nls_abi_version())"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", code, REPO, str(build)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "2", (out, err[-2000:])
    files = sorted(os.listdir(build))
    assert files == sorted(["lock", native.library_path().name]), files


def test_load_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No Python fallback inside the binding: a failing g++ makes
    ``load`` raise with the compiler's output, and leaves nothing behind."""
    src = tmp_path / "native"
    src.mkdir()
    (src / "ndt_builder.cc").write_text("this is not C++\n")
    (src / "eigh3.cc").write_text("int nls_eigh3_unused;\n")
    build = tmp_path / "build"
    monkeypatch.setattr(native, "NATIVE_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)native build failed.*ndt_builder.cc"):
        native.load()
    assert sorted(os.listdir(build)) == ["lock"]


# ---------------------------------------------------------------------------
# _packed_lm_solve and HybridRegistrar against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("planar", [False, True], ids=["6dof", "planar"])
def test_packed_lm_solve_matches_jax(room, planar):
    """One buffer from the native matcher, at the JAX registrar's lane
    count (a multiple of its LANE_BLOCK, so both sum the same zero lanes):
    the LM count equal, the cost within rtol 1e-5, the pose within 1e-5."""
    m_nat, scan = room
    pose = testing.maha_3dof6dof_true_pose() if planar else testing.maha_true_pose()
    local = pose.inverse().apply(scan)
    valid = m_nat.valid_only()
    from nonlinear_optimizer_for_slam_tpu.ops import pallas_kernels as pk

    lanes = -(-local.shape[0] * 2 // pk.LANE_BLOCK) * pk.LANE_BLOCK
    packed = native.match_and_pack(local, np.eye(3), np.zeros(3), valid.means,
                                   valid.sqrt_informations, 1.0, 2, lanes, num_threads=1)
    t0, q0 = np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0])
    jt, jq, jit, jcost = jfr._packed_lm_solve(
        jnp.asarray(t0, jnp.float32), jnp.asarray(q0, jnp.float32),
        jnp.asarray(packed.reshape(16, -1, 128)), nls.ExponentialLoss(), nls.Options(), planar,
    )
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    tt, tq, tit, tcost = tfr._packed_lm_solve(
        f32(t0), f32(q0), torch.as_tensor(packed), port.ExponentialLoss(), port.Options(), planar,
    )
    assert int(tit) == int(jit)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)


@pytest.mark.parametrize("planar", [False, True], ids=["6dof", "planar"])
def test_hybrid_registrar_matches_jax(room, planar, jax_binding):
    """The port's HybridRegistrar against the JAX one on the reduced room:
    outer counts equal, per-outer costs within rtol 1e-5, poses within
    1e-5. The port sums the N k real lanes, JAX its lanes rounded up to
    4096; PyTorch's CPU sums are not invariant to zero lanes, so the two
    float32 pipelines agree to rounding, within the stated tolerances."""
    m_nat, scan = room
    pose = testing.maha_3dof6dof_true_pose() if planar else testing.maha_true_pose()
    local = pose.inverse().apply(scan)
    mine = port.HybridRegistrar(
        m_nat, port.Options(), port.ExponentialLoss(), planar=planar, num_threads=2,
        device="cpu",
    ).register(local, port.Pose.identity())
    theirs = jfr.HybridRegistrar(
        m_nat, nls.Options(), nls.ExponentialLoss(), planar=planar, num_threads=2,
    ).register(local, nls.Pose.identity())
    n = theirs.outer_iterations
    assert mine.outer_iterations == n
    np.testing.assert_allclose(mine.costs[:n], theirs.costs[:n], rtol=1e-5)
    np.testing.assert_allclose(mine.final_cost, theirs.final_cost, rtol=1e-5)
    np.testing.assert_allclose(mine.pose.translation, theirs.pose.translation, atol=1e-5)
    np.testing.assert_allclose(mine.pose.rotation, theirs.pose.rotation, atol=1e-5)


def test_hybrid_registrar_reuses_its_buffers(room):
    """The host and device buffers are allocated once per lane count, and
    on the CPU the device buffer is the host one (no copy)."""
    m_nat, scan = room
    reg = port.HybridRegistrar(m_nat, port.Options(), port.ExponentialLoss(),
                               max_outer_iterations=1, num_threads=1, device="cpu")
    local = testing.maha_true_pose().inverse().apply(scan)
    reg.register(local, port.Pose.identity())
    host = reg._host
    assert host.shape == (16, -(-local.shape[0] * 2 // ck.LANE_ALIGN) * ck.LANE_ALIGN)
    assert reg._dev is host
    reg.register(local, port.Pose.identity())
    assert reg._host is host
    reg.register(local[:-2], port.Pose.identity())  # 2 (N - 2) lanes: a new buffer
    assert reg._host is not host and reg._host.shape[1] == 2 * (local.shape[0] - 2)
