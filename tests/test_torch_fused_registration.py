"""The port's device-resident registrar against the JAX package.

The world is tests/test_fused_sharded.py's (room at 5 cm, scan filtered at
0.3 m, ``maha_true_pose``), with the default ``Options()`` and outer count.
Each case builds the JAX ``NdtRegistrar``, carries its map state into the
port through ``interop.from_reference``, and runs the port's registrar
(its plain "torch" path, the only one on the CPU) against the JAX flat
state machine ``_fused_register_impl(..., eval_backend="jnp")``, jitted
here, for the Mahalanobis objective, planar mode, point-to-plane and a
bucket-padded map, in float32 and float64:

- the outer count and every per-outer inner count are equal;
- the per-outer costs agree within rtol 1e-5 (two float32 or float64
  pipelines that sum in different orders), with atol 1e-9 for the
  point-to-plane costs that converge to 0;
- the poses agree within 1e-5.

Point-to-plane starts 5 cm above the identity: from the identity every
floor point lies exactly ``trim_distance`` (0.3 m, the true pose's height)
from the floor plane, and in float32 the last bit of the map centroid,
which XLA and PyTorch sum in different orders, decides whether about 360
of them are trimmed.

Then the lockstep batch (each lane equals ``register`` exactly in its
counts; a batch of 2 equals the JAX ``register_batch``), the registrar's
information, ``register_point_to_plane``,
``voxel_normals``, the plane matcher, tie order, the rule that a K-step
block reads nothing on the host, and the errors the API raises.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.pipelines import fused_registration as jfr
from nonlinear_optimizer_for_slam_tpu.pipelines import matching as jmatching
from nonlinear_optimizer_for_slam_tpu.pipelines import ndt as jndt
from nonlinear_optimizer_for_slam_tpu.pipelines import registration as jregistration
from nonlinear_optimizer_for_slam_tpu.utils import testing as jtesting
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch import interop
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.parallel import make_factor_mesh
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration as tfr
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import matching, ndt
from nonlinear_optimizer_for_slam_tpu_torch.solvers import minimizers
from nonlinear_optimizer_for_slam_tpu_torch.utils import tracing

P2P_START = (0.0, 0.0, 0.05)
CASES = {
    # name: (registrar keywords, identity_moment of the map, start translation)
    "maha": ({}, True, (0.0, 0.0, 0.0)),
    "planar": ({"planar": True}, True, (0.0, 0.0, 0.0)),
    "p2p": ({"objective": "p2p", "max_thickness": 0.05}, False, P2P_START),
    "map_pad": ({"map_pad_multiple": 128}, True, (0.0, 0.0, 0.0)),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


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
def world():
    """Both packages' maps (which must agree bit for bit: the port's NDT
    code is a copy) with and without the identity moment, and the scan."""
    pts = jtesting.generate_room_points(point_step=0.05)
    maps = {}
    for moment in (True, False):
        tmap = ndt.build_ndt_map(pts, 1.0, identity_moment=moment)
        jmap = jndt.build_ndt_map(pts, 1.0, identity_moment=moment)
        for f in dataclasses.fields(ndt.NdtMap):
            np.testing.assert_array_equal(getattr(tmap, f.name), getattr(jmap, f.name))
        maps[moment] = (tmap, jmap)
    local = jtesting.maha_true_pose().inverse().apply(ndt.filter_points(pts, 0.3))
    return maps, local


def _start(t, package=port):
    return package.Pose(np.eye(3), np.asarray(t, np.float64))


def _registrars(world, case, dtype_name):
    """(JAX registrar, port registrar built from its arrays, start pose)."""
    kw, moment, start = CASES[case]
    (tmap, jmap), jdt, tdt = world[0][moment], *DTYPES[dtype_name]
    jreg = jfr.NdtRegistrar(jmap, nls.Options(), nls.ExponentialLoss(1.0, 1.0), dtype=jdt, **kw)
    arrays = {
        f: None if getattr(jreg, f) is None else np.asarray(getattr(jreg, f))
        for f in tfr.RegistrarMap._fields
    }
    state = interop.from_reference(registrar_map=arrays, device="cpu", dtype=tdt)
    back = interop.to_reference(state)["registrar_map"]
    for f, a in arrays.items():  # the round trip
        assert (a is None) == (back[f] is None), f
        if a is not None:
            np.testing.assert_array_equal(back[f], a, err_msg=f)
    # the port builds the same state from its own map
    own = tfr.build_map_state(
        tmap, kw.get("objective", "maha"), max_thickness=kw.get("max_thickness"),
        map_pad_multiple=kw.get("map_pad_multiple"), dtype=tdt, device="cpu",
    )
    for a, b in zip(own, state.registrar_map):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    treg = port.NdtRegistrar(
        state.registrar_map, port.Options(), port.ExponentialLoss(1.0, 1.0), dtype=tdt,
        device="cpu", planar=kw.get("planar", False), objective=kw.get("objective", "maha"),
    )
    return jreg, treg, _start(start)


def _jax_register(jreg, local, start):
    """The JAX flat state machine with its plain ("jnp") evaluation."""
    fn = jax.jit(functools.partial(
        jfr._fused_register_impl, num_neighbors=jreg.num_neighbors,
        max_outer=jreg.max_outer_iterations, options=jreg.options, planar=jreg.planar,
        eval_backend="jnp", objective=jreg.objective,
    ))
    dt = jreg.dtype
    pts = jnp.asarray(local, dt)
    out = fn(
        jreg.means_T, jreg.infos_T, pts, pts.T, jnp.ones(pts.shape[0], dt),
        jnp.asarray(start.translation, dt), jnp.asarray(start.quaternion(), dt),
        jreg.loss, jreg.search_radius, jreg.outer_tolerance, map_mask=jreg.map_mask,
        normals_T=jreg.normals_T, voxel_weights=jreg.voxel_weights,
        trim_distance=jreg.trim_distance,
    )
    # copies: JAX's finalize divides in place, which a read-only float64
    # device_get array refuses
    return jfr.NdtRegistrar.finalize(tuple(np.array(a) for a in out))


def _assert_same_run(got, want):
    assert got.outer_iterations == want.outer_iterations
    np.testing.assert_array_equal(got.inner_iterations, want.inner_iterations)
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got.final_cost, want.final_cost, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got.pose.translation, want.pose.translation, atol=1e-5)
    np.testing.assert_allclose(got.pose.rotation, want.pose.rotation, atol=1e-5)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_registrar_matches_jax(world, case, dtype_name):
    jreg, treg, start = _registrars(world, case, dtype_name)
    local = world[1]
    want = _jax_register(jreg, local, start)
    got = treg.register(local, start)
    _assert_same_run(got, want)
    assert got.outer_iterations >= 3 and sum(got.inner_iterations) > 5
    if case == "planar":  # z, roll and pitch stay where they started
        assert got.pose.translation[2] == start.translation[2]
        np.testing.assert_allclose(got.pose.rotation[2], [0.0, 0.0, 1.0], atol=1e-7)
        np.testing.assert_allclose(got.pose.rotation[:2, 2], 0.0, atol=1e-7)
    if case == "p2p":  # the planes pin the pose; the coarse NDT does not
        t_err = np.linalg.norm(got.pose.translation - jtesting.maha_true_pose().translation)
        assert t_err < 1e-4
    stats = treg.run_stats()
    assert stats["steps"] == stats["host_reads"] * tfr.BLOCK_STEPS
    assert 0 <= stats["wasted_steps"] < tfr.BLOCK_STEPS * got.outer_iterations


@pytest.mark.parametrize("case", ["maha", "planar", "p2p"])
def test_batch_lanes_equal_register(world, case, rng):
    """Three ragged scans (the full scan, a 75 % and a 50 % subset, the
    last from a nudged start, as tests/test_batched.py:210-243) in one
    lockstep run: each lane has the counts of ``register`` exactly and its
    pose within 1e-5. Float64: a lane's correspondences are zero-padded to
    the longest scan, and the CPU's plain sums, unlike the kernels'
    fixed-order reduction, round differently over a longer axis; in
    float32 that moves an LM stop by one iteration now and then."""
    _, treg, start = _registrars(world, case, "f64")
    local = world[1]
    nudge = port.Pose.from_axis_angle(0.02, rng.normal(size=3), 0.02 * rng.normal(size=3))
    scans = [local, local[np.arange(len(local)) % 4 != 3], local[::2]]
    starts = [start, start, nudge * start]
    batch = treg.register_batch(scans, starts)
    again = treg.finalize_batch(treg.register_batch_async(np.stack([local] * 2), starts[:2]))
    assert len(batch) == 3 and len(again) == 2
    for scan, init, lane in zip(scans, starts, batch):
        one = treg.register(scan, init)
        assert lane.outer_iterations == one.outer_iterations
        np.testing.assert_array_equal(lane.inner_iterations, one.inner_iterations)
        np.testing.assert_allclose(lane.pose.matrix(), one.pose.matrix(), atol=1e-5)
    np.testing.assert_array_equal(again[0].inner_iterations, batch[0].inner_iterations)
    # the lanes run different schedules, so some wait frozen for others
    assert len({tuple(lane.inner_iterations) for lane in batch}) > 1


def test_batch_matches_jax_register_batch(world):
    """B = 2 against the JAX lockstep machine itself (``register_batch``,
    its Pallas kernels run in interpret mode), float32."""
    jreg, treg, start = _registrars(world, "maha", "f32")
    local = world[1]
    scans, starts = [local, local[::2]], [start, start]
    want = jreg.register_batch(scans, [_start((0.0, 0.0, 0.0), nls)] * 2)
    got = treg.register_batch(scans, starts)
    assert got[0].inner_iterations.tolist() != got[1].inner_iterations.tolist()
    for g, w in zip(got, want):
        _assert_same_run(g, w)


@pytest.mark.parametrize("case", ["maha", "p2p"])
def test_information_matches_jax(world, case):
    jreg, treg, start = _registrars(world, case, "f32")
    local = world[1]
    pose = treg.register(local, start).pose
    got, want = treg.information(local, pose), jreg.information(local, pose)
    assert got.shape == (6, 6) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.linalg.cholesky(got)


def test_register_point_to_plane_matches_jax(world):
    tmap, jmap = world[0][False]
    local = world[1]
    start = _start(P2P_START)
    jstart = _start(P2P_START, nls)
    loss_t, loss_j = port.ExponentialLoss(1.0, 1.0), nls.ExponentialLoss(1.0, 1.0)
    jm = nls.PointToPlaneMinimizer(backend="jnp", dtype=jnp.float32).set_loss_function(loss_j)
    want = jregistration.register_point_to_plane(
        jmap, local, jstart, jm, nls.Options(), max_thickness=0.05
    )
    tm = port.PointToPlaneMinimizer(device="cpu").set_loss_function(loss_t)
    assert tm.backend == "torch" and tm.dtype == torch.float32
    got = port.register_point_to_plane(tmap, local, start, tm, port.Options(), max_thickness=0.05)
    assert got.outer_iterations == want.outer_iterations >= 2
    assert [int(s.iterations) for s in got.summaries] == [int(s.iterations) for s in want.summaries]
    np.testing.assert_allclose(
        [float(s.final_cost) for s in got.summaries],
        [float(s.final_cost) for s in want.summaries], rtol=1e-5, atol=1e-9,
    )
    np.testing.assert_allclose(got.pose.matrix(), want.pose.matrix(), atol=1e-5)


def test_p2p_minimizer_kernel_path_matches_torch_backend(world):
    """One point-to-plane solve through the kernel's packed path (on the
    CPU: the kernel's plain version) against the "torch" backend."""
    tmap, _ = world[0][False]
    reg = port.NdtRegistrar(tmap, port.Options(), None, objective="p2p", device="cpu")
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    m = reg.map
    data = matching.match_point_to_plane(
        m.means_T.T, m.normals_T.T, m.voxel_weights, f32(world[1]),
        torch.ones(len(world[1])), torch.eye(3), f32(P2P_START),
    ).pad_to(2048)
    t0, q0 = f32(P2P_START), torch.tensor([1.0, 0.0, 0.0, 0.0])
    loss = port.HuberLoss(0.1)
    out = {
        b: minimizers._se3_solve("p2p", t0, q0, data, loss, None, port.Options(), b)
        for b in ("cuda", "torch")
    }
    (pk_, sk), (pt, st) = out["cuda"], out["torch"]
    assert int(sk.iterations) == int(st.iterations) > 1
    torch.testing.assert_close(pk_.translation, pt.translation, rtol=0, atol=1e-5)
    torch.testing.assert_close(pk_.quaternion, pt.quaternion, rtol=0, atol=1e-5)


def test_voxel_normals_and_plane_matching_match_jax(world, rng):
    for moment in (True, False):
        tmap, jmap = world[0][moment]
        for a, b in zip(ndt.voxel_normals(tmap.valid_only()), jndt.voxel_normals(jmap.valid_only())):
            np.testing.assert_array_equal(a, b)
    tmap, _ = world[0][False]
    valid = tmap.valid_only()
    normals, flatness, thickness = ndt.voxel_normals(valid)
    weights = ((flatness <= 0.2) & (thickness <= 0.05)).astype(np.float64)
    local = world[1]
    pose = nls.Pose.from_axis_angle(0.05, rng.normal(size=3), 0.1 * rng.normal(size=3))
    args = (valid.means, normals, weights, local, np.ones(len(local)), pose.rotation, pose.translation)
    want = jmatching.match_point_to_plane(*(jnp.asarray(a) for a in args))
    got = matching.match_point_to_plane(*(torch.as_tensor(a) for a in args))
    assert 0.5 * len(local) < float(got.mask.sum()) < len(local)
    for a, b in zip(got, want):  # the same plane for every point
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_k_nearest_orders_ties_as_lax_top_k(rng):
    d2 = rng.integers(0, 4, size=(64, 12)).astype(np.float32)  # many exact ties
    for k in (2, 4):
        values, idx = matching.k_nearest(torch.as_tensor(d2), k)
        neg, want = jax.lax.top_k(-jnp.asarray(d2), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        np.testing.assert_array_equal(values.numpy(), -np.asarray(neg))


@contextlib.contextmanager
def _no_host_reads():
    """Make every way of reading a tensor's value on the host, or of
    copying a Python value into a new tensor, raise."""
    def refuse(*_, **__):
        raise AssertionError("host read or host-to-device copy inside a block")

    saved = {}
    for owner, name in [(torch.Tensor, "__bool__"), (torch.Tensor, "item"),
                        (torch.Tensor, "tolist"), (torch.Tensor, "numpy"),
                        (torch.Tensor, "cpu"), (torch, "tensor"), (torch, "as_tensor")]:
        saved[(owner, name)] = getattr(owner, name)
        setattr(owner, name, refuse)
    try:
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)


@pytest.mark.parametrize("case", ["maha", "planar", "p2p"])
def test_block_reads_nothing_on_the_host(world, case, monkeypatch):
    """Inside a K-step block nothing is read on the host and no Python
    value is copied into a tensor, on both evaluation paths (the kernel
    path runs the kernels' plain versions here)."""
    _, treg, start = _registrars(world, case, "f32")
    blocks = []
    block = treg._block

    def guarded(*args):
        with _no_host_reads():
            out = block(*args)
        blocks.append(1)
        return out

    monkeypatch.setattr(treg, "_block", guarded)
    plain = treg.register(world[1], start)
    assert len(blocks) == treg.run_stats()["host_reads"] > 1
    # the vmap mode's per-step matching and select read nothing either
    blocks.clear()
    (vmapped,) = treg.register_batch([world[1]], [start], mode="vmap")
    assert len(blocks) == treg.run_stats()["host_reads"] > 1
    assert vmapped.outer_iterations == plain.outer_iterations
    np.testing.assert_array_equal(vmapped.inner_iterations, plain.inner_iterations)
    treg.eval_backend = "cuda"  # the kernel path, through the plain versions
    treg._loss_code, treg._loss_ab = ck.maha6_loss_ab(treg.loss, "cpu")
    kernel = treg.register(world[1], start)
    assert kernel.outer_iterations == plain.outer_iterations
    np.testing.assert_array_equal(kernel.inner_iterations, plain.inner_iterations)


def test_api_errors(world):
    tmap, _ = world[0][True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.NdtRegistrar(tmap, port.Options())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.PointToPlaneMinimizer()
    with pytest.raises(NotImplementedError, match="mahalanobis-only"):
        port.NdtRegistrar(tmap, port.Options(), objective="p2p", planar=True, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        port.NdtRegistrar(tmap, port.Options(), device="cpu", eval_backend="cuda")
    with pytest.raises(ValueError, match="unknown objective"):
        port.NdtRegistrar(tmap, port.Options(), device="cpu", objective="d2d")
    reg = port.NdtRegistrar(tmap, port.Options(), device="cpu")
    assert reg.eval_backend == "torch" and reg.num_neighbors == 2
    scan = world[1][:50]
    with pytest.raises(ValueError, match="unknown mode"):
        reg.register_batch([scan], [nls.Pose.identity()], mode="serial")
    with pytest.raises(ValueError, match="poses for batch"):
        reg.register_batch([scan, scan], [nls.Pose.identity()])
    padded = port.NdtRegistrar(tmap, port.Options(), device="cpu", map_pad_multiple=128)
    with pytest.raises(NotImplementedError, match="map_pad_multiple"):
        padded.register_batch([scan], [nls.Pose.identity()])


# ---- the block's CUDA graph, with a stand-in graph on the CPU --------------


class _FakeGraph:
    """A CUDA graph's stand-in: the capture runs the body once (a real one
    runs nothing; the machine loads its static state after it either way),
    and a replay runs it again with its kernel calls uncounted, as a real
    replay runs no Python."""

    def __init__(self, body, device, share=None):
        body()
        self.body = body

    def replay(self):
        saved = dict(ck.LAUNCHES)
        self.body()
        ck.LAUNCHES.update(saved)


def _fake_card(monkeypatch, world, case, kernel_path=True, **kw):
    """A CPU registrar of ``case`` whose blocks may take the graph path,
    with :class:`_FakeGraph` for the graph and, with ``kernel_path``, the
    kernel path through the plain versions, each call counted in
    ``ck.LAUNCHES`` as a launch on the card is. Graphs stay off until the
    test turns ``tfr._can_capture`` on."""
    case_kw, moment, start = CASES[case]
    reg = port.NdtRegistrar(world[0][moment][0], port.Options(), port.ExponentialLoss(1.0, 1.0),
                            device="cpu", **case_kw, **kw)
    if kernel_path:
        reg.eval_backend = "cuda"
        reg._loss_code, reg._loss_ab = ck.maha6_loss_ab(reg.loss, "cpu")
    onepass = ck._onepass

    def counted(name, *args):
        ck.LAUNCHES[name] += 1
        return onepass(name, *args)

    monkeypatch.setattr(ck, "_onepass", counted)
    monkeypatch.setattr(tfr, "_capture", _FakeGraph)
    monkeypatch.setattr(tfr, "_can_capture", lambda device: False)
    return reg, _start(start)


def _graph_counts() -> dict:
    c = tracing.counters()
    return {k: c.get(k, 0) for k in ("graph.captures", "graph.replays")}


def _same_bits(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", ["planar", "p2p"])
def test_block_graph_captures_the_second_block(world, case, monkeypatch):
    """The first block of a new shape runs eagerly, the second captures
    the graph and replays it, every later block replays, and the next run
    of that shape replays from its first block. Each run gives the eager
    run's bits and run statistics, ``graph_blocks`` counts the replays,
    ``ck.LAUNCHES`` counts one launch a step (a replay adds the graph's
    launches, the capture none), and the results are the caller's own."""
    reg, start = _fake_card(monkeypatch, world, case)
    scan, kernel = world[1], {"planar": "maha3", "p2p": "p2p"}[case]
    calls = []
    block = reg._block
    monkeypatch.setattr(reg, "_block", lambda *a: calls.append(1) or block(*a))

    def run():
        ck.reset_launches()
        calls.clear()
        before = _graph_counts()
        out = reg.register_async(scan, start)
        counts = {k: v - before[k] for k, v in _graph_counts().items()}
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        # the blocks run outside a replay (the stand-in's replays run it too)
        return out, reg.run_stats(), launches, counts, len(calls) - counts["graph.replays"]

    eager, eager_stats, launches, counts, blocks = run()
    steps, reads = eager_stats["steps"], eager_stats["host_reads"]
    assert eager_stats["graph_blocks"] == 0 and reads >= 3 and reg._graph is None
    assert launches == {kernel: steps} and blocks == reads
    assert counts == {"graph.captures": 0, "graph.replays": 0}

    monkeypatch.setattr(tfr, "_can_capture", lambda device: True)
    first, stats, launches, counts, blocks = run()
    _same_bits(first, eager)
    assert stats == {**eager_stats, "graph_blocks": reads - 1}
    assert launches == {kernel: steps} and blocks == 2  # the eager block and the capture
    assert counts == {"graph.captures": 1, "graph.replays": reads - 1}
    kept = [a.clone() for a in first]

    second, stats, launches, counts, blocks = run()
    _same_bits(second, eager)
    assert stats == {**eager_stats, "graph_blocks": reads}
    assert launches == {kernel: steps} and blocks == 0
    assert counts == {"graph.captures": 0, "graph.replays": reads}
    graph = reg._graph
    _same_bits(first, kept)  # the second run left the first run's tensors alone
    static = {a.data_ptr() for a in graph.state}
    assert not static & {a.data_ptr() for a in first + second}


def test_block_graph_keys_and_lru(world, monkeypatch):
    """A registrar keeps one graph, of the last shape captured: a new N, a
    new B or new options is a new key, whose second block captures a graph
    that replaces the old one; the kept shape replays from its first
    block."""
    reg, start = _fake_card(monkeypatch, world, "p2p")
    monkeypatch.setattr(tfr, "_can_capture", lambda device: True)
    scan = world[1][::4]
    shape = lambda: reg._graph.key[0]
    captures = lambda: _graph_counts()["graph.captures"]
    for n in (len(scan), len(scan) - 4):
        reg.register(scan[:n], start)
        assert reg.run_stats()["graph_blocks"] == reg.run_stats()["host_reads"] - 1
        assert shape() == (1, 10, n)
    reg.register_batch([scan, scan], [start] * 2)
    assert shape() == (2, 10, len(scan))
    before = captures()
    reg.register_batch([scan, scan], [start] * 2)
    stats = reg.run_stats()
    assert stats["graph_blocks"] == stats["host_reads"] and captures() == before
    reg.options = reg.options.replace(max_iterations=reg.options.max_iterations - 1)
    reg.register_batch([scan, scan], [start] * 2)
    stats = reg.run_stats()
    assert stats["graph_blocks"] == stats["host_reads"] - 1 and captures() == before + 1
    assert reg._graph.key[-2] == reg.options


@pytest.mark.parametrize("path", ["torch", "mesh", "vmap"])
def test_block_graph_not_on_eager_paths(world, path, monkeypatch):
    """The "torch" evaluation, a mesh and the vmap mode run every block
    eagerly, whatever the device."""
    kw = {"mesh": make_factor_mesh(device="cpu")} if path == "mesh" else {}
    reg, start = _fake_card(monkeypatch, world, "p2p", kernel_path=path != "torch", **kw)
    monkeypatch.setattr(tfr, "_can_capture", lambda device: True)
    before = _graph_counts()
    scan = world[1][::2]
    for _ in range(2):
        if path == "vmap":
            reg.register_batch([scan], [start], mode="vmap")
        else:
            reg.register(scan, start)
        stats = reg.run_stats()
        assert stats["graph_blocks"] == 0 and stats["host_reads"] > 1
    assert _graph_counts() == before and reg._graph is None
