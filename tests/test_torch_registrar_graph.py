"""The registrar machine's CUDA graph on the card: each path replayed from
its graph against the same registrar's eager chain of blocks.

For the maha objective at B = 16 in lockstep and at B = 1 (with the
default Cholesky solve, and with DENSE_QR and CONJUGATE_GRADIENT), planar,
p2p and ``D2dRegistrar``, on the upstream test's room (the maha-simple
scan, 9,356 points): the eager run, then a run that captures its second
block and a run that replays every block, each with the six result
tensors, the run statistics (``graph_blocks`` aside) and the maha6, maha3
and p2p launch counts exactly the eager run's. A replayed run's trace
holds as many of the port's kernels as ``ck.LAUNCHES`` counts. Then two
``register_batch_async`` calls hand out tensors of their own.

These tests need a CUDA device and skip without one. The file imports
nothing of JAX, so it runs on a machine with the card alone:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m chip tests/test_torch_registrar_graph.py
"""

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import fused_registration as tfr
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import ndt
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

pytestmark = pytest.mark.chip

KERNELS = ("maha6", "maha3", "p2p")
SOLVERS = {"qr": port.LinearSolverType.DENSE_QR, "cg": port.LinearSolverType.CONJUGATE_GRADIENT}
CASES = ("maha_b16", "maha", "planar", "p2p", "d2d", *(f"maha{b}_{s}" for b in ("_b16", "")
                                                        for s in SOLVERS))


@pytest.fixture(scope="module")
def room():
    """The room's two maps, the scan in the true pose's frame and in the
    planar pose's, on a machine with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pts = testing.generate_room_points()
    scan = ndt.filter_points(pts, 0.1)
    return {
        "map": ndt.build_ndt_map(pts, 1.0),
        "p2p_map": ndt.build_ndt_map(pts, 1.0, identity_moment=False),
        "local": testing.maha_true_pose().inverse().apply(scan),
        "local_planar": testing.maha_3dof6dof_true_pose().inverse().apply(scan),
    }


def _case(room, case):
    """(registrar, run) for ``case``: ``run()`` gives a run's device
    tensors. A case ``<case>_<solver>`` solves with ``SOLVERS[solver]``."""
    loss = port.ExponentialLoss(1.0, 1.0)
    identity = port.Pose.identity()
    local = room["local"]
    solver = case.rsplit("_", 1)[-1]
    if solver in SOLVERS:
        case = case[: -len(solver) - 1]
        options = port.Options(linear_solver_type=SOLVERS[solver])
    else:
        options = port.Options()
    if case == "maha_b16":
        reg = port.NdtRegistrar(room["map"], options, loss)
        starts = [port.Pose(np.eye(3), np.full(3, 1e-5 * (i + 1))) for i in range(16)]
        return reg, lambda: reg.register_batch_async([local] * 16, starts)
    if case == "d2d":
        reg = port.D2dRegistrar(room["p2p_map"], port.Options())
        return reg, lambda: reg.register_async(local, identity)
    if case == "p2p":
        reg = port.NdtRegistrar(room["p2p_map"], port.Options(), loss, objective="p2p",
                                max_thickness=0.05)
        start = port.Pose(np.eye(3), np.array([0.0, 0.0, 0.05]))
        return reg, lambda: reg.register_async(local, start)
    if case == "planar":
        reg = port.NdtRegistrar(room["map"], port.Options(), loss, planar=True)
        return reg, lambda: reg.register_async(room["local_planar"], identity)
    reg = port.NdtRegistrar(room["map"], options, loss)
    return reg, lambda: reg.register_async(local, identity)


def _counted(reg, run):
    """One run: (device tensors, run statistics, launches by kernel)."""
    ck.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, reg.run_stats(), {k: ck.LAUNCHES[k] for k in KERNELS}


def _same_bits(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", CASES)
def test_graph_replays_give_the_eager_bits(room, case, monkeypatch):
    reg, run = _case(room, case)
    monkeypatch.setattr(tfr, "_can_capture", lambda device: False)
    eager, eager_stats, eager_launches = _counted(reg, run)
    reads = eager_stats["host_reads"]
    assert eager_stats["graph_blocks"] == 0 and reads >= 3
    assert sum(eager_launches.values()) == eager_stats["steps"]
    monkeypatch.undo()
    for graph_blocks in (reads - 1, reads):  # capture on the second block; then replays only
        out, stats, launches = _counted(reg, run)
        _same_bits(out, eager)
        assert stats == {**eager_stats, "graph_blocks": graph_blocks}
        assert launches == eager_launches
    assert reg._graph is not None


@pytest.mark.parametrize("case", ("maha_b16", "planar", "p2p", "d2d"))
def test_a_replayed_run_launches_what_the_counter_counts(room, case):
    """The port's kernels in the trace of a run replayed from its graph
    are the launches that ``ck.LAUNCHES`` adds in that run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reg, run = _case(room, case)
    for _ in range(2):  # the capturing run, then one that replays only
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, stats, launches = _counted(reg, run)
    traced = sum(ev.count for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and "nls::" in ev.key)
    assert stats["graph_blocks"] == stats["host_reads"]
    assert traced == sum(launches.values()) == stats["steps"]


def test_batch_async_results_are_the_callers(room):
    reg, run = _case(room, "maha_b16")
    first = run()
    kept = [a.clone() for a in first]
    second = run()
    torch.cuda.synchronize()
    assert reg.run_stats()["graph_blocks"] == reg.run_stats()["host_reads"]
    _same_bits(first, kept)
    _same_bits(second, kept)
    assert not {a.data_ptr() for a in first} & {a.data_ptr() for a in second}
