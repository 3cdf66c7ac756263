"""The port's spans and counters (``utils/tracing.py``) on the CPU.

On a small room (10 cm points, 1 m voxels, the scan filtered at 0.3 m, in
float64 on the plain paths): with no profiler running, ``register_ndt``
and ``NdtRegistrar.register_batch`` never enter ``record_function``; under
``torch.profiler`` the spans appear, nested as ``utils/tracing.py`` says,
and their counts agree with the program's own: one ``nls.lm.iter`` an LM
iteration of the summaries, one ``nls.read`` a ``host_reads``, eight
machine steps an ``nls.block``, and the batch's reads ``run_stats()``'s
``host_reads`` and the six copies of ``finalize_batch``. The answers are
bitwise the same with and without the profiler. ``TimeChecker`` and
``device_time`` scopes land on the profiler's timeline.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.pipelines import ndt, registration
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing, time_checker, tracing

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    pts = testing.generate_room_points(point_step=0.1)
    ndt_map = ndt.build_ndt_map(pts, 1.0)
    local = testing.maha_true_pose().inverse().apply(ndt.filter_points(pts, 0.3))
    return ndt_map, local


def _register_ndt(world):
    ndt_map, local = world
    minimizer = port.MahalanobisDistanceMinimizer(dtype=F64, device="cpu")
    minimizer.set_loss_function(port.ExponentialLoss())
    opts = port.Options().replace(max_iterations=6)
    return registration.register_ndt(ndt_map, local, port.Pose.identity(), minimizer, opts,
                                     max_outer_iterations=3)


def _registrar(world):
    ndt_map, _ = world
    return port.NdtRegistrar(ndt_map, port.Options().replace(max_iterations=6),
                             port.ExponentialLoss(), max_outer_iterations=3, dtype=F64,
                             device="cpu")


def _scans(world):
    _, local = world
    return [local, local[: len(local) // 2]], [port.Pose.identity()] * 2


def _spans(prof):
    """The port's spans of a stopped profiler: {name: [(start, end), ...]}
    in time order, in ns (read from the profiler's own records: building
    ``prof.events()`` takes seconds)."""
    out = {}
    events = prof.profiler.kineto_results.events()
    for ev in sorted(events, key=lambda e: e.start_ns()):
        if ev.name().startswith("nls."):
            out.setdefault(ev.name(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def _inside(inner, outer) -> bool:
    """Every span of ``inner`` lies inside one of ``outer``."""
    return all(any(s <= a and b <= e for s, e in outer) for a, b in inner)


def _profiled(fn):
    before = tracing.counters()["host_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof), tracing.counters()["host_reads"] - before


def test_no_profiler_no_record_function(world, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = tracing.counters()["host_reads"]
    res = _register_ndt(world)
    registrar = _registrar(world)
    registrar.register_batch(*_scans(world))
    reads = tracing.counters()["host_reads"] - before
    assert res.summaries and reads > registrar.run_stats()["host_reads"] + 6


def test_host_loop_spans_nest_and_count(world):
    res, spans, reads = _profiled(lambda: _register_ndt(world))
    outer = len(res.summaries)
    lm_iters = sum(int((~torch.isnan(s.records.cost)).sum()) for s in res.summaries)
    assert len(spans["nls.register"]) == 1
    assert len(spans["nls.match"]) == len(spans["nls.solve"]) == outer
    assert len(spans["nls.lm.iter"]) == lm_iters > outer
    # one read an LM iteration and one pose read-back a solve
    assert len(spans["nls.read"]) == reads == lm_iters + outer
    assert _inside(spans["nls.match"] + spans["nls.solve"], spans["nls.register"])
    assert _inside(spans["nls.lm.iter"], spans["nls.solve"])
    assert _inside(spans["nls.read"], spans["nls.solve"])
    assert not _inside(spans["nls.match"], spans["nls.solve"])


def test_machine_spans_nest_and_count(world):
    registrar = _registrar(world)
    out, spans, reads = _profiled(lambda: registrar.register_batch(*_scans(world)))
    stats = registrar.run_stats()
    assert len(out) == 2 and "nls.lm.iter" not in spans and "nls.solve" not in spans
    for name in ("nls.register", "nls.batch.upload", "nls.batch.finalize"):
        assert len(spans[name]) == 1, name
    assert 8 * len(spans["nls.block"]) == stats["steps"]
    assert len(spans["nls.read"]) == reads == stats["host_reads"] + 6
    # the first match, then one a rematch: at most one a read that did not end the run
    assert 1 < len(spans["nls.match"]) <= stats["host_reads"]
    everything = [s for name, v in spans.items() if name != "nls.register" for s in v]
    assert _inside(everything, spans["nls.register"])
    assert not any(_inside([r], spans["nls.block"]) for r in spans["nls.read"])
    finals = [r for r in spans["nls.read"] if _inside([r], spans["nls.batch.finalize"])]
    assert len(finals) == 6
    upload, first_match = spans["nls.batch.upload"][0], spans["nls.match"][0]
    assert upload[1] <= first_match[0] and first_match[1] <= spans["nls.block"][0][0]


def test_answers_bitwise_equal_under_the_profiler(world):
    registrar = _registrar(world)
    plain = (_register_ndt(world), registrar.register_batch(*_scans(world)))
    traced, _, _ = _profiled(lambda: (_register_ndt(world),
                                      registrar.register_batch(*_scans(world))))
    for a, b in [(plain[0], traced[0])] + list(zip(plain[1], traced[1])):
        np.testing.assert_array_equal(a.pose.translation, b.pose.translation)
        np.testing.assert_array_equal(a.pose.rotation, b.pose.rotation)
    for a, b in zip(plain[0].summaries, traced[0].summaries):
        assert torch.equal(a.final_cost, b.final_cost) and torch.equal(a.iterations, b.iterations)
    for a, b in zip(plain[1], traced[1]):
        assert a.final_cost == b.final_cost and a.outer_iterations == b.outer_iterations


def test_time_checker_scopes_are_spans():
    def body():
        with time_checker.TimeChecker("nls.test.checker"):
            torch.ones(3).sum()
        with time_checker.device_time("nls.test.device", {}) as holder:
            holder["out"] = torch.ones(3) * 2
        with time_checker.check_exec_time("nls.test.exec"):
            pass

    _, spans, _ = _profiled(body)
    for name in ("nls.test.checker", "nls.test.device", "nls.test.exec"):
        assert len(spans[name]) == 1, name
    samples = time_checker.TimeCheckerManager.instance().samples
    assert all(samples[n] for n in ("nls.test.checker", "nls.test.device", "nls.test.exec"))


def test_counters_report_launches_and_reset(monkeypatch):
    from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck

    # A fresh table: counters other tests of this process made (the
    # registrar's graph counters) would otherwise show in the key set.
    monkeypatch.setattr(tracing, "COUNTERS", {"host_reads": 5})
    monkeypatch.setitem(ck.LAUNCHES, "maha6", 7)
    got = tracing.counters()
    assert got["host_reads"] == 5 and got["launch.maha6"] == 7
    assert set(got) == {"host_reads"} | {f"launch.{k}" for k in ck.LAUNCHES}
    assert tracing.host_read(torch.tensor([True]), bool) is True
    assert tracing.counters()["host_reads"] == 6
    tracing.reset_counters()
    assert not any(tracing.counters().values())
