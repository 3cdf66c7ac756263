"""The generator, the profiler arithmetic, the roofline counts and the
module check, on canned inputs."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH
from harness import guard, manifest, roofline, runner, traffic
from harness.trace import Event, Trace, merge

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**70 + 3])
def test_traffic_repeats_exactly_from_a_seed(mix, seed):
    spec = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    a, b, c = traffic.plan(spec, seed), traffic.plan(spec, seed), traffic.plan(spec, seed + 1)
    assert a.items == b.items and len(a.items) == spec["pool"]
    assert [a.request(k) for k in range(20)] == [b.request(k) for k in range(20)]
    rounds = len(a.items) // a.batch
    assert sorted(i for k in range(rounds) for i in a.request(k)) == list(range(len(a.items)))
    batches = lambda p: sorted(sorted(p.request(k)) for k in range(rounds))
    if "pool_seed" in spec:  # the same items in the same batches, in another order
        assert c.items == a.items and batches(c) == batches(a) and c.order != a.order
    else:
        assert c.items != a.items


def test_closed_loop_counts_and_traces_the_first_requests():
    spec = {"entry": "x", "pool": 4, "draws": {"v": ["normal", 0, 1]}, "batch": 2,
            "check": 2, "trace_seconds": 0.01}
    plan = traffic.plan(spec, 1)

    class Prof:
        stopped = False

        def stop(self):
            Prof.stopped = True

    calls = []

    def entry(items):
        calls.append(items)
        if len(calls) == 3:
            raise RuntimeError("one failed request")
        return [0] * len(items), {"n": 1}

    loop = manifest.load_module(BENCH / "loops" / "closed.py")
    w = runner.drive(loop, entry, plan, 0.2, Prof)
    traced = [r for r in w.requests if r.traced]
    assert Prof.stopped and traced and w.requests[: len(traced)] == traced  # traced first
    assert w.trace_s >= traced[-1].end - traced[0].start > 0 and w.start >= traced[-1].end
    assert w.attempted() == 2 * len(calls) and w.failed() == 2
    assert [bool(r.error) for r in w.requests].count(True) == 1 and "one failed" in w.requests[2].error
    assert w.counters(traced=True)["n"] + w.counters()["n"] == len(calls) - 1
    assert w.items() == 2 * w.counters()["requests"] == len(w.latencies())
    window = [r for r in w.requests if not r.traced]
    assert window[-1].start < w.start + 0.201 and w.end == window[-1].end


def test_trace_arithmetic_on_a_canned_table():
    events = [
        Event("pb.request", False, 0.0, 5.0),
        Event("aten::item", False, 2.2, 2.9),
        Event("void nls::onepass::kernel<nls::Maha6, 1>(...)", True, 0.0, 1.0),
        Event("void gemm(...)", True, 0.5, 2.0),
        Event("void nls::onepass::kernel<nls::Maha6Bf16, 1>(...)", True, 3.0, 4.0),
        Event("Memcpy DtoH", True, 6.0, 6.0),  # no duration: not counted
    ]
    t = Trace(events, window_s=5.0)
    assert merge([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert t.busy_s == pytest.approx(3.0) and t.idle_pct() == pytest.approx(40.0)
    assert len(t.ops(within="pb.request")) == 3
    assert t.seconds(r"nls::.*\bMaha6\b") == pytest.approx(1.0)
    assert t.device_ops()[0] == ["void gemm(...)", pytest.approx(1.5)]
    gaps = dict(map(tuple, t.idle_gaps()))
    assert gaps == {"aten::item": pytest.approx(1.0), "pb.request": pytest.approx(1.0)}
    assert Trace([], 1.0).idle_pct() is None and Trace([], 1.0).idle_gaps() == []


def test_roofline_counts_of_maha6_by_hand():
    # 18,712 factors of one problem: 16 rows x 4 bytes a factor, 16 params
    # and 28 outputs of 4 bytes: 1,197,744 bytes; 314 x 18,712 operations
    assert roofline.bytes_needed("maha6", 18712, 1) == 1197744
    assert roofline.operations("maha6", 18712) == 5875568
    assert roofline.bound_seconds("maha6", 18712, 1) == pytest.approx(1197744 / 3.35e12)
    # 16 problems of 18,712 factors: still bound by the bytes
    assert roofline.bound_seconds("maha6", 16 * 18712, 16) == pytest.approx(
        4 * (16 * 16 * 18712 + 44 * 16) / 3.35e12)


def test_module_check_compares_top_level_names_whole():
    assert guard.banned_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert guard.banned_modules(["nonlinear_optimizer_for_slam_tpu.core.lie"]) == [
        "nonlinear_optimizer_for_slam_tpu"]
    assert guard.banned_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert guard.banned_modules(
        ["nonlinear_optimizer_for_slam_tpu_torch", "nonlinear_optimizer_for_slam_tpu_torch.ops",
         "jaxtyping", "jax_like"]) == []
