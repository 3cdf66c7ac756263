"""The readers of the program's spans (``harness/spans.py`` and the metrics
that use it) on canned traces: nested spans for self time, a span with no
device operation inside, a span outside the traced requests, and a trace
of a program without spans, where every reader reports nothing."""

from __future__ import annotations

import pytest

from conftest import BENCH, ROOT
from harness import manifest, runner, spans, traffic
from harness.trace import Event, Trace

SCAN_METRICS = ["host_reads_per_scan.scan", "lm_iter_us.scan", "lm_kernels_per_iter.scan",
                "match_ms_per_scan.scan", "solve_self_ms_per_scan.scan"]
SERVE_METRICS = ["block_us_per_step.serve16", "read_ms_per_batch.serve16",
                 "rematch_ms_per_batch.serve16", "edge_ms_per_batch.serve16"]

H = lambda name, s, e: Event(name, False, s, e)
D = lambda s: Event("void kernel(...)", True, s, s + 0.01)

# One scan: two outer iterations, a match and a solve each; the second
# solve's one LM iteration launches nothing.
SCAN = [
    H("pb.request", 0.0, 10.0), H("nls.register", 0.1, 9.9),
    H("nls.match", 0.2, 1.0), H("nls.solve", 1.0, 6.0),
    H("nls.lm.iter", 1.5, 3.0), H("nls.read", 2.8, 3.0),
    H("nls.lm.iter", 3.05, 5.05), H("nls.read", 4.8, 5.0), H("nls.read", 5.5, 5.8),
    H("nls.match", 6.0, 6.5), H("nls.solve", 6.5, 8.0),
    H("nls.lm.iter", 6.6, 7.6), H("nls.read", 7.5, 7.6), H("nls.read", 7.8, 7.9),
    D(0.3), D(1.6), D(1.7), D(3.1), D(9.0),
]

# One batch of 16 lanes, 16 steps: upload, the first match, two blocks
# each read, a rematch, the six copies of the results; one read falls
# outside the traced request.
SERVE = [
    H("pb.request", 0.0, 10.0), H("nls.register", 0.1, 9.9),
    H("nls.batch.upload", 0.2, 0.5), H("nls.match", 0.5, 1.0),
    H("nls.block", 1.0, 2.0), H("nls.read", 2.0, 2.1), H("nls.match", 2.1, 2.4),
    H("nls.block", 2.4, 3.3), H("nls.read", 3.3, 3.5),
    H("nls.batch.finalize", 8.0, 9.0),
    *(H("nls.read", 8.0 + 0.15 * k, 8.1 + 0.15 * k) for k in range(6)),
    H("nls.read", 10.5, 10.6),
    D(0.6), D(1.2), D(2.2),
]


def _ctx(events, counters):
    request = traffic.Request(0, [0], 0.0, 10.0, [None], counters, traced=True)
    window = traffic.Window(0.0, 10.0, [request])
    trace = None if events is None else Trace(events, 11.0)
    return runner.Context(None, {}, {}, 0.0, window, trace)


def _read(metric, ctx):
    return manifest.load_module(manifest.Manifest(ROOT).reader_path(metric)).read(ctx)


def test_span_arithmetic():
    t = Trace(SCAN, 11.0)
    assert spans.count(t, "nls.lm.iter") == 3 and spans.count(t, "nls.none") == 0
    assert spans.seconds(t, "nls.match") == pytest.approx(1.3)
    # 5.0 less 3.5 of LM iterations, 1.5 less 1.0
    assert spans.self_seconds(t, "nls.solve", ["nls.lm.iter"]) == pytest.approx(2.0)
    # children that overlap each other and the span's edges count once, clipped
    kids = Trace([H("p", 1.0, 2.0), H("c", 0.5, 1.2), H("c", 1.1, 1.3), H("d", 1.9, 2.5)], 3.0)
    assert spans.self_seconds(kids, "p", ["c", "d"]) == pytest.approx(0.6)
    assert spans.self_seconds(kids, "p", []) == pytest.approx(1.0)
    serve = Trace(SERVE, 11.0)
    assert spans.count(serve, "nls.read") == 9
    assert spans.count(serve, "nls.read", within="pb.request") == 8


@pytest.mark.parametrize("metric,want", [
    ("host_reads_per_scan.scan", 5.0),
    ("lm_iter_us.scan", 1.5e6),  # (1.5 + 2.0 + 1.0) s over 3
    ("lm_kernels_per_iter.scan", 1.0),  # 2, 1 and 0 operations
    ("match_ms_per_scan.scan", 1300.0),
    ("solve_self_ms_per_scan.scan", 2000.0),
])
def test_scan_readers(metric, want):
    assert _read(metric, _ctx(SCAN, {})) == pytest.approx(want)  # one scan


@pytest.mark.parametrize("metric,want", [
    ("block_us_per_step.serve16", 1e6 * 1.9 / 16),
    ("read_ms_per_batch.serve16", 900.0),  # 0.1 + 0.2 + 6 x 0.1 s: not the read outside
    ("rematch_ms_per_batch.serve16", 800.0),
    ("edge_ms_per_batch.serve16", 1300.0),
])
def test_serve_readers(metric, want):
    ctx = _ctx(SERVE, {"steps": 16, "batches": 1})
    assert _read(metric, ctx) == pytest.approx(want)


@pytest.mark.parametrize("metric", SCAN_METRICS + SERVE_METRICS)
def test_readers_report_nothing_without_spans(metric):
    bare = [e for e in SCAN if not e.name.startswith("nls.")]
    counters = {"steps": 16, "batches": 1}
    assert _read(metric, _ctx(bare, counters)) is None
    assert _read(metric, _ctx(None, counters)) is None
    assert _read(metric, _ctx([], {})) is None


def test_new_metrics_load_through_the_manifest():
    m = manifest.Manifest(ROOT)
    for cell, mine, other in [("maha_simple.scan", SCAN_METRICS, SERVE_METRICS),
                              ("maha_simple.serve16", SERVE_METRICS, SCAN_METRICS)]:
        entries = {e["name"]: e for e in m.cell(cell).per_layer}
        assert set(mine) <= set(entries) and not set(other) & set(entries)
        for name in mine:
            assert entries[name]["source"] == "program_span"
            assert m.reader_path(name) == BENCH / "metrics" / f"{name.split('.')[0]}.py"
