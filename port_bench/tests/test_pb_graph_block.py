"""The reader of ``graph_block_pct.serve16`` on canned traces: the share of
the registrar's blocks replayed from a CUDA graph in the traced requests,
and nothing from a program that replays no graph."""

from __future__ import annotations

import pytest

from conftest import BENCH, ROOT
from harness import manifest, runner, traffic
from harness.trace import Event, Trace

METRIC = "graph_block_pct.serve16"

H = lambda name, s, e: Event(name, False, s, e)

# Three blocks in the traced request: the first eager, the second a capture
# and its replay, the third a replay; a replayed block outside the request.
BLOCKS = [
    H("pb.request", 0.0, 10.0),
    H("nls.block", 1.0, 2.0),
    H("nls.block", 2.5, 3.5), H("nls.graph.replay", 3.0, 3.4),
    H("nls.block", 4.0, 4.1), H("nls.graph.replay", 4.0, 4.05),
    H("nls.block", 10.5, 10.6), H("nls.graph.replay", 10.5, 10.55),
    Event("void kernel(...)", True, 1.0, 1.1),
]


def _read(events):
    request = traffic.Request(0, [0], 0.0, 10.0, [None], {"steps": 24, "batches": 1}, traced=True)
    window = traffic.Window(0.0, 10.0, [request])
    trace = None if events is None else Trace(events, 11.0)
    ctx = runner.Context(None, {}, {}, 0.0, window, trace)
    return manifest.load_module(manifest.Manifest(ROOT).reader_path(METRIC)).read(ctx)


def test_share_of_replayed_blocks():
    assert _read(BLOCKS) == pytest.approx(100.0 * 2 / 3)


@pytest.mark.parametrize("events", [
    None, [], [e for e in BLOCKS if e.name != "nls.graph.replay"],
    [e for e in BLOCKS if not e.name.startswith("nls.")],
])
def test_nothing_without_replays(events):
    assert _read(events) is None


def test_entry():
    m = manifest.Manifest(ROOT)
    entries = {e["name"]: e for e in m.cell("maha_simple.serve16").per_layer}
    assert entries[METRIC]["source"] == "program_span"
    assert entries[METRIC]["moves"] == "scans_per_s"
    assert m.reader_path(METRIC) == BENCH / "metrics" / "graph_block_pct.py"
    assert METRIC not in {e["name"] for e in m.cell("maha_simple.scan").per_layer}
