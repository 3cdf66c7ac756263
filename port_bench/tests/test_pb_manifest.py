"""BENCHMARK.json parses and keeps to the rules; every cell's pieces are
found by name; a cell made of new files and entries alone runs."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil
import time

import pytest

from conftest import BENCH, ROOT
from harness import manifest, runner

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_manifest_parses_and_names_keep_to_the_rules():
    spec = manifest.Manifest(ROOT).spec
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            assert manifest.NAME.match(entry["name"]), entry["name"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
    for w in spec["workloads"]:
        assert manifest.NAME.match(w["config"]) and manifest.NAME.match(w["traffic"])
    assert len(json.dumps(spec)) < 64 * 1024
    assert spec["paths"] == ["port_bench"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    m = manifest.Manifest(ROOT)
    c = m.cell(cell)
    assert c.config_module == BENCH / "configs" / f"{c.config}.py"
    assert c.traffic_file == BENCH / "traffic" / f"{c.traffic}.json"
    assert c.config_file.is_file() and c.chips == 1
    assert "setup_s" in [e["name"] for e in c.end_to_end] and len(c.end_to_end) >= 2
    assert c.per_layer
    for metric in c.end_to_end + c.per_layer:
        assert m.reader_path(metric["name"]).is_file()


@pytest.mark.parametrize("bad", [
    ("workloads", "name", "has space"), ("workloads", "name", "a/b"),
    ("end_to_end", "unit", "tokens per s"), ("end_to_end", "bound", 0.3),
    ("per_layer", "moves", "no_such_metric"), ("per_layer", "source", "guess"),
])
def test_validate_refuses_what_breaks_the_rules(bad):
    group, key, value = bad
    spec = copy.deepcopy(SPEC)
    spec[group][0][key] = value
    with pytest.raises(manifest.ManifestError):
        manifest.validate(spec)


TOY_CONFIG = '''
from harness.report import Check

class System:
    def __init__(self, cfg, plan, device):
        self.plan = plan
    def release(self):
        pass
    def check(self, window, rng, limits):
        return [Check("gap", float("inf"), limits["gap"])]
'''

# an entry point with a check of its own, which replaces the system's
TOY_ENTRY = '''
from harness.report import Check

def make(system):
    def serve(items):
        return [system.plan.items[i]["v"] for i in items], {"work": len(items)}
    return serve

def check(system, window, rng, limits):
    answers = [a for r in window.requests if r.answers for a in r.answers]
    return [Check("gap", max(abs(a - 0.5) for a in answers), limits["gap"])]
'''

# NdtRegistrar.register, one scan a request: an entry point that the
# configuration's code does not know
REGISTRAR1 = '''
def make(system):
    registrar = system.port.NdtRegistrar(system.ndt_map, system.options, system.loss,
                                         device=system.device, **system.matching)

    def serve(scans):
        r = registrar.register(scans[0], system.identity)
        return [(r.pose, r.final_cost)], {}

    return system.counted(serve)
'''

# an open loop: requests due at the mix's rate, served in turn by one
# server, each request's latency counted from when it was due
OPEN_LOOP = '''
import time
from harness import traffic

def drive(serve, plan, seconds, first, traced):
    start = time.perf_counter()
    gap = 1.0 / plan.mix["rate_per_s"]
    requests = []
    while not requests or start + len(requests) * gap < start + seconds:
        due = start + len(requests) * gap
        time.sleep(max(0.0, due - time.perf_counter()))
        requests.append(traffic.send(serve, plan, first + len(requests), traced, due=due))
    return start, requests
'''

LATENCY_P50 = '''
import statistics

def read(ctx):
    return 1e3 * statistics.median(ctx.window.latencies())
'''


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add(root, configs=(), workloads=(), end_to_end=(), per_layer=()):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for key, new in (("configs", configs), ("workloads", workloads),
                     ("end_to_end", end_to_end), ("per_layer", per_layer)):
        spec[key] += list(new)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_cell_of_new_files_alone_is_found_and_runs(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "port_bench")
    bench = tmp_path / "port_bench"
    (bench / "configs" / "toy.json").write_text(json.dumps({"limits": {"gap": 1.0}}))
    (bench / "configs" / "toy.py").write_text(TOY_CONFIG)
    (bench / "entries" / "toy").mkdir()
    (bench / "entries" / "toy" / "any.py").write_text(TOY_ENTRY)
    (bench / "traffic" / "burst.json").write_text(json.dumps(
        {"entry": "any", "pool": 6, "draws": {"v": ["uniform", 0, 1]}, "batch": 2, "check": 2}))
    (bench / "metrics" / "work_per_item.py").write_text(
        "def read(ctx):\n    c = ctx.counters()\n    return c['work'] / c['items']\n")
    (bench / "metrics" / "toy_ms.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.window.seconds / ctx.window.items()\n")
    _add(tmp_path,
         configs=[{"name": "toy", "source": "a test", "file": "port_bench/configs/toy.json",
                   "reduced": [], "why": "a test"}],
         workloads=[{"name": "toy.burst", "config": "toy", "traffic": "burst", "chips": 1,
                     "why": "a test"}],
         end_to_end=[{"name": "toy_ms", "unit": "ms", "better": "lower", "bound": 0.1,
                      "source": "host_clock", "workloads": ["toy.burst"]}],
         per_layer=[{"name": "work_per_item.toy", "unit": "count", "better": "lower",
                     "source": "program_counter", "layer": "toy", "moves": "toy_ms",
                     "workloads": ["toy.burst"]}])

    assert {k: v for k, v in _digest(bench).items() if k in before} == before
    cell = manifest.Manifest(tmp_path).cell("toy.burst")
    assert {m["name"] for m in cell.end_to_end} == {"toy_ms", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["work_per_item.toy"]
    assert cell.loop_module == bench / "loops" / "closed.py"
    for trace in (False, True):
        out = runner.run(tmp_path, "toy.burst", 7, 0.2, trace, time.perf_counter(), device="cpu")
        assert out["correct"] and out["attempted"] % 2 == 0 and out["failed"] == 0
        names = {"toy_ms", "setup_s"} if not trace else {"work_per_item.toy"}
        assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


def test_a_new_entry_point_under_an_open_loop_needs_only_new_files(small_root):
    """maha_simple served through ``NdtRegistrar.register`` one scan at a
    time, the scans due at a fixed rate: an entry point, a loop, a mix and
    a metric that no existing file names."""
    bench = small_root / "port_bench"
    before = _digest(bench)
    (bench / "entries" / "maha_simple" / "registrar1.py").write_text(REGISTRAR1)
    (bench / "loops" / "open.py").write_text(OPEN_LOOP)
    (bench / "traffic" / "registrar1_open.json").write_text(json.dumps(
        {"entry": "registrar1", "loop": "open", "rate_per_s": 4.0, "pool": 4, "pool_seed": 3,
         "draws": {"yaw": ["normal", 0.0, 0.02]}, "batch": 1, "check": 2, "trace_seconds": 0.1}))
    (bench / "metrics" / "scan_latency_p50_ms.py").write_text(LATENCY_P50)
    cell = "maha_simple.registrar1_open"
    _add(small_root,
         workloads=[{"name": cell, "config": "maha_simple", "traffic": "registrar1_open",
                     "chips": 1, "why": "a test"}],
         end_to_end=[{"name": "scan_latency_p50_ms", "unit": "ms", "better": "lower",
                      "bound": 0.1, "source": "host_clock", "workloads": [cell]}],
         per_layer=[{"name": "maha6_launches_per_scan.registrar1", "unit": "count",
                     "better": "lower", "source": "program_counter", "layer": "registrar machine",
                     "moves": "scan_latency_p50_ms", "workloads": [cell]}])

    assert {k: v for k, v in _digest(bench).items() if k in before} == before
    found = manifest.Manifest(small_root).cell(cell)
    assert found.entry_module.name == "registrar1.py" and found.loop_module.name == "open.py"
    for trace in (False, True):
        out = runner.run(small_root, cell, 11, 1.0, trace, time.perf_counter(), device="cpu")
        assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2, out["checks"]
        names = {"maha6_launches_per_scan.registrar1"} if trace else {"scan_latency_p50_ms", "setup_s"}
        assert set(out["metrics"]) == names
