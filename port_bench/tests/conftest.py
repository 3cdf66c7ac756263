"""The harness's tests: on the CPU, except those marked ``chip``, which
need a CUDA device and skip without one (decided inside the test, by the
``cuda`` fixture, never while a module is imported).

    python -m pytest port_bench/tests -q                # on the CPU
    python -m pytest port_bench/tests -q -m chip -n 0   # on the card
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark (``BENCHMARK.json`` and ``port_bench/``) with
    the port's package linked beside it, the cells held out of
    ``BENCHMARK.json`` (``port_bench/held_out/``) put back, and its
    configurations cut to sizes the CPU runs in seconds: a 2 cm room, a
    300-pose world."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((BENCH / "held_out").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            spec[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pkg = "nonlinear_optimizer_for_slam_tpu_torch"
    (tmp_path / pkg).symlink_to(ROOT / pkg)
    cfg = tmp_path / "port_bench" / "configs"
    maha = json.loads((cfg / "maha_simple.json").read_text())
    maha["room"]["point_step"] = 0.02
    (cfg / "maha_simple.json").write_text(json.dumps(maha))
    graph = json.loads((cfg / "m3500.json").read_text())
    graph.update(n_poses=300, arena=5, n_edges=466)  # M3500's closures a pose
    (cfg / "m3500.json").write_text(json.dumps(graph))
    return tmp_path
