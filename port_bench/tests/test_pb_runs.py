"""A run fails loudly where it cannot measure the port; on the card, the
control fails the check that the program passes."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import BENCH, ROOT
from harness import runner

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    saved = [p for p in sys.path if os.path.isdir(os.path.join(p, "nonlinear_optimizer_for_slam_tpu_torch"))]
    mods = {k: v for k, v in sys.modules.items() if k.startswith("nonlinear_optimizer_for_slam_tpu_torch")}
    try:
        for p in saved:
            sys.path.remove(p)
        for k in mods:
            del sys.modules[k]
        with pytest.raises(ModuleNotFoundError):
            runner.run(tmp_path, CELLS[0], 1, 1.0, False, time.perf_counter(), device="cpu")
    finally:
        sys.path[:0] = saved
        sys.modules.update(mods)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cuda, cell):
    """Three seeds at the cell's own size: every reading of the program
    within its limit, every seed's control outside at least one."""
    import readings

    cfg = json.loads((BENCH / "configs" / f"{cell.split('.')[0]}.json").read_text())
    limits = cfg["limits"]
    seeds = [20261101, 20261102, 20261103]
    for row in readings.readings(cell, seeds):
        assert all(row[k] <= limits[k] for k in limits), row
    for row in readings.readings(cell, seeds, control=True):
        assert any(row[k] > limits[k] for k in limits), row
