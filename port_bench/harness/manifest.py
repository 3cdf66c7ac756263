"""``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; the harness finds each
piece by its name, so a later change adds a configuration, a mix or a
metric by adding files and entries, and edits none:

- ``port_bench/configs/<config>.py``: the set-up that the configuration's
  entry points share, and its check; its sizes are the ``file`` that
  ``BENCHMARK.json`` names (``port_bench/configs/<config>.json``);
- ``port_bench/traffic/<traffic>.json``: the mix's parameters, read by the
  one generator of ``harness/traffic.py``; the mix names its entry point,
  ``port_bench/entries/<config>/<entry>.py``, and its loop,
  ``port_bench/loops/<loop>.py``;
- ``port_bench/metrics/<metric>.py``: the reader of one metric, found by
  the metric's whole name first and else by the part before its first dot
  (``device_idle_pct.scan`` and ``device_idle_pct.graph`` share
  ``device_idle_pct.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = "port_bench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class ManifestError(ValueError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    config_file: Path
    config_module: Path
    traffic_file: Path
    entry_module: Path
    loop_module: Path
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _one_line(text: str, what: str) -> None:
    if not (1 <= len(text) <= 200) or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line, no tab")


def validate(spec: dict) -> None:
    """Raise ManifestError where ``spec`` breaks the rules on names, units,
    sources and the links between its entries."""
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(spec) != keys:
        raise ManifestError(f"keys {sorted(spec)} are not {sorted(keys)}")
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            name = entry["name"]
            if not NAME.match(name):
                raise ManifestError(f"{group}: bad name {name!r}")
            if name in names:
                raise ManifestError(f"name {name!r} used twice")
            names.add(name)
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        _one_line(c["source"], f"{c['name']}.source")
        for key in c["reduced"]:
            if not NAME.match(key):
                raise ManifestError(f"{c['name']}: bad reduced key {key!r}")
    e2e = {m["name"] for m in spec["end_to_end"]}
    if "setup_s" not in e2e:
        raise ManifestError("setup_s is not an end-to-end metric")
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                raise ManifestError(f"{w['name']}: bad {key} {w[key]!r}")
        if w["config"] not in configs:
            raise ManifestError(f"{w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"{w['name']}: chips must be 1 or 4")
        _one_line(w["why"], f"{w['name']}.why")
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            if not UNIT.match(m["unit"]):
                raise ManifestError(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                raise ManifestError(f"{m['name']}: better is lower or higher")
            if m["source"] not in SOURCES:
                raise ManifestError(f"{m['name']}: unknown source {m['source']!r}")
            for cell in m.get("workloads", []):
                if cell not in cells:
                    raise ManifestError(f"{m['name']}: unknown workload {cell!r}")
    for m in spec["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"{m['name']}: an end-to-end metric is host_clock or device_trace")
        if not 0.0 < m["bound"] <= 0.25:
            raise ManifestError(f"{m['name']}: bound in (0, 0.25]")
    for m in spec["per_layer"]:
        _one_line(m["layer"], f"{m['name']}.layer")
        if m["moves"] not in e2e:
            raise ManifestError(f"{m['name']}: moves unknown metric {m['moves']!r}")


class Manifest:
    """``BENCHMARK.json`` at ``root``, with the finder of each cell's
    files under ``root / BENCH_DIR``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        validate(self.spec)
        self.bench = self.root / BENCH_DIR

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise ManifestError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        config = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        applies = lambda m: name in m.get("workloads", [name])
        e2e = [m for m in self.spec["end_to_end"] if applies(m)]
        reported = {m["name"] for m in e2e}
        per_layer = [
            m for m in self.spec["per_layer"]
            if applies(m) and ("workloads" in m or m["moves"] in reported)
        ]
        traffic_file = self.bench / "traffic" / f"{w['traffic']}.json"
        if not traffic_file.is_file():
            raise ManifestError(f"{name}: {traffic_file} is missing")
        mix = read_json(traffic_file)
        for key in ("entry", "loop"):
            if not NAME.match(mix.get(key, "closed")):
                raise ManifestError(f"{name}: bad {key} {mix.get(key)!r}")
        cell = Cell(
            name=name, config=w["config"], traffic=w["traffic"], chips=w["chips"],
            config_file=self.root / config["file"],
            config_module=self.bench / "configs" / f"{w['config']}.py",
            traffic_file=traffic_file,
            entry_module=self.bench / "entries" / w["config"] / f"{mix['entry']}.py",
            loop_module=self.bench / "loops" / f"{mix.get('loop', 'closed')}.py",
            end_to_end=e2e, per_layer=per_layer,
        )
        for path in (cell.config_file, cell.config_module, cell.entry_module, cell.loop_module):
            if not path.is_file():
                raise ManifestError(f"{name}: {path} is missing")
        for m in e2e + per_layer:
            self.reader_path(m["name"])
        return cell

    def reader_path(self, metric: str) -> Path:
        for stem in (metric, metric.split(".")[0]):
            path = self.bench / "metrics" / f"{stem}.py"
            if path.is_file():
                return path
        raise ManifestError(f"no reader for metric {metric!r} under {self.bench / 'metrics'}")


def load_module(path: Path, name: str = None):
    """Import the file at ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name or f"pb_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())
