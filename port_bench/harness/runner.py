"""One run of one cell: set-up and warm-up, the window, the traced
segment, the check against the reference, and the metrics.

The configuration module (``configs/<config>.py``) provides
``System(cfg, plan, device)``, the set-up its entry points share, with

- ``release()``: drop the program's state;
- ``check(window, rng, limits) -> [report.Check]``: the answers of the
  window, or a sample of them drawn from ``rng``, against the reference.

The entry point (``entries/<config>/<entry>.py``, the mix's ``entry``)
provides ``make(system) -> serve``, where ``serve(items) -> (answers,
counters)`` serves one request of pool indices and ends when its answers
are on the host; it may provide its own ``check(system, window, rng,
limits)``, which then replaces the system's. Set-up serves the mix's
``warm_up`` requests. The loop (``loops/<loop>.py``, the mix's ``loop``)
drives ``serve`` through the traced segment and the window.

Each metric is read by its own reader (``metrics/<name>.py``:
``read(ctx) -> float or None``) from a :class:`Context`.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Optional

from . import report, traffic
from .manifest import Cell, Manifest, load_module, read_json
from .trace import Trace, events_from_profiler


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: Cell
    cfg: dict
    mix: dict
    setup_s: float
    window: traffic.Window
    trace: Optional[Trace]

    def counters(self, traced: bool = False) -> dict:
        return self.window.counters(traced)


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def drive(loop, serve, plan: traffic.Plan, seconds: float, profiler=None) -> traffic.Window:
    """The window of ``seconds`` that ``loop`` drives; with ``profiler`` (a
    factory of a started profiler with a ``stop``), first a traced segment
    of ``plan.trace_seconds``, whose profiler is stopped before the window
    opens."""
    requests, profile, trace_s = [], None, 0.0
    if profiler is not None:
        profile = profiler()
        t0, requests = loop.drive(serve, plan, plan.trace_seconds, 0, True)
        profile.stop()
        trace_s = max(r.end for r in requests) - t0
    start, timed = loop.drive(serve, plan, seconds, len(requests), False)
    return traffic.Window(start, max(r.end for r in timed), requests + timed, profile, trace_s)


def check(entry, system, window: traffic.Window, rng, limits: dict) -> list:
    """The entry point's own check where it has one, else the system's."""
    if hasattr(entry, "check"):
        return entry.check(system, window, rng, limits)
    return system.check(window, rng, limits)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda") -> dict:
    """Run ``workload`` once and return its result (see ``report.result``).
    ``t_process`` is the process's start on ``time.perf_counter``'s clock;
    ``device`` is "cuda", or "cpu" in the harness's own tests."""
    import torch

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    cfg, mix = read_json(cell.config_file), read_json(cell.traffic_file)
    plan = traffic.plan(mix, seed)
    module = load_module(cell.config_module, f"pb_config_{cell.config}")
    entry = load_module(cell.entry_module, f"pb_entry_{cell.config}_{plan.entry}")
    loop = load_module(cell.loop_module, f"pb_loop_{plan.loop}")
    system = module.System(cfg, plan, device)
    serve = entry.make(system)
    for k in range(plan.warm_up):
        serve(plan.request(k))
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log(f"{workload}: set-up {setup_s:.3f} s, window {seconds} s, trace {int(trace)}")

    window = drive(loop, serve, plan, seconds, _profiler if trace else None)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = None
    if trace:
        found = Trace(events_from_profiler(window.profile), window.trace_s)
        window.profile = None
    serve = None
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    log(f"{workload}: {len(window.requests)} requests, {window.items()} items in {window.seconds:.3f} s")
    errors = [r.error for r in window.requests if r.error]
    if errors:
        log(f"{workload}: {len(errors)} requests failed; the first:\n{errors[0]}")

    checks = check(entry, system, window, traffic.rng(seed, 1), cfg["limits"])
    failed = window.failed()
    correct = failed == 0 and window.items() > 0 and all(c.ok for c in checks)

    ctx = Context(cell, cfg, mix, setup_s, window, found)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        reader = load_module(manifest.reader_path(m["name"]))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = (float(value), m["unit"])

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if found is not None:
        dev.update(busy_s=found.busy_s, window_s=found.window_s)
        breakdown = {"device_ops": found.device_ops(), "idle_gaps": found.idle_gaps()}
    return report.result(correct, window.attempted(), failed, metrics, dev, checks, breakdown)
