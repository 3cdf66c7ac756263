"""Scope timing + process-lifetime aggregation (PyTorch port of the JAX
package's ``utils/time_checker.py``).

The reference's TimeChecker/TimeCheckerManager (time_checker.{h,cc}): a
context-manager scope timer feeding a singleton aggregator that can print a
min/max/avg/std/total "Time Analysis" table — by default at interpreter
exit, like the reference's destructor dump (time_checker.cc:44-76).

Every scope also runs under ``tracing.span(label)``: while a
``torch.profiler`` runs, it is a span on the profiler's timeline beside the
kernels; with none running it costs one check.

Device-aware additions the reference has no counterpart for:
- ``device_time`` waits for the CUDA devices of the tensors the body hands
  it before it stops the clock, so asynchronous kernel launches don't make
  device work look free;
- ``trace`` records a ``torch.profiler`` trace of its body.
"""

from __future__ import annotations

import atexit
import contextlib
import inspect
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from . import tracing


class TimeCheckerManager:
    """Singleton label -> samples aggregator (reference: time_checker.cc:16-42)."""

    _instance: Optional["TimeCheckerManager"] = None

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}
        self.min_time_threshold_ms = 0.0
        self.print_at_exit = False
        self._atexit_registered = False

    @classmethod
    def instance(cls) -> "TimeCheckerManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register_time(self, label: str, milliseconds: float):
        self.samples.setdefault(label, []).append(milliseconds)

    def set_min_time_threshold(self, milliseconds: float):
        self.min_time_threshold_ms = milliseconds

    def enable_exit_report(self):
        self.print_at_exit = True
        if not self._atexit_registered:
            atexit.register(self._exit_report)
            self._atexit_registered = True

    def _exit_report(self):
        if self.print_at_exit and self.samples:
            self.print_report()

    def reset(self):
        self.samples.clear()

    def report_lines(self) -> List[str]:
        lines = [
            "Time Analysis",
            f"{'label':<48} {'calls':>6} {'min[ms]':>10} {'max[ms]':>10}"
            f" {'avg[ms]':>10} {'std[ms]':>10} {'total[ms]':>12}",
        ]
        for label in sorted(self.samples):
            xs = self.samples[label]
            total = sum(xs)
            if total < self.min_time_threshold_ms:
                continue
            avg = total / len(xs)
            std = math.sqrt(sum((x - avg) ** 2 for x in xs) / len(xs))
            lines.append(
                f"{label:<48} {len(xs):>6} {min(xs):>10.3f} {max(xs):>10.3f}"
                f" {avg:>10.3f} {std:>10.3f} {total:>12.3f}"
            )
        return lines

    def print_report(self, file=sys.stderr):
        print("\n".join(self.report_lines()), file=file)

    def save_file(self, path: str):
        """Write the report to a file — the reference declares SaveFile
        but leaves it a stub (time_checker.cc:73-75); implemented here."""
        with open(path, "w") as f:
            f.write("\n".join(self.report_lines()) + "\n")


class TimeChecker:
    """Context-manager scope timer (reference: time_checker.h:15-23)."""

    def __init__(self, label: Optional[str] = None):
        if label is None:
            frame = inspect.stack()[1]
            label = f"{frame.filename.rsplit('/', 1)[-1]}/{frame.function}"
        self.label = label
        self._start = 0.0
        self._span = None

    def __enter__(self):
        self._span = tracing.span(self.label)
        self._span.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._start) * 1e3
        self._span.__exit__(*exc)
        TimeCheckerManager.instance().register_time(self.label, ms)
        return False


@contextlib.contextmanager
def check_exec_time(label: Optional[str] = None):
    """Function-style CHECK_EXEC_TIME_FROM_HERE (time_checker.h:12-13)."""
    if label is None:
        frame = inspect.stack()[2]
        label = f"{frame.filename.rsplit('/', 1)[-1]}/{frame.function}"
    with TimeChecker(label):
        yield


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


@contextlib.contextmanager
def device_time(label: str, result_holder: Optional[dict] = None):
    """Wall-time a device computation with a completion fence. The body
    should put its output tensors (a tensor or a tuple, list or dict of
    them) in ``result_holder['out']``; before the clock stops, each CUDA
    device that holds one of them is synchronised. Tensors on the CPU are
    done when the body returns them."""
    with tracing.span(label):
        start = time.perf_counter()
        holder = result_holder if result_holder is not None else {}
        yield holder
        out = holder.get("out")
        if out is not None:
            for device in {t.device for t in _tensors(out) if t.is_cuda}:
                torch.cuda.synchronize(device)
        ms = (time.perf_counter() - start) * 1e3
    TimeCheckerManager.instance().register_time(label, ms)


@contextlib.contextmanager
def trace(label: str, log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the body, under ``tracing.span(label)``,
    the host's activity and, with a GPU, the device's; at exit the trace is
    written to ``log_dir`` (default ``torch-trace`` under the temporary
    directory, ``TMPDIR``) as a Chrome trace (``*.pt.trace.json``, for
    Perfetto or TensorBoard). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    handler = tensorboard_trace_handler(log_dir)
    with profile(activities=activities, on_trace_ready=handler) as prof:
        with tracing.span(label):
            yield prof
