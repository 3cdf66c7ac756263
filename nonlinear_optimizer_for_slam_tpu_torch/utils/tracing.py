"""Spans and counters of the port's host paths.

``span(name)`` marks a stretch of host work. With no profiler running it is
a shared no-op context, and costs one check of
``torch.autograd._profiler_enabled()``. While any ``torch.profiler``
runs, it is ``torch.profiler.record_function(name)``: the profiler then
records it on the clock of the device's kernels, so each idle gap of the
device falls under the span the host was in. The port's spans:

- ``nls.register``: one registration call (``register_ndt``,
  ``register_d2d_ndt``, ``register_point_to_plane``, the registrars'
  ``register`` and ``register_batch``), its uploads included;
- ``nls.match``: one matching of the scan at a pose (the host loop's, the
  registrar machine's first match and each rematch);
- ``nls.solve``: one minimizer ``solve``: cast, pad and pack, the pose
  upload, the LM loop and the read-back;
- ``nls.lm.iter``: one iteration of ``solvers/lm.solve_batch``, its
  ``all done`` read included;
- ``nls.read``: the host blocked on a copy from the device
  (:func:`host_read`);
- ``nls.batch.upload``: the registrar's padding of the scans and their
  upload; ``nls.block``: one block of K machine steps, enqueued (a
  capture or a replay included); ``nls.graph.replay``: inside it, the
  replay of the block's CUDA graph; ``nls.batch.finalize``: the copies of
  a run's results to the host and their unpacking.

The counters count whether a profiler runs or not: ``host_reads``, one a
:func:`host_read`; ``graph.captures`` and ``graph.replays``, one a
capture and one a replay of a registrar block's CUDA graph;
:func:`counters` also reports the kernel launches of
``ops.cuda_kernels.LAUNCHES`` as ``launch.<kernel>``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict

import torch

_OFF = contextlib.nullcontext()

COUNTERS: Dict[str, int] = {"host_reads": 0}


def span(name: str):
    """A context that records ``name`` in a running ``torch.profiler``;
    with none running, a no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def traced(name: str):
    """A decorator: each call of the function runs under ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The counters since the last reset, with the kernel launches as
    ``launch.<kernel>``."""
    from ..ops.cuda_kernels import LAUNCHES

    return {**COUNTERS, **{f"launch.{k}": v for k, v in LAUNCHES.items()}}


def reset_counters() -> None:
    """Zero the counters and the kernel launches."""
    from ..ops.cuda_kernels import reset_launches

    for name in COUNTERS:
        COUNTERS[name] = 0
    reset_launches()


def host_read(tensor: torch.Tensor, convert: Callable = torch.Tensor.cpu):
    """``convert(tensor)``, a read that blocks the host until the device
    has made ``tensor`` (``Tensor.cpu`` by default; ``bool``,
    ``Tensor.tolist``...), under the span ``nls.read`` and counted as one
    ``host_reads``."""
    count("host_reads")
    with span("nls.read"):
        return convert(tensor)
