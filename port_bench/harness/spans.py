"""Span arithmetic over a traced window's host events (``Trace.host``): the
program's own spans (``nls.register``, ``nls.lm.iter``, ``nls.read``...,
listed in the port's ``utils/tracing.py``) counted and timed.

- :func:`named`: the spans of a name, optionally only those that start
  inside a span of another name (``pb.request``: the traced requests);
- :func:`count`, :func:`seconds`: how many, and their summed duration;
- :func:`self_seconds`: their summed duration less the part covered by
  spans of the named children (the time a span spends in its own code);
- device operations starting inside the spans of a name are
  ``Trace.ops(within=name)``.

A program without such spans gives none, a count of 0 and 0 seconds:
the readers then report nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

from .trace import Event, Trace, merge


def named(trace: Trace, name: str, within: Optional[str] = None) -> List[Event]:
    """The host spans called ``name``, in order of start; with ``within``,
    only those that start inside a span of that name."""
    out = [h for h in trace.host if h.name == name]
    if within is None:
        return out
    outer = [h for h in trace.host if h.name == within]
    starts = [h.start for h in outer]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= outer[i].end

    return [h for h in out if inside(h.start)]


def count(trace: Trace, name: str, within: Optional[str] = None) -> int:
    return len(named(trace, name, within))


def seconds(trace: Trace, name: str, within: Optional[str] = None) -> float:
    return sum(h.end - h.start for h in named(trace, name, within))


def self_seconds(trace: Trace, name: str, children: Sequence[str],
                 within: Optional[str] = None) -> float:
    """The summed duration of the spans called ``name`` less, in each, the
    union of the spans called one of ``children`` clipped to it."""
    kids = [(h.start, h.end) for h in trace.host if h.name in children]
    kids = merge(kids)
    starts = [s for s, _ in kids]
    total = 0.0
    for span in named(trace, name, within):
        covered = 0.0
        i = max(bisect.bisect_right(starts, span.start) - 1, 0)
        while i < len(kids) and kids[i][0] < span.end:
            covered += max(0.0, min(kids[i][1], span.end) - max(kids[i][0], span.start))
            i += 1
        total += (span.end - span.start) - covered
    return total
