"""Profiler arithmetic: a table of events (a name, on the device or on the
host, start and end in seconds) and what the metrics read from it.

- busy time: the union of the device operations' intervals (overlapping
  operations count once), and the idle share of the traced window;
- device operations by name, counted and timed, optionally only those
  that start inside a host span of a given name (the harness's
  ``record_function`` spans: ``pb.request``, ``pb.solve``...);
- idle gaps: each stretch of the traced window in which no device
  operation ran, put down to the innermost host event running at its
  middle, summed by that event's name.

Only :func:`events_from_profiler` touches the profiler, so the arithmetic
runs on a canned table in the tests.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

NAME_CHARS = 120  # of a name in the breakdown


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool
    start: float  # seconds
    end: float


def events_from_profiler(prof) -> List[Event]:
    """The events of a stopped ``torch.profiler.profile``: device
    operations (kernels, copies, sets) and host events, on the trace's
    clock."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.events():
        device = ev.device_type == DeviceType.CUDA
        if device and (getattr(ev, "is_user_annotation", False) or ev.name.startswith("pb.")):
            continue  # a host span's mirror on the device's timeline, not work
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        out.append(Event(ev.name, device, start, end))
    return out


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``intervals`` as disjoint intervals, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The events of one traced window of ``window_s`` seconds."""

    def __init__(self, events: Sequence[Event], window_s: float):
        self.window_s = float(window_s)
        self.device = sorted((e for e in events if e.device and e.end > e.start),
                             key=lambda e: e.start)
        self.host = sorted((e for e in events if not e.device), key=lambda e: e.start)
        self._busy = merge([(e.start, e.end) for e in self.device])
        self.busy_s = sum(e - s for s, e in self._busy)

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0.0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def ops(self, pattern: str = None, within: str = None) -> List[Event]:
        """Device operations whose name matches ``pattern`` (a regular
        expression) and, with ``within``, that start inside a host span of
        that name."""
        rx = re.compile(pattern) if pattern else None
        out = [e for e in self.device if rx is None or rx.search(e.name)]
        if within is not None:
            spans = [h for h in self.host if h.name == within]
            starts = [h.start for h in spans]

            def inside(t):
                i = bisect.bisect_right(starts, t) - 1
                return i >= 0 and t <= spans[i].end

            out = [e for e in out if inside(e.start)]
        return out

    def seconds(self, pattern: str = None, within: str = None) -> float:
        return sum(e.end - e.start for e in self.ops(pattern, within))

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time, by name:
        [[name, seconds], ...]."""
        total = {}
        for e in self.device:
            key = e.name[:NAME_CHARS]
            total[key] = total.get(key, 0.0) + (e.end - e.start)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time by what the host was doing: each gap between device
        operations (and before the first and after the last) put down to
        the innermost host event running at the gap's middle (the latest
        started that has not ended); the ``n`` names with the most idle
        time: [[name, seconds], ...]."""
        if not self.device:
            return []
        lo = min([self.device[0].start] + [h.start for h in self.host[:1]])
        hi = max(max(e.end for e in self.device), max((h.end for h in self.host), default=lo))
        gaps, t = [], lo
        for s, e in self._busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        total, open_, k = {}, [], 0
        for s, e in gaps:  # in time order: one sweep over the host events
            mid = 0.5 * (s + e)
            while k < len(self.host) and self.host[k].start <= mid:
                open_.append(self.host[k])
                k += 1
            while open_ and open_[-1].end < mid:  # ended: ended for every later gap too
                open_.pop()
            name = open_[-1].name[:NAME_CHARS] if open_ else "no host event"
            total[name] = total.get(name, 0.0) + (e - s)
        return [[k_, v] for k_, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
