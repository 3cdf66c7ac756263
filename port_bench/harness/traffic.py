"""The one traffic generator, and what a loop hands back.

A mix is a JSON file of parameters:

- ``entry``: the entry point that serves a request, the file
  ``entries/<config>/<entry>.py`` of the cell's configuration;
- ``loop``: the loop that drives the entry, the file ``loops/<loop>.py``
  (``closed`` where the mix names none); a loop reads its own parameters
  from the mix (``plan.mix``);
- ``pool``: how many items set-up makes, each from one draw of ``draws``;
- ``draws``: per item, named values, each ``["normal", mean, sd]``,
  ``["uniform", low, high]`` or ``["integers", low, high]``, drawn in the
  file's order from ``pool_seed`` where the mix gives one, else from
  ``--seed``;
- ``batch``: items per request. The pool, in blocks of ``batch``
  consecutive items, is served in an order drawn from ``--seed``: the
  blocks shuffled and the items inside each block shuffled, then cycled.
  With a ``pool_seed`` every seed serves the same items in the same
  batches, in another order: the same work, so that the spread of the
  runs is the system's and not the seed's;
- ``warm_up``: how many requests set-up serves first (1 where the mix
  names none): enough to meet every shape the window will;
- ``check``: how many answers of the window the check compares with the
  reference, drawn from the seed (for ``batch`` > 1, one per position in
  the batch and no fewer);
- ``trace_seconds``: how long the traced segment of a ``--trace 1`` run
  lasts; it runs before the window.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable, List, Optional

import numpy as np

DRAWS = ("normal", "uniform", "integers")


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``stream`` for ``seed``: any whole number, as
    large as it comes."""
    return np.random.default_rng([int(seed) % 2**64, stream])


@dataclasses.dataclass
class Plan:
    mix: dict  # the mix's parameters, as the file has them
    entry: str
    loop: str
    batch: int
    items: List[dict]  # the pool, one dict of drawn values an item
    order: List[int]  # the pool's indices in the order they are served
    warm_up: int
    check: int
    trace_seconds: float

    def request(self, k: int) -> List[int]:
        """The pool indices of request ``k``."""
        n = len(self.order)
        return [self.order[(k * self.batch + j) % n] for j in range(self.batch)]


def plan(mix: dict, seed: int) -> Plan:
    """The pool and the requests of ``mix`` for ``seed``: the same seed
    gives the same pool in the same order."""
    pool, batch = int(mix["pool"]), int(mix["batch"])
    if pool % batch:
        raise ValueError(f"pool {pool} is not a multiple of batch {batch}")
    gen = rng(mix["pool_seed"] if "pool_seed" in mix else seed)
    items = []
    for _ in range(pool):
        item = {}
        for key, (kind, a, b) in mix["draws"].items():
            if kind not in DRAWS:
                raise ValueError(f"draw {key}: unknown kind {kind!r}")
            if kind == "normal":
                item[key] = float(gen.normal(a, b))
            elif kind == "uniform":
                item[key] = float(gen.uniform(a, b))
            else:
                item[key] = int(gen.integers(a, b))
        items.append(item)
    shuffle = rng(seed, 2)
    blocks = [list(range(b, b + batch)) for b in range(0, pool, batch)]
    shuffle.shuffle(blocks)
    for block in blocks:
        shuffle.shuffle(block)
    return Plan(
        mix=mix, entry=mix["entry"], loop=mix.get("loop", "closed"), batch=batch, items=items,
        order=[i for block in blocks for i in block], warm_up=int(mix.get("warm_up", 1)),
        check=int(mix["check"]), trace_seconds=float(mix.get("trace_seconds", 3.0)),
    )


@dataclasses.dataclass
class Request:
    index: int
    items: List[int]
    start: float  # when the request was due: its latency runs from here
    end: float
    answers: Optional[list]  # one answer an item; None when the call raised
    counters: dict
    traced: bool
    error: str = ""  # the traceback where the call raised


def send(serve: Callable, plan: Plan, k: int, traced: bool, due: float = None) -> Request:
    """Serve request ``k`` of ``plan`` through ``serve(items) -> (answers,
    counters)``, due at ``due`` (now where it is None). A request that
    raises is failed, not fatal."""
    items = plan.request(k)
    t0 = time.perf_counter() if due is None else due
    try:
        answers, counters = serve(items)
        error = ""
    except Exception:
        answers, counters, error = None, {}, traceback.format_exc()
    return Request(k, items, t0, time.perf_counter(), answers, counters, traced, error)


@dataclasses.dataclass
class Window:
    """The requests of a run: those of the traced segment (``traced``), then
    those of the measured window, which runs with the profiler off. The
    window opens when its loop starts and closes when its last request
    returns."""

    start: float
    end: float
    requests: List[Request]
    profile: object = None  # the stopped profiler of the traced segment
    trace_s: float = 0.0  # length of the traced segment

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def _served(self, traced: bool = False):
        return [r for r in self.requests if r.answers is not None and r.traced == traced]

    def latencies(self) -> List[float]:
        """Seconds from send to answer, one a served item of the window."""
        return [r.end - r.start for r in self._served() for _ in r.items]

    def items(self) -> int:
        """Items served in the window."""
        return sum(len(r.items) for r in self._served())

    def attempted(self) -> int:
        """Items sent, in the traced segment and in the window."""
        return sum(len(r.items) for r in self.requests)

    def failed(self) -> int:
        return sum(len(r.items) for r in self.requests if r.answers is None)

    def counters(self, traced: bool = False) -> dict:
        """Counters summed over the window's served requests, or with
        ``traced`` over the traced segment's."""
        out = {"requests": 0, "items": 0}
        for r in self._served(traced):
            out["requests"] += 1
            out["items"] += len(r.items)
            for k, v in r.counters.items():
                out[k] = out.get(k, 0) + v
        return out
