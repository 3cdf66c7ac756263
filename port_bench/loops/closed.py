"""The closed loop: one request in flight, the next sent when it returns.

A loop is ``drive(serve, plan, seconds, first, traced) -> (start,
requests)``: it serves requests ``first``, ``first + 1``, ... of ``plan``
(``harness.traffic.send``) while ``seconds`` have not passed since
``start``, at least one, and returns when every request it sent has
returned. A new loop (an open one, with arrivals at a rate the mix
gives) is a new file beside this one that a mix names as its ``loop``.
"""

from __future__ import annotations

import time

from harness import traffic


def drive(serve, plan, seconds: float, first: int, traced: bool):
    start = time.perf_counter()
    close = start + seconds
    requests = [traffic.send(serve, plan, first, traced)]
    while time.perf_counter() < close:
        requests.append(traffic.send(serve, plan, first + len(requests), traced))
    return start, requests
