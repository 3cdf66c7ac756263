"""The result of a run: the last line of standard output (one JSON object)
and, as the last lines of standard error, each number the check compared
beside its limit."""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, List, Optional


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: within the
    limit when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def result(
    correct: bool,
    attempted: int,
    failed: int,
    metrics: Dict[str, tuple],  # name -> (value, unit)
    device: dict,
    checks: List[Check],
    breakdown: Optional[dict] = None,
) -> dict:
    out = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def emit(out: dict) -> None:
    """The checks on standard error, then the result as the last line of
    standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
