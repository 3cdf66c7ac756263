"""The check that a run measured the port alone: no module of JAX, of its
companions or of the JAX package may be loaded. Names are compared by
their top-level part, whole: ``nonlinear_optimizer_for_slam_tpu_torch``
is the port and passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = frozenset({"jax", "jaxlib", "flax", "nonlinear_optimizer_for_slam_tpu"})


def banned_modules(names: Iterable[str] = None) -> List[str]:
    """The banned top-level names among ``names`` (default: ``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & BANNED)
