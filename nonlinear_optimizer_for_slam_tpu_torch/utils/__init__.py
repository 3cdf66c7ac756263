import importlib

from . import bimap, time_checker, tracing
from .bimap import UnorderedBimap
from .time_checker import TimeChecker, TimeCheckerManager, check_exec_time, device_time

# Modules that import the solvers or the pipelines, which import
# ``tracing`` from here: loaded at first use, so that importing this
# package from inside them starts no cycle.
_ON_FIRST_USE = ("anchor_np", "checkpoint", "evaluation", "testing")


def __getattr__(name):
    if name in _ON_FIRST_USE:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "anchor_np",
    "bimap",
    "checkpoint",
    "evaluation",
    "testing",
    "time_checker",
    "tracing",
    "TimeChecker",
    "TimeCheckerManager",
    "UnorderedBimap",
    "check_exec_time",
    "device_time",
]
