from . import anchor_np, bimap, checkpoint, evaluation, testing, time_checker
from .bimap import UnorderedBimap
from .time_checker import TimeChecker, TimeCheckerManager, check_exec_time, device_time

__all__ = [
    "anchor_np",
    "bimap",
    "checkpoint",
    "evaluation",
    "testing",
    "time_checker",
    "TimeChecker",
    "TimeCheckerManager",
    "UnorderedBimap",
    "check_exec_time",
    "device_time",
]
