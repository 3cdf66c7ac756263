from . import linear, lm, manifolds, minimizers
from .lm import IterationRecord, Summary
from .minimizers import (
    MahalanobisDistanceMinimizer,
    MahalanobisDistanceMinimizer3DOF,
    PointToPlaneMinimizer,
    ReprojectionErrorMinimizer,
)

__all__ = [
    "linear",
    "lm",
    "manifolds",
    "minimizers",
    "IterationRecord",
    "MahalanobisDistanceMinimizer",
    "MahalanobisDistanceMinimizer3DOF",
    "PointToPlaneMinimizer",
    "ReprojectionErrorMinimizer",
    "Summary",
]
