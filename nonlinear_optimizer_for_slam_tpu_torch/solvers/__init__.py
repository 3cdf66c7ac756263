from . import (
    autodiff,
    batched,
    block_tridiag,
    graph_init,
    linear,
    lm,
    manifolds,
    minimizers,
    multifrontal,
    pose_graph,
)
from .batched import (
    finalize_solve_batch,
    solve_mahalanobis_batch,
    solve_mahalanobis_batch_async,
    solve_point_to_plane_batch,
    solve_point_to_plane_batch_async,
    solve_reprojection_batch,
    solve_reprojection_batch_async,
)
from .lm import IterationRecord, Summary
from .minimizers import (
    MahalanobisDistanceMinimizer,
    MahalanobisDistanceMinimizer3DOF,
    PointToPlaneMinimizer,
    ReprojectionErrorMinimizer,
)
from .pose_graph import (
    ConstraintType,
    PoseGraphOptimizer,
    PoseGraphOptimizer2D,
    select_solver,
)

__all__ = [
    "autodiff",
    "batched",
    "block_tridiag",
    "graph_init",
    "linear",
    "lm",
    "manifolds",
    "minimizers",
    "multifrontal",
    "pose_graph",
    "finalize_solve_batch",
    "solve_mahalanobis_batch",
    "solve_mahalanobis_batch_async",
    "solve_point_to_plane_batch",
    "solve_point_to_plane_batch_async",
    "solve_reprojection_batch",
    "solve_reprojection_batch_async",
    "IterationRecord",
    "MahalanobisDistanceMinimizer",
    "MahalanobisDistanceMinimizer3DOF",
    "PointToPlaneMinimizer",
    "ReprojectionErrorMinimizer",
    "Summary",
    "ConstraintType",
    "PoseGraphOptimizer",
    "PoseGraphOptimizer2D",
    "select_solver",
]
