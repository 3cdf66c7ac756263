from . import (
    autodiff,
    batched,
    block_tridiag,
    fixed_lag,
    graph_init,
    linear,
    lm,
    manifolds,
    minimizers,
    multifrontal,
    pose_graph,
    problem,
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
from .fixed_lag import FixedLagSmoother
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
from .problem import GenericOptions, PoseOptimizer, Problem

__all__ = [
    "autodiff",
    "batched",
    "block_tridiag",
    "fixed_lag",
    "graph_init",
    "linear",
    "lm",
    "manifolds",
    "minimizers",
    "multifrontal",
    "pose_graph",
    "problem",
    "finalize_solve_batch",
    "solve_mahalanobis_batch",
    "solve_mahalanobis_batch_async",
    "solve_point_to_plane_batch",
    "solve_point_to_plane_batch_async",
    "solve_reprojection_batch",
    "solve_reprojection_batch_async",
    "FixedLagSmoother",
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
    "GenericOptions",
    "PoseOptimizer",
    "Problem",
]
