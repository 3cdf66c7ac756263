"""PyTorch and CUDA port of ``nonlinear_optimizer_for_slam_tpu``.

The JAX package stays the reference; this package grows beside it slice by
slice, with the same solvers, LM policy, reference quirks and public names.
It imports ``torch`` and numpy, never ``jax`` and nothing of the JAX
package. Entry points take ``device=`` (default ``"cuda"``) and raise when
no GPU is present unless the caller asks for the CPU.

Ported so far: host-driven NDT, D2D and point-to-plane scan-to-map
registration (``register_ndt``, ``register_d2d_ndt``,
``register_point_to_plane``), the device-resident ``NdtRegistrar`` (6-DoF,
planar, point-to-plane, lockstep and vmap batches) and ``D2dRegistrar``,
the single-pose minimizers (6-DoF and planar 3-DoF NDT, reprojection/PnP,
point-to-plane), the batched serving solvers (``solve_*_batch``), the
autodiff oracle (``solvers.autodiff``), the streaming map builder
(``NdtMapAccumulator``) and loop closure (``LoopClosureDetector``). Their
factor evaluation runs in the hand-written CUDA kernels ``csrc/maha6.cu``,
``csrc/maha3.cu``, ``csrc/maha3c.cu``, ``csrc/reproj.cu`` and
``csrc/p2p.cu``. The SE(3) pose-graph optimizer (``PoseGraphOptimizer``:
dense, tridiag, banded, sparse multifrontal, CG and ``solver="auto"``), the
SE(2) ``PoseGraphOptimizer2D`` (dense, banded, sparse, CG, auto), the
spanning-tree and chordal initializers (``solvers.graph_init``, behind
``initialize()``) and g2o file IO for 3-D and 2-D graphs (``io.g2o``) run in
plain PyTorch ops, as the JAX package's run in XLA; so do the generic pose
problem (``solvers.problem``) and the small utilities (``utils``).
``parallel`` shards the minimizers, the registrar and the CG and sparse
pose-graph paths over a ``torch.distributed`` group (``mesh=``).
Bundle adjustment (``BundleAdjuster``: the camera-landmark Schur solve
in the grouped and flat layouts and over ``mesh=``), the BAL solver of the
Snavely model (``solvers.bal.solve_bal``, dense and iterative Schur, with
BAL file IO in ``io.bal`` and the scipy anchor in ``utils.anchor_np``) and
the pose-landmark optimizers (``PoseLandmarkOptimizer``,
``PoseLandmark2DOptimizer``: dense and sparse landmark-Schur solves and
marginal covariances, g2o landmark records) run in plain PyTorch ops too.
``native`` binds the repository's C++ host pipeline (``native/``: the NDT
map builder, the voxel filter and the matcher that writes the maha6
buffer), built with g++ at first use; ``HybridRegistrar`` matches with it
on the host and solves on the card. ``FixedLagSmoother`` is the online
sliding-window pose-graph smoother. The inertial stack (``ops.imu``'s
preintegration, ``InertialGraphOptimizer`` for GPS-INS smoothing and
``FixedLagInertialSmoother`` for online inertial odometry) and the Sim(3)
essential graph of monocular SLAM (``Sim3GraphOptimizer``: dense and
sparse, with its float64 polish on the device) run in plain PyTorch ops.
With them the port covers the JAX package module for module. A
``bfloat16`` storage of the packed maha rows
(``cuda_kernels.pack_maha6(..., buffer_dtype=torch.bfloat16)``) is read by
its own instantiations of the maha6 and maha3 kernels, with float32
arithmetic. ``examples`` holds the user-facing
examples, each run as ``python -m
nonlinear_optimizer_for_slam_tpu_torch.examples.<name>``.
"""

from . import core, interop, io, native, ops, parallel, pipelines, solvers, utils
from .core import (
    CauchyLoss,
    DCSLoss,
    ExponentialLoss,
    GemanMcClureLoss,
    HuberLoss,
    LinearSolverType,
    MinimizerType,
    Options,
    Pose,
    Pose2,
    TrivialLoss,
    TukeyLoss,
)
from .pipelines import (
    D2dRegistrar,
    FusedRegistrationResult,
    HybridRegistrar,
    LoopClosure,
    LoopClosureDetector,
    NdtMap,
    NdtMapAccumulator,
    NdtRegistrar,
    RegistrationResult,
    build_ndt_map,
    edge_information_to_world,
    filter_points,
    register_d2d_ndt,
    register_ndt,
    register_ndt_fused,
    register_point_to_plane,
)
from .solvers import (
    BAData,
    BundleAdjuster,
    ConstraintType,
    FixedLagInertialSmoother,
    FixedLagSmoother,
    InertialGraphOptimizer,
    MahalanobisDistanceMinimizer,
    MahalanobisDistanceMinimizer3DOF,
    PointToPlaneMinimizer,
    PoseGraphOptimizer,
    PoseGraphOptimizer2D,
    PoseLandmark2DOptimizer,
    PoseLandmarkOptimizer,
    ReprojectionErrorMinimizer,
    Sim3GraphOptimizer,
    Summary,
    finalize_solve_batch,
    solve_mahalanobis_batch,
    solve_mahalanobis_batch_async,
    solve_point_to_plane_batch,
    solve_point_to_plane_batch_async,
    solve_reprojection_batch,
    solve_reprojection_batch_async,
    sqrt_info_from_information,
)

__version__ = "0.1.0"
