"""PyTorch and CUDA port of ``nonlinear_optimizer_for_slam_tpu``.

The JAX package stays the reference; this package grows beside it slice by
slice, with the same solvers, LM policy, reference quirks and public names.
It imports ``torch`` and numpy, never ``jax`` and nothing of the JAX
package. Entry points take ``device=`` (default ``"cuda"``) and raise when
no GPU is present unless the caller asks for the CPU.

Ported so far: host-driven NDT and point-to-plane scan-to-map registration
(``register_ndt``, ``register_point_to_plane``), the device-resident
``NdtRegistrar`` (6-DoF, planar, point-to-plane, lockstep batches), and the
single-pose minimizers (6-DoF and planar 3-DoF NDT, reprojection/PnP,
point-to-plane), whose factor evaluation runs in the hand-written CUDA
kernels ``csrc/maha6.cu``, ``csrc/maha3.cu``, ``csrc/maha3c.cu``,
``csrc/reproj.cu`` and ``csrc/p2p.cu``.
"""

from . import core, interop, ops, pipelines, solvers, utils
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
    TrivialLoss,
    TukeyLoss,
)
from .pipelines import (
    FusedRegistrationResult,
    NdtMap,
    NdtRegistrar,
    RegistrationResult,
    build_ndt_map,
    filter_points,
    register_ndt,
    register_ndt_fused,
    register_point_to_plane,
)
from .solvers import (
    MahalanobisDistanceMinimizer,
    MahalanobisDistanceMinimizer3DOF,
    PointToPlaneMinimizer,
    ReprojectionErrorMinimizer,
    Summary,
)

__version__ = "0.1.0"
