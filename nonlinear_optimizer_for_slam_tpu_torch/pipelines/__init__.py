from . import fused_d2d, fused_registration, loop_closure, matching, ndt, registration
from .fused_d2d import D2dRegistrar
from .fused_registration import (
    FusedRegistrationResult,
    HybridRegistrar,
    NdtRegistrar,
    RegistrarMap,
    register_ndt_fused,
)
from .loop_closure import LoopClosure, LoopClosureDetector, edge_information_to_world
from .ndt import (
    NdtMap,
    NdtMapAccumulator,
    build_ndt_map,
    compute_voxel_keys,
    filter_points,
    voxel_covariances,
    voxel_normals,
)
from .registration import (
    RegistrationResult,
    register_d2d_ndt,
    register_ndt,
    register_point_to_plane,
)

__all__ = [
    "fused_d2d",
    "fused_registration",
    "loop_closure",
    "matching",
    "ndt",
    "registration",
    "D2dRegistrar",
    "FusedRegistrationResult",
    "HybridRegistrar",
    "LoopClosure",
    "LoopClosureDetector",
    "NdtMap",
    "NdtMapAccumulator",
    "NdtRegistrar",
    "RegistrarMap",
    "RegistrationResult",
    "build_ndt_map",
    "compute_voxel_keys",
    "edge_information_to_world",
    "filter_points",
    "register_d2d_ndt",
    "register_ndt",
    "register_ndt_fused",
    "register_point_to_plane",
    "voxel_covariances",
    "voxel_normals",
]
