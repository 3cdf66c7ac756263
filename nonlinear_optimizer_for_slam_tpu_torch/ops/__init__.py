from . import (
    cuda_kernels,
    imu,
    mahalanobis,
    point_to_plane,
    quadratic,
    relative_pose,
    reprojection,
)
from .imu import ImuParams, ImuPreintegrator, PreintegratedImuFactor
from .mahalanobis import MahalanobisData
from .point_to_plane import PointToPlaneData
from .relative_pose import PoseGraphEdges
from .reprojection import CameraIntrinsics, ReprojectionData

__all__ = [
    "cuda_kernels",
    "imu",
    "mahalanobis",
    "point_to_plane",
    "quadratic",
    "relative_pose",
    "reprojection",
    "MahalanobisData",
    "PointToPlaneData",
    "PoseGraphEdges",
    "CameraIntrinsics",
    "ImuParams",
    "ImuPreintegrator",
    "PreintegratedImuFactor",
    "ReprojectionData",
]
