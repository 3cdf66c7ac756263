from . import cuda_kernels, mahalanobis, point_to_plane, quadratic, relative_pose, reprojection
from .mahalanobis import MahalanobisData
from .point_to_plane import PointToPlaneData
from .relative_pose import PoseGraphEdges
from .reprojection import CameraIntrinsics, ReprojectionData

__all__ = [
    "cuda_kernels",
    "mahalanobis",
    "point_to_plane",
    "quadratic",
    "relative_pose",
    "reprojection",
    "MahalanobisData",
    "PointToPlaneData",
    "PoseGraphEdges",
    "CameraIntrinsics",
    "ReprojectionData",
]
