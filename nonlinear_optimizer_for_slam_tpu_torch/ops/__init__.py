from . import cuda_kernels, mahalanobis, point_to_plane, quadratic, reprojection
from .mahalanobis import MahalanobisData
from .point_to_plane import PointToPlaneData
from .reprojection import CameraIntrinsics, ReprojectionData

__all__ = [
    "cuda_kernels",
    "mahalanobis",
    "point_to_plane",
    "quadratic",
    "reprojection",
    "MahalanobisData",
    "PointToPlaneData",
    "CameraIntrinsics",
    "ReprojectionData",
]
