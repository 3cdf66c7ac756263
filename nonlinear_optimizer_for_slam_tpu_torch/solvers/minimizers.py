"""User-facing minimizer classes (PyTorch port of the single-pose solvers
of the JAX package's ``solvers/minimizers.py``).

``MahalanobisDistanceMinimizer`` and ``MahalanobisDistanceMinimizer3DOF``
mirror the reference's ``MahalanobisDistanceMinimizer*::Solve`` (6-DoF and
planar 3-DoF), ``ReprojectionErrorMinimizer`` its
``ReprojectionErrorMinimizer*::Solve``; ``PointToPlaneMinimizer`` solves
the point-to-plane objective. Each class takes ``backend=``:

- ``"torch"``: plain PyTorch evaluation (the ``eval_quadratic`` functions
  of ``ops/mahalanobis``, ``ops/reprojection`` and ``ops/point_to_plane``,
  the counterpart of the JAX ``"jnp"`` backend), on any device and dtype;
- ``"cuda"``: the hand-written kernel, maha6, maha3c, reproj or p2p
  (``ops/cuda_kernels``, the counterpart of the JAX ``"pallas"``
  backend), float32 on a CUDA device.

On a CUDA device the default backend is ``"cuda"``, on the CPU ``"torch"``.
Correspondence counts are padded to ``pad_multiple`` with masked rows, as in
the JAX package, so every backend sees the same factor set.

``mesh=`` (a ``parallel.FactorMesh``) shards a solve over the ranks of a
``torch.distributed`` group: every rank calls ``solve`` with the full data,
the rows are padded to ``pad_multiple`` times the world size, each rank
evaluates its own block of rows (through its objective's kernel on the
card) and the (H, g, cost) partials are summed across ranks before the
priors are added, so the priors count once and the LM loop is the same on
every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.losses import LossFunction
from ..core.options import Options
from ..core.pose import Pose, np_quat_to_rotmat, np_rotmat_to_quat
from ..ops import cuda_kernels, mahalanobis, point_to_plane, reprojection
from ..ops.reprojection import CameraIntrinsics
from ..parallel import FactorMesh, reducer
from ..parallel.sharded import shard_rows
from ..utils import tracing
from . import lm
from .manifolds import SE2Params, SE3Params, se2_retract, se3_retract

Tensor = torch.Tensor

BACKENDS = ("torch", "cuda")


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _pose_from_params(params: SE3Params) -> Pose:
    """Device SE3Params -> host Pose: one copy to the host, then the
    quaternion is normalised in float64 numpy."""
    tq = tracing.host_read(torch.cat([params.translation, params.quaternion])).numpy()
    t = np.asarray(tq[:3], np.float64)
    q = np.asarray(tq[3:], np.float64)
    q = q / np.linalg.norm(q)
    return Pose(np_quat_to_rotmat(q), t)


class SE3Priors(NamedTuple):
    """Pose prior folded into the damped-GN system as extra quadratic
    terms: weight * ||t - t_prior||^2 and weight * ||log(q_prior^-1 q)||^2
    (the reference's declared-but-never-wired prior fields,
    mahalanobis_distance_minimizer.h:38-39). Weights of 0 disable a term."""

    translation: Tensor  # (3,)
    quaternion: Tensor  # (4,) wxyz
    translation_weight: Tensor  # scalar
    rotation_weight: Tensor  # scalar


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """``backend`` checked against ``device``: "cuda" on a CUDA device by
    default, "torch" on the CPU; "cuda" needs a CUDA device."""
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend 'cuda' runs the CUDA kernel and needs a CUDA device, "
            f"not {device}; use backend='torch'"
        )
    return backend


def intrinsics_tensors(intrinsics: CameraIntrinsics, dtype, device) -> CameraIntrinsics:
    """The intrinsics as scalar tensors of a solve: ``inv_fx`` is cast as
    given (the reciprocal in the caller's precision), not recomputed in the
    solve's dtype."""
    return CameraIntrinsics(
        *(torch.as_tensor(v, dtype=dtype, device=device) for v in intrinsics[:6]),
        intrinsics.width,
        intrinsics.height,
    )


class _MinimizerBase:
    """Shared plumbing: loss, backend, device, dtype, padding."""

    def __init__(
        self,
        backend: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        pad_multiple: int = 1024,
        device="cuda",
        mesh: Optional[FactorMesh] = None,
    ):
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.dtype = dtype
        self.pad_multiple = pad_multiple
        self.mesh = mesh
        self.loss_function: Optional[LossFunction] = None
        self.priors: Optional[SE3Priors] = None

    def set_loss_function(self, loss: Optional[LossFunction]):
        """Reference: MahalanobisDistanceMinimizer::SetLossFunction
        (mahalanobis_distance_minimizer.cc:15-18)."""
        self.loss_function = loss
        return self

    def set_prior_constraints(
        self,
        translation=None,
        rotation=None,
        translation_weight: float = 1.0,
        rotation_weight: float = 1.0,
    ):
        """Attach translation and/or rotation priors (see
        :class:`SE3Priors`). ``rotation`` is a Pose, a (3, 3) rotation
        matrix, or a (4,) wxyz quaternion. Pass both as None to clear."""
        if translation is None and rotation is None:
            self.priors = None
            return self
        t = np.zeros(3) if translation is None else np.asarray(translation, float)
        wt = 0.0 if translation is None else float(translation_weight)
        if rotation is None:
            q, wr = np.array([1.0, 0.0, 0.0, 0.0]), 0.0
        else:
            if isinstance(rotation, Pose):
                q = rotation.quaternion()
            else:
                rotation = np.asarray(rotation, float)
                q = (
                    np_rotmat_to_quat(rotation)
                    if rotation.shape == (3, 3)
                    else rotation / np.linalg.norm(rotation)
                )
            wr = float(rotation_weight)
        as_t = self._as_tensor
        self.priors = SE3Priors(as_t(t), as_t(q), as_t(wt), as_t(wr))
        return self

    def _pad(self, n: int) -> int:
        m = self.pad_multiple
        if self.mesh is not None:
            m *= self.mesh.devices.size
        return _round_up(max(n, 1), m)

    def _prepared(self, data):
        """``data`` cast and padded as every solve sees it, then this rank's
        block of rows under a mesh; and the reducer of the partials (None
        without a mesh)."""
        data = data.astype(self.dtype).pad_to(self._pad(data.num_factors))
        if self.mesh is None:
            return data, None
        return shard_rows(self.mesh, data), reducer(self.mesh)

    def _as_tensor(self, value) -> Tensor:
        return torch.as_tensor(value, dtype=self.dtype, device=self.device)


class MahalanobisDistanceMinimizer(_MinimizerBase):
    """6-DoF NDT scan-to-map alignment
    (reference: mahalanobis_distance_minimizer_analytic{,_simd}.cc)."""

    @tracing.traced("nls.solve")
    def solve(
        self,
        options: Options,
        data: mahalanobis.MahalanobisData,
        pose: Pose,
    ) -> Tuple[Pose, lm.Summary]:
        as_t = self._as_tensor
        t0 = as_t(pose.translation)
        q0 = as_t(pose.quaternion())
        data, reduce = self._prepared(data)
        params, summary = _se3_solve(
            "maha", t0, q0, data, self.loss_function, self.priors, options, self.backend,
            reduce=reduce,
        )
        return _pose_from_params(params), summary

    def information(self, data: mahalanobis.MahalanobisData, pose: Pose) -> np.ndarray:
        """Gauss-Newton information J^T W J (6, 6) of the objective at
        ``pose``, in the right-retraction tangent [dt, dtheta]: the
        whitening a pose-graph backend wants for an edge produced by this
        solve (``sqrt_info = cholesky(information)``). Float64 numpy."""
        return _information_impl(self, data, pose, mahalanobis.eval_quadratic)


class MahalanobisDistanceMinimizer3DOF(_MinimizerBase):
    """3-DoF planar (x, y, yaw) NDT alignment
    (reference: mahalanobis_distance_minimizer_analytic_3dof{,_simd}.cc).

    Like the reference, takes and returns a full SE(3) pose: the planar
    pose is the top-left block's yaw and the translation's xy
    (.._analytic_3dof.cc:22-25), and the result overwrites only those, so
    z, roll and pitch of the input pose pass through (:104-105)."""

    @tracing.traced("nls.solve")
    def solve(
        self,
        options: Options,
        data: mahalanobis.MahalanobisData,
        pose: Pose,
    ) -> Tuple[Pose, lm.Summary]:
        t0 = self._as_tensor(pose.translation[:2])
        theta0 = self._as_tensor(np.arctan2(pose.rotation[1, 0], pose.rotation[0, 0]))
        planar_priors = None
        if self.priors is not None:
            # the SE(3) prior projected onto the plane: (x, y) and the yaw
            # of the prior quaternion, as stored in the solve's dtype
            pq = tracing.host_read(self.priors.quaternion).numpy().astype(np.float64)
            planar_priors = (
                self.priors.translation[:2],
                self._as_tensor(2.0 * np.arctan2(pq[3], pq[0])),
                self.priors.translation_weight,
                self.priors.rotation_weight,
            )
        data, reduce = self._prepared(data)
        params, summary = _maha3_solve(
            t0, theta0, data, self.loss_function, planar_priors, options, self.backend, reduce
        )
        t2_theta = tracing.host_read(torch.cat([params.translation, params.theta[None]])).numpy()
        out = pose.copy()
        out.translation = out.translation.copy()
        out.rotation = out.rotation.copy()
        out.translation[:2] = np.asarray(t2_theta[:2], np.float64)
        c, s = np.cos(float(t2_theta[2])), np.sin(float(t2_theta[2]))
        out.rotation[:2, :2] = np.array([[c, -s], [s, c]])
        return out, summary


class ReprojectionErrorMinimizer(_MinimizerBase):
    """6-DoF pose from 3D-2D correspondences
    (reference: reprojection_error_minimizer_analytic{,_simd}.cc)."""

    def _intrinsics(self, intrinsics: CameraIntrinsics) -> CameraIntrinsics:
        return intrinsics_tensors(intrinsics, self.dtype, self.device)

    @tracing.traced("nls.solve")
    def solve(
        self,
        options: Options,
        data: reprojection.ReprojectionData,
        intrinsics: CameraIntrinsics,
        pose: Pose,
    ) -> Tuple[Pose, lm.Summary]:
        data, reduce = self._prepared(data)
        params, summary = _se3_solve(
            "reproj", self._as_tensor(pose.translation), self._as_tensor(pose.quaternion()),
            data, self.loss_function, self.priors, options, self.backend,
            self._intrinsics(intrinsics), reduce,
        )
        return _pose_from_params(params), summary

    def information(
        self,
        data: reprojection.ReprojectionData,
        intrinsics: CameraIntrinsics,
        pose: Pose,
    ) -> np.ndarray:
        """Gauss-Newton information of the reprojection objective at
        ``pose`` (PnP uncertainty; see
        :meth:`MahalanobisDistanceMinimizer.information`)."""
        return _information_impl(
            self, data, pose, reprojection.eval_quadratic, self._intrinsics(intrinsics)
        )


class PointToPlaneMinimizer(_MinimizerBase):
    """6-DoF point-to-plane ICP (factor math from the reference's
    pose_optimizer/cost_functors.h:106-157)."""

    @tracing.traced("nls.solve")
    def solve(
        self,
        options: Options,
        data: point_to_plane.PointToPlaneData,
        pose: Pose,
    ) -> Tuple[Pose, lm.Summary]:
        as_t = self._as_tensor
        data, reduce = self._prepared(data)
        params, summary = _se3_solve(
            "p2p", as_t(pose.translation), as_t(pose.quaternion()), data,
            self.loss_function, self.priors, options, self.backend, reduce=reduce,
        )
        return _pose_from_params(params), summary

    def information(self, data: point_to_plane.PointToPlaneData, pose: Pose) -> np.ndarray:
        """Gauss-Newton information of the point-to-plane objective at
        ``pose`` (see :meth:`MahalanobisDistanceMinimizer.information`)."""
        return _information_impl(self, data, pose, point_to_plane.eval_quadratic)


def _information_impl(
    minimizer: _MinimizerBase, data, pose: Pose, eval_quadratic, intrinsics=None
) -> np.ndarray:
    """H of ``eval_quadratic`` (the plain evaluation, on every backend) at
    ``pose``, on data cast and padded as a solve would see it; the
    reprojection objective also takes the solve's ``intrinsics``."""
    as_t = minimizer._as_tensor
    data = data.astype(minimizer.dtype).pad_to(minimizer._pad(data.num_factors))
    R = lie.quat_to_rotmat(lie.quat_normalize(as_t(pose.quaternion())))
    camera = () if intrinsics is None else (intrinsics,)
    H, _, _ = eval_quadratic(
        R, as_t(pose.translation), data, *camera, minimizer.loss_function
    )
    return H.cpu().numpy().astype(np.float64)


def _add_se3_priors(H, g, c, params: SE3Params, priors: Optional[SE3Priors]):
    """Fold pose priors into a batch's (H, g, cost) as Gauss-Newton
    quadratic terms, the same prior for every instance.

    Translation: residual t - t_prior, Jacobian [I 0].
    Rotation: residual log(q_prior^-1 q) in the right-retraction tangent
    (J ~= I near the prior)."""
    if priors is None:
        return H, g, c
    wt, wr = priors.translation_weight, priors.rotation_weight
    rt = params.translation - priors.translation
    q = lie.quat_normalize(params.quaternion)
    rw = lie.quat_log_vec(
        lie.quat_multiply(lie.quat_conjugate(priors.quaternion), q)
    )
    H = H + torch.diag(torch.cat([wt.expand(3), wr.expand(3)]))
    g = g + torch.cat([wt * rt, wr * rw], dim=-1)
    c = c + wt * torch.sum(rt * rt, dim=-1) + wr * torch.sum(rw * rw, dim=-1)
    return H, g, c


# objective -> (plain eval_quadratic, packer, kernel params, loss tail, kernel)
_SE3_OBJECTIVES = {
    "maha": (mahalanobis.eval_quadratic, cuda_kernels.pack_maha6,
             cuda_kernels.maha6_params, cuda_kernels.maha6_loss_ab,
             cuda_kernels.maha6_partials),
    "reproj": (reprojection.eval_quadratic, cuda_kernels.pack_reproj,
               cuda_kernels.reproj_params, cuda_kernels.reproj_loss_ab,
               cuda_kernels.reproj_partials),
    "p2p": (point_to_plane.eval_quadratic, cuda_kernels.pack_p2p,
            cuda_kernels.maha6_params, cuda_kernels.maha6_loss_ab,
            cuda_kernels.p2p_partials),
}


def se3_quadratic(
    objective: str,
    data,
    loss: Optional[LossFunction],
    backend: str,
    intrinsics: Optional[CameraIntrinsics] = None,
    reduce: Optional[Callable] = None,
):
    """``quad(params) -> (H (B, 6, 6), g (B, 6), cost (B,))`` of B SE(3)
    problems of ``objective`` ("maha", "reproj" or "p2p") at (B, ...)
    ``SE3Params``, on data (B, N, ...) already cast and padded; "reproj"
    takes the intrinsics as scalar tensors of the solve.

    ``backend="cuda"`` packs the data once, here, into (B, rows, N) float32
    rows, and each call evaluates the whole batch with ONE launch of the
    objective's kernel; ``"torch"`` runs the plain factor code. A lone
    problem is a batch of one: the serial minimizers and
    ``solvers/batched`` share this evaluation. ``reduce`` (a
    ``parallel.reducer``) sums each evaluation over the ranks of a mesh:
    the kernel's outputs, or the plain path's (H, g, cost)."""
    reduce = reduce or (lambda x: x)
    plain, pack, kernel_params, loss_ab_fn, partials = _SE3_OBJECTIVES[objective]
    camera = () if intrinsics is None else (intrinsics,)
    if backend == "cuda":
        packed = pack(data)
        code, loss_ab = loss_ab_fn(loss, packed.device)

        def eval_fn(R, t):
            kparams = kernel_params(R, t, *camera, loss_ab).contiguous()
            out = partials(kparams, packed, code)
            return cuda_kernels.unpack_out(reduce(out.to(t.dtype)), 6)

    else:
        eval_fn = lambda R, t: reduce(plain(R, t, data, *camera, loss))

    def quad(params: SE3Params):
        return eval_fn(lie.quat_to_rotmat(params.quaternion), params.translation)

    return quad


def _se3_solve(
    objective: str,
    t0: Tensor,
    q0: Tensor,
    data,
    loss: Optional[LossFunction],
    priors: Optional[SE3Priors],
    options: Options,
    backend: str,
    intrinsics: Optional[CameraIntrinsics] = None,
    reduce: Optional[Callable] = None,
) -> Tuple[SE3Params, lm.Summary]:
    """One SE(3) LM solve of ``objective`` on data already cast and padded
    (the reprojection objective with the intrinsics as scalar tensors of
    the solve): the problem as a batch of one through
    :func:`se3_quadratic` and ``lm.solve_batch``. Under a mesh ``data`` is
    this rank's block and ``reduce`` sums the evaluations; the priors are
    added after the sum, so they count once."""
    batch = type(data)(*(a[None] for a in data))
    quad_b = se3_quadratic(objective, batch, loss, backend, intrinsics, reduce)

    def quad(params: SE3Params):
        return _add_se3_priors(*quad_b(params), params, priors)

    params, summary = lm.solve_batch(
        quad, se3_retract, SE3Params(t0[None], q0[None]), options
    )
    return lm.instance(params, 0), lm.instance(summary, 0)


def _maha3_solve(
    t0: Tensor,
    theta0: Tensor,
    data: mahalanobis.MahalanobisData,
    loss: Optional[LossFunction],
    priors: Optional[Tuple[Tensor, Tensor, Tensor, Tensor]],
    options: Options,
    backend: str,
    reduce: Optional[Callable] = None,
) -> Tuple[SE2Params, lm.Summary]:
    """One planar LM solve on data already cast and padded. ``priors`` is
    (t2 prior, yaw prior, translation weight, yaw weight) or None; under a
    mesh ``reduce`` sums each evaluation before they are added."""
    reduce = reduce or (lambda x: x)
    if backend == "cuda":
        # the compact 10-row Gram packing, built once per solve: 40 bytes a
        # factor against the 16-row layout's 64
        packed = cuda_kernels.pack_maha3_compact(data)[None]
        code, loss_ab = cuda_kernels.maha6_loss_ab(loss, packed.device)

        def eval_fn(R2, t2):
            params = cuda_kernels.maha3_params(R2, t2, loss_ab)[None]
            out = cuda_kernels.maha3c_partials(params, packed, code)[0]
            return cuda_kernels.unpack_out(reduce(out.to(t0.dtype)), 3)

    else:
        eval_fn = lambda R2, t2: reduce(mahalanobis.eval_quadratic_3dof(R2, t2, data, loss))

    def quad(params: SE2Params):
        H, g, c = eval_fn(lie.rot2(params.theta), params.translation)
        if priors is not None:
            t2p, thp, wt, wr = priors
            rt = params.translation - t2p
            # the yaw residual wrapped to (-pi, pi]
            rth = params.theta - thp
            rth = torch.atan2(torch.sin(rth), torch.cos(rth))
            H = H + torch.diag(torch.stack([wt, wt, wr]))
            g = g + torch.cat([wt * rt, (wr * rth)[None]])
            c = c + wt * torch.dot(rt, rt) + wr * rth * rth
        return H, g, c

    return lm.solve(quad, se2_retract, SE2Params(t0, theta0), options)
