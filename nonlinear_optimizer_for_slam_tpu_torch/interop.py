"""Carry state from the JAX package into the port, as plain numpy arrays.

The port never imports the JAX package. A caller that holds the JAX
package's objects turns each into numpy (``np.asarray`` of every field) and
hands those to :func:`from_reference`, which builds the port's objects on
a given device:

- ``ndt_map``: the ``NdtMap`` fields ``means``, ``sqrt_informations``,
  ``informations``, ``counts`` and ``valid`` (the map stays host-side numpy,
  as in both packages);
- ``data``: the ``MahalanobisData`` fields ``points``, ``means``,
  ``sqrt_infos`` and ``mask``;
- ``pose``: the ``Pose`` fields ``rotation`` and ``translation``;
- ``loss``: ``(class name, {parameter: value})``, for example
  ``("ExponentialLoss", {"c1": 1.0, "c2": 1.0})``;
- ``options``: ``Options`` as a nested dict (``dataclasses.asdict``), with
  each enum given by its name or its value;
- ``registrar_map``: the map state of a JAX ``NdtRegistrar``, its arrays
  ``means_T``, ``infos_T``, ``normals_T``, ``voxel_weights`` and
  ``map_mask`` (each may be None or left out but the first two); it goes to
  ``device`` in ``dtype`` as a ``RegistrarMap``, which the port's
  ``NdtRegistrar`` takes in place of an ``NdtMap``;
- ``reprojection_data``: the ``ReprojectionData`` fields ``local_points``,
  ``matched_pixels`` and ``mask``, to ``device`` in ``dtype``;
- ``intrinsics``: the ``CameraIntrinsics`` fields ``fx``, ``fy``, ``cx``,
  ``cy``, ``width`` and ``height``, rebuilt with ``CameraIntrinsics.create``
  (host floats; a minimizer casts them to its dtype);
- ``pose_graph_edges``: the seven ``PoseGraphEdges`` fields
  (``reference_indices``, ``query_indices``, ``relative_translations``,
  ``relative_quaternions``, ``is_loop``, ``mask``, and ``sqrt_info``: None,
  (E, 6) diagonal rows or (E, 6, 6) matrices), to ``device``: the indices
  as int64, the rest in ``dtype``;
- ``pose_graph_state``: a pose-graph solve's state, ``positions`` (P, 3),
  ``quaternions`` (P, 4) and ``switches`` (L,), to ``device`` in ``dtype``
  as a :class:`PoseGraphState`;
- ``pose_graph_2d_edges``: the six ``PoseGraph2DEdges`` fields
  (``reference_indices``, ``query_indices``, ``relative_xyt``, ``is_loop``,
  ``mask``, and ``sqrt_info``: None, (E, 3) diagonal rows or (E, 3, 3)
  matrices), to ``device``: the indices as int64, the rest in ``dtype``;
- ``pose_graph_2d_state``: an SE(2) solve's state, ``xyt`` (P, 3) and
  ``switches`` (L,), to ``device`` in ``dtype`` as a
  :class:`PoseGraph2DState`;
- ``problem``: the residual blocks of a ``solvers.problem.Problem``, a list
  of ``(functor class name, {constructor argument: array or None}, loss)``
  with the loss as above or None; the functors are the four built-in ones
  (``MahalanobisDistanceCostFunctor``: ``points``, ``means``,
  ``sqrt_infos``, ``mask``; ``PointToPlaneCostFunctor``: ``points``,
  ``means``, ``normals``, ``mask``; ``TranslationDeltaCostFunctor``:
  ``target_translation``, ``sqrt_info``; ``RotationDeltaCostFunctor``:
  ``target_rotation``, ``sqrt_info``), built on ``device`` with each array
  in its own dtype;
- ``ba_data``: the ``BAData`` fields ``camera_indices``,
  ``landmark_indices``, ``pixels`` and ``mask``, to ``device`` (the indices
  as int64, the rest in ``dtype``);
- ``ba_params``: the ``BAParams`` fields ``translations``, ``quaternions``
  and ``landmarks``, to ``device`` in ``dtype``;
- ``bal_problem``: the ``BALProblem`` fields ``camera_params``, ``points``,
  ``camera_indices``, ``point_indices`` and ``observations``, as the port's
  host ``BALProblem`` (float64 and int32, as ``io.bal`` reads them).

:func:`to_reference` is the inverse but for ``problem``: the same dicts
back, as numpy (the intrinsics as floats and ints).

:func:`pose_landmark_from_reference` builds a port ``PoseLandmarkOptimizer``
or ``PoseLandmark2DOptimizer`` holding a JAX one's registry (poses,
landmarks, constants, constraints and observations with their sqrt_info,
the losses and the learned loop switches), so that both solve, or answer
covariance queries, on the same problem.

:func:`fixed_lag_from_reference` builds a port ``FixedLagSmoother`` that
carries a JAX ``FixedLagSmoother``'s state mid-stream (its window, its
estimates and frozen history, its odometry and loops with their switches,
and its marginal prior), so that both can go on from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .core import losses as losses_mod
from .core.device import resolve_device
from .core.options import (
    ConvergenceHandle,
    LinearSolverType,
    MinimizerType,
    OptimizationHandle,
    Options,
)
from .core.pose import Pose
from .io.bal import BALProblem
from .ops.mahalanobis import MahalanobisData
from .ops.relative_pose import PoseGraphEdges
from .solvers import problem as problem_mod
from .solvers.bundle_adjustment import BAData, BAParams
from .solvers.fixed_lag import FixedLagSmoother
from .solvers.pose_graph import PoseGraph2DEdges
from .solvers.pose_landmark import PoseLandmark2DOptimizer, PoseLandmarkOptimizer
from .ops.reprojection import CameraIntrinsics, ReprojectionData
from .pipelines.fused_registration import RegistrarMap
from .pipelines.ndt import NdtMap

LOSSES = {
    cls.__name__: cls
    for cls in (
        losses_mod.TrivialLoss,
        losses_mod.ExponentialLoss,
        losses_mod.HuberLoss,
        losses_mod.CauchyLoss,
        losses_mod.TukeyLoss,
        losses_mod.GemanMcClureLoss,
        losses_mod.DCSLoss,
    )
}

FUNCTORS = {
    cls.__name__: cls
    for cls in (
        problem_mod.MahalanobisDistanceCostFunctor,
        problem_mod.PointToPlaneCostFunctor,
        problem_mod.TranslationDeltaCostFunctor,
        problem_mod.RotationDeltaCostFunctor,
    )
}


class PoseGraphState(NamedTuple):
    """A pose graph's solve state: positions (P, 3), quaternions (P, 4)
    (w, x, y, z) and loop switches (L,)."""

    positions: torch.Tensor
    quaternions: torch.Tensor
    switches: torch.Tensor


class PoseGraph2DState(NamedTuple):
    """An SE(2) pose graph's solve state: xyt (P, 3) and loop switches
    (L,)."""

    xyt: torch.Tensor
    switches: torch.Tensor


class PortState(NamedTuple):
    """The port's objects built by :func:`from_reference`; a field is None
    where its input was not given."""

    ndt_map: Optional[NdtMap]
    data: Optional[MahalanobisData]
    pose: Optional[Pose]
    loss: Optional[losses_mod.LossFunction]
    options: Optional[Options]
    registrar_map: Optional[RegistrarMap] = None
    reprojection_data: Optional[ReprojectionData] = None
    intrinsics: Optional[CameraIntrinsics] = None
    pose_graph_edges: Optional[PoseGraphEdges] = None
    pose_graph_state: Optional[PoseGraphState] = None
    pose_graph_2d_edges: Optional[PoseGraph2DEdges] = None
    pose_graph_2d_state: Optional[PoseGraph2DState] = None
    problem: Optional[problem_mod.Problem] = None
    ba_data: Optional[BAData] = None
    ba_params: Optional[BAParams] = None
    bal_problem: Optional[BALProblem] = None


def _enum(cls, value):
    if isinstance(value, str):
        return cls[value]
    if isinstance(value, int):
        return cls(value)
    return cls[value.name]  # an enum of the same name from another package


def _options(fields: Mapping[str, Any]) -> Options:
    fields = dict(fields)
    if "minimizer_type" in fields:
        fields["minimizer_type"] = _enum(MinimizerType, fields["minimizer_type"])
    if "linear_solver_type" in fields:
        fields["linear_solver_type"] = _enum(
            LinearSolverType, fields["linear_solver_type"]
        )
    if "convergence_handle" in fields:
        fields["convergence_handle"] = ConvergenceHandle(
            **fields["convergence_handle"]
        )
    if "optimization_handle" in fields:
        fields["optimization_handle"] = OptimizationHandle(
            **fields["optimization_handle"]
        )
    return Options(**fields)


def _loss(spec) -> Optional[losses_mod.LossFunction]:
    if spec is None:
        return None
    name, params = spec
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; one of {sorted(LOSSES)}")
    return LOSSES[name](**{k: float(v) for k, v in params.items()})


def from_reference(
    *,
    ndt_map: Optional[Mapping[str, np.ndarray]] = None,
    data: Optional[Mapping[str, np.ndarray]] = None,
    pose: Optional[Mapping[str, np.ndarray]] = None,
    loss: Optional[Tuple[str, Mapping[str, float]]] = None,
    options: Optional[Mapping[str, Any]] = None,
    registrar_map: Optional[Mapping[str, Optional[np.ndarray]]] = None,
    reprojection_data: Optional[Mapping[str, np.ndarray]] = None,
    intrinsics: Optional[Mapping[str, Any]] = None,
    pose_graph_edges: Optional[Mapping[str, Optional[np.ndarray]]] = None,
    pose_graph_state: Optional[Mapping[str, np.ndarray]] = None,
    pose_graph_2d_edges: Optional[Mapping[str, Optional[np.ndarray]]] = None,
    pose_graph_2d_state: Optional[Mapping[str, np.ndarray]] = None,
    problem: Optional[list] = None,
    ba_data: Optional[Mapping[str, np.ndarray]] = None,
    ba_params: Optional[Mapping[str, np.ndarray]] = None,
    bal_problem: Optional[Mapping[str, np.ndarray]] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> PortState:
    """The port's objects from numpy copies of the JAX package's (see the
    module docstring). ``data``, ``registrar_map``, ``reprojection_data``
    and the pose-graph edges and states go to ``device`` in ``dtype`` (edge
    indices as int64); raises if ``device`` names CUDA and no GPU is
    present."""
    device = resolve_device(device)
    port_map = None
    if ndt_map is not None:
        port_map = NdtMap(
            means=np.asarray(ndt_map["means"], np.float64),
            sqrt_informations=np.asarray(ndt_map["sqrt_informations"], np.float64),
            informations=np.asarray(ndt_map["informations"], np.float64),
            counts=np.asarray(ndt_map["counts"]),
            valid=np.asarray(ndt_map["valid"], bool),
        )
    to_device = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    port_data = None
    if data is not None:
        port_data = MahalanobisData(*(to_device(data[f]) for f in MahalanobisData._fields))
    port_pose = None
    if pose is not None:
        port_pose = Pose(
            np.asarray(pose["rotation"], np.float64),
            np.asarray(pose["translation"], np.float64),
        )
    port_loss = _loss(loss)
    port_options = None if options is None else _options(options)
    port_registrar_map = None
    if registrar_map is not None:
        port_registrar_map = RegistrarMap(
            *(
                None if registrar_map.get(f) is None else to_device(registrar_map[f])
                for f in RegistrarMap._fields
            )
        )
    port_reprojection = None
    if reprojection_data is not None:
        port_reprojection = ReprojectionData(
            *(to_device(reprojection_data[f]) for f in ReprojectionData._fields)
        )
    port_intrinsics = None
    if intrinsics is not None:
        port_intrinsics = CameraIntrinsics.create(
            *(float(intrinsics[f]) for f in ("fx", "fy", "cx", "cy")),
            width=int(intrinsics.get("width", 0)),
            height=int(intrinsics.get("height", 0)),
        )
    index = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=device)
    optional = lambda a: None if a is None else to_device(a)
    port_edges = None
    if pose_graph_edges is not None:
        port_edges = PoseGraphEdges(
            index(pose_graph_edges["reference_indices"]),
            index(pose_graph_edges["query_indices"]),
            *(to_device(pose_graph_edges[f]) for f in PoseGraphEdges._fields[2:6]),
            sqrt_info=optional(pose_graph_edges.get("sqrt_info")),
        )
    port_graph_state = None
    if pose_graph_state is not None:
        port_graph_state = PoseGraphState(
            *(to_device(pose_graph_state[f]) for f in PoseGraphState._fields)
        )
    port_edges_2d = None
    if pose_graph_2d_edges is not None:
        port_edges_2d = PoseGraph2DEdges(
            index(pose_graph_2d_edges["reference_indices"]),
            index(pose_graph_2d_edges["query_indices"]),
            *(to_device(pose_graph_2d_edges[f]) for f in PoseGraph2DEdges._fields[2:5]),
            sqrt_info=optional(pose_graph_2d_edges.get("sqrt_info")),
        )
    port_state_2d = None
    if pose_graph_2d_state is not None:
        port_state_2d = PoseGraph2DState(
            *(to_device(pose_graph_2d_state[f]) for f in PoseGraph2DState._fields)
        )
    port_problem = None
    if problem is not None:
        port_problem = problem_mod.Problem()
        for name, arrays, block_loss in problem:
            if name not in FUNCTORS:
                raise ValueError(f"unknown cost functor {name!r}; one of {sorted(FUNCTORS)}")
            functor = FUNCTORS[name](
                **{k: None if a is None else np.asarray(a) for k, a in arrays.items()},
                device=device,
            )
            port_problem.add_residual_block(functor, _loss(block_loss))
    port_ba_data = None
    if ba_data is not None:
        port_ba_data = BAData(
            index(ba_data["camera_indices"]), index(ba_data["landmark_indices"]),
            to_device(ba_data["pixels"]), to_device(ba_data["mask"]),
        )
    port_ba_params = None
    if ba_params is not None:
        port_ba_params = BAParams(*(to_device(ba_params[f]) for f in BAParams._fields))
    port_bal = None
    if bal_problem is not None:
        port_bal = BALProblem(
            np.array(bal_problem["camera_params"], np.float64),
            np.array(bal_problem["points"], np.float64),
            np.array(bal_problem["camera_indices"], np.int32),
            np.array(bal_problem["point_indices"], np.int32),
            np.array(bal_problem["observations"], np.float64),
        )
    return PortState(
        port_map, port_data, port_pose, port_loss, port_options, port_registrar_map,
        port_reprojection, port_intrinsics, port_edges, port_graph_state,
        port_edges_2d, port_state_2d, port_problem, port_ba_data, port_ba_params, port_bal,
    )


def to_reference(state: PortState) -> dict:
    """Inverse of :func:`from_reference`: numpy arrays, the loss as
    ``(class name, parameters)`` and the options as a nested dict with
    enums by name. Fields that are None are left out."""
    out = {}
    if state.ndt_map is not None:
        out["ndt_map"] = {
            f.name: np.asarray(getattr(state.ndt_map, f.name))
            for f in dataclasses.fields(NdtMap)
        }
    if state.data is not None:
        out["data"] = {
            f: getattr(state.data, f).cpu().numpy() for f in MahalanobisData._fields
        }
    if state.pose is not None:
        out["pose"] = {
            "rotation": np.asarray(state.pose.rotation),
            "translation": np.asarray(state.pose.translation),
        }
    if state.loss is not None:
        out["loss"] = (type(state.loss).__name__, dataclasses.asdict(state.loss))
    if state.options is not None:
        opts = dataclasses.asdict(state.options)
        opts["minimizer_type"] = state.options.minimizer_type.name
        opts["linear_solver_type"] = state.options.linear_solver_type.name
        out["options"] = opts
    if state.registrar_map is not None:
        out["registrar_map"] = {
            f: None if a is None else a.cpu().numpy()
            for f, a in zip(RegistrarMap._fields, state.registrar_map)
        }
    if state.reprojection_data is not None:
        out["reprojection_data"] = {
            f: a.cpu().numpy()
            for f, a in zip(ReprojectionData._fields, state.reprojection_data)
        }
    if state.intrinsics is not None:
        intr = state.intrinsics
        out["intrinsics"] = {
            "fx": float(intr.fx), "fy": float(intr.fy), "cx": float(intr.cx),
            "cy": float(intr.cy), "width": int(intr.width), "height": int(intr.height),
        }
    if state.pose_graph_edges is not None:
        out["pose_graph_edges"] = {
            f: None if a is None else a.cpu().numpy()
            for f, a in zip(PoseGraphEdges._fields, state.pose_graph_edges)
        }
    if state.pose_graph_state is not None:
        out["pose_graph_state"] = {
            f: a.cpu().numpy() for f, a in zip(PoseGraphState._fields, state.pose_graph_state)
        }
    if state.pose_graph_2d_edges is not None:
        out["pose_graph_2d_edges"] = {
            f: None if a is None else a.cpu().numpy()
            for f, a in zip(PoseGraph2DEdges._fields, state.pose_graph_2d_edges)
        }
    if state.pose_graph_2d_state is not None:
        out["pose_graph_2d_state"] = {
            f: a.cpu().numpy()
            for f, a in zip(PoseGraph2DState._fields, state.pose_graph_2d_state)
        }
    for key, cls in (("ba_data", BAData), ("ba_params", BAParams)):
        value = getattr(state, key)
        if value is not None:
            out[key] = {f: a.cpu().numpy() for f, a in zip(cls._fields, value)}
    if state.bal_problem is not None:
        out["bal_problem"] = {
            f: np.asarray(a) for f, a in zip(BALProblem._fields, state.bal_problem)
        }
    return out


def fixed_lag_from_reference(
    state: Mapping[str, Any],
    *,
    lag: int,
    switch_penalty: Optional[float] = None,
    max_iterations: int = 50,
    marginalize_every: int = 1,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> FixedLagSmoother:
    """A port ``FixedLagSmoother`` in the state of a JAX one, given as
    numpy (the JAX smoother's private fields of the same names, with no
    update pending):

    - ``window``: the active pose ids, oldest first;
    - ``est``: {id: (7,) [p, q wxyz]} of the window poses;
    - ``history``: {id: (7,)} of the marginalized (frozen) poses;
    - ``odom``: a list of (ref, qry, rel_t (3,), rel_q (4,), sqrt_info),
      sqrt_info None, (6,) or (6, 6);
    - ``loops``: a list of dicts with ``ref``, ``qry``, ``rel_t``,
      ``rel_q``, ``switch`` and ``sqrt_info``;
    - ``prior``: None or (support ids, S (6B, 6B), x_lin (B, 7), c (6B,));
    - ``gauge``: the gauge-fixed pose id, or None once a prior exists.

    The keywords are the smoother's constructor arguments."""
    sm = FixedLagSmoother(
        lag, dtype=dtype, switch_penalty=switch_penalty, max_iterations=max_iterations,
        marginalize_every=marginalize_every, device=device,
    )
    f64 = lambda a: np.array(a, np.float64)
    opt = lambda a: None if a is None else f64(a)
    sm._window = [int(i) for i in state["window"]]
    sm._est = {int(k): f64(v) for k, v in state["est"].items()}
    sm._history = {int(k): f64(v) for k, v in state["history"].items()}
    sm._odom = [
        (int(a), int(b), f64(t), f64(q), opt(w)) for a, b, t, q, w in state["odom"]
    ]
    sm._loops = [
        dict(ref=int(l["ref"]), qry=int(l["qry"]), rel_t=f64(l["rel_t"]),
             rel_q=f64(l["rel_q"]), switch=float(l["switch"]), sqrt_info=opt(l["sqrt_info"]))
        for l in state["loops"]
    ]
    prior = state.get("prior")
    if prior is not None:
        ids, S, x_lin, c = prior
        prior = ([int(i) for i in ids], f64(S), f64(x_lin), f64(c))
    sm._prior = prior
    gauge = state.get("gauge")
    sm._gauge = None if gauge is None else int(gauge)
    return sm


def pose_landmark_from_reference(
    state: Mapping[str, Any],
    *,
    dim: int = 3,
    pose_solver: str = "dense",
    device="cuda",
    dtype: torch.dtype = torch.float64,
):
    """A port ``PoseLandmarkOptimizer`` (``dim=3``) or
    ``PoseLandmark2DOptimizer`` (``dim=2``) holding the registry of a JAX
    one, given as numpy (its public records and private fields of the same
    names):

    - ``poses``: {id: (4, 4) homogeneous matrix} (3-D, ``Pose.matrix()``)
      or {id: (3,) xyt} (2-D);
    - ``landmarks``: {id: (3,) or (2,)};
    - ``constant_poses``, ``constant_landmarks``: ids;
    - ``constraints``: a list of dicts with ``reference_index``,
      ``query_index``, ``relative`` ((4, 4) matrix or (3,) xyt),
      ``type`` and ``sqrt_info`` (None, diagonal or matrix);
    - ``observations``: a list of dicts with ``pose_index``,
      ``landmark_index``, ``measurement`` and ``sqrt_info``;
    - ``switch_penalty``; ``edge_loss`` and ``obs_loss`` as
      ``(class name, {parameter: value})`` or None;
    - ``last_switches``: the loop switches a solve learned, or None.

    Records are copied in as they are stored (no re-expansion of the
    sqrt-information)."""
    cls = PoseLandmarkOptimizer if dim == 3 else PoseLandmark2DOptimizer
    opt = cls(
        dtype=dtype, switch_penalty=float(state["switch_penalty"]),
        edge_loss=_loss(state.get("edge_loss")), obs_loss=_loss(state.get("obs_loss")),
        pose_solver=pose_solver, device=device,
    )
    f64 = lambda a: np.array(a, np.float64)
    opt_f64 = lambda a: None if a is None else f64(a)

    def pose_of(v):
        v = f64(v)
        return Pose.from_matrix(v) if dim == 3 else v

    for i, v in state["poses"].items():
        opt._poses[int(i)] = pose_of(v)
    for j, v in state["landmarks"].items():
        opt._landmarks[int(j)] = f64(v)
    opt._constant_poses = {int(i) for i in state["constant_poses"]}
    opt._constant_landmarks = {int(j) for j in state["constant_landmarks"]}
    key = "relative_pose" if dim == 3 else "relative_xyt"
    opt._constraints = [
        dict(reference_index=int(c["reference_index"]), query_index=int(c["query_index"]),
             **{key: pose_of(c["relative"])}, type=int(c["type"]),
             sqrt_info=opt_f64(c["sqrt_info"]))
        for c in state["constraints"]
    ]
    opt._observations = [
        dict(pose_index=int(o["pose_index"]), landmark_index=int(o["landmark_index"]),
             measurement=f64(o["measurement"]), sqrt_info=opt_f64(o["sqrt_info"]))
        for o in state["observations"]
    ]
    switches = state.get("last_switches")
    if switches is not None:
        opt._last_switches = f64(switches)
    return opt
