"""g2o pose-graph file IO (PyTorch port of the JAX package's ``io/g2o.py``).

The reference framework has no dataset IO (its pose-graph tests build
graphs programmatically). Users arrive with standard benchmark files
(sphere2500, torus, parking-garage, ...), so this module reads and writes
the g2o text format and builds ready-to-solve optimizers from it.

Records read and written:

  3-D: ``VERTEX_SE3:QUAT id x y z qx qy qz qw``
       ``EDGE_SE3:QUAT i j x y z qx qy qz qw  <21 upper-tri info>``
       ``VERTEX_TRACKXYZ id x y z``, ``EDGE_SE3_TRACKXYZ i j [offset] x y z
       <6 upper-tri info>`` (landmarks)
  2-D: ``VERTEX_SE2 id x y theta``, ``EDGE_SE2 i j dx dy dtheta <6 info>``,
       ``VERTEX_XY``, ``EDGE_SE2_XY``
  both: ``FIX id``

:func:`load_pose_graph` builds a :class:`PoseGraphOptimizer` from a 3-D
file of poses and a :class:`PoseGraphOptimizer2D` from a 2-D one; a file
with landmark records loads into a ``PoseLandmarkOptimizer`` (3-D) or a
``PoseLandmark2DOptimizer`` (2-D), and :func:`save_pose_graph` writes
either back with its landmarks and observations.

Quaternions are (x, y, z, w) on disk (g2o/Eigen order) and (w, x, y, z) in
this package. Information matrices are the upper triangle row by row,
reassembled symmetric.

Convention note: g2o's EDGE_SE3:QUAT error is ``[R_rel^T R_i^T ((p_j -
p_i) - R_i t_rel); vec(q_rel^-1 q_i^-1 q_j)]``: translation in the
MEASUREMENT frame, rotation the error-quaternion vector part (angle/2 to
first order). This package's residual keeps translation in the world frame
and uses 2 vec. The loader scales the rotation rows of the sqrt factor by
1/2, which preserves the g2o objective exactly whenever the translation
information block is isotropic and has no translation-rotation cross
terms (true of every standard benchmark dataset); otherwise the
translation anisotropy is read in the world frame. g2o's EDGE_SE2 error
is ``R_rel^T`` times this package's translation residual; the loader folds
that constant rotation into the sqrt factor, so the SE(2) objective
matches g2o exactly for any information matrix.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from ..core.pose import Pose, np_quat_to_rotmat, np_rotmat_to_quat
from ..solvers.pose_graph import (
    ConstraintType,
    PoseGraphOptimizer,
    PoseGraphOptimizer2D,
    sqrt_info_from_information,
)
from ..solvers.pose_landmark import PoseLandmark2DOptimizer, PoseLandmarkOptimizer

_TRI6 = [(i, j) for i in range(6) for j in range(i, 6)]  # 21 entries
_TRI3 = [(i, j) for i in range(3) for j in range(i, 3)]  # 6 entries


@dataclass
class G2oEdge:
    """One relative-pose constraint as stored in the file."""

    i: int
    j: int
    measurement: np.ndarray  # (7,) [t, q_wxyz] for 3-D; (3,) [dx dy dth] for 2-D
    information: np.ndarray  # (6, 6) or (3, 3) symmetric


@dataclass
class G2oGraph:
    """Parsed g2o file: vertices keyed by id, edges in file order."""

    dim: int  # 3 or 2
    vertices: Dict[int, np.ndarray] = field(default_factory=dict)
    # (7,) [t, q_wxyz] for 3-D; (3,) [x y theta] for 2-D
    edges: List[G2oEdge] = field(default_factory=list)
    fixed: Set[int] = field(default_factory=set)
    # landmark-SLAM records (3-D): VERTEX_TRACKXYZ points and
    # EDGE_SE3_TRACKXYZ body-frame observations (measurement (3,),
    # information (3, 3); i = pose id, j = landmark id)
    landmarks: Dict[int, np.ndarray] = field(default_factory=dict)
    landmark_edges: List[G2oEdge] = field(default_factory=list)


def _sym_from_upper(vals, tri, n):
    m = np.zeros((n, n))
    for v, (i, j) in zip(vals, tri):
        m[i, j] = v
        m[j, i] = v
    return m


def _upper_from_sym(m, tri):
    return [m[i, j] for (i, j) in tri]


def read_g2o(path: str) -> G2oGraph:
    """Parse a g2o text file (3-D and 2-D records; mixing is an error).

    Unknown record tags are skipped (the format carries landmark/feature
    records this pose-graph subset doesn't model)."""
    graph: Optional[G2oGraph] = None
    skipped: Set[str] = set()

    def need(dim: int) -> G2oGraph:
        nonlocal graph
        if graph is None:
            graph = G2oGraph(dim=dim)
        elif graph.dim != dim:
            raise ValueError(
                f"{path}: mixed 2-D and 3-D records in one file"
            )
        return graph

    def fnums(seq, n):
        """Exactly-n float fields; short slices (truncated lines) must
        fail loudly, not zero-fill the information matrix."""
        if len(seq) < n:
            raise IndexError(f"expected {n} numeric fields, got {len(seq)}")
        return list(map(float, seq[:n]))

    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            try:
                if tag == "VERTEX_SE3:QUAT":
                    g = need(3)
                    vid = int(parts[1])
                    x, y, z, qx, qy, qz, qw = fnums(parts[2:], 7)
                    g.vertices[vid] = np.array([x, y, z, qw, qx, qy, qz])
                elif tag == "EDGE_SE3:QUAT":
                    g = need(3)
                    i, j = int(parts[1]), int(parts[2])
                    x, y, z, qx, qy, qz, qw = fnums(parts[3:], 7)
                    info = _sym_from_upper(fnums(parts[10:], 21), _TRI6, 6)
                    g.edges.append(
                        G2oEdge(
                            i, j, np.array([x, y, z, qw, qx, qy, qz]), info
                        )
                    )
                elif tag == "VERTEX_SE2":
                    g = need(2)
                    vid = int(parts[1])
                    g.vertices[vid] = np.array(fnums(parts[2:], 3))
                elif tag == "EDGE_SE2":
                    g = need(2)
                    i, j = int(parts[1]), int(parts[2])
                    meas = np.array(fnums(parts[3:], 3))
                    info = _sym_from_upper(fnums(parts[6:], 6), _TRI3, 3)
                    g.edges.append(G2oEdge(i, j, meas, info))
                elif tag in ("VERTEX_XY", "VERTEX_POINTXY"):
                    g = need(2)
                    g.landmarks[int(parts[1])] = np.array(fnums(parts[2:], 2))
                elif tag in ("EDGE_SE2_XY", "EDGE_SE2_POINTXY"):
                    g = need(2)
                    i, j = int(parts[1]), int(parts[2])
                    meas = np.array(fnums(parts[3:], 2))
                    vals = fnums(parts[5:], 3)  # 2x2 upper tri
                    info = np.array(
                        [[vals[0], vals[1]], [vals[1], vals[2]]]
                    )
                    g.landmark_edges.append(G2oEdge(i, j, meas, info))
                elif tag == "PARAMS_SE3OFFSET":
                    # sensor-extrinsic parameter referenced by
                    # EDGE_SE3_TRACKXYZ records. Only the identity
                    # offset is supported (observations are interpreted
                    # in the BODY frame); silently ignoring a real
                    # extrinsic would shift every landmark.
                    vals = fnums(parts[2:], 7)
                    if not (
                        np.allclose(vals[:6], 0.0, atol=1e-12)
                        and abs(abs(vals[6]) - 1.0) < 1e-9
                    ):
                        raise ValueError(
                            f"{path}:{lineno}: non-identity PARAMS_SE3OFFSET "
                            f"(sensor extrinsic) is not supported — transform "
                            f"the TRACKXYZ measurements into the body frame "
                            f"first"
                        )
                elif tag == "VERTEX_TRACKXYZ":
                    g = need(3)
                    g.landmarks[int(parts[1])] = np.array(fnums(parts[2:], 3))
                elif tag == "EDGE_SE3_TRACKXYZ":
                    g = need(3)
                    # with or without a PARAMS_SE3OFFSET id after (i, j):
                    # 11 operands = i j x y z info6; 12 = i j off x y z info6
                    vals = parts[1:]
                    if len(vals) not in (11, 12):
                        raise IndexError(
                            f"expected 11 or 12 fields, got {len(vals)}"
                        )
                    off = len(vals) - 11
                    i, j = int(vals[0]), int(vals[1])
                    meas = np.array(fnums(vals[2 + off :], 3))
                    info = _sym_from_upper(fnums(vals[5 + off :], 6), _TRI3, 3)
                    g.landmark_edges.append(G2oEdge(i, j, meas, info))
                elif tag == "FIX":
                    if graph is None:
                        raise ValueError("FIX before any vertex record")
                    graph.fixed.update(int(p) for p in parts[1:])
                else:
                    skipped.add(tag)
            except (ValueError, IndexError) as exc:
                if isinstance(exc, ValueError) and (
                    "mixed" in str(exc)
                    or "FIX" in str(exc)
                    or "PARAMS_SE3OFFSET" in str(exc)
                ):
                    raise
                raise ValueError(
                    f"{path}:{lineno}: malformed {tag} record: {line.rstrip()!r}"
                ) from exc
    if graph is None:
        raise ValueError(f"{path}: no pose-graph records found")
    return graph


def _pose_from_vec7(v: np.ndarray) -> Pose:
    q = v[3:] / np.linalg.norm(v[3:])
    return Pose(np_quat_to_rotmat(q), v[:3].copy())


# rotation rows of the 3-D residual are 2*vec(q_err); g2o's error is
# vec(q_err) — whiten with S @ diag(1,1,1,.5,.5,.5) to keep the
# objective value identical (see module docstring)
_ROT_HALF = np.diag([1.0, 1.0, 1.0, 0.5, 0.5, 0.5])


def _edge_sqrt_info_3d(info: np.ndarray) -> np.ndarray:
    return sqrt_info_from_information(info) @ _ROT_HALF


def _edge_sqrt_info_2d(info: np.ndarray, dtheta: float) -> np.ndarray:
    # fold the constant R_rel^T (g2o expresses the translation error in
    # the measurement frame) into the sqrt factor: exact for any info
    c, s = math.cos(dtheta), math.sin(dtheta)
    T = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    return sqrt_info_from_information(info) @ T


def load_pose_graph(
    path: str,
    *,
    loop_closure_gap: int = 2,
    switchable_loops: bool = False,
    switch_penalty: Optional[float] = None,
    unit_information: bool = False,
    **optimizer_kwargs,
):
    """Read a g2o file into a ready-to-solve optimizer:
    :class:`PoseGraphOptimizer` (3-D files) or :class:`PoseGraphOptimizer2D`
    (2-D files), or with landmark records ``PoseLandmarkOptimizer`` /
    ``PoseLandmark2DOptimizer``; ``optimizer_kwargs``, ``device=``
    included, go to its constructor.

    Edges whose endpoint ids differ by >= ``loop_closure_gap`` are loop
    closures; with ``switchable_loops=True`` they get switchable
    constraints (``switch_penalty`` defaults to the discriminating 0.03).
    ``unit_information=True`` ignores the file's information matrices (the
    reference's unweighted behavior). The first vertex (or every FIX
    record) is held constant for gauge; a FIX on a landmark holds the
    landmark."""
    graph = read_g2o(path)
    if switch_penalty is not None:
        optimizer_kwargs.setdefault("switch_penalty", switch_penalty)
    elif switchable_loops:
        optimizer_kwargs.setdefault("switch_penalty", 0.03)

    if graph.dim == 3:
        cls = PoseLandmarkOptimizer if graph.landmarks else PoseGraphOptimizer
        opt = cls(**optimizer_kwargs)
        for vid in sorted(graph.vertices):
            opt.set_pose(vid, _pose_from_vec7(graph.vertices[vid]))
    else:
        cls = PoseLandmark2DOptimizer if graph.landmarks else PoseGraphOptimizer2D
        opt = cls(**optimizer_kwargs)
        for vid in sorted(graph.vertices):
            opt.set_pose(vid, graph.vertices[vid])
    if graph.landmarks:
        for lid in sorted(graph.landmarks):
            opt.set_landmark(lid, graph.landmarks[lid])
        for e in graph.landmark_edges:
            opt.set_observation(
                e.i, e.j, e.measurement,
                sqrt_info=None if unit_information else sqrt_info_from_information(e.information),
            )
    for e in graph.edges:
        is_loop = switchable_loops and abs(e.j - e.i) >= loop_closure_gap
        if unit_information:
            sqrt_info = None
        elif graph.dim == 3:
            sqrt_info = _edge_sqrt_info_3d(e.information)
        else:
            sqrt_info = _edge_sqrt_info_2d(e.information, float(e.measurement[2]))
        opt.set_constraint(
            e.i,
            e.j,
            _pose_from_vec7(e.measurement) if graph.dim == 3 else e.measurement,
            constraint_type=ConstraintType.LOOP if is_loop else ConstraintType.ODOMETRY,
            sqrt_info=sqrt_info,
        )
    for vid in graph.fixed if graph.fixed else {min(graph.vertices)}:
        if vid in graph.landmarks:
            opt.set_landmark_constant(vid)
        else:
            opt.set_pose_constant(vid)
    return opt


def write_g2o(path: str, graph: G2oGraph) -> None:
    """Write a :class:`G2oGraph` back to disk (g2o text format)."""
    with open(path, "w") as f:
        if graph.dim == 3:
            for vid in sorted(graph.vertices):
                x, y, z, qw, qx, qy, qz = graph.vertices[vid]
                f.write(
                    f"VERTEX_SE3:QUAT {vid} {x:.9g} {y:.9g} {z:.9g} "
                    f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g}\n"
                )
            for lid in sorted(graph.landmarks):
                x, y, z = graph.landmarks[lid]
                f.write(f"VERTEX_TRACKXYZ {lid} {x:.9g} {y:.9g} {z:.9g}\n")
            for e in graph.edges:
                x, y, z, qw, qx, qy, qz = e.measurement
                vals = " ".join(
                    f"{v:.9g}" for v in _upper_from_sym(e.information, _TRI6)
                )
                f.write(
                    f"EDGE_SE3:QUAT {e.i} {e.j} {x:.9g} {y:.9g} {z:.9g} "
                    f"{qx:.9g} {qy:.9g} {qz:.9g} {qw:.9g} {vals}\n"
                )
            for e in graph.landmark_edges:
                vals = " ".join(
                    f"{v:.9g}" for v in _upper_from_sym(e.information, _TRI3)
                )
                f.write(
                    f"EDGE_SE3_TRACKXYZ {e.i} {e.j} "
                    f"{e.measurement[0]:.9g} {e.measurement[1]:.9g} "
                    f"{e.measurement[2]:.9g} {vals}\n"
                )
        else:
            for vid in sorted(graph.vertices):
                x, y, th = graph.vertices[vid]
                f.write(f"VERTEX_SE2 {vid} {x:.9g} {y:.9g} {th:.9g}\n")
            for lid in sorted(graph.landmarks):
                x, y = graph.landmarks[lid]
                f.write(f"VERTEX_XY {lid} {x:.9g} {y:.9g}\n")
            for e in graph.edges:
                vals = " ".join(
                    f"{v:.9g}" for v in _upper_from_sym(e.information, _TRI3)
                )
                f.write(
                    f"EDGE_SE2 {e.i} {e.j} "
                    f"{e.measurement[0]:.9g} {e.measurement[1]:.9g} "
                    f"{e.measurement[2]:.9g} {vals}\n"
                )
            for e in graph.landmark_edges:
                m = e.information
                f.write(
                    f"EDGE_SE2_XY {e.i} {e.j} "
                    f"{e.measurement[0]:.9g} {e.measurement[1]:.9g} "
                    f"{m[0, 0]:.9g} {m[0, 1]:.9g} {m[1, 1]:.9g}\n"
                )
        for vid in sorted(graph.fixed):
            f.write(f"FIX {vid}\n")


def save_pose_graph(path: str, optimizer, graph: Optional[G2oGraph] = None) -> None:
    """Write an optimizer's CURRENT poses (and landmarks) as a g2o file:
    3-D for a :class:`PoseGraphOptimizer` or ``PoseLandmarkOptimizer``,
    2-D for a :class:`PoseGraphOptimizer2D` or ``PoseLandmark2DOptimizer``.

    With ``graph`` (the G2oGraph it was loaded from), the original edges
    and information matrices are kept and only vertex and landmark
    estimates are replaced. Without it, edges and observations are rebuilt
    from the optimizer's records with unit information."""
    landmarks = hasattr(optimizer, "landmark_indices")
    if graph is not None:
        out = G2oGraph(
            dim=graph.dim,
            edges=graph.edges,
            fixed=set(graph.fixed),
            landmark_edges=graph.landmark_edges,
        )
        for vid in graph.vertices:
            out.vertices[vid] = _vertex_vec(optimizer, vid, graph.dim)
        for lid in graph.landmarks:
            out.landmarks[lid] = (
                np.asarray(optimizer.get_landmark(lid), np.float64)
                if landmarks else graph.landmarks[lid]
            )
        write_g2o(path, out)
        return
    dim = 2 if isinstance(optimizer, (PoseGraphOptimizer2D, PoseLandmark2DOptimizer)) else 3
    out = G2oGraph(dim=dim)
    for vid in optimizer.pose_indices():
        out.vertices[vid] = _vertex_vec(optimizer, vid, dim)
    for c in optimizer.constraints():
        if dim == 3:
            rel = c["relative_pose"]
            meas = np.concatenate([rel.translation, rel.quaternion()])
            info = np.eye(6)
        else:
            meas = np.asarray(c["relative_xyt"], np.float64)
            info = np.eye(3)
        out.edges.append(G2oEdge(c["reference_index"], c["query_index"], meas, info))
    if landmarks:
        for lid in optimizer.landmark_indices():
            out.landmarks[lid] = np.asarray(optimizer.get_landmark(lid), np.float64)
        for o in optimizer.observations():
            out.landmark_edges.append(G2oEdge(
                o["pose_index"], o["landmark_index"], np.asarray(o["measurement"], np.float64),
                np.eye(3 if dim == 3 else 2),
            ))
    write_g2o(path, out)


def _vertex_vec(optimizer, vid: int, dim: int) -> np.ndarray:
    if dim == 3:
        pose = optimizer.get_pose(vid)
        return np.concatenate([pose.translation, np_rotmat_to_quat(pose.rotation)])
    return np.asarray(optimizer.get_pose(vid), np.float64)
