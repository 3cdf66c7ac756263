"""Pose-graph initialization: spanning-tree composition and chordal
(rotation-averaging) relaxation (PyTorch port of the JAX package's
``solvers/graph_init.py``).

LM on a pose graph only converges to the basin it starts in; the classic
initializers (g2o's spanning tree, GTSAM's ``InitializePose3``/chordal,
Martinec & Pajdla CVPR'07, Carlone et al. ICRA'15) are the difference
between solving sphere- and city-scale graphs and stalling in a fold. The
reference has no initializer (its fixture starts from hand-noised ground
truth); this module provides both:

- ``spanning_tree_init``: BFS from the anchors composing measured relative
  poses along tree edges, on the host (an irregular graph walk).
- ``chordal_init``: two matrix-free linear least squares solved by
  Jacobi-preconditioned CG on the device, every per-pose sum an
  ``index_put_(accumulate=True)``:
    1. rotations: min sum_e ||X_q - X_i R_e||_F^2 over unconstrained 3x3
       matrices (the chordal relaxation), anchored at the fixed poses,
       then projected to SO(3) by SVD;
    2. translations: min sum_e ||t_q - t_i - R_i t_e||^2 with the projected
       rotations fixed (a graph-Laplacian solve, 3 right-hand sides).

The SE(2) pair (``spanning_tree_init_2d``, ``chordal_init_2d``) averages
rotations as unit vectors (cos theta, sin theta).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.pose import (
    np_quat_to_rotmat,
    np_quat_to_rotmat_batch,
    np_rotmat_to_quat,
    np_rotmat_to_quat_batch,
)
from .pose_graph import _pcg, _scatter_add

Tensor = torch.Tensor


def spanning_tree_init(
    ref_idx: np.ndarray,  # (E,) int
    query_idx: np.ndarray,  # (E,) int
    rel_q: np.ndarray,  # (E, 4) wxyz, T_ref<-query rotation
    rel_t: np.ndarray,  # (E, 3)
    num_poses: int,
    anchors: Dict[int, Tuple[np.ndarray, np.ndarray]],  # i -> (R (3,3), t)
    edge_priority: Optional[np.ndarray] = None,  # lower = preferred
) -> Tuple[np.ndarray, np.ndarray]:
    """Compose measured relative poses along a BFS spanning tree from the
    anchor(s). Returns ``(positions (P, 3), quaternions (P, 4))``.

    ``edge_priority`` orders each node's adjacency (e.g. odometry edges
    first so the tree follows the trajectory chain and loops only bridge
    components). Unreachable poses keep identity."""
    E = len(ref_idx)
    order = np.argsort(edge_priority, kind="stable") if edge_priority is not None else np.arange(E)
    adj: Dict[int, list] = {}
    for e in order:
        i, j = int(ref_idx[e]), int(query_idx[e])
        adj.setdefault(i, []).append((j, e, +1))
        adj.setdefault(j, []).append((i, e, -1))

    R = np.tile(np.eye(3), (num_poses, 1, 1))
    t = np.zeros((num_poses, 3))
    seen = np.zeros(num_poses, bool)
    frontier = []
    for a, (Ra, ta) in anchors.items():
        R[a], t[a] = Ra, ta
        seen[a] = True
        frontier.append(a)

    Re = np.stack([np_quat_to_rotmat(q) for q in rel_q]) if E else np.zeros((0, 3, 3))
    while frontier:
        nxt = []
        for i in frontier:
            for j, e, sgn in adj.get(i, ()):  # T_ref<-query
                if seen[j]:
                    continue
                if sgn > 0:  # i = ref, j = query: X_j = X_i * T_e
                    R[j] = R[i] @ Re[e]
                    t[j] = t[i] + R[i] @ rel_t[e]
                else:  # i = query, j = ref: X_j = X_i * T_e^-1
                    R[j] = R[i] @ Re[e].T
                    t[j] = t[i] - R[j] @ rel_t[e]
                seen[j] = True
                nxt.append(j)
        frontier = nxt
    quats = np.stack([np_rotmat_to_quat(r) for r in R])
    return t, quats


def _project_so3(X: Tensor) -> Tensor:
    """Closest rotations (Frobenius) to a batch of 3x3 matrices. U D V^T
    does not depend on the signs the SVD picks where the singular values
    are distinct."""
    U, _, Vt = torch.linalg.svd(X)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[:, None, :]) @ Vt


def _cg_graph_solve(op, b: Tensor, diag: Tensor, iters: int, tol: float) -> Tensor:
    """Jacobi-preconditioned CG from x0 = 0 with the stopping rule of
    ``jax.scipy.sparse.linalg.cg(op, b, M=, tol=, maxiter=)``; ``diag``
    broadcasts against b."""
    inv_diag = 1.0 / torch.clamp(diag, min=1.0)
    (x,) = _pcg(lambda v: (op(v[0]),), (b,), lambda v: (v[0] * inv_diag,), iters, tol)
    return x


def _segment_sum(values: Tensor, idx: Tensor, P: int) -> Tensor:
    return _scatter_add(values.new_zeros((P,) + values.shape[1:]), idx, values)


def _degrees(ref_idx, query_idx, P: int) -> np.ndarray:
    deg = np.zeros(P)
    np.add.at(deg, ref_idx, 1.0)
    np.add.at(deg, query_idx, 1.0)
    return deg


def chordal_init(
    ref_idx: np.ndarray,
    query_idx: np.ndarray,
    rel_q: np.ndarray,
    rel_t: np.ndarray,
    num_poses: int,
    anchors: Dict[int, Tuple[np.ndarray, np.ndarray]],
    cg_iterations: int = 300,
    cg_tol: float = 1e-8,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Chordal initialization. Returns ``(positions (P, 3), quaternions
    (P, 4))``; anchored poses are returned exactly as given.

    ``dtype``: compute precision of the two CG solves, default float64 (the
    dtype of the numpy inputs, as the JAX package defaults to the incoming
    array dtype). ``device``: where they run, default "cuda"; raises
    without a GPU unless "cpu" is asked for."""
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    P, E = num_poses, len(ref_idx)
    ri = torch.as_tensor(np.asarray(ref_idx, np.int64), device=device)
    qi = torch.as_tensor(np.asarray(query_idx, np.int64), device=device)
    tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    Re = tensor(np_quat_to_rotmat_batch(rel_q) if E else np.zeros((0, 3, 3)))
    te = tensor(np.asarray(rel_t).reshape(E, 3))

    free = np.ones(P)
    Xa_np = np.zeros((P, 3, 3))
    ta_np = np.zeros((P, 3))
    for a, (Ra, ta) in anchors.items():
        free[a] = 0.0
        Xa_np[a] = Ra
        ta_np[a] = ta
    m = tensor(free)[:, None, None]
    Xa, ta = tensor(Xa_np), tensor(ta_np)
    # degree of each pose = diagonal of both normal operators
    deg = tensor(_degrees(ref_idx, query_idx, P))

    def rot_normal_op(V):
        V = V * m
        d = V[qi] - V[ri] @ Re
        out = _segment_sum(d, qi, P) - _segment_sum(d @ Re.mT, ri, P)
        return out * m

    # RHS: -A^T r(Xa) restricted to free slots
    d0 = Xa[qi] - Xa[ri] @ Re
    b = -(_segment_sum(d0, qi, P) - _segment_sum(d0 @ Re.mT, ri, P)) * m
    Xf = _cg_graph_solve(rot_normal_op, b, deg[:, None, None], cg_iterations, cg_tol)
    R = _project_so3(Xf * m + Xa)
    # anchors exactly (projection of an exact rotation is itself, but keep
    # them bit-identical to the caller's values)
    R = R * m + Xa

    # translations with rotations fixed
    mt = m[:, :, 0]
    c = (R[ri] @ te[:, :, None])[..., 0]  # R_i t_e

    def tr_normal_op(v):
        v = v * mt
        d = v[qi] - v[ri]
        return (_segment_sum(d, qi, P) - _segment_sum(d, ri, P)) * mt

    d0t = ta[qi] - ta[ri] - c
    bt = -(_segment_sum(d0t, qi, P) - _segment_sum(d0t, ri, P)) * mt
    tf = _cg_graph_solve(tr_normal_op, bt, deg[:, None], cg_iterations, cg_tol)
    t = tf * mt + ta
    # one device-to-host copy
    out = torch.cat([t.reshape(-1), R.reshape(-1)]).cpu().numpy().astype(np.float64)
    t_np = out[: 3 * P].reshape(P, 3)
    R_np = out[3 * P:].reshape(P, 3, 3)
    return t_np, np_rotmat_to_quat_batch(R_np)


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------


def _rot2(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def spanning_tree_init_2d(
    ref_idx: np.ndarray,
    query_idx: np.ndarray,
    rel_xyt: np.ndarray,  # (E, 3) (dx, dy, dtheta), T_ref<-query
    num_poses: int,
    anchors: Dict[int, np.ndarray],  # i -> (x, y, theta)
    edge_priority: Optional[np.ndarray] = None,
) -> np.ndarray:
    """BFS spanning-tree composition for SE(2); returns xyt (P, 3)."""
    E = len(ref_idx)
    order = np.argsort(edge_priority, kind="stable") if edge_priority is not None else np.arange(E)
    adj: Dict[int, list] = {}
    for e in order:
        i, j = int(ref_idx[e]), int(query_idx[e])
        adj.setdefault(i, []).append((j, e, +1))
        adj.setdefault(j, []).append((i, e, -1))

    xyt = np.zeros((num_poses, 3))
    seen = np.zeros(num_poses, bool)
    frontier = []
    for a, v in anchors.items():
        xyt[a] = v
        seen[a] = True
        frontier.append(a)
    while frontier:
        nxt = []
        for i in frontier:
            for j, e, sgn in adj.get(i, ()):
                if seen[j]:
                    continue
                dx, dy, dth = rel_xyt[e]
                if sgn > 0:
                    xyt[j, :2] = xyt[i, :2] + _rot2(xyt[i, 2]) @ (dx, dy)
                    xyt[j, 2] = xyt[i, 2] + dth
                else:
                    xyt[j, 2] = xyt[i, 2] - dth
                    xyt[j, :2] = xyt[i, :2] - _rot2(xyt[j, 2]) @ (dx, dy)
                seen[j] = True
                nxt.append(j)
        frontier = nxt
    xyt[:, 2] = np.arctan2(np.sin(xyt[:, 2]), np.cos(xyt[:, 2]))
    return xyt


def chordal_init_2d(
    ref_idx: np.ndarray,
    query_idx: np.ndarray,
    rel_xyt: np.ndarray,
    num_poses: int,
    anchors: Dict[int, np.ndarray],
    cg_iterations: int = 300,
    cg_tol: float = 1e-8,
    device="cuda",
) -> np.ndarray:
    """SE(2) chordal initialization in float64; returns xyt (P, 3).

    Rotations as unit vectors v_i = (cos th, sin th): the relaxation
    min sum_e ||v_q - R(dth_e) v_i||^2 is linear (complex rotation
    averaging in real form), then normalized back to the circle; the
    translation Laplacian follows with rotations fixed. ``device``: where
    the CG solves run, default "cuda"."""
    device = resolve_device(device)
    f64 = torch.float64
    P, E = num_poses, len(ref_idx)
    ri = torch.as_tensor(np.asarray(ref_idx, np.int64), device=device)
    qi = torch.as_tensor(np.asarray(query_idx, np.int64), device=device)
    tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=device)
    if E:
        th = rel_xyt[:, 2]
        c_, s_ = np.cos(th), np.sin(th)
        Re_np = np.empty((E, 2, 2))
        Re_np[:, 0, 0] = c_
        Re_np[:, 0, 1] = -s_
        Re_np[:, 1, 0] = s_
        Re_np[:, 1, 1] = c_
    else:
        Re_np = np.zeros((0, 2, 2))
    Re = tensor(Re_np)
    te = tensor(rel_xyt[:, :2] if E else np.zeros((0, 2)))

    free = np.ones(P)
    va_np = np.zeros((P, 2))
    ta_np = np.zeros((P, 2))
    for a, v in anchors.items():
        free[a] = 0.0
        va_np[a] = (np.cos(v[2]), np.sin(v[2]))
        ta_np[a] = v[:2]
    m = tensor(free)[:, None]
    va, ta = tensor(va_np), tensor(ta_np)
    deg = tensor(_degrees(ref_idx, query_idx, P))[:, None]

    rot = lambda M, x: (M @ x[:, :, None])[..., 0]  # R x per edge
    rot_t = lambda M, x: (x[:, None, :] @ M)[:, 0]  # R^T x per edge

    def rot_op(v):
        v = v * m
        d = v[qi] - rot(Re, v[ri])
        return (_segment_sum(d, qi, P) - _segment_sum(rot_t(Re, d), ri, P)) * m

    d0 = va[qi] - rot(Re, va[ri])
    b = -(_segment_sum(d0, qi, P) - _segment_sum(rot_t(Re, d0), ri, P)) * m
    vf = _cg_graph_solve(rot_op, b, deg, cg_iterations, cg_tol)
    v = vf * m + va
    v = v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=1e-12)
    v = v * m + va

    # translations: t_q - t_i - R_i t_e with R_i from the unit vectors
    Ri = torch.stack(
        [torch.stack([v[:, 0], -v[:, 1]], dim=1), torch.stack([v[:, 1], v[:, 0]], dim=1)],
        dim=1,
    )  # (P, 2, 2)
    c = rot(Ri[ri], te)

    def tr_op(w):
        w = w * m
        d = w[qi] - w[ri]
        return (_segment_sum(d, qi, P) - _segment_sum(d, ri, P)) * m

    d0t = ta[qi] - ta[ri] - c
    bt = -(_segment_sum(d0t, qi, P) - _segment_sum(d0t, ri, P)) * m
    tf = _cg_graph_solve(tr_op, bt, deg, cg_iterations, cg_tol)
    t = tf * m + ta
    out = torch.cat([v, t], dim=1).cpu().numpy()
    theta = np.arctan2(out[:, 1], out[:, 0])
    return np.concatenate([out[:, 2:], theta[:, None]], axis=1)
