"""SE(3) relative-pose (pose-graph edge) factor (PyTorch port of the JAX
package's ``ops/relative_pose.py``).

Residual per constraint (reference:
pose_graph_optimizer/ceres_cost_functor.h:44-52), with poses parameterized
in ambient coordinates (position p (3,), quaternion q (4,) wxyz) like the
reference's Ceres formulation (which sets NO quaternion manifold:
quaternions drift off the unit sphere during the solve and are renormalized
on write-back, pose_graph_optimizer.h:89-101):

    r_t = (p_q - p_r) - R(q_r) t_rel                (3,)
    r_q = 2 * vec(q_q^* (x) q_r (x) q_rel)          (3,)

Switchable-constraint variant for loop closures (ceres_cost_functor.h:83-97):
the 6-D residual is scaled by the switch variable s and a penalty row
(1 - s) * 1e-9 is appended (residual dim 7).

The Jacobian blocks are closed-form (:func:`edge_residuals_and_jacobians`);
the tests hold them to ``torch.func.jacfwd`` of :func:`edge_residuals`.
Functions are batched over edges and dtype-polymorphic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import lie
from ..core.lie import np_quat_conjugate, np_quat_left_matrix, np_quat_multiply

Tensor = torch.Tensor

SWITCH_PENALTY_SCALE = 1e-9  # reference: ceres_cost_functor.h:97

__all__ = [
    "SWITCH_PENALTY_SCALE",
    "PoseGraphEdges",
    "apply_sqrt_info",
    "stack_sqrt_info",
    "relative_pose_residual",
    "switchable_residual",
    "edge_residuals",
    "edge_residuals_and_jacobians",
    "np_edge_residuals_and_jacobians",
    "np_quat_left_matrix",
    "np_quat_conjugate",
    "np_quat_multiply",
]


class PoseGraphEdges(NamedTuple):
    """SoA batch of constraints (reference: pose_graph_optimizer/types.h:11-19)."""

    reference_indices: Tensor  # (E,) int64
    query_indices: Tensor  # (E,) int64
    relative_translations: Tensor  # (E, 3) t_rel
    relative_quaternions: Tensor  # (E, 4) q_rel (w, x, y, z)
    is_loop: Tensor  # (E,) 1.0 for loop (switchable) constraints
    mask: Tensor  # (E,)
    # optional sqrt-information S with S^T S = Omega whitening the 6-D
    # residual r -> S r: (E, 6) diagonal rows (translation rows 0-2,
    # rotation rows 3-5) or (E, 6, 6) full matrices; None = unit
    # information (the reference's behavior). The switch penalty row is
    # never whitened (a prior on s, not a measurement).
    sqrt_info: Optional[Tensor] = None

    @property
    def num_edges(self) -> int:
        return self.reference_indices.shape[0]


def apply_sqrt_info(w, r, *jacobians):
    """Whiten a residual batch and its Jacobian blocks.

    ``w`` is a batched sqrt-information: (E, d) diagonal rows or (E, d, d)
    full matrices; ``r`` is (E, d); each Jacobian is (E, d, n). Works for
    numpy and torch inputs alike. Returns (r', jac0', jac1', ...)."""
    if w.ndim == 2:
        out = [r * w]
        out += [J * w[:, :, None] for J in jacobians]
    else:
        einsum = torch.einsum if isinstance(r, torch.Tensor) else np.einsum
        out = [einsum("eij,ej->ei", w, r)]
        out += [einsum("eij,ejn->ein", w, J) for J in jacobians]
    return out[0] if not jacobians else tuple(out)


def stack_sqrt_info(entries, dim: int):
    """Stack per-edge sqrt-info specs (each None | (dim,) diagonal |
    (dim, dim) matrix) into the batched numpy form the edge structs take:
    None if all None, (E, dim) if all diagonal, else (E, dim, dim) with
    diagonal entries promoted to matrices."""
    if all(e is None for e in entries):
        return None
    if all(e is None or np.asarray(e).ndim == 1 for e in entries):
        return np.stack(
            [np.ones(dim) if e is None else np.asarray(e, np.float64) for e in entries]
        )
    out = np.zeros((len(entries), dim, dim))
    for k, e in enumerate(entries):
        if e is None:
            out[k] = np.eye(dim)
        else:
            a = np.asarray(e, np.float64)
            out[k] = np.diag(a) if a.ndim == 1 else a
    return out


def relative_pose_residual(
    p_ref: Tensor, q_ref: Tensor, p_query: Tensor, q_query: Tensor,
    t_rel: Tensor, q_rel: Tensor,
) -> Tensor:
    """6-D residual of one edge, quaternions normalized before use.

    A deliberate deviation from the reference functor (which feeds raw
    ambient quaternions to Eigen, ceres_cost_functor.h:44-52): normalizing
    makes quaternion scale an exact gauge direction (handled by the
    solver's Tikhonov floor) and the renormalize-on-write-back step
    residual-preserving."""
    q_ref = lie.quat_normalize(q_ref)
    q_query = lie.quat_normalize(q_query)
    r_t = (p_query - p_ref) - lie.quat_rotate(q_ref, t_rel)
    err_q = lie.quat_multiply(lie.quat_multiply(lie.quat_conjugate(q_query), q_ref), q_rel)
    r_q = 2.0 * err_q[..., 1:]
    return torch.cat([r_t, r_q], dim=-1)


def switchable_residual(
    p_ref: Tensor, q_ref: Tensor, p_query: Tensor, q_query: Tensor,
    t_rel: Tensor, q_rel: Tensor, switch: Tensor,
    penalty_scale: float = SWITCH_PENALTY_SCALE,
) -> Tensor:
    """7-D switchable-constraint residual (reference:
    ceres_cost_functor.h:83-97); ``switch`` is (...,)."""
    r6 = relative_pose_residual(p_ref, q_ref, p_query, q_query, t_rel, q_rel)
    r6 = r6 * switch[..., None]
    penalty = (1.0 - switch) * penalty_scale
    return torch.cat([r6, penalty[..., None]], dim=-1)


def edge_residuals(
    positions: Tensor,  # (N, 3)
    quaternions: Tensor,  # (N, 4)
    switches: Tensor,  # (E,)
    edges: PoseGraphEdges,
    penalty_scale: float = SWITCH_PENALTY_SCALE,
) -> Tensor:
    """Batched per-edge residuals (E, 7).

    Odometry edges use the plain 6-D residual with a zero seventh row;
    loop edges the switchable form, selected elementwise by ``is_loop``."""
    p_ref = positions[edges.reference_indices]
    q_ref = quaternions[edges.reference_indices]
    p_query = positions[edges.query_indices]
    q_query = quaternions[edges.query_indices]

    r6 = relative_pose_residual(
        p_ref, q_ref, p_query, q_query,
        edges.relative_translations, edges.relative_quaternions,
    )
    if edges.sqrt_info is not None:
        r6 = apply_sqrt_info(edges.sqrt_info, r6)
    loop = edges.is_loop > 0
    scaled = torch.where(loop[:, None], r6 * switches[:, None], r6)
    penalty = torch.where(loop, (1.0 - switches) * penalty_scale, torch.zeros_like(switches))
    r = torch.cat([scaled, penalty[:, None]], dim=-1)
    return r * edges.mask[:, None]


def _quat_left_matrix(a: Tensor) -> Tensor:
    """L(a) with a (x) b = L(a) @ b, batched over leading dims; wxyz."""
    w, x, y, z = a.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], dim=-1),
            torch.stack([x, w, -z, y], dim=-1),
            torch.stack([y, z, w, -x], dim=-1),
            torch.stack([z, -y, x, w], dim=-1),
        ],
        dim=-2,
    )


def _quat_right_matrix(b: Tensor) -> Tensor:
    """R(b) with a (x) b = R(b) @ a, batched over leading dims; wxyz."""
    w, x, y, z = b.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], dim=-1),
            torch.stack([x, w, z, -y], dim=-1),
            torch.stack([y, -z, w, x], dim=-1),
            torch.stack([z, y, -x, w], dim=-1),
        ],
        dim=-2,
    )


def _normalize_jacobian(q: Tensor) -> Tensor:
    """d(q/|q|)/dq = (I - n n^T) / |q|, batched: (..., 4, 4)."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    n = q / norm
    eye = torch.eye(4, dtype=q.dtype, device=q.device)
    return (eye - n[..., :, None] * n[..., None, :]) / norm[..., None]


def _skew_batch(v: Tensor) -> Tensor:
    """[v]_x batched: (..., 3) -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _rotate_jacobian_wrt_quat(n: Tensor, v: Tensor) -> Tensor:
    """d(R(n) v)/dn for UNIT quaternion n (..., 4) and vector v (..., 3):
    (..., 3, 4). From R(n)v = v + 2w (u x v) + 2 u x (u x v):
    d/dw = 2 (u x v); d/du = -2w [v]_x - 2[u x v]_x - 2[u]_x [v]_x."""
    w = n[..., 0]
    u = n[..., 1:]
    uxv = torch.linalg.cross(u, v, dim=-1)
    d_dw = 2.0 * uxv
    d_du = (
        -2.0 * w[..., None, None] * _skew_batch(v)
        - 2.0 * _skew_batch(uxv)
        - 2.0 * _skew_batch(u) @ _skew_batch(v)
    )
    return torch.cat([d_dw[..., :, None], d_du], dim=-1)


def edge_residuals_and_jacobians(
    positions: Tensor,
    quaternions: Tensor,
    switches: Tensor,
    edges: PoseGraphEdges,
    penalty_scale: float = SWITCH_PENALTY_SCALE,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-edge residuals and closed-form Jacobian blocks.

    The residual is bilinear in the quaternions (products are the linear
    maps L(a)/R(b)); the only nonlinearities are the normalization, with
    Jacobian (I - n n^T)/|q|, and R(q) t_rel, with the classic 3x4 closed
    form.

    Returns:
      r       (E, 7)
      J_ref   (E, 7, 7)  w.r.t. (p_ref, q_ref)
      J_query (E, 7, 7)  w.r.t. (p_query, q_query)
      J_s     (E, 7)     w.r.t. the switch variable
    """
    dtype, device = positions.dtype, positions.device
    E = edges.num_edges
    p_ref = positions[edges.reference_indices]
    q_ref = quaternions[edges.reference_indices]
    p_query = positions[edges.query_indices]
    q_query = quaternions[edges.query_indices]
    t_rel = edges.relative_translations
    q_rel = edges.relative_quaternions

    n_ref = lie.quat_normalize(q_ref)
    n_query = lie.quat_normalize(q_query)
    Dn_ref = _normalize_jacobian(q_ref)  # (E, 4, 4)
    Dn_query = _normalize_jacobian(q_query)

    r_t = (p_query - p_ref) - lie.quat_rotate(n_ref, t_rel)  # (E, 3)
    B = lie.quat_multiply(n_ref, q_rel)  # (E, 4)
    err_q = lie.quat_multiply(lie.quat_conjugate(n_query), B)
    r_q = 2.0 * err_q[..., 1:]
    r6 = torch.cat([r_t, r_q], dim=-1)

    # d r_t / d n_ref, chained through the normalization
    drt_dqref = -(_rotate_jacobian_wrt_quat(n_ref, t_rel) @ Dn_ref)  # (E, 3, 4)
    # d r_q / d n_ref = 2 V L(conj(n_query)) R(q_rel); V selects vec rows
    Lcq = _quat_left_matrix(lie.quat_conjugate(n_query))
    Rrel = _quat_right_matrix(q_rel)
    drq_dqref = 2.0 * (Lcq @ Rrel)[..., 1:, :] @ Dn_ref
    # d r_q / d n_query = 2 V R(B) C with C = conjugation sign flip
    RB = _quat_right_matrix(B)
    conj_sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype, device=device)
    drq_dqquery = 2.0 * (RB[..., 1:, :] * conj_sign) @ Dn_query

    eye3 = torch.eye(3, dtype=dtype, device=device).expand(E, 3, 3)
    zero33 = torch.zeros((E, 3, 3), dtype=dtype, device=device)
    zero34 = torch.zeros((E, 3, 4), dtype=dtype, device=device)
    J6_ref = torch.cat(
        [torch.cat([-eye3, drt_dqref], dim=-1), torch.cat([zero33, drq_dqref], dim=-1)],
        dim=-2,
    )  # (E, 6, 7)
    J6_query = torch.cat(
        [torch.cat([eye3, zero34], dim=-1), torch.cat([zero33, drq_dqquery], dim=-1)],
        dim=-2,
    )

    if edges.sqrt_info is not None:
        r6, J6_ref, J6_query = apply_sqrt_info(edges.sqrt_info, r6, J6_ref, J6_query)

    # switchable scaling: loop rows 0-5 are s * r6 (d/dpose = s * J6,
    # d/ds = r6); the penalty row (1 - s) * scale has d/ds = -scale
    loop = edges.is_loop > 0
    s = torch.where(loop, switches, torch.ones_like(switches))
    m = edges.mask
    zero = torch.zeros((), dtype=dtype, device=device)
    penalty = torch.where(loop, (1.0 - switches) * penalty_scale, zero)
    r = torch.cat([r6 * s[:, None], penalty[:, None]], dim=-1) * m[:, None]

    sm = (s * m)[:, None, None]
    zero17 = torch.zeros((E, 1, 7), dtype=dtype, device=device)
    J_ref = torch.cat([J6_ref * sm, zero17], dim=-2)
    J_query = torch.cat([J6_query * sm, zero17], dim=-2)
    J_s = torch.cat(
        [
            torch.where(loop[:, None], r6, zero),
            torch.where(loop, zero - penalty_scale, zero)[:, None],
        ],
        dim=-1,
    ) * m[:, None]
    return r, J_ref, J_query, J_s


def np_edge_residuals_and_jacobians(
    positions,  # (P, 3) float64
    quaternions,  # (P, 4)
    switches,  # (E,)
    ref_idx,  # (E,) int
    qry_idx,  # (E,) int
    rel_t,  # (E, 3)
    rel_q,  # (E, 4)
    is_loop,  # (E,) float
    penalty_scale: float = SWITCH_PENALTY_SCALE,
    sqrt_info=None,  # optional (E, 6) diagonal or (E, 6, 6) whitening
):
    """Numpy twin of :func:`edge_residuals_and_jacobians` (same math, same
    conventions, unmasked) for host-side linearization."""
    E = len(ref_idx)
    q_ref = quaternions[ref_idx]
    q_qry = quaternions[qry_idx]
    p_ref = positions[ref_idx]
    p_qry = positions[qry_idx]

    def normalize(q):
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    def right(b):
        w, x, y, z = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack(
            [
                np.stack([w, -x, -y, -z], -1),
                np.stack([x, w, z, -y], -1),
                np.stack([y, -z, w, x], -1),
                np.stack([z, y, -x, w], -1),
            ],
            -2,
        )

    def qrot(n, v):
        w = n[..., :1]
        u = n[..., 1:]
        uxv = np.cross(u, v)
        return v + 2.0 * w * uxv + 2.0 * np.cross(u, uxv)

    def skew(v):
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        o = np.zeros_like(x)
        return np.stack(
            [np.stack([o, -z, y], -1), np.stack([z, o, -x], -1), np.stack([-y, x, o], -1)],
            -2,
        )

    def dnorm(q):
        norm = np.linalg.norm(q, axis=-1, keepdims=True)
        n = q / norm
        return (np.eye(4) - n[..., :, None] * n[..., None, :]) / norm[..., None]

    def drot_dn(n, v):
        w = n[..., 0]
        u = n[..., 1:]
        uxv = np.cross(u, v)
        d_du = -2.0 * w[..., None, None] * skew(v) - 2.0 * skew(uxv) - 2.0 * skew(u) @ skew(v)
        return np.concatenate([2.0 * uxv[..., :, None], d_du], axis=-1)

    n_ref = normalize(q_ref)
    n_qry = normalize(q_qry)
    Dn_ref = dnorm(q_ref)
    Dn_qry = dnorm(q_qry)

    r_t = (p_qry - p_ref) - qrot(n_ref, rel_t)
    B = np_quat_multiply(n_ref, rel_q)
    err_q = np_quat_multiply(np_quat_conjugate(n_qry), B)
    r6 = np.concatenate([r_t, 2.0 * err_q[..., 1:]], axis=-1)

    drt_dqref = -(drot_dn(n_ref, rel_t) @ Dn_ref)
    drq_dqref = 2.0 * (np_quat_left_matrix(np_quat_conjugate(n_qry)) @ right(rel_q))[..., 1:, :] @ Dn_ref
    conj_sign = np.array([1.0, -1.0, -1.0, -1.0])
    drq_dqqry = 2.0 * (right(B)[..., 1:, :] * conj_sign) @ Dn_qry

    eye3 = np.broadcast_to(np.eye(3), (E, 3, 3))
    z33 = np.zeros((E, 3, 3))
    z34 = np.zeros((E, 3, 4))
    J6_ref = np.concatenate(
        [np.concatenate([-eye3, drt_dqref], axis=-1), np.concatenate([z33, drq_dqref], axis=-1)],
        axis=-2,
    )
    J6_qry = np.concatenate(
        [np.concatenate([eye3, z34], axis=-1), np.concatenate([z33, drq_dqqry], axis=-1)],
        axis=-2,
    )

    if sqrt_info is not None:
        r6, J6_ref, J6_qry = apply_sqrt_info(sqrt_info, r6, J6_ref, J6_qry)

    loop = is_loop > 0
    s = np.where(loop, switches, 1.0)
    penalty = np.where(loop, (1.0 - switches) * penalty_scale, 0.0)
    r = np.concatenate([r6 * s[:, None], penalty[:, None]], axis=-1)

    z17 = np.zeros((E, 1, 7))
    J_ref = np.concatenate([J6_ref * s[:, None, None], z17], axis=-2)
    J_qry = np.concatenate([J6_qry * s[:, None, None], z17], axis=-2)
    J_s = np.concatenate(
        [np.where(loop[:, None], r6, 0.0), np.where(loop, -penalty_scale, 0.0)[:, None]],
        axis=-1,
    )
    return r, J_ref, J_qry, J_s
