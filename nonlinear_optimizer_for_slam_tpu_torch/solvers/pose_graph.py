"""SE(3) and SE(2) pose-graph optimizers (PyTorch port of the JAX
package's ``solvers/pose_graph.py``): batched relative-pose Gauss-Newton/LM.

Implements what the reference's analytic pose-graph path left as a TODO
stub (pose_graph_optimizer_analytic.cc:12-51), with the reference's Ceres
semantics kept deliberately (pose_graph_optimizer_ceres.cc:15-69):

- poses parameterized in AMBIENT coordinates: position (3,) + quaternion
  (4,) with no manifold; the quaternion drifts off the unit sphere during
  the solve and is renormalized only on write-back
  (pose_graph_optimizer.h:89-101);
- loop-closure edges get a switchable constraint: the 6-D residual scaled
  by a free switch variable s plus a penalty row (1 - s) * penalty,
  residual dim 7 (ceres_cost_functor.h:83-97);
- gauge freedom fixed by marking poses constant, a 1e-8 Tikhonov floor on
  the damped system, and 500 LM iterations by default.

Every edge evaluates in one batch (closed-form 7x7 Jacobian blocks,
``ops/relative_pose.py``); the LM policy is the one ``solvers/lm`` loop.
Five linear solvers share it: "dense" assembles the (7P+L)^2 normal
matrix, "tridiag" solves chain-dominated graphs by cyclic reduction and a
Woodbury correction, "banded" solves loop-rich graphs by superblock
cyclic reduction after a reverse Cuthill-McKee ordering, "sparse" by the
nested-dissection multifrontal Cholesky (``solvers/multifrontal.py``) for
loop-rich graphs whose band is fat, and "cg" is the matrix-free
preconditioned CG path. "auto" picks among them (:func:`select_solver`).
With ``mesh=`` (a ``parallel.FactorMesh``) the CG path shards the edges
over the ranks of a ``torch.distributed`` group and sums every edge
reduction across them, and the sparse path partitions each tree level's
fronts over the ranks (``multifrontal.factor(mesh=)``).

``PoseGraphOptimizer2D`` is the SE(2) counterpart (x, y, theta poses, the
g2o EDGE_SE2 factor with the same switchable loops) with the dense,
banded, sparse and CG paths; ``initialize()`` on both optimizers runs the
spanning-tree or chordal initializer of ``solvers/graph_init.py``. Both
also answer ``covariance()`` (marginal pose blocks of the inverse
Gauss-Newton information, by a dense inverse, the banded selected-inverse
recurrence or the multifrontal selected inverse) and ``solve_batch()`` (B
instances of one topology on the dense path at once, each following its
serial solve).

Every sum of per-edge contributions into per-pose rows that may see the
same row twice is ``index_put_`` with ``accumulate=True``, which sums in
a fixed order (on CUDA it sorts the indices; no float atomics), or a
shift-add where the topology allows one; LM traces are compared across
solvers and runs.

API mirrors the reference base class (pose_graph_optimizer.h:21-108).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.options import Options
from ..core.pose import Pose, np_quat_to_rotmat
from ..ops.relative_pose import (
    SWITCH_PENALTY_SCALE,
    PoseGraphEdges,
    _normalize_jacobian,
    _quat_left_matrix,
    apply_sqrt_info,
    edge_residuals_and_jacobians,
    stack_sqrt_info,
)
from ..parallel import FactorMesh, all_sum, factor_sharding
from . import block_tridiag, lm, multifrontal

Tensor = torch.Tensor

class ConstraintType:
    """Reference: pose_graph_optimizer/types.h:11-13."""

    ODOMETRY = 0
    LOOP = 1


def _expand_sqrt_info_2d(sqrt_info) -> Optional[np.ndarray]:
    """(3,) = [x y theta] or full (3, 3) from None | scalar | (2,)
    (trans, rot) | (3,) | (3, 3) matrix."""
    if sqrt_info is None:
        return None
    a = np.asarray(sqrt_info, np.float64)
    if a.ndim == 2:
        if a.shape != (3, 3):
            raise ValueError(f"matrix sqrt_info must be (3, 3); got {a.shape}")
        return a.copy()
    w = a.reshape(-1)
    if w.size == 1:
        return np.full(3, w[0])
    if w.size == 2:
        return np.array([w[0], w[0], w[1]])
    if w.size == 3:
        return w.copy()
    raise ValueError(
        f"sqrt_info must be a scalar, (2,) (translation, rotation), "
        f"(3,) diagonal, or (3, 3) matrix; got shape {np.asarray(sqrt_info).shape}"
    )


def _expand_sqrt_info(sqrt_info) -> Optional[np.ndarray]:
    """Normalize a user sqrt-info spec to a (6,) f64 vector, a (6, 6)
    matrix, or None.

    Accepted: None, scalar, (2,) = (weight_t, weight_rot), (6,) full
    diagonal [x y z rx ry rz], or a full (6, 6) sqrt-information matrix S
    with S^T S = Omega (see :func:`sqrt_info_from_information`)."""
    if sqrt_info is None:
        return None
    a = np.asarray(sqrt_info, np.float64)
    if a.ndim == 2:
        if a.shape != (6, 6):
            raise ValueError(f"matrix sqrt_info must be (6, 6); got {a.shape}")
        return a.copy()
    w = a.reshape(-1)
    if w.size == 1:
        return np.full(6, w[0])
    if w.size == 2:
        return np.concatenate([np.full(3, w[0]), np.full(3, w[1])])
    if w.size == 6:
        return w.copy()
    raise ValueError(
        f"sqrt_info must be a scalar, (2,) (translation, rotation), "
        f"(6,) diagonal, or (6, 6) matrix; got shape {np.asarray(sqrt_info).shape}"
    )


def sqrt_info_from_information(information) -> np.ndarray:
    """Sqrt-information S (upper triangular, S^T S = Omega) from a
    symmetric positive-(semi)definite information matrix: Cholesky when PD,
    else an eigendecomposition square root with negative eigenvalues
    clamped to zero (rank-deficient priors are legal)."""
    omega = np.asarray(information, np.float64)
    omega = 0.5 * (omega + omega.T)
    try:
        return np.linalg.cholesky(omega).T
    except np.linalg.LinAlgError:
        lam, V = np.linalg.eigh(omega)
        lam = np.clip(lam, 0.0, None)
        return (V * np.sqrt(lam)) @ V.T


def edge_information_to_world(information, reference_rotation) -> np.ndarray:
    """Conjugate a measurement-frame edge information matrix into the
    world-frame translation-residual convention of the edge residual.

    A registration against a reference keyframe measures T_{ref<-query};
    its Gauss-Newton information lives in that measurement's right
    tangent, whose translation perturbations are vectors in the
    reference-keyframe frame. The edge residual ``r_t = (p_q - p_r) - R_ref
    t_rel`` expresses the same error in the world frame, so the
    frame-consistent edge information is

        Omega_world = blkdiag(R_ref, I) Omega blkdiag(R_ref, I)^T.

    The rotation block is already frame-consistent. ``reference_rotation``
    is the reference pose's world-rotation estimate at edge-build time.
    """
    R = np.asarray(reference_rotation, np.float64)
    if R.shape != (3, 3):
        raise ValueError(f"reference_rotation must be (3, 3); got {R.shape}")
    B = np.eye(6)
    B[:3, :3] = R
    omega = np.asarray(information, np.float64)
    return B @ omega @ B.T


# ---------------------------------------------------------------------------
# Shared pieces of the four solve paths
# ---------------------------------------------------------------------------


def _scatter_add(out: Tensor, indices, values: Tensor) -> Tensor:
    """``out[indices] += values`` with repeated indices summed in a fixed
    order (``index_put_`` with ``accumulate=True``: a sort on CUDA, no float
    atomics). ``indices`` is one index tensor or a tuple of them."""
    if not isinstance(indices, tuple):
        indices = (indices,)
    return out.index_put_(indices, values, accumulate=True)


def _bmv(A: Tensor, x: Tensor) -> Tensor:
    """Batched (..., m, n) @ (..., n) -> (..., m)."""
    return (A @ x[..., None])[..., 0]


def _btv(A: Tensor, y: Tensor) -> Tensor:
    """Batched A^T y: (..., m, n), (..., m) -> (..., n)."""
    return (y[..., None, :] @ A)[..., 0, :]


def _loop_slot(is_loop: Tensor, L: int) -> Tensor:
    """(E,) slot of each edge's switch: loops numbered in edge order (the
    value at a non-loop edge is only ever multiplied by zero)."""
    if L == 0:
        return torch.zeros(is_loop.shape, dtype=torch.long, device=is_loop.device)
    return torch.clamp(torch.cumsum((is_loop > 0).long(), 0) - 1, 0, L - 1)


class _Graph:
    """Per-solve constants shared by the solve paths (loop slots, the loop
    edges, the gauge masks) and the edge linearization. ``edges`` is a
    :class:`PoseGraphEdges` (SE(3): pose parameters (P, 7) = position and
    quaternion) or a :class:`PoseGraph2DEdges` (SE(2): (P, 3) = x, y,
    theta).

    ``loop_slot`` (E,) is given when ``edges`` is one rank's block of a
    sharded graph: the slots are numbered over the whole graph, on the
    host, and :meth:`per_switch` places this block's loop edges at their
    global slots (zeros elsewhere) for the sum across ranks."""

    def __init__(self, edges, free_mask: Tensor, P: int, L: int,
                 switch_penalty: float, edge_loss, loop_slot: Optional[Tensor] = None):
        self.edges, self.P, self.L = edges, P, L
        self.switch_penalty, self.edge_loss = switch_penalty, edge_loss
        self.E = edges.num_edges
        self.dtype, self.device = free_mask.dtype, free_mask.device
        self.ref_i = edges.reference_indices
        self.qry_i = edges.query_indices
        self.is_loop = edges.is_loop > 0
        self.sharded = loop_slot is not None
        self.loop_slot = loop_slot if self.sharded else _loop_slot(edges.is_loop, L)
        # each loop edge owns one slot (slots follow edge order), so the
        # per-switch sums are gathers of the loop edges' values
        self.loop_ids = torch.nonzero(self.is_loop)[:, 0]
        self.free_ref = free_mask[self.ref_i]
        self.free_qry = free_mask[self.qry_i]
        self.fixed_p = (1.0 - free_mask)[:, None]
        self.pose_rows = torch.cat([self.ref_i, self.qry_i])

    def per_switch(self, per_edge: Tensor) -> Tensor:
        """(E,) values of the loop edges, in slot order (L,)."""
        if self.sharded:
            out = per_edge.new_zeros(self.L)
            return out.index_put_((self.loop_slot[self.loop_ids],), per_edge[self.loop_ids])
        return per_edge[self.loop_ids]

    def accumulate_pose(self, contrib_ref: Tensor, contrib_qry: Tensor) -> Tensor:
        """Per-edge contributions at each edge's two poses summed per pose
        (P, ...), by one ``index_put_(accumulate=True)``."""
        out = contrib_ref.new_zeros((self.P,) + contrib_ref.shape[1:])
        return _scatter_add(out, self.pose_rows, torch.cat([contrib_ref, contrib_qry]))

    def linearize(self, pose_params: Tensor, switches: Tensor):
        """Residuals, gauge-masked Jacobian blocks and each edge's cost
        (E,), with the optional Ceres-style robust loss over each edge's
        squared norm."""
        if self.L:
            sw_full = switches[self.loop_slot]
        else:
            sw_full = torch.zeros(self.E, dtype=self.dtype, device=self.device)
        if isinstance(self.edges, PoseGraph2DEdges):
            r, J_ref, J_query, J_s = se2_edge_residuals_and_jacobians(
                pose_params, sw_full, self.edges, self.switch_penalty
            )
        else:
            r, J_ref, J_query, J_s = edge_residuals_and_jacobians(
                pose_params[:, :3], pose_params[:, 3:], sw_full, self.edges,
                self.switch_penalty,
            )
        # gauge fixing: fixed poses contribute no derivative columns
        J_ref = J_ref * self.free_ref[:, None, None]
        J_query = J_query * self.free_qry[:, None, None]
        if self.edge_loss is not None:
            rho, w, _ = self.edge_loss.evaluate(torch.sum(r * r, dim=1))
            cost = rho
            sqrt_w = torch.sqrt(w)
            r = r * sqrt_w[:, None]
            J_ref = J_ref * sqrt_w[:, None, None]
            J_query = J_query * sqrt_w[:, None, None]
            J_s = J_s * sqrt_w[:, None]
        else:
            cost = torch.sum(r * r, dim=1)
        return r, J_ref, J_query, J_s, cost

    def split_quadratic(self, accumulate_pose=None):
        """``eval_quadratic`` of the tridiag, banded, sparse and CG paths
        over (pose params (P, k), switches (L,)): the per-edge Jacobian
        blocks and diag(J^T J) as the operator, never H, and g = (g_p,
        g_s), with the per-pose sums by ``accumulate_pose(contrib_ref,
        contrib_qry)`` (default :meth:`accumulate_pose`)."""
        accumulate_pose = accumulate_pose or self.accumulate_pose

        def eval_quadratic(params):
            pose_params, switches = params
            r, J_ref, J_query, J_s, cost_e = self.linearize(pose_params, switches)
            g_p = accumulate_pose(_btv(J_ref, r), _btv(J_query, r))
            d_p = accumulate_pose(torch.sum(J_ref * J_ref, dim=1),
                                  torch.sum(J_query * J_query, dim=1))
            d_s = self.per_switch(torch.sum(J_s * J_s, dim=1))
            g_s = self.per_switch(torch.sum(J_s * r, dim=1))
            return (J_ref, J_query, J_s, d_p, d_s), (g_p, g_s), torch.sum(cost_e)

        return eval_quadratic

    def eliminate_switches(self, J_a: Tensor, J_b: Tensor, J_s: Tensor, d_s: Tensor,
                           g_s: Tensor, lam: Tensor, rows_ab: Tensor, b_p: Tensor):
        """Exact damped-Schur elimination of each loop edge's switch (its
        damped Schur complement is a rank-1 update of the edge's pose
        blocks). Adds (A^T c) g_s / gamma to ``b_p`` at the rows
        ``rows_ab`` in place and returns (1 / gamma per edge, 0 at non-loop
        edges; g_s at each edge; A_a^T c; A_b^T c)."""
        c = J_s
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        gamma = torch.sum(c * c, dim=1) + lam * d_s[self.loop_slot] + 1e-8
        inv_gamma = torch.where(self.is_loop, 1.0 / gamma, zero)
        Jac = _btv(J_a, c)  # (E, k) = A_a^T c
        Jbc = _btv(J_b, c)
        g_s_e = g_s[self.loop_slot]
        coef = inv_gamma * g_s_e
        _scatter_add(b_p, rows_ab, torch.cat([Jac * coef[:, None], Jbc * coef[:, None]]))
        return inv_gamma, g_s_e, Jac, Jbc

    def back_substitute(self, J_a: Tensor, J_b: Tensor, J_s: Tensor, dp_a: Tensor,
                        dp_b: Tensor, g_s_e: Tensor, inv_gamma: Tensor) -> Tensor:
        """Exact switch back-substitution ds = (-g_s - c^T A dp) / gamma."""
        v = _bmv(J_a, dp_a) + _bmv(J_b, dp_b)  # (E, r) = A_e dp
        ds_e = (-g_s_e - torch.sum(J_s * v, dim=1)) * inv_gamma
        return self.per_switch(ds_e)


def _solve_split(eval_quadratic, solve_linear, free_mask, pose0, switches0, options):
    """The LM loop over (pose params (P, k), switches (L,)) with a
    ``solve_linear`` step, shared by the tridiag, banded, sparse and CG
    paths. Returns (pose params, switches, summary)."""

    def retract(params, delta):
        pose_params, switches = params
        dp, ds = delta
        return (pose_params + dp * free_mask[:, None], switches + ds)

    (pose_params, switches), summary = lm.solve(
        eval_quadratic, retract, (pose0, switches0), options, solve_linear=solve_linear
    )
    return pose_params, switches, summary


# ---------------------------------------------------------------------------
# "dense": the (kP+L)^2 normal matrix
# ---------------------------------------------------------------------------


def _instances(edges, B: int, P: int):
    """B disjoint copies of one topology as one graph: instance b's pose
    indices are offset by b P, per-instance measurements ((B, E, ...)
    fields) are flattened instance by instance and the shared fields
    repeated. A graph with shared measurements at B = 1 is itself."""
    measured = ("relative_xyt",) if isinstance(edges, PoseGraph2DEdges) else (
        "relative_translations", "relative_quaternions")
    fields = edges._asdict()
    if B == 1 and fields[measured[0]].dim() == 2:
        return edges
    offset = P * torch.arange(B, device=edges.reference_indices.device)[:, None]
    for name, v in fields.items():
        if v is None:
            continue
        if name in ("reference_indices", "query_indices"):
            fields[name] = (v[None] + offset).reshape(-1)
        elif name in measured:
            fields[name] = v.expand((B,) + v.shape[-2:]).reshape((-1,) + v.shape[-1:])
        else:
            fields[name] = v.repeat((B,) + (1,) * (v.dim() - 1))
    return type(edges)(**fields)


def _pose_graph_solve(
    pose0,  # (B, P, k): [position (3), quaternion (4)] per pose, or (x, y, theta)
    switches0,  # (B, L)
    edges,  # PoseGraphEdges or PoseGraph2DEdges; measurements (E, ...) or (B, E, ...)
    free_mask,  # (P,) 1.0 = free pose, 0.0 = constant (gauge-fixed)
    switch_penalty: float,
    edge_loss,  # optional LossFunction robustifying each edge block
    num_poses: int,
    num_loops: int,
    options: Options,
    prior_sqrt=None,  # (6n, 6n) sqrt-information over TANGENT coords
    prior_mean=None,  # (n, 7) prior linearization point [p_lin, q_lin(unit)]
    prior_sel=None,  # (n,) pose indices the prior couples
    prior_offset=None,  # (6n,) residual offset c: r_p = S dphi(x) + c
    floor: float = 1e-8,  # Tikhonov floor on every diagonal entry
):
    """Dense direct path for B instances of one topology (the serial solve
    is B = 1): block assembly of B (kP+L)^2 normal matrices (k = 7 for
    SE(3), 3 for SE(2)). Each edge adds four k x k pose blocks and, for
    loops, a switch row and column at its block coordinates.

    Parameter layout per instance: [pose_0, ..., pose_{P-1} | switches]
    (pose-interleaved, so an edge's columns are two contiguous k-spans).
    The B instances share the edges, gauge, priors and weights; each has
    its own start, measurements, lambda and done flag (``lm.solve_batch``).
    One ``index_put_(accumulate=True)`` assembles the whole batch: instance
    b's flat indices are offset by b (kP+L)^2, and the stable sort by index
    keeps each instance's repeated entries in its serial order. A lane is
    not its serial solve bit for bit on the H100: cuSOLVER's batched
    Cholesky, the batched triangular solves and some small batched matmuls
    of the linearization round otherwise than at B = 1 (ROADMAP §C).
    Returns (pose params (B, P, k), switches (B, L), summary with a
    leading B)."""
    Bt, P, k = pose0.shape
    L = num_loops
    dim = k * P + L
    dtype, device = free_mask.dtype, free_mask.device
    graph = _Graph(_instances(edges, Bt, P), free_mask.repeat(Bt), Bt * P, Bt * L,
                   switch_penalty, edge_loss)
    E = edges.num_edges

    col_mask = torch.cat(
        [free_mask.repeat_interleave(k), torch.ones(L, dtype=dtype, device=device)]
    )
    ks = torch.arange(k, device=device)
    rows_ref = k * edges.reference_indices[:, None] + ks  # (E, k)
    rows_qry = k * edges.query_indices[:, None] + ks
    col_sw = k * P + _loop_slot(edges.is_loop, L)  # (E,)
    # the block coordinates of every H entry an edge adds, in the order
    # ref-ref, ref-qry, qry-ref, qry-qry (then the switch terms); each kind
    # lists the instances in turn
    blk_r = [rows_ref[:, :, None], rows_ref[:, :, None], rows_qry[:, :, None], rows_qry[:, :, None]]
    blk_c = [rows_ref[:, None, :], rows_qry[:, None, :], rows_ref[:, None, :], rows_qry[:, None, :]]
    h_local = [(r * dim + c).expand(E, k, k).reshape(-1) for r, c in zip(blk_r, blk_c)]
    if L > 0:
        swk = col_sw[:, None].expand(E, k)
        h_local += [(rows_ref * dim + swk).reshape(-1), (swk * dim + rows_ref).reshape(-1),
                    (rows_qry * dim + swk).reshape(-1), (swk * dim + rows_qry).reshape(-1),
                    col_sw * dim + col_sw]
    g_local = [rows_ref.reshape(-1), rows_qry.reshape(-1)] + ([col_sw] if L else [])
    instance = torch.arange(Bt, device=device)[:, None]
    h_index = torch.cat([(instance * dim * dim + h).reshape(-1) for h in h_local])
    g_index = torch.cat([(instance * dim + g).reshape(-1) for g in g_local])

    if prior_sqrt is not None:
        n = prior_sel.shape[0]
        prior_rows = (7 * prior_sel[:, None] + ks).reshape(-1)
        g_prior = (instance * dim + prior_rows).reshape(-1)
        h_prior = (instance[:, :, None] * dim * dim + prior_rows[:, None] * dim
                   + prior_rows[None, :]).reshape(-1)
        eye3 = torch.eye(3, dtype=dtype, device=device)
        q_lin_conj = lie.quat_conjugate(prior_mean[:, 3:])

    def quad(params):
        (x,) = params
        pose = x[:, : k * P].reshape(Bt * P, k)
        r, J_ref, J_query, J_s, cost_e = graph.linearize(pose, x[:, k * P:].reshape(-1))
        cost = torch.sum(cost_e.reshape(Bt, E), dim=1)
        B_rq = J_ref.mT @ J_query
        h_vals = [J_ref.mT @ J_ref, B_rq, B_rq.mT, J_query.mT @ J_query]
        g_vals = [_btv(J_ref, r), _btv(J_query, r)]
        if L > 0:
            b_rs = _btv(J_ref, J_s)  # (E, k)
            b_qs = _btv(J_query, J_s)
            h_vals += [b_rs, b_rs, b_qs, b_qs, torch.sum(J_s * J_s, dim=1)]
            g_vals.append(torch.sum(J_s * r, dim=1))
        H = torch.zeros(Bt * dim * dim, dtype=dtype, device=device)
        _scatter_add(H, h_index, torch.cat([v.reshape(-1) for v in h_vals]))
        H = H.reshape(Bt, dim, dim)
        g = torch.zeros(Bt * dim, dtype=dtype, device=device)
        _scatter_add(g, g_index, torch.cat([v.reshape(-1) for v in g_vals]))
        g = g.reshape(Bt, dim)

        if prior_sqrt is not None:
            # Gaussian prior in TANGENT (6-DoF local) coordinates:
            #   r_p(x) = S dphi(x) + c,
            #   dphi_i = [p_i - p_lin_i ; 2 vec(q_lin_i^-1 (x) n(q_i))]
            # (the fixed-lag smoother's marginalization product); tangent,
            # not raw-ambient, and an affine offset, not a mean shift (see
            # the JAX package's _pose_graph_solve for why).
            pose_b = pose.reshape(Bt, P, k)
            pb = pose_b[:, prior_sel, :3]
            qb = pose_b[:, prior_sel, 3:]
            A = lie.quat_multiply(q_lin_conj.expand_as(qb), lie.quat_normalize(qb))
            dphi = torch.cat([pb - prior_mean[:, :3], 2.0 * A[..., 1:]], dim=-1)
            r_p = _bmv(prior_sqrt, dphi.reshape(Bt, -1)) + prior_offset
            # d dphi / d(ambient x): identity translation rows; rotation
            # rows 2 [L(q_lin^-1) Dn(q)]_vec (3x4 per pose)
            dq = 2.0 * (_quat_left_matrix(q_lin_conj) @ _normalize_jacobian(qb))[..., 1:, :]
            T = torch.zeros((Bt, 6 * n, 7 * n), dtype=dtype, device=device)
            for i in range(n):  # the prior support is small
                T[:, 6 * i:6 * i + 3, 7 * i:7 * i + 3] = eye3
                T[:, 6 * i + 3:6 * i + 6, 7 * i + 3:7 * i + 7] = dq[:, i]
            J_p = prior_sqrt @ T  # (B, 6n, 7n)
            cost = cost + torch.sum(r_p * r_p, dim=1)
            _scatter_add(g.view(-1), g_prior, _btv(J_p, r_p).reshape(-1))
            _scatter_add(H.view(-1), h_prior, (J_p.mT @ J_p).reshape(-1))

        diagonal = H.diagonal(dim1=-2, dim2=-1)
        # fixed-pose rows stay nonsingular (their g is 0, so delta is 0)
        diagonal.add_(1.0 - col_mask)
        # Tikhonov floor: at an all-identity-quaternion state every
        # quaternion w-derivative vanishes and the multiplicatively damped
        # system is singular; Ceres clamps its damping diagonal
        # (min_diagonal = 1e-6) for the same structure
        diagonal.add_(floor)
        return H, g, cost

    def retract(params, delta):
        # ambient update (the Ceres-without-manifold behavior)
        (x,) = params
        return (x + delta * col_mask,)

    x0 = torch.cat([pose0.reshape(Bt, -1), switches0], dim=1)
    (x,), summary = lm.solve_batch(quad, retract, (x0,), options)
    return x[:, : k * P].reshape(Bt, P, k), x[:, k * P:], summary


# ---------------------------------------------------------------------------
# "cg": matrix-free preconditioned conjugate gradients
# ---------------------------------------------------------------------------

# The CG loop masks converged iterations on the device and reads its stop
# flag on the host once per this many iterations.
_CG_CHECK_EVERY = 8


def _tree_vdot(a, b) -> Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def _pcg(matvec, b, precond, maxiter: int, tol: float = 1e-5):
    """Preconditioned CG on tuples of tensors from x0 = 0, the iteration
    and stopping rule of ``jax.scipy.sparse.linalg.cg(A, b, maxiter=,
    M=)``: iterate while ||r||^2 > tol^2 ||b||^2 and k < maxiter. A
    finished iteration keeps its state, so the stop is exact although the
    host reads it only every ``_CG_CHECK_EVERY`` iterations."""
    atol2 = (tol * tol) * _tree_vdot(b, b)
    x = tuple(torch.zeros_like(v) for v in b)
    r = tuple(v - w for v, w in zip(b, matvec(x)))
    p = z = precond(r)
    gamma = _tree_vdot(r, z)
    for k in range(maxiter):
        active = _tree_vdot(r, r) > atol2
        if k % _CG_CHECK_EVERY == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = gamma / _tree_vdot(p, Ap)
        x_new = tuple(u + alpha * v for u, v in zip(x, p))
        r_new = tuple(u - alpha * v for u, v in zip(r, Ap))
        z = precond(r_new)
        gamma_new = _tree_vdot(r_new, z)
        p_new = tuple(u + (gamma_new / gamma) * v for u, v in zip(z, p))
        x = tuple(torch.where(active, u, v) for u, v in zip(x_new, x))
        r = tuple(torch.where(active, u, v) for u, v in zip(r_new, r))
        p = tuple(torch.where(active, u, v) for u, v in zip(p_new, p))
        gamma = torch.where(active, gamma_new, gamma)
    return x


def _shard_edges(edges, mesh: FactorMesh, P: int, L: int):
    """This rank's block of ``edges`` (SE(3) or SE(2)) padded to a multiple
    of the world size, and its slice of the GLOBAL loop slots, numbered on
    the host (a per-block cumsum would misnumber them). Padding edges are
    masked, join poses 0 and min(1, P - 1) by the identity and are no
    loop, as in the JAX package's ``_pose_graph_solve_cg_sharded``."""
    is_loop = edges.is_loop.cpu().numpy() > 0
    E = len(is_loop)
    pad = (-E) % mesh.size
    loop_slot = np.clip(np.cumsum(is_loop) - 1, 0, max(L - 1, 0))
    loop_slot = np.concatenate([loop_slot, np.zeros(pad, np.int64)])
    if pad:
        def padded(field, x):
            if x is None:
                return None
            if field == "sqrt_info":  # unit information
                eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
                filler = x.new_ones((pad, x.shape[1])) if x.dim() == 2 else eye.expand(pad, -1, -1)
            elif field == "relative_quaternions":  # the identity rotation
                filler = x.new_zeros((pad, 4))
                filler[:, 0] = 1.0
            else:  # masked, no loop, between poses 0 and min(1, P - 1)
                fill = min(1, P - 1) if field == "query_indices" else 0
                filler = x.new_full((pad,) + tuple(x.shape[1:]), fill)
            return torch.cat([x, filler])

        edges = type(edges)(*(padded(f, x) for f, x in edges._asdict().items()))
    rows = factor_sharding(mesh, E + pad)
    local = type(edges)(*(None if x is None else x[rows] for x in edges))
    return local, torch.as_tensor(loop_slot[rows], device=edges.mask.device)


def _pose_graph_solve_cg(
    pose0, switches0, edges, free_mask, switch_penalty: float, edge_loss,
    num_poses: int, num_loops: int, options: Options, cg_iterations: int,
    cg_precond: str = "chain", mesh: Optional[FactorMesh] = None,
):
    """Matrix-free LM: the ``lm.solve`` policy loop with a preconditioned-CG
    linear step. ``eval_quadratic`` returns the per-edge Jacobian blocks as
    the operator (H is never formed) and ``solve_linear`` runs the damped
    matvec CG. Pose blocks are k = 7 (SE(3)) or 3 (SE(2)) wide.

    ``cg_precond``: "chain" (default) is the damped block-tridiagonal part
    of H (per-pose k x k blocks plus the coupling blocks of
    consecutive-pose edges), factored by cyclic reduction once per LM step
    and applied per CG iteration; exact up to the loop off-diagonals.
    "jacobi" is the per-pose damped k x k diagonal blocks only.

    ``mesh``: each rank keeps its block of the edges (:func:`_shard_edges`)
    and every edge reduction (cost, gradient, diag(J^T J), the
    preconditioner's blocks, each CG matvec) is summed across ranks, so the
    pose-dimension state, the LM loop and the CG iterations stay the same
    on every rank."""
    P, L = num_poses, num_loops
    k = pose0.shape[1]
    loop_slot, reduce = None, lambda x: x
    if mesh is not None:
        edges, loop_slot = _shard_edges(edges, mesh, P, L)
        reduce = lambda x: all_sum(mesh, x)
    graph = _Graph(edges, free_mask, P, L, switch_penalty, edge_loss, loop_slot)
    dtype, device = graph.dtype, graph.device
    ref_i, qry_i = graph.ref_i, graph.qry_i
    accumulate_pose = graph.accumulate_pose
    eye_k = torch.eye(k, dtype=dtype, device=device)
    if cg_precond == "chain":
        chain = torch.nonzero((torch.abs(ref_i - qry_i) == 1) & (edges.mask > 0))[:, 0]
        chain_lo = torch.minimum(ref_i, qry_i)[chain]
        chain_fwd = (ref_i < qry_i)[chain][:, None, None]

    def scatter_jt(J_ref, J_query, J_s, y):
        """J^T y as ((P, k), (L,)), summed over a mesh's ranks."""
        gp = accumulate_pose(_btv(J_ref, y), _btv(J_query, y))
        return reduce((gp, graph.per_switch(torch.sum(J_s * y, dim=1))))

    split_quadratic = graph.split_quadratic()

    def eval_quadratic(params):
        (J_ref, J_query, J_s, d_p, d_s), g, cost = split_quadratic(params)
        # and the per-pose k x k J^T J blocks of the preconditioner
        B_p = accumulate_pose(J_ref.mT @ J_ref, J_query.mT @ J_query)
        O_chain = None
        if cg_precond == "chain":
            # off-diagonal H blocks of consecutive-pose edges at slot
            # min(ref, qry), oriented so O[i] = H[i, i+1]
            cross = J_ref[chain].mT @ J_query[chain]
            cross = torch.where(chain_fwd, cross, cross.mT)
            O_chain = _scatter_add(
                torch.zeros((P, k, k), dtype=dtype, device=device), chain_lo, cross
            )
        g, cost, d_p, d_s, B_p, O_chain = reduce((g, cost, d_p, d_s, B_p, O_chain))
        return (J_ref, J_query, J_s, d_p, d_s, B_p, O_chain), g, cost

    def solve_linear(H_rep, g, lam):
        J_ref, J_query, J_s, d_p, d_s, B_p, O_chain = H_rep
        g_p, g_s = g
        fixed_p = graph.fixed_p
        loop_w = graph.is_loop.to(dtype)

        def matvec(v):
            vp, vs = v
            Jv = _bmv(J_ref, vp[ref_i]) + _bmv(J_query, vp[qry_i])
            if L > 0:
                Jv = Jv + J_s * (vs[graph.loop_slot] * loop_w)[:, None]
            hp, hs = scatter_jt(J_ref, J_query, J_s, Jv)
            hp = hp + lam * d_p * vp + fixed_p * vp + 1e-8 * vp
            hs = hs + lam * d_s * vs + 1e-8 * vs
            return hp, hs

        # block-Jacobi part: the per-pose damped k x k J^T J blocks (exactly
        # the pose diagonal of the damped H the matvec applies); switch
        # variables are diagonal in H
        dvec = lam * d_p + fixed_p + 1e-8  # (P, k) damping diagonal
        Bp = B_p + eye_k * dvec[:, None, :]
        pre_s = (1.0 + lam) * d_s + 1e-8

        if cg_precond == "chain":
            # preconditioner-only diagonal floor: at small lambda each pose
            # block is near-singular along its quaternion-scale gauge
            # direction and the tridiagonal factorization would propagate
            # that across poses; M only has to be PD
            floor = 1e-3 * torch.amax(d_p, dim=1, keepdim=True) + 1e-8
            fact = block_tridiag.factor(Bp + eye_k * floor[:, :, None], O_chain)

            def precond(v):
                return block_tridiag.solve_factored(fact, v[0]), v[1] / pre_s
        else:
            Bp_inv = torch.linalg.inv(Bp)

            def precond(v):
                return _bmv(Bp_inv, v[0]), v[1] / pre_s

        return _pcg(matvec, (-g_p, -g_s), precond, cg_iterations)

    return _solve_split(eval_quadratic, solve_linear, free_mask, pose0, switches0, options)


# ---------------------------------------------------------------------------
# "tridiag": cyclic reduction + Woodbury correction
# ---------------------------------------------------------------------------

# Woodbury correction sizing: up to _CORR_DENSE_MAX correction edges the
# (P, Uc, 7, 7) dense-columns form is used (one tridiagonal solve); beyond
# it columns go _CORR_CHUNK edges at a time, so memory stays O(P *
# _CORR_CHUNK * 56) at any loop count. Both numbers are the JAX package's.
_CORR_DENSE_MAX = 32
_CORR_CHUNK = 16


def _pose_graph_solve_tridiag(
    pose0, switches0,
    edges: PoseGraphEdges,  # REORDERED: chain edges (by lo) first, then corr
    free_mask, switch_penalty: float, edge_loss,
    chain_lo,  # (Ec,) min(ref, qry) per chain edge
    chain_forward,  # (Ec,) 1.0 when ref < qry
    num_chain: int,  # Ec: the first Ec edges are the chain partition
    num_poses: int, num_loops: int, options: Options,
    chain_seq: bool,  # chain_lo == arange(P-1): every consecutive pair has
    # exactly one chain edge, so every chain segment sum is a shift-add
):
    """Direct LM for chain-dominated graphs: exact damped-GN steps by
    block-tridiagonal cyclic reduction and a Woodbury low-rank correction.

    The damped normal system splits exactly as H_d = T + U W U^T:

    - ``T``: the chain-edge 7x7 blocks plus the FULL damping diagonal
      lam*diag(H) + gauge + 1e-8, solved by ``block_tridiag``;
    - ``U W U^T``: each remaining edge adds its pose-block outer product
      A_e^T A_e (7 columns) minus the switch-Schur rank-1 term
      (A_e^T c_e)(A_e^T c_e)^T / gamma_e of its eliminated switch, as a
      signed column, so W = diag(+1, ..., -1, ...) = W^{-1} exactly.

    Switches are recovered by exact back-substitution
    ds = Hss^{-1} (-g_s - Hsp dp)."""
    P, L = num_poses, num_loops
    graph = _Graph(edges, free_mask, P, L, switch_penalty, edge_loss)
    dtype, device = graph.dtype, graph.device
    E, Ec = graph.E, num_chain
    Uc = E - Ec
    ref_i, qry_i = graph.ref_i, graph.qry_i
    fixed_p = graph.fixed_p

    corr_a = ref_i[Ec:]
    corr_b = qry_i[Ec:]
    corr_rows = torch.cat([corr_a, corr_b])
    corr_is_loop = edges.is_loop[Ec:]  # (Uc,)
    # loop edges are never chain edges and keep their relative order, so
    # the loops among the corrections are in slot order
    corr_loop_ids = torch.nonzero(corr_is_loop > 0)[:, 0]
    corr_slot = graph.loop_slot[Ec:]
    eye7 = torch.eye(7, dtype=dtype, device=device)
    fwd1 = chain_forward[:, None] > 0  # (Ec, 1)
    fwd2 = chain_forward[:, None, None] > 0
    chain_rows = torch.cat([chain_lo, chain_lo + 1])

    def chain_accumulate(c_lo, c_hi):
        """Per-chain-edge contributions to poses lo / lo+1 summed per pose:
        two shifted pads when chain_seq, else a scatter-add."""
        if chain_seq:
            z = torch.zeros((1,) + c_lo.shape[1:], dtype=dtype, device=device)
            return torch.cat([c_lo, z]) + torch.cat([z, c_hi])
        out = torch.zeros((P,) + c_lo.shape[1:], dtype=dtype, device=device)
        return _scatter_add(out, chain_rows, torch.cat([c_lo, c_hi]))

    def accumulate_pose(contrib_ref, contrib_qry):
        cr, cq = contrib_ref[:Ec], contrib_qry[:Ec]
        f = fwd1 if cr.dim() == 2 else fwd2
        gp = chain_accumulate(torch.where(f, cr, cq), torch.where(f, cq, cr))
        if Uc > 0:
            _scatter_add(gp, corr_rows, torch.cat([contrib_ref[Ec:], contrib_qry[Ec:]]))
        return gp

    eval_quadratic = graph.split_quadratic(accumulate_pose)

    def solve_linear(H_rep, g, lam):
        J_ref, J_query, J_s, d_p, d_s = H_rep
        g_p, g_s = g
        dvec = lam * d_p + fixed_p + 1e-8  # (P, 7) damping diagonal

        # ---- T: chain blocks + damping diagonal ---------------------------
        Jr, Jq = J_ref[:Ec], J_query[:Ec]
        J_lo = torch.where(fwd2, Jr, Jq)
        J_hi = torch.where(fwd2, Jq, Jr)
        D = chain_accumulate(J_lo.mT @ J_lo, J_hi.mT @ J_hi)
        D = D + eye7 * dvec[:, None, :]
        O_c = J_lo.mT @ J_hi
        if chain_seq:
            O = O_c  # (P-1, 7, 7), already in lo order
        else:
            O = _scatter_add(
                torch.zeros((max(P - 1, 1), 7, 7), dtype=dtype, device=device), chain_lo, O_c
            )
        b_p = -g_p
        if Uc == 0:
            dp = block_tridiag.solve(D, O, b_p)
            return dp, torch.zeros(L, dtype=dtype, device=device)

        # ---- signed low-rank correction columns ---------------------------
        Ja, Jb = J_ref[Ec:], J_query[Ec:]  # (Uc, 7, 7) blocks at poses a, b
        c = J_s[Ec:]  # (Uc, 7)
        loop_c = corr_is_loop > 0
        zero = torch.zeros((), dtype=dtype, device=device)
        d_s_corr = torch.where(loop_c, d_s[corr_slot], zero) if L else torch.zeros_like(corr_is_loop)
        g_s_corr = torch.where(loop_c, g_s[corr_slot], zero) if L else torch.zeros_like(corr_is_loop)
        gamma = torch.sum(c * c, dim=1) + lam * d_s_corr + 1e-8
        Jac = _btv(Ja, c)  # (Uc, 7) = A_a^T c
        Jbc = _btv(Jb, c)
        # RHS after switch elimination: b_p = -g_p + Hps Hss^{-1} g_s
        coef = torch.where(loop_c, g_s_corr / gamma, zero)
        _scatter_add(b_p, corr_rows, torch.cat([Jac * coef[:, None], Jbc * coef[:, None]]))
        inv_sq = torch.where(loop_c, 1.0 / torch.sqrt(gamma), zero)[:, None]

        if Uc <= _CORR_DENSE_MAX:
            # dense columns: one tridiagonal solve over 1 + 8 Uc right-hand
            # sides; an edge's two poses differ, so no entry is written twice
            arange_u = torch.arange(Uc, device=device)
            U4 = torch.zeros((P, Uc, 7, 7), dtype=dtype, device=device)
            U4[corr_a, arange_u] = Ja
            U4[corr_b, arange_u] = Jb
            U_plus = U4.permute(0, 3, 1, 2).reshape(P, 7, Uc * 7)
            V3 = torch.zeros((P, Uc, 7), dtype=dtype, device=device)
            V3[corr_a, arange_u] = Jac * inv_sq
            V3[corr_b, arange_u] = Jbc * inv_sq
            U_all = torch.cat([U_plus, V3.permute(0, 2, 1)], dim=-1)  # (P, 7, K)
            K = 8 * Uc
            w_sign = torch.cat([torch.ones(7 * Uc, dtype=dtype, device=device),
                                -torch.ones(Uc, dtype=dtype, device=device)])
            X = block_tridiag.solve(D, O, torch.cat([b_p[:, :, None], U_all], dim=-1))
            xb = X[..., 0]  # T^{-1} b_p
            Y = X[..., 1:]  # T^{-1} U
            Uf = U_all.reshape(P * 7, K)
            M = torch.diag(w_sign) + Uf.T @ Y.reshape(P * 7, K)
            alpha = torch.linalg.solve(M, Uf.T @ xb.reshape(P * 7))
            dp = xb - Y @ alpha
        else:
            # chunked columns: the capacitance system is assembled a chunk
            # of correction edges at a time (U never exists densely; its
            # transpose applies by per-edge gathers), and the correction
            # costs one more single-rhs solve: dp = xb - T^{-1} (U alpha).
            # Column layout per chunk: [7 '+' columns per edge (e-major,
            # d-fast) | 1 '-' column per edge]; padded edges have zero
            # blocks, so their capacitance rows reduce to the +-1 diagonal.
            Cc = _CORR_CHUNK
            n_chunks = (Uc + Cc - 1) // Cc
            Up = n_chunks * Cc
            pad = Up - Uc

            def padc(x):
                return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x

            ca, cb = padc(corr_a), padc(corr_b)
            Jap, Jbp = padc(Ja), padc(Jb)
            Jva, Jvb = padc(Jac * inv_sq), padc(Jbc * inv_sq)  # '-' column blocks
            K = 8 * Up
            pad_rows = torch.cat([ca, cb])

            def ut_apply(z):
                """U^T z for z (P, 7, m) -> (K, m), by gathers."""
                za, zb = z[ca], z[cb]  # (Up, 7, m)
                plus = Jap @ za + Jbp @ zb  # (Up, 7, m)
                minus = (Jva[:, None, :] @ za)[:, 0] + (Jvb[:, None, :] @ zb)[:, 0]
                m = z.shape[-1]
                return torch.cat(
                    [plus.reshape(n_chunks, Cc * 7, m), minus.reshape(n_chunks, Cc, m)], dim=1
                ).reshape(K, m)

            def u_apply(alpha):
                """U alpha for alpha (K,) -> (P, 7), by a scatter-add."""
                a2 = alpha.reshape(n_chunks, 8 * Cc)
                a_plus = a2[:, : 7 * Cc].reshape(Up, 7)
                a_minus = a2[:, 7 * Cc:].reshape(Up)
                contrib_a = _btv(Jap, a_plus) + a_minus[:, None] * Jva
                contrib_b = _btv(Jbp, a_plus) + a_minus[:, None] * Jvb
                out = torch.zeros((P, 7), dtype=dtype, device=device)
                return _scatter_add(out, pad_rows, torch.cat([contrib_a, contrib_b]))

            # factor T once; every chunk and the two single-rhs solves
            # reuse the reduction
            fact = block_tridiag.factor(D, O)
            xb = block_tridiag.solve_factored(fact, b_p)
            arange_c = torch.arange(Cc, device=device)
            blocks = []
            for i in range(n_chunks):
                sl = slice(i * Cc, (i + 1) * Cc)
                U4c = torch.zeros((P, Cc, 7, 7), dtype=dtype, device=device)
                U4c[ca[sl], arange_c] = Jap[sl]
                U4c[cb[sl], arange_c] = Jbp[sl]
                V3c = torch.zeros((P, Cc, 7), dtype=dtype, device=device)
                V3c[ca[sl], arange_c] = Jva[sl]
                V3c[cb[sl], arange_c] = Jvb[sl]
                U_chunk = torch.cat(
                    [U4c.permute(0, 3, 1, 2).reshape(P, 7, Cc * 7), V3c.permute(0, 2, 1)], dim=-1
                )  # (P, 7, 8 Cc)
                blocks.append(ut_apply(block_tridiag.solve_factored(fact, U_chunk)))
            UtY = torch.stack(blocks, dim=1).reshape(K, K)
            w_sign = torch.cat([torch.ones(7 * Cc, dtype=dtype, device=device),
                                -torch.ones(Cc, dtype=dtype, device=device)]).repeat(n_chunks)
            Utx = ut_apply(xb[:, :, None])[:, 0]
            alpha = torch.linalg.solve(torch.diag(w_sign) + UtY, Utx)
            dp = xb - block_tridiag.solve_factored(fact, u_apply(alpha))

        # exact switch back-substitution ds = (-g_s - c^T A dp) / gamma
        if L > 0:
            v = _bmv(Ja, dp[corr_a]) + _bmv(Jb, dp[corr_b])  # (Uc, 7) = A_e dp
            ds_e = (-g_s_corr - torch.sum(c * v, dim=1)) / gamma
            ds = ds_e[corr_loop_ids]
        else:
            ds = torch.zeros(0, dtype=dtype, device=device)
        return dp, ds

    return _solve_split(eval_quadratic, solve_linear, free_mask, pose0, switches0, options)


# ---------------------------------------------------------------------------
# "banded": RCM ordering + superblock cyclic reduction
# ---------------------------------------------------------------------------


def _scatter_banded_blocks(P: int, d: int, s: int, lo, hi, B_ll, B_hh, B_hl, diag):
    """Assemble permuted-order edge blocks into superblock-tridiagonal
    (D, O) panels: K = ceil(P / s) superblocks of s poses, m = s d.

    ``lo``/``hi`` (E,) are each edge's smaller and larger permuted pose
    index (hi - lo <= s), ``B_ll``/``B_hh``/``B_hl`` its (E, d, d) blocks
    H[lo, lo], H[hi, hi] and H[hi, lo]; ``diag`` (P, d) is added to the
    pose diagonals, and padding poses get 1.0. Returns (K, m, D
    (K, m, m), O (K - 1, m, m)) with O[k] = H(superblock k, k + 1)."""
    K = max(1, -(-P // s))
    m = s * d
    dtype, device = B_ll.dtype, B_ll.device
    k_lo, r_lo = lo // s, lo % s
    k_hi, r_hi = hi // s, hi % s
    # panels accumulate in (K, s, s, d, d) layout: [k, r1, r2] is the
    # (pose r1, pose r2) block of superblock k
    # an edge's off-diagonal block goes to its superblock's panel when
    # both poses share one, else to the coupling panel; the other
    # destination gets a zero (masks, not boolean indexing: no host sync)
    same = (k_lo == k_hi)[:, None, None]
    zero = torch.zeros((), dtype=dtype, device=device)
    B_lh = B_hl.mT
    Dsup = torch.zeros((K, s, s, d, d), dtype=dtype, device=device)
    _scatter_add(
        Dsup,
        (torch.cat([k_lo, k_hi, k_lo, k_lo]),
         torch.cat([r_lo, r_hi, r_hi, r_lo]),
         torch.cat([r_lo, r_hi, r_lo, r_hi])),
        torch.cat([B_ll, B_hh, torch.where(same, B_hl, zero), torch.where(same, B_lh, zero)]),
    )
    D = Dsup.permute(0, 1, 3, 2, 4).reshape(K, m, m)
    Osup = torch.zeros((K - 1, s, s, d, d), dtype=dtype, device=device)
    if K > 1:
        _scatter_add(
            Osup, (torch.clamp(k_lo, max=K - 2), r_lo, r_hi), torch.where(same, zero, B_lh)
        )
    O = Osup.permute(0, 1, 3, 2, 4).reshape(K - 1, m, m)
    dpad = torch.ones((K * s, d), dtype=dtype, device=device)
    dpad[:P] = diag
    D = D + torch.eye(m, dtype=dtype, device=device) * dpad.reshape(K, 1, m)
    return K, m, D, O


def _pose_graph_solve_banded(
    pose0,  # (P, k) in RCM-PERMUTED order
    switches0,  # (L,)
    edges,  # endpoint indices in PERMUTED order
    free_mask,  # (P,) permuted
    switch_penalty: float, edge_loss, num_poses: int, num_loops: int,
    super_size: int,  # s >= block bandwidth of the permuted graph
    options: Options,
):
    """Direct LM for loop-rich graphs: block-banded Cholesky by superblock
    cyclic reduction.

    1. Host symbolic phase, once per topology: a reverse Cuthill-McKee
       ordering bounds the block bandwidth b = max |perm_i - perm_j|.
    2. Device numeric phase, per LM iteration: the banded system packs
       into K = ceil(P/s) superblocks of s >= b poses (ks x ks panels, k =
       7 for SE(3) and 3 for SE(2)). Every edge couples the same or
       adjacent superblocks, so the system is block-tridiagonal at
       superblock granularity and ``block_tridiag`` factors it in log2(K)
       levels of batched panel products.

    Loop switches are eliminated exactly per edge (their damped Schur
    complement is a rank-1 update inside the band) and recovered by
    back-substitution. The panels factor in the solve's own dtype: float64
    is native on the H100, so the JAX package's float32 factorization
    with two steps of iterative refinement (a TPU measure) is not
    carried."""
    P, L = num_poses, num_loops
    k = pose0.shape[1]
    s = super_size
    graph = _Graph(edges, free_mask, P, L, switch_penalty, edge_loss)
    dtype, device = graph.dtype, graph.device
    ref_i, qry_i = graph.ref_i, graph.qry_i

    # lo/hi endpoint split (lo = smaller permuted index)
    swap = (qry_i < ref_i)[:, None, None]
    lo_i = torch.minimum(ref_i, qry_i)
    hi_i = torch.maximum(ref_i, qry_i)
    lohi_rows = torch.cat([lo_i, hi_i])

    eval_quadratic = graph.split_quadratic()

    def solve_linear(H_rep, g, lam):
        J_ref, J_query, J_s, d_p, d_s = H_rep
        g_p, g_s = g
        J_lo = torch.where(swap, J_query, J_ref)  # (E, r, k)
        J_hi = torch.where(swap, J_ref, J_query)
        B_ll = J_lo.mT @ J_lo
        B_hh = J_hi.mT @ J_hi
        B_hl = J_hi.mT @ J_lo
        b_p = -g_p

        if L > 0:
            # exact damped-Schur elimination of each loop edge's switch:
            # H_pp -= (A^T c)(A^T c)^T / gamma,  b_p += (A^T c) g_s / gamma
            inv_gamma, g_s_e, Jlc, Jhc = graph.eliminate_switches(
                J_lo, J_hi, J_s, d_s, g_s, lam, lohi_rows, b_p
            )
            ig = inv_gamma[:, None, None]
            B_ll = B_ll - ig * (Jlc[:, :, None] * Jlc[:, None, :])
            B_hh = B_hh - ig * (Jhc[:, :, None] * Jhc[:, None, :])
            B_hl = B_hl - ig * (Jhc[:, :, None] * Jlc[:, None, :])

        # damping diagonal (reference policy: lam * diag(H), gauge fixing
        # and the rank-deficiency floor); padding poses get 1.0
        dvec = lam * d_p + graph.fixed_p + 1e-8  # (P, k)
        K, m, D, O = _scatter_banded_blocks(P, k, s, lo_i, hi_i, B_ll, B_hh, B_hl, dvec)
        rhs = torch.cat([b_p, b_p.new_zeros((K * s - P, k))]).reshape(K, m)
        # dense tail in superblock rows: stop once it is ~4k wide
        x = block_tridiag.solve(D, O, rhs, dense_cutoff=max(1, 4096 // m))
        dp = x.reshape(K * s, k)[:P]

        if L > 0:
            ds = graph.back_substitute(J_lo, J_hi, J_s, dp[lo_i], dp[hi_i], g_s_e, inv_gamma)
        else:
            ds = torch.zeros(0, dtype=dtype, device=device)
        return dp, ds

    return _solve_split(eval_quadratic, solve_linear, free_mask, pose0, switches0, options)


# ---------------------------------------------------------------------------
# "sparse": nested-dissection multifrontal Cholesky
# ---------------------------------------------------------------------------


def _pose_graph_solve_sparse(
    pose0,  # (P, k) registry order (no permutation: the plan owns it)
    switches0,  # (L,)
    edges,  # PoseGraphEdges or PoseGraph2DEdges
    free_mask,  # (P,)
    switch_penalty: float, edge_loss, num_poses: int, num_loops: int,
    plan: multifrontal.Plan,  # from PoseGraphOptimizer._flatten_sparse
    options: Options,
    mesh: Optional[FactorMesh] = None,
):
    """Direct LM by nested-dissection multifrontal block-sparse Cholesky
    (``solvers/multifrontal.py``): the solver class for loop-rich
    fat-bandwidth graphs (Olson's Manhattan worlds), where every RCM
    ordering still couples across the arena and banded superblocks go
    near-dense, while nested dissection keeps O(P^{3/2}) with
    sqrt(P)-sized separator fronts.

    The eval_quadratic, the LM policy and the exact per-edge switch
    elimination are the banded path's (the damped Schur complement of a
    loop switch is a rank-1 update of its edge's blocks, which stay inside
    the sparsity pattern); only the linear solver differs. The fronts
    factor in the solve's own dtype (see ``multifrontal.solve``), over the
    ranks of ``mesh`` when one is given."""
    P, L = num_poses, num_loops
    graph = _Graph(edges, free_mask, P, L, switch_penalty, edge_loss)
    dtype, device = graph.dtype, graph.device
    ref_i, qry_i = graph.ref_i, graph.qry_i

    eval_quadratic = graph.split_quadratic()

    def solve_linear(H_rep, g, lam):
        J_ref, J_query, J_s, d_p, d_s = H_rep
        g_p, g_s = g
        # per-edge blocks in (ref, query) = (a, b) convention
        B_aa = J_ref.mT @ J_ref
        B_bb = J_query.mT @ J_query
        B_ab = J_ref.mT @ J_query
        b_p = -g_p

        if L > 0:
            # exact damped-Schur elimination of each loop edge's switch
            # (rank 1 per edge: the same algebra as the banded path)
            inv_gamma, g_s_e, Jac, Jbc = graph.eliminate_switches(
                J_ref, J_query, J_s, d_s, g_s, lam, graph.pose_rows, b_p
            )
            ig = inv_gamma[:, None, None]
            B_aa = B_aa - ig * (Jac[:, :, None] * Jac[:, None, :])
            B_bb = B_bb - ig * (Jbc[:, :, None] * Jbc[:, None, :])
            B_ab = B_ab - ig * (Jac[:, :, None] * Jbc[:, None, :])

        dvec = lam * d_p + graph.fixed_p + 1e-8  # damping + gauge + floor
        dp = multifrontal.solve(plan, ref_i, qry_i, B_aa, B_bb, B_ab, dvec, b_p, mesh=mesh)

        if L > 0:
            ds = graph.back_substitute(J_ref, J_query, J_s, dp[ref_i], dp[qry_i], g_s_e, inv_gamma)
        else:
            ds = torch.zeros(0, dtype=dtype, device=device)
        return dp, ds

    return _solve_split(eval_quadratic, solve_linear, free_mask, pose0, switches0, options)


# ---------------------------------------------------------------------------
# solver selection
# ---------------------------------------------------------------------------


def _rcm_perm_bandwidth(P: int, ref_idx, query_idx):
    """Reverse Cuthill-McKee ordering of the pose graph and the block
    bandwidth it achieves (host, scipy.sparse). Returns (perm, inv,
    bandwidth)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if len(ref_idx) == 0:
        return np.arange(P), np.arange(P), 1
    A = coo_matrix(
        (
            np.ones(len(ref_idx)),
            (np.asarray(ref_idx, np.int64), np.asarray(query_idx, np.int64)),
        ),
        shape=(P, P),
    )
    A = (A + A.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    inv = np.empty(P, np.int64)
    inv[perm] = np.arange(P)
    bw = max(1, int(np.abs(inv[ref_idx] - inv[query_idx]).max()))
    return perm, inv, bw


def _rcm_bandwidth(P: int, ref_idx, query_idx) -> int:
    return _rcm_perm_bandwidth(P, ref_idx, query_idx)[2]


def select_solver(
    P: int,
    ref_idx,
    query_idx,
    is_loop,
    d: int,
    plan_fn=None,
    allow_tridiag: bool = True,
    bandwidth: Optional[int] = None,
) -> Tuple[str, dict]:
    """Pick a linear-solver family from the graph's topology (the 'auto'
    policy), the JAX package's decision tree and numbers unchanged:

      1. d P + E <= 6000 -> 'dense';
      2. chains with <= 100 non-chain edges -> 'tridiag';
      3. 'banded' when its superblock flops are <= 5e9 and its panels fit
         the 2 GiB guard;
      4. else consult the nested-dissection plan (``plan_fn``) and compare
         the calibrated per-iteration time models

             t_banded ~ 14 + 1.6e-3 E + banded_flops / 1e9    [ms]
             t_sparse ~ 10 + 1.6e-3 E + sparse_flops / 1.5e8

         (fitted on the JAX package's reference chip; retuning them for
         the H100 is open work, ROADMAP A.11.6);
      'cg' when both direct forms are infeasible.

    ``plan_fn()`` builds the multifrontal plan and may raise ValueError to
    veto 'sparse'. Returns (name, info) with the model numbers in info."""
    E = len(ref_idx)
    info: dict = dict(P=P, E=E, d=d)
    if d * P + E <= 6000:
        info["reason"] = "small dense system"
        return "dense", info
    adj = np.abs(np.asarray(ref_idx, np.int64) - np.asarray(query_idx, np.int64)) == 1
    n_corr = int(E - np.sum(adj & (np.asarray(is_loop) == 0)))
    info["n_corr"] = n_corr
    if allow_tridiag and n_corr <= 100:
        info["reason"] = "chain + few corrections"
        return "tridiag", info
    b = _rcm_bandwidth(P, ref_idx, query_idx) if bandwidth is None else bandwidth
    s = max(b, 8)
    K = -(-P // s)
    panel_bytes = 2 * K * (s * d) ** 2 * 4
    banded_flops = 2.0 * K * float(s * d) ** 3
    banded_ok = panel_bytes <= 2 << 30
    t_edges = 1.6e-3 * E
    t_banded = 14.0 + t_edges + banded_flops / 1e9
    info.update(bandwidth=b, banded_flops=banded_flops,
                banded_panel_bytes=panel_bytes, predicted_banded_ms=t_banded)
    if banded_ok and banded_flops <= 5e9:
        info["reason"] = "small superblock flops"
        return "banded", info
    plan = None
    if plan_fn is not None:
        try:
            plan = plan_fn()
        except ValueError as e:  # multifrontal memory guard
            info["sparse_veto"] = str(e)
    if plan is not None:
        st = plan.stats()
        sparse_flops = st["factor_flops"]
        t_sparse = 10.0 + t_edges + sparse_flops / 1.5e8
        info["sparse_flops"] = sparse_flops
        info["predicted_sparse_ms"] = t_sparse
        if banded_ok and t_banded <= t_sparse:
            info["reason"] = "band predicted faster"
            return "banded", info
        info["reason"] = "separators predicted faster"
        return "sparse", info
    if banded_ok:
        info["reason"] = "sparse infeasible, band feasible"
        return "banded", info
    info["reason"] = "both direct forms infeasible"
    return "cg", info


# ---------------------------------------------------------------------------
# covariance: pose-diagonal blocks of the inverse Gauss-Newton information
# ---------------------------------------------------------------------------


def _edge_information_blocks(J_ref: Tensor, J_qry: Tensor, J_s: Tensor):
    """Per-edge pose information blocks with EXACT per-edge switch
    elimination (the rank-1 Schur downdate, undamped; the solve paths
    carry the damped form in ``_Graph.eliminate_switches``). Shared by the
    banded and sparse covariance paths. Returns (B_aa, B_bb, B_ab) in
    (ref, query) row/col convention."""
    B_aa = J_ref.mT @ J_ref
    B_bb = J_qry.mT @ J_qry
    B_ab = J_ref.mT @ J_qry
    gamma = torch.sum(J_s * J_s, dim=1)
    loop = gamma > 0
    one = torch.ones_like(gamma)
    ig = torch.where(loop, one / torch.where(loop, gamma, one), torch.zeros_like(gamma))
    ig = ig[:, None, None]
    Jac = _btv(J_ref, J_s)
    Jbc = _btv(J_qry, J_s)
    B_aa = B_aa - ig * (Jac[:, :, None] * Jac[:, None, :])
    B_bb = B_bb - ig * (Jbc[:, :, None] * Jbc[:, None, :])
    B_ab = B_ab - ig * (Jac[:, :, None] * Jbc[:, None, :])
    return B_aa, B_bb, B_ab


def _block_tridiag_selected_inverse(D: Tensor, O: Tensor) -> Tensor:
    """Diagonal superblocks (K, m, m) of the inverse of a block-tridiagonal
    SPD matrix (D (K, m, m) diagonal panels, O (K-1, m, m) upper couplings)
    by the exact selected-inverse recurrence:

        Lam_1 = D_1,  Lam_k = D_k - O_{k-1}^T Lam_{k-1}^{-1} O_{k-1}
        Sig_K = Lam_K^{-1},  Sig_k = Lam_k^{-1} + G_k Sig_{k+1} G_k^T
        with G_k = Lam_k^{-1} O_k.

    O(K m^3) on the device in the panels' dtype: K sequential steps of
    m x m panel algebra each way (the JAX package runs it in host float64
    numpy). The covariance engine of the 3-D and SE(2) banded paths."""
    K = D.shape[0]
    Lam_inv = [torch.linalg.inv(D[0])]
    for k in range(1, K):
        Lam = D[k] - O[k - 1].mT @ Lam_inv[k - 1] @ O[k - 1]
        Lam_inv.append(torch.linalg.inv(Lam))
    sig = [Lam_inv[K - 1]]
    for k in range(K - 2, -1, -1):
        G = Lam_inv[k] @ O[k]
        sig.append(Lam_inv[k] + G @ sig[-1] @ G.mT)
    return torch.stack(sig[::-1])


def _banded_covariance_fits(P: int, bandwidth: int, d: int) -> bool:
    """The JAX package's panel-memory guard of the banded covariance,
    2 K (s d)^2 8 bytes <= 4 GiB with s = max(bandwidth, 8): a figure kept
    for selection parity (its retune is ROADMAP A.11.6)."""
    s = max(bandwidth, 8)
    K = max(1, -(-P // s))
    return 2 * K * (s * d) ** 2 * 8 <= 4 << 30


def _batch_size(batch_size, *arrays) -> int:
    """B of a batched solve: the leading size of every per-instance array
    and ``batch_size``, which must agree."""
    sizes = {np.shape(a)[0] for a in arrays if a is not None}
    if batch_size is not None:
        sizes.add(int(batch_size))
    if len(sizes) != 1:
        raise ValueError(
            f"inconsistent or missing batch size: {sorted(sizes)}; pass "
            "batch_size= or at least one (B, ...) per-instance array"
        )
    return sizes.pop()


def _batched_input(B: int, dtype, device):
    """``batched(arr, default, shape, name)``: a per-instance input as a
    (B,) + shape tensor, or ``default`` broadcast to it when omitted."""

    def batched(arr, default, shape, name):
        if arr is None:
            default = torch.as_tensor(np.asarray(default), dtype=dtype, device=device)
            return default.expand((B,) + shape)
        a = np.array(arr, np.float64)  # a copy: a broadcast view is read-only
        if a.shape != (B,) + shape:
            raise ValueError(f"{name} must be (B,) + {shape}; got {a.shape}")
        return torch.as_tensor(a, dtype=dtype, device=device)

    return batched


def _fetch(*trees):
    """Trees of device tensors (tuples, NamedTuples such as a Summary) as
    trees of numpy arrays of the same dtypes, by one device-to-host copy."""
    leaves = [x for tree in trees for x in lm.tree_leaves(tree)]
    host = torch.cat([x.reshape(-1).to(torch.float64) for x in leaves]).cpu().numpy()
    arrays, at = [], 0
    for x in leaves:
        np_dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        arrays.append(host[at:at + x.numel()].reshape(tuple(x.shape)).astype(np_dtype))
        at += x.numel()
    it = iter(arrays)
    return tuple(lm.tree_map(lambda _: next(it), tree) for tree in trees)


_SINGULAR = (
    "covariance: information matrix is singular — the graph is "
    "under-constrained"
)


def _marginal_blocks(method: str, J_ref: Tensor, J_qry: Tensor, J_s: Tensor,
                     ref_i: Tensor, qry_i: Tensor, loop_slot: Tensor, free: np.ndarray,
                     want: np.ndarray, L: int, rcm=None, plan=None, prior_blocks=None,
                     singular: str = _SINGULAR) -> np.ndarray:
    """(n, d, d) host float64 marginal covariance blocks of the poses at
    registry positions ``want``, from the gauge-masked per-edge Jacobian
    blocks on the pose chart (d columns) and the switch column ``J_s``;
    constant poses get zero blocks. One device-to-host copy.

    "dense" inverts the (dP+L)^2 information with its constant-pose rows
    and columns dropped (``torch.linalg.inv_ex``: LU, as the JAX package's
    ``np.linalg.inv``; a singular matrix raises ValueError(``singular``)),
    ``prior_blocks`` {position: (d, d)} added; "banded" eliminates each
    switch exactly and runs the selected-inverse recurrence over the RCM
    superblocks ``rcm`` = (perm, inv, s); "sparse" eliminates the switches
    and runs the multifrontal selected inverse over ``plan``."""
    P = len(free)
    d = J_ref.shape[-1]
    dtype, device = J_ref.dtype, J_ref.device
    up = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    want = np.asarray(want, np.int64)
    if method == "dense":
        dim = d * P + L
        ds = torch.arange(d, device=device)
        rows_ref = d * ref_i[:, None] + ds  # (E, d)
        rows_qry = d * qry_i[:, None] + ds
        cross = J_ref.mT @ J_qry
        index = [rows_ref[:, :, None] * dim + rows_ref[:, None, :],
                 rows_qry[:, :, None] * dim + rows_qry[:, None, :],
                 rows_ref[:, :, None] * dim + rows_qry[:, None, :],
                 rows_qry[:, :, None] * dim + rows_ref[:, None, :]]
        values = [J_ref.mT @ J_ref, J_qry.mT @ J_qry, cross, cross.mT]
        if L:
            cols_sw = (d * P + loop_slot)[:, None]  # (E, 1)
            b_rs = _btv(J_ref, J_s)
            b_qs = _btv(J_qry, J_s)
            index += [rows_ref * dim + cols_sw, cols_sw * dim + rows_ref,
                      rows_qry * dim + cols_sw, cols_sw * dim + rows_qry,
                      cols_sw * dim + cols_sw]
            values += [b_rs, b_rs, b_qs, b_qs, torch.sum(J_s * J_s, dim=1)]
        H = torch.zeros(dim * dim, dtype=dtype, device=device)
        _scatter_add(H, torch.cat([i.reshape(-1) for i in index]),
                     torch.cat([v.reshape(-1) for v in values]))
        H = H.reshape(dim, dim)
        for i, block in (prior_blocks or {}).items():
            H[d * i:d * i + d, d * i:d * i + d] += torch.as_tensor(block, dtype=dtype, device=device)
        # drop the constant poses' rows and columns, invert
        keep = np.concatenate([np.repeat(free > 0, d), np.ones(L, bool)])
        kept = up(np.flatnonzero(keep))
        Sigma, info = torch.linalg.inv_ex(H[kept][:, kept])
        if int(info) != 0:
            raise ValueError(singular)
        # each wanted free pose's rows in the reduced matrix
        blocks = torch.zeros((len(want), d, d), dtype=dtype, device=device)
        wanted_free = np.flatnonzero(free[want] > 0)
        if len(wanted_free):
            start = d * (np.cumsum(free > 0) - 1)[want[wanted_free]]
            rows = up(start[:, None] + np.arange(d))
            blocks[up(wanted_free)] = Sigma[rows[:, :, None], rows[:, None, :]]
    else:
        B_aa, B_bb, B_ab = _edge_information_blocks(J_ref, J_qry, J_s)
        gauge = torch.as_tensor(1.0 - free, dtype=dtype, device=device)
        if method == "banded":
            perm, inv, s = rcm
            ref_p, qry_p = up(inv)[ref_i], up(inv)[qry_i]
            swap = (qry_p < ref_p)[:, None, None]
            lo, hi = torch.minimum(ref_p, qry_p), torch.maximum(ref_p, qry_p)
            # (row, col) conventions: B_ab is (row ref, col qry); gauge-fixed
            # poses and padding keep an identity diagonal
            K, m, D, O = _scatter_banded_blocks(
                P, d, s, lo, hi, torch.where(swap, B_bb, B_aa), torch.where(swap, B_aa, B_bb),
                torch.where(swap, B_ab, B_ab.mT), gauge[up(perm)][:, None].expand(P, d),
            )
            sig = _block_tridiag_selected_inverse(D, O).reshape(K, s, d, s, d)
            q = inv[want]
            blocks = sig[up(q // s), up(q % s), :, up(q % s), :]
        else:
            fact = multifrontal.factor(plan, B_aa, B_bb, B_ab, gauge[:, None].expand(P, d))
            blocks = multifrontal.selected_inverse_diag(plan, fact)[up(want)]
    keep_want = torch.as_tensor(free[want] > 0, device=device)[:, None, None]
    blocks = torch.where(keep_want, blocks, torch.zeros_like(blocks))
    return blocks.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


# the JAX package's text, word for word
_MESH_SOLVERS = (
    "mesh sharding is implemented for the matrix-free CG path "
    "(edges sharded, whole-loop replication) and the sparse "
    "multifrontal path (fronts partitioned by XLA SPMD over a "
    "Mesh with a 'factors' axis); pass solver='cg' or "
    "solver='sparse' with mesh=..."
)


class PoseGraphOptimizer:
    """Mirror of the reference API (pose_graph_optimizer.h:21-108) with a
    real analytic solve."""

    def __init__(
        self,
        dtype: torch.dtype = torch.float64,
        switch_penalty: float = None,
        solver: str = "dense",
        cg_iterations: int = 250,
        cg_precond: str = "chain",
        edge_loss=None,
        mesh=None,
        device="cuda",
    ):
        """``switch_penalty`` weights the (1 - s) prior row of loop-closure
        switch variables. Default = the reference's 1e-9 for API parity,
        far too weak to keep inlier switches at 1; 0.03 is the measured
        discrimination point on the 80-pose reference fixture.

        ``solver``: "auto" picks the family from the graph's topology at
        solve() time (:func:`select_solver`; the choice lands in
        ``last_solver_choice`` / ``last_selection``); "dense" materializes
        the (7P+L)^2 normal matrix; "tridiag" is cyclic reduction plus a
        Woodbury correction for chain-dominated graphs; "banded" is RCM +
        superblock cyclic reduction for loop-rich graphs with a moderate
        reordered bandwidth; "sparse" is the nested-dissection
        multifrontal Cholesky (``solvers/multifrontal.py``) for loop-rich
        graphs whose band is fat; "cg" is matrix-free preconditioned CG
        (``cg_iterations`` per LM step, ``cg_precond`` "chain" or
        "jacobi").

        ``mesh``: optional ``parallel.FactorMesh`` for the "cg" path (the
        edges sharded over the ranks of a process group, every edge
        reduction summed across them, the LM and CG loop the same on every
        rank) and the "sparse" path (each tree level's fronts factored
        block by block over the ranks and gathered).

        ``edge_loss``: optional robust loss (e.g. ``HuberLoss``) over each
        edge block's squared residual norm, Ceres-style.

        ``device``: where the solve runs, default "cuda"; raises without a
        GPU unless "cpu" is asked for."""
        if solver not in ("auto", "dense", "cg", "tridiag", "banded", "sparse"):
            raise ValueError(f"unknown solver {solver!r}")
        if cg_precond not in ("chain", "jacobi"):
            raise ValueError(f"unknown cg_precond {cg_precond!r}")
        if mesh is not None and solver not in ("cg", "sparse"):
            raise ValueError(_MESH_SOLVERS)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dtype = dtype
        self.solver = solver
        self.cg_iterations = cg_iterations
        self.cg_precond = cg_precond
        self.edge_loss = edge_loss
        self.switch_penalty = (
            SWITCH_PENALTY_SCALE if switch_penalty is None else switch_penalty
        )
        self._poses: Dict[int, Pose] = {}
        self._constant: set = set()
        self._priors: Dict[int, tuple] = {}  # index -> (mean (7,), S (6, 6))
        self._constraints: List[dict] = []
        # Flattening / upload caches, invalidated on registry mutation:
        # the SoA arrays and device uploads only change when the topology
        # does; the packed (P, 3) + (P, 4) pose state is kept up to date
        # through a dirty set.
        self._topo_version = 0
        self._flat_cache: Optional[dict] = None
        self._packed_poses: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._dirty_poses: set = set()
        # after a solve the packed arrays are the authoritative state and
        # self._poses entries are stale until get_pose() materializes them
        self._poses_stale = False

    # -- registry (reference :40-60) ---------------------------------------
    def set_pose(self, index: int, pose: Pose) -> None:
        """Copies the pose in (reference SetPose copies into PoseParameter)."""
        if index not in self._poses:
            self._topo_version += 1  # pose ordering changes
        self._poses[index] = pose.copy()
        self._dirty_poses.add(index)

    def set_pose_constant(self, index: int) -> None:
        if index not in self._poses:
            raise KeyError(f"pose {index} not registered")
        self._constant.add(index)

    def set_prior(self, index: int, pose: Pose, sqrt_info=1.0) -> None:
        """Unary Gaussian prior on one pose: residual S [p - p0 ; 2 vec(q0^-1
        (x) n(q))] over 6-DoF tangent coordinates at ``pose``. ``sqrt_info``
        accepts scalar / (2,) (trans, rot) / (6,) diagonal / full (6, 6).
        Priors anchor the gauge; one prior per pose (a second call replaces
        the first). Dense path only (``solver="dense"`` or "auto")."""
        if index not in self._poses:
            raise KeyError(f"pose {index} not registered")
        w = _expand_sqrt_info(sqrt_info)
        S = np.diag(w) if w.ndim == 1 else w
        mean = np.concatenate([pose.translation, pose.quaternion()])
        self._priors[index] = (mean, S)

    def set_constraint(
        self,
        reference_index: int,
        query_index: int,
        relative_pose: Pose,
        constraint_type: int = ConstraintType.ODOMETRY,
        sqrt_info=None,
    ) -> None:
        """Reference SetConstraint validation (:62-87). ``sqrt_info``
        optionally whitens the 6-D residual: scalar, (2,) = (1/sigma_t,
        1/sigma_theta), (6,) diagonal or a full (6, 6) S with S^T S =
        Omega (:func:`sqrt_info_from_information`)."""
        if reference_index not in self._poses or query_index not in self._poses:
            raise KeyError("constraint endpoints must be registered poses")
        if reference_index == query_index:
            raise ValueError("self-constraint is not allowed")
        self._topo_version += 1
        self._constraints.append(
            dict(
                reference_index=reference_index,
                query_index=query_index,
                relative_pose=relative_pose.copy(),
                type=constraint_type,
                sqrt_info=_expand_sqrt_info(sqrt_info),
            )
        )

    def get_pose(self, index: int) -> Pose:
        if self._poses_stale and index not in self._dirty_poses:
            i = self._flat_cache["index_of"][index]
            pos, quat = self._packed_poses
            return Pose(np_quat_to_rotmat(quat[i]), pos[i])
        return self._poses[index].copy()

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    @property
    def num_constraints(self) -> int:
        return len(self._constraints)

    def pose_indices(self) -> List[int]:
        """Registered pose ids, sorted (the solver's packing order)."""
        return sorted(self._poses)

    def constraints(self) -> List[dict]:
        """Shallow copies of the registered constraint records."""
        return [dict(c) for c in self._constraints]

    # -- flattening caches ---------------------------------------------------
    def _edges(self, ref_idx, query_idx, rel_t, rel_q, is_loop, sqrt_info,
               dtype=None) -> PoseGraphEdges:
        dev, dtype = self.device, dtype or self.dtype
        return PoseGraphEdges(
            reference_indices=torch.as_tensor(np.asarray(ref_idx, np.int64), device=dev),
            query_indices=torch.as_tensor(np.asarray(query_idx, np.int64), device=dev),
            relative_translations=torch.as_tensor(rel_t, dtype=dtype, device=dev),
            relative_quaternions=torch.as_tensor(rel_q, dtype=dtype, device=dev),
            is_loop=torch.as_tensor(is_loop, dtype=dtype, device=dev),
            mask=torch.ones(len(ref_idx), dtype=dtype, device=dev),
            sqrt_info=None if sqrt_info is None else torch.as_tensor(sqrt_info, dtype=dtype, device=dev),
        )

    def _flatten(self) -> dict:
        """Constraint SoA arrays and device uploads, cached per topology
        version."""
        if self._flat_cache is not None and self._flat_cache["version"] == self._topo_version:
            return self._flat_cache
        # flush solved-but-unmaterialized state before re-ordering
        self._materialize()
        indices = sorted(self._poses)
        index_of = {pi: i for i, pi in enumerate(indices)}
        cs = self._constraints
        ref_idx = np.array([index_of[c["reference_index"]] for c in cs], np.int32)
        query_idx = np.array([index_of[c["query_index"]] for c in cs], np.int32)
        rel_t = np.stack([c["relative_pose"].translation for c in cs])
        rel_q = np.stack([c["relative_pose"].quaternion() for c in cs])
        is_loop = np.array([1.0 if c["type"] == ConstraintType.LOOP else 0.0 for c in cs])
        sqrt_info = stack_sqrt_info([c["sqrt_info"] for c in cs], 6)
        self._flat_cache = dict(
            version=self._topo_version, indices=indices, index_of=index_of,
            P=len(indices), E=len(cs), L=int(is_loop.sum()),
            ref_idx=ref_idx, query_idx=query_idx, rel_t=rel_t, rel_q=rel_q,
            is_loop=is_loop, sqrt_info=sqrt_info,
            edges_dev=self._edges(ref_idx, query_idx, rel_t, rel_q, is_loop, sqrt_info),
            tridiag=None,
        )
        self._packed_poses = None  # pose ordering may have changed
        return self._flat_cache

    def _flatten_tridiag(self, flat: dict) -> dict:
        """Chain/correction partition and reordered device edges for the
        tridiag solver, attached to the topology cache. Chain = adjacent
        non-loop edges (sorted by lo); everything else enters the
        Woodbury correction, loops keeping their relative order."""
        if flat["tridiag"] is not None:
            return flat["tridiag"]
        P = flat["P"]
        ref_idx, query_idx = flat["ref_idx"], flat["query_idx"]
        is_loop = flat["is_loop"]
        adj = np.abs(ref_idx.astype(np.int64) - query_idx.astype(np.int64)) == 1
        chain_sel = adj & (is_loop == 0)
        chain_ids = np.nonzero(chain_sel)[0]
        corr_ids = np.nonzero(~chain_sel)[0]
        lo_all = np.minimum(ref_idx, query_idx)
        chain_ids = chain_ids[np.argsort(lo_all[chain_ids], kind="stable")]
        order = np.concatenate([chain_ids, corr_ids])
        chain_lo = lo_all[chain_ids].astype(np.int64)
        chain_forward = (ref_idx < query_idx)[chain_ids]
        # every consecutive pair covered exactly once: the chain segment
        # sums become shift-adds
        chain_seq = bool(
            len(chain_ids) == P - 1 and np.array_equal(chain_lo, np.arange(P - 1))
        )
        sqrt_info = flat["sqrt_info"]
        flat["tridiag"] = dict(
            edges_r=self._edges(
                ref_idx[order], query_idx[order], flat["rel_t"][order],
                flat["rel_q"][order], is_loop[order],
                None if sqrt_info is None else sqrt_info[order],
            ),
            chain_lo=torch.as_tensor(chain_lo, device=self.device),
            chain_forward=torch.as_tensor(chain_forward, dtype=self.dtype, device=self.device),
            num_chain=int(len(chain_ids)),
            chain_seq=chain_seq,
        )
        return flat["tridiag"]

    def _flatten_banded(self, flat: dict) -> dict:
        """Host symbolic phase of the banded solver, cached per topology:
        RCM ordering, bandwidth, superblock size and the permuted device
        edges. Raises when the superblock panels would pass the JAX
        package's 2 GiB guard."""
        if flat.get("banded") is not None:
            return flat["banded"]
        P = flat["P"]
        perm, inv, bandwidth = self._rcm_cached(flat)
        s = max(bandwidth, 8)
        K = -(-P // s)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        # superblock panel memory (the factorization roughly doubles it)
        panel_bytes = K * (s * 7) ** 2 * itemsize
        if panel_bytes > 2 << 30:
            raise ValueError(
                f"banded solver: RCM bandwidth {bandwidth} over {P} poses "
                f"needs ~{2 * panel_bytes / 1e9:.1f} GB of superblock "
                "panels — the graph's loop structure is not band-friendly; "
                "use solver='cg' (matrix-free) instead"
            )
        flat["banded"] = dict(
            perm=perm, inv=inv, super_size=s, bandwidth=bandwidth,
            edges_p=self._edges(
                inv[flat["ref_idx"]], inv[flat["query_idx"]], flat["rel_t"],
                flat["rel_q"], flat["is_loop"], flat["sqrt_info"],
            ),
        )
        return flat["banded"]

    def _flatten_sparse(self, flat: dict, positions: np.ndarray) -> dict:
        """Host symbolic phase of the nested-dissection multifrontal
        solver, cached per topology: separator tree and index maps
        (``solvers/multifrontal.py``). Pose positions seed the geometric
        median cuts, the natural dissection oracle for SLAM graphs. The
        plan's index maps go to the device once, on the first solve."""
        if flat.get("sparse") is not None:
            return flat["sparse"]
        plan = multifrontal.symbolic(
            flat["P"],
            flat["ref_idx"].astype(np.int64),
            flat["query_idx"].astype(np.int64),
            d=7,
            coords=np.asarray(positions, np.float64),
            leaf_size=16,
        )
        flat["sparse"] = dict(plan=plan)
        return flat["sparse"]

    def _rcm_cached(self, flat: dict):
        """(perm, inv, bandwidth) of the RCM ordering, cached on the
        topology cache (shared by selection and the banded phase)."""
        if flat.get("rcm") is None:
            flat["rcm"] = _rcm_perm_bandwidth(flat["P"], flat["ref_idx"], flat["query_idx"])
        return flat["rcm"]

    def _materialize(self) -> None:
        """Flush lazily written-back solve results into the Pose registry."""
        if not self._poses_stale:
            return
        index_of = self._flat_cache["index_of"]
        pos, quat = self._packed_poses
        for pi in self._poses:
            if pi not in self._dirty_poses:
                i = index_of[pi]
                self._poses[pi] = Pose(np_quat_to_rotmat(quat[i]), pos[i])
        self._poses_stale = False

    def _packed(self, indices, index_of) -> Tuple[np.ndarray, np.ndarray]:
        """Current (P, 3) positions + (P, 4) quaternions; only poses touched
        by set_pose since the last solve are re-extracted."""
        if self._packed_poses is None or self._packed_poses[0].shape[0] != len(indices):
            positions = np.stack([self._poses[pi].translation for pi in indices]).astype(np.float64)
            quaternions = np.stack([self._poses[pi].quaternion() for pi in indices]).astype(np.float64)
            self._packed_poses = (positions, quaternions)
        elif self._dirty_poses:
            positions, quaternions = self._packed_poses
            for pi in self._dirty_poses:
                i = index_of[pi]
                positions[i] = self._poses[pi].translation
                quaternions[i] = self._poses[pi].quaternion()
        self._dirty_poses.clear()
        return self._packed_poses

    # -- initialization ------------------------------------------------------
    def initialize(
        self,
        method: str = "chordal",
        include_loops: bool = True,
        cg_iterations: int = 300,
        init_dtype: torch.dtype = torch.float32,
    ) -> None:
        """Replace the non-constant pose estimates with an initialization
        computed from the relative-pose measurements (the registry's
        current values are ignored except at anchors).

        ``method="spanning_tree"`` composes measurements along a BFS tree
        from the anchors (odometry edges preferred); ``"chordal"`` solves
        the rotation-averaging chordal relaxation and a translation
        Laplacian by preconditioned CG on the optimizer's device (see
        ``solvers/graph_init.py``).

        ``include_loops=False`` initializes from odometry edges only,
        robust when loop measurements may contain outliers (chordal
        averaging has no switch variables; a wrong loop bends the whole
        init). Anchors: the ``set_pose_constant`` poses, else the lowest
        pose index at its current registry value.

        ``init_dtype``: precision of the chordal CG solves. float32 is the
        JAX package's default, chosen there for its chip's emulated
        float64; the initializer's float32 residual floor lies deep inside
        LM's basin. Pass torch.float64 for a float64 initialization."""
        from . import graph_init

        flat = self._flatten()
        indices, index_of = flat["indices"], flat["index_of"]
        P = flat["P"]
        ref_idx, query_idx = flat["ref_idx"], flat["query_idx"]
        rel_t, rel_q = flat["rel_t"], flat["rel_q"]
        is_loop = flat["is_loop"]

        if not include_loops:
            keep = is_loop == 0.0
            ref_idx, query_idx = ref_idx[keep], query_idx[keep]
            rel_t, rel_q = rel_t[keep], rel_q[keep]
            is_loop = is_loop[keep]

        anchor_ids = sorted(self._constant) or [indices[0]]
        anchors = {}
        for pi in anchor_ids:
            p = self.get_pose(pi)
            anchors[index_of[pi]] = (p.rotation, p.translation)

        if method == "spanning_tree":
            t, q = graph_init.spanning_tree_init(
                ref_idx, query_idx, rel_q, rel_t, P, anchors, edge_priority=is_loop,
            )
        elif method == "chordal":
            t, q = graph_init.chordal_init(
                ref_idx, query_idx, rel_q, rel_t, P, anchors,
                cg_iterations=cg_iterations, dtype=init_dtype, device=self.device,
            )
        else:
            raise ValueError(
                f"unknown initialization method {method!r} "
                "(spanning_tree | chordal)"
            )

        for pi in indices:
            if pi in self._constant:
                continue
            i = index_of[pi]
            self.set_pose(pi, Pose(np_quat_to_rotmat(q[i]), t[i]))

    # -- solve ---------------------------------------------------------------
    def solve(self, options: Optional[Options] = None) -> Tuple[lm.Summary, np.ndarray]:
        """Optimize all registered poses; write results back into the
        registry with quaternion renormalization (reference
        UpdateOptimizedPose, pose_graph_optimizer.h:89-101).

        Returns (summary, switch_values); the summary's tensors stay on the
        solve's device."""
        if options is None:
            # the reference's pose-graph test runs Ceres with 500 iterations
            # (pose_graph_optimizer_ceres.cc:49-59)
            options = Options().replace(max_iterations=500)
        if not self._constraints:
            raise ValueError(
                "PoseGraphOptimizer.solve: no constraints registered; add "
                "edges with set_constraint() before solving (a graph of "
                "only poses has nothing to optimize)"
            )
        if self._priors and self.solver not in ("dense", "auto"):
            raise ValueError(
                "set_prior is implemented on the dense path; construct "
                "with solver='dense' (or anchor via set_pose_constant)"
            )
        flat = self._flatten()
        indices, index_of = flat["indices"], flat["index_of"]
        P, L = flat["P"], flat["L"]
        positions, quaternions = self._packed(indices, index_of)

        dev, dtype = self.device, self.dtype
        free = np.ones(P)
        for pi in self._constant:
            free[index_of[pi]] = 0.0
        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        switches0 = torch.ones(L, dtype=dtype, device=dev)  # inliers at start

        solver = self.solver
        if solver == "auto":
            if self._priors:
                solver = "dense"  # priors are a dense-path feature
                self.last_selection = dict(reason="priors registered")
            else:
                solver, self.last_selection = select_solver(
                    P, flat["ref_idx"], flat["query_idx"], flat["is_loop"], 7,
                    plan_fn=lambda: self._flatten_sparse(flat, positions)["plan"],
                    bandwidth=self._rcm_cached(flat)[2],
                )
        self.last_solver_choice = solver

        common = (self.switch_penalty, self.edge_loss)
        pose_np = np.concatenate([positions, quaternions], axis=1)
        pose0 = tensor(pose_np)
        if solver == "sparse":
            sp = self._flatten_sparse(flat, positions)
            pose, sw, summary = _pose_graph_solve_sparse(
                pose0, switches0, flat["edges_dev"], tensor(free), *common, P, L,
                sp["plan"], options, self.mesh,
            )
        elif solver == "banded":
            bd = self._flatten_banded(flat)
            perm = bd["perm"]
            pose_p, sw, summary = _pose_graph_solve_banded(
                tensor(pose_np[perm]), switches0, bd["edges_p"],
                tensor(free[perm]), *common, P, L, bd["super_size"], options,
            )
            # un-permute back to registry order on the device
            pose = pose_p[torch.as_tensor(bd["inv"], device=dev)]
        elif solver == "tridiag":
            td = self._flatten_tridiag(flat)
            pose, sw, summary = _pose_graph_solve_tridiag(
                pose0, switches0, td["edges_r"], tensor(free), *common,
                td["chain_lo"], td["chain_forward"], td["num_chain"], P, L, options,
                td["chain_seq"],
            )
        elif solver == "cg":
            pose, sw, summary = _pose_graph_solve_cg(
                pose0, switches0, flat["edges_dev"], tensor(free), *common, P, L,
                options, self.cg_iterations, self.cg_precond, self.mesh,
            )
        else:
            pose, sw, summary = _pose_graph_solve(
                pose0[None], switches0[None], flat["edges_dev"], tensor(free), *common, P, L,
                options, *self._prior_args(index_of),
            )
            pose, sw, summary = pose[0], sw[0], lm.instance(summary, 0)
        pos, quat = pose[:, :3], pose[:, 3:]
        # one device-to-host copy of the solved state
        state = torch.cat([pos.reshape(-1), quat.reshape(-1), sw]).cpu().numpy()
        pos = state[: 3 * P].reshape(P, 3).astype(np.float64)
        quat = state[3 * P: 7 * P].reshape(P, 4).astype(np.float64)
        sw = state[7 * P:].astype(np.float64)
        # renormalize on write-back, lazily: the packed arrays become the
        # authoritative state and Pose objects materialize per get_pose()
        quat = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        self._packed_poses = (pos, quat)
        self._poses_stale = True
        self._dirty_poses.clear()
        self._last_switches = sw.copy()
        return summary, sw

    def _prior_args(self, index_of: dict):
        """Device tensors of the tangent-space unary priors consumed by the
        dense path (Nones when no priors are set)."""
        if not self._priors:
            return None, None, None, None
        sel = sorted(self._priors)
        B = len(sel)
        S = np.zeros((6 * B, 6 * B))
        for k, pi in enumerate(sel):
            S[6 * k: 6 * k + 6, 6 * k: 6 * k + 6] = self._priors[pi][1]
        dev, dtype = self.device, self.dtype
        return (
            torch.as_tensor(S, dtype=dtype, device=dev),
            torch.as_tensor(np.stack([self._priors[pi][0] for pi in sel]), dtype=dtype, device=dev),
            torch.as_tensor(np.array([index_of[pi] for pi in sel], np.int64), device=dev),
            torch.zeros(6 * B, dtype=dtype, device=dev),
        )

    # -- batched serving solves ----------------------------------------------
    def solve_batch(
        self,
        batch_size: Optional[int] = None,
        initial_positions=None,  # (B, P, 3), pose_indices() order
        initial_quaternions=None,  # (B, P, 4) wxyz
        relative_translations=None,  # (B, E, 3), constraints() order
        relative_quaternions=None,  # (B, E, 4) wxyz
        options: Optional[Options] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, lm.Summary]:
        """Solve B independent instances sharing THIS graph's topology at
        once on the dense direct path (serving mode: Monte-Carlo and
        multi-hypothesis back ends).

        All instances share the edge structure: endpoint indices, loop
        flags, per-edge sqrt-information, gauge fixing, switch penalty,
        edge loss, and any unary priors. Per-instance inputs (each
        optional; this graph's own state and measurements are broadcast
        for whatever is omitted):

        - ``initial_positions`` / ``initial_quaternions``: starting
          estimates, ordered like :meth:`pose_indices`;
        - ``relative_translations`` / ``relative_quaternions``: edge
          measurements, ordered like :meth:`constraints`.

        Each instance keeps its own lambda and done flag, and follows its
        serial ``solve()`` to float64 roundoff (``_pose_graph_solve``).
        ``batch_size`` is required only when every
        per-instance input is omitted. The registry is NOT written back;
        returns ``(positions (B, P, 3), quaternions (B, P, 4)
        renormalized, switches (B, L), summary)`` as numpy arrays, the
        summary's fields with a leading B, from one device-to-host copy."""
        if self.solver not in ("dense", "auto"):
            raise ValueError(
                "solve_batch runs on the dense direct path; construct the "
                "optimizer with solver='dense' (CG/tridiag batching would "
                "multiply their iteration-count compromises, not amortize "
                "them)"
            )
        if self.solver == "auto" and 7 * len(self._poses) > 6000:
            raise ValueError(
                "solve_batch materializes B dense (7P+L)^2 systems — at "
                f"{len(self._poses)} poses that is far past the dense "
                "envelope 'auto' would pick for solve(); batch serving is "
                "a small-graph shape (construct with solver='dense' "
                "explicitly to override)"
            )
        if options is None:
            options = Options().replace(max_iterations=500)
        if not self._constraints:
            raise ValueError(
                "PoseGraphOptimizer.solve_batch: no constraints registered"
            )
        flat = self._flatten()
        indices, index_of = flat["indices"], flat["index_of"]
        P, E, L = flat["P"], flat["E"], flat["L"]
        B = _batch_size(batch_size, initial_positions, initial_quaternions,
                        relative_translations, relative_quaternions)
        batched = _batched_input(B, self.dtype, self.device)
        pos0, quat0 = self._packed(indices, index_of)
        pos_b = batched(initial_positions, pos0, (P, 3), "initial_positions")
        quat_b = batched(initial_quaternions, quat0, (P, 4), "initial_quaternions")
        rel_t_b = batched(relative_translations, flat["rel_t"], (E, 3), "relative_translations")
        rel_q_b = batched(relative_quaternions, flat["rel_q"], (E, 4), "relative_quaternions")

        free = np.ones(P)
        for pi in self._constant:
            free[index_of[pi]] = 0.0
        edges_b = flat["edges_dev"]._replace(
            relative_translations=rel_t_b, relative_quaternions=rel_q_b
        )
        pose, sw, summary = _pose_graph_solve(
            torch.cat([pos_b, quat_b], dim=2),
            torch.ones((B, L), dtype=self.dtype, device=self.device),
            edges_b, torch.as_tensor(free, dtype=self.dtype, device=self.device),
            self.switch_penalty, self.edge_loss, P, L, options, *self._prior_args(index_of),
        )
        (pose, sw), summary = _fetch((pose, sw), summary)
        pos = pose[..., :3].astype(np.float64)
        quat = pose[..., 3:].astype(np.float64)
        quat = quat / np.linalg.norm(quat, axis=2, keepdims=True)
        return pos, quat, sw.astype(np.float64), summary

    # -- marginal covariances ------------------------------------------------
    def _tangent_edge_blocks(self, flat):
        """Linearization of every constraint on the 6-DoF tangent chart at
        the current estimates (unit quaternions), on the device in
        float64, with the switch values of the last ``solve()``
        (ones before any solve) and the gauge mask; shared by the three
        covariance paths. Returns (J_ref6, J_qry6, J_s, the ``_Graph``,
        free (P,), unit quaternions (P, 4) and Tq (P, 4, 3), the last
        three host numpy)."""
        index_of = flat["index_of"]
        P, L = flat["P"], flat["L"]
        pos, quat = self._packed(flat["indices"], index_of)
        pos = pos.astype(np.float64)
        quat = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        sw = getattr(self, "_last_switches", None)
        if sw is None or len(sw) != L:
            sw = np.ones(L)
        free = np.ones(P)
        for pi in self._constant:
            free[index_of[pi]] = 0.0
        tensor = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)
        edges = flat["edges_dev"]
        if self.dtype != torch.float64:  # the registry's float64 measurements
            edges = self._edges(flat["ref_idx"], flat["query_idx"], flat["rel_t"], flat["rel_q"],
                                flat["is_loop"], flat["sqrt_info"], dtype=torch.float64)
        graph = _Graph(edges, tensor(free), P, L, self.switch_penalty, self.edge_loss)
        _, J_ref, J_qry, J_s, _ = graph.linearize(tensor(np.concatenate([pos, quat], 1)), tensor(sw))
        # chain the ambient (E, 7, 7) blocks onto the per-pose tangent chart
        # dq = n(q) (x) (0, dtheta / 2)
        Tq = 0.5 * lie.np_quat_left_matrix(quat)[:, :, 1:]  # (P, 4, 3)
        Tq_dev = tensor(Tq)
        J_ref = torch.cat([J_ref[:, :, :3], J_ref[:, :, 3:] @ Tq_dev[graph.ref_i]], dim=2)
        J_qry = torch.cat([J_qry[:, :, :3], J_qry[:, :, 3:] @ Tq_dev[graph.qry_i]], dim=2)
        return J_ref, J_qry, J_s, graph, free, quat, Tq

    def _covariance_sparse_plan(self, flat):
        """d=6 tangent-chart dissection plan for the selected-inverse
        covariance (separate from the solver's d=7 ambient plan; cached per
        topology)."""
        if flat.get("sparse_cov") is not None:
            return flat["sparse_cov"]
        pos, _ = self._packed(flat["indices"], flat["index_of"])
        flat["sparse_cov"] = multifrontal.symbolic(
            flat["P"],
            flat["ref_idx"].astype(np.int64),
            flat["query_idx"].astype(np.int64),
            d=6,
            coords=np.asarray(pos, np.float64),
            leaf_size=16,
        )
        return flat["sparse_cov"]

    def covariance(
        self,
        indices: Optional[List[int]] = None,
        method: str = "auto",
    ) -> Dict[int, np.ndarray]:
        """Marginal 6x6 TANGENT-space covariance blocks per pose.

        Linearizes every constraint (with the switch values learned by the
        last ``solve()``, ones before any solve) at the current estimates,
        assembles the Gauss-Newton information over the 6-DoF local chart
        per free pose (dp; dtheta with q -> n(q) (x) (1, dtheta/2)) plus
        the loop switch variables, and returns the pose-diagonal blocks of
        its inverse. Constant (gauge) poses get a zero block.

        ``method``: "dense" inverts the full (6P+L)^2 information
        (O(dim^3); priors included); "banded" computes the same blocks by
        the exact block-tridiagonal selected-inverse recurrence over RCM
        superblocks (O(K (6s)^3)); "sparse" by the multifrontal selected
        inverse over a nested-dissection plan (``solvers/multifrontal.py``);
        switch variables are eliminated exactly per edge first in both.
        "auto" (default): dense up to 500 poses or with priors, else banded
        when its panels pass the memory guard, else sparse, else dense.
        Everything runs on the optimizer's device in float64, with one
        device-to-host copy of the requested blocks.

        Returns {pose_index: (6, 6) ndarray}."""
        flat = self._flatten()
        all_indices, index_of = flat["indices"], flat["index_of"]
        P, E, L = flat["P"], flat["E"], flat["L"]
        if E == 0:
            raise ValueError("covariance: no constraints registered")
        if not self._constant and not self._priors:
            raise ValueError(
                "covariance: gauge-free graph has unbounded covariance; "
                "fix at least one pose with set_pose_constant() or anchor "
                "one with set_prior()"
            )
        if method not in ("auto", "dense", "banded", "sparse"):
            raise ValueError(f"unknown covariance method {method!r}")
        if method == "auto":
            if P <= 500 or self._priors:
                method = "dense"
            elif _banded_covariance_fits(P, self._rcm_cached(flat)[2], 6):
                method = "banded"
            else:
                try:
                    self._covariance_sparse_plan(flat)
                    method = "sparse"
                except ValueError:
                    method = "dense"
        if method in ("banded", "sparse") and self._priors:
            raise ValueError(
                f"covariance(method={method!r}) does not support "
                "priors yet; use method='dense'"
            )
        rcm = plan = prior_blocks = None
        if method == "banded":
            perm, inv, bw = self._rcm_cached(flat)
            if not _banded_covariance_fits(P, bw, 6):
                raise ValueError(
                    f"covariance(method='banded'): RCM bandwidth {bw} over "
                    f"{P} poses needs tens of GB of host panels; use "
                    "method='sparse' (multifrontal selected inverse)"
                )
            rcm = (perm, inv, max(bw, 8))
        elif method == "sparse":
            plan = self._covariance_sparse_plan(flat)
        J_ref, J_qry, J_s, graph, free, quat, Tq = self._tangent_edge_blocks(flat)
        if method == "dense" and self._priors:
            # prior factors r_p = S dphi, chained onto the tangent chart at
            # the current estimate: J_tan = S d(dphi)/d(ambient)
            # blkdiag(I3, Tq) (the dense solver's prior block)
            prior_blocks = {}
            for pi, (mean, S) in self._priors.items():
                i = index_of[pi]
                q = quat[i]
                q_lin = mean[3:] / np.linalg.norm(mean[3:])
                Dn = np.eye(4) - np.outer(q, q)  # d(q/|q|)/dq at |q| = 1
                dq = 2.0 * (lie.np_quat_left_matrix(lie.np_quat_conjugate(q_lin)) @ Dn)[1:, :]
                T_amb = np.zeros((6, 7))
                T_amb[:3, :3] = np.eye(3)
                T_amb[3:, 3:] = dq
                chart = np.zeros((7, 6))
                chart[:3, :3] = np.eye(3)
                chart[3:, 3:] = Tq[i]
                J = S @ T_amb @ chart
                prior_blocks[i] = J.T @ J
        if indices is None:
            indices = all_indices
        want = np.array([index_of[pi] for pi in indices], np.int64)
        blocks = _marginal_blocks(
            method, J_ref, J_qry, J_s, graph.ref_i, graph.qry_i, graph.loop_slot, free, want,
            L, rcm=rcm, plan=plan, prior_blocks=prior_blocks,
            singular="covariance: information matrix is singular — the graph "
            "is under-constrained (disconnected components or unobserved poses)",
        )
        return {pi: blocks[k] for k, pi in enumerate(indices)}


# ----------------------------------------------------------------------------
# SE(2) pose graph (BASELINE config 4: "2D and 3D relative-pose graph").
# The reference repo has no 2D graph module; this follows the standard
# g2o-style SE(2) edge with the same switchable-constraint treatment and
# the same solve paths as the 3D optimizer above.
# ----------------------------------------------------------------------------


class PoseGraph2DEdges(NamedTuple):
    reference_indices: Tensor  # (E,) int64
    query_indices: Tensor  # (E,) int64
    relative_xyt: Tensor  # (E, 3) (dx, dy, dtheta) in the reference frame
    is_loop: Tensor  # (E,)
    mask: Tensor  # (E,)
    # optional sqrt-information: (E, 3) diagonal rows (1/sigma_x,
    # 1/sigma_y, 1/sigma_theta) or (E, 3, 3) full matrices (g2o EDGE_SE2
    # information; see io/g2o.py). None = unit weights. Penalty row
    # unwhitened.
    sqrt_info: Optional[Tensor] = None

    @property
    def num_edges(self) -> int:
        return self.reference_indices.shape[0]


def _wrap_angle(a: Tensor) -> Tensor:
    """Branch-free angle wrap to (-pi, pi]: atan2(sin a, cos a), as the
    JAX package writes it (a remainder differs at +-pi)."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def se2_edge_residual(xyt_ref: Tensor, xyt_query: Tensor, rel: Tensor) -> Tensor:
    """r = [R(th_r)^T (p_q - p_r) - t_rel ; wrap(th_q - th_r - th_rel)]."""
    c, s = torch.cos(xyt_ref[2]), torch.sin(xyt_ref[2])
    dp = xyt_query[:2] - xyt_ref[:2]
    local = torch.stack([c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1]])
    dth = _wrap_angle(xyt_query[2] - xyt_ref[2] - rel[2])
    return torch.cat([local - rel[:2], dth[None]])


def se2_edge_residuals_and_jacobians(
    xyt: Tensor,  # (P, 3)
    switches: Tensor,  # (E,)
    edges: PoseGraph2DEdges,
    penalty_scale,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Batched SE(2) edge residuals and CLOSED-FORM Jacobian blocks.

    r = [s? * (R(th_r)^T (p_q - p_r) - t_rel) ;
         s? * wrap(th_q - th_r - th_rel) ;
         loop? (1 - s) * penalty]                         (E, 4)
    J_ref/J_query (E, 4, 3) with respect to (x, y, th); J_s (E, 4). The
    wrap is a piecewise-constant shift, so its derivative is 1 almost
    everywhere."""
    dtype, device = xyt.dtype, xyt.device
    E = edges.mask.shape[0]
    ref = xyt[edges.reference_indices]  # (E, 3)
    qry = xyt[edges.query_indices]
    rel = edges.relative_xyt

    c = torch.cos(ref[:, 2])
    sn = torch.sin(ref[:, 2])
    dx = qry[:, 0] - ref[:, 0]
    dy = qry[:, 1] - ref[:, 1]
    lx = c * dx + sn * dy
    ly = -sn * dx + c * dy
    dth = _wrap_angle(qry[:, 2] - ref[:, 2] - rel[:, 2])
    r3 = torch.stack([lx - rel[:, 0], ly - rel[:, 1], dth], dim=-1)  # (E, 3)

    zero = torch.zeros(E, dtype=dtype, device=device)
    one = torch.ones(E, dtype=dtype, device=device)
    # d local / d th_ref = [[-sn, c], [-c, -sn]] @ d
    dlx_dth = -sn * dx + c * dy
    dly_dth = -c * dx - sn * dy
    J3_ref = torch.stack(
        [
            torch.stack([-c, -sn, dlx_dth], dim=-1),
            torch.stack([sn, -c, dly_dth], dim=-1),
            torch.stack([zero, zero, -one], dim=-1),
        ],
        dim=-2,
    )  # (E, 3, 3)
    J3_query = torch.stack(
        [
            torch.stack([c, sn, zero], dim=-1),
            torch.stack([-sn, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )

    if edges.sqrt_info is not None:
        r3, J3_ref, J3_query = apply_sqrt_info(edges.sqrt_info, r3, J3_ref, J3_query)

    loop = edges.is_loop > 0
    sw = torch.where(loop, switches, one)
    m = edges.mask
    penalty = torch.where(loop, (1.0 - switches) * penalty_scale, zero)
    r = torch.cat([r3 * sw[:, None], penalty[:, None]], dim=-1)
    r = r * m[:, None]
    smm = (sw * m)[:, None, None]
    zero13 = torch.zeros((E, 1, 3), dtype=dtype, device=device)
    J_ref = torch.cat([J3_ref * smm, zero13], dim=-2)  # (E, 4, 3)
    J_query = torch.cat([J3_query * smm, zero13], dim=-2)
    J_s = torch.cat(
        [
            torch.where(loop[:, None], r3, zero[:, None]),
            torch.where(loop, one * -penalty_scale, zero)[:, None],
        ],
        dim=-1,
    ) * m[:, None]  # (E, 4)
    return r, J_ref, J_query, J_s


class PoseGraphOptimizer2D:
    """SE(2) pose-graph optimizer; same API shape as the 3D one. Its solve
    paths are the 3D optimizer's at pose blocks of width 3 (the JAX
    package writes them out a second time, ``_pose_graph_2d_solve*``); the
    dense path's Tikhonov floor is the JAX package's 1e-10 for SE(2)."""

    def __init__(
        self,
        dtype: torch.dtype = torch.float64,
        switch_penalty: float = None,
        edge_loss=None,
        solver: str = "dense",
        cg_iterations: int = 250,
        cg_precond: str = "chain",
        device="cuda",
        mesh=None,
    ):
        """``solver``: "auto" picks dense/banded/sparse/cg from the
        graph's topology at solve() time (:func:`select_solver`; the
        choice lands in ``last_solver_choice`` / ``last_selection``);
        "dense" materializes the (3P+L)^2 normal matrix; "cg" is the
        matrix-free path (same ``cg_iterations`` / ``cg_precond``
        semantics as the 3D optimizer); "banded" is RCM + superblock
        cyclic reduction; "sparse" is the nested-dissection multifrontal
        direct solver (``solvers/multifrontal.py``) for loop-rich
        fat-bandwidth city graphs (Olson's M3500 class) whose RCM
        bandwidth grows with the arena diameter.

        ``device``: where the solve runs, default "cuda"; raises without a
        GPU unless "cpu" is asked for.

        ``mesh``: a ``parallel.FactorMesh`` for the "cg" and "sparse" paths,
        as on the 3D optimizer (the JAX package's SE(2) optimizer takes
        none)."""
        if solver not in ("auto", "dense", "cg", "banded", "sparse"):
            raise ValueError(f"unknown solver {solver!r}")
        if cg_precond not in ("chain", "jacobi"):
            raise ValueError(f"unknown cg_precond {cg_precond!r}")
        if mesh is not None and solver not in ("cg", "sparse"):
            raise ValueError(_MESH_SOLVERS)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dtype = dtype
        self.edge_loss = edge_loss
        self.solver = solver
        self.cg_iterations = cg_iterations
        self.cg_precond = cg_precond
        self.switch_penalty = (
            SWITCH_PENALTY_SCALE if switch_penalty is None else switch_penalty
        )
        self._poses: Dict[int, np.ndarray] = {}  # index -> (x, y, theta)
        self._constant: set = set()
        self._constraints: List[dict] = []
        # nested-dissection plan cache: (topology key, Plan)
        self._sparse_plan = None

    def set_pose(self, index: int, xyt) -> None:
        self._poses[index] = np.asarray(xyt, dtype=np.float64).copy()

    def set_pose_constant(self, index: int) -> None:
        if index not in self._poses:
            raise KeyError(f"pose {index} not registered")
        self._constant.add(index)

    def set_constraint(
        self,
        reference_index: int,
        query_index: int,
        relative_xyt,
        constraint_type: int = ConstraintType.ODOMETRY,
        sqrt_info=None,
    ) -> None:
        """``sqrt_info``: optional whitening: scalar, (2,) = (1/sigma_t,
        1/sigma_theta), (3,) diagonal = (x, y, theta), or a full (3, 3)
        sqrt-information matrix (see :func:`sqrt_info_from_information` /
        io.g2o)."""
        if reference_index not in self._poses or query_index not in self._poses:
            raise KeyError("constraint endpoints must be registered poses")
        if reference_index == query_index:
            raise ValueError("self-constraint is not allowed")
        self._constraints.append(
            dict(
                reference_index=reference_index,
                query_index=query_index,
                relative_xyt=np.asarray(relative_xyt, np.float64).copy(),
                type=constraint_type,
                sqrt_info=_expand_sqrt_info_2d(sqrt_info),
            )
        )

    def get_pose(self, index: int) -> np.ndarray:
        return self._poses[index].copy()

    def pose_indices(self) -> List[int]:
        """Registered pose ids, sorted (the solver's packing order)."""
        return sorted(self._poses)

    def constraints(self) -> List[dict]:
        """Shallow copies of the registered constraint records
        (reference_index, query_index, relative_xyt, type, sqrt_info)."""
        return [dict(c) for c in self._constraints]

    def initialize(
        self,
        method: str = "chordal",
        include_loops: bool = True,
        cg_iterations: int = 300,
    ) -> None:
        """SE(2) counterpart of :meth:`PoseGraphOptimizer.initialize`:
        replace non-constant estimates with a spanning-tree or chordal
        (complex rotation averaging, float64, on the optimizer's device)
        initialization from the edge measurements."""
        from . import graph_init

        indices = sorted(self._poses)
        index_of = {pi: i for i, pi in enumerate(indices)}
        P = len(indices)
        cons = self._constraints
        if not include_loops:
            cons = [c for c in cons if c["type"] != ConstraintType.LOOP]
        ref_idx = np.array([index_of[c["reference_index"]] for c in cons], np.int32)
        query_idx = np.array([index_of[c["query_index"]] for c in cons], np.int32)
        rel_xyt = np.stack([c["relative_xyt"] for c in cons]) if cons else np.zeros((0, 3))
        is_loop = np.array([1.0 if c["type"] == ConstraintType.LOOP else 0.0 for c in cons])
        anchor_ids = sorted(self._constant) or [indices[0]]
        anchors = {index_of[pi]: self._poses[pi].copy() for pi in anchor_ids}

        if method == "spanning_tree":
            xyt = graph_init.spanning_tree_init_2d(
                ref_idx, query_idx, rel_xyt, P, anchors, edge_priority=is_loop
            )
        elif method == "chordal":
            xyt = graph_init.chordal_init_2d(
                ref_idx, query_idx, rel_xyt, P, anchors,
                cg_iterations=cg_iterations, device=self.device,
            )
        else:
            raise ValueError(
                f"unknown initialization method {method!r} "
                "(spanning_tree | chordal)"
            )
        for pi in indices:
            if pi in self._constant:
                continue
            self._poses[pi] = xyt[index_of[pi]].copy()

    def _flat_2d(self, dtype=None):
        """Pack the registry into solver arrays: (indices, index_of, P, L,
        xyt (P, 3), free (P,), ref (E,), qry (E,), is_loop (E,)) on the
        host and the edges on the device, in ``dtype`` (default the
        optimizer's)."""
        indices = sorted(self._poses)
        index_of = {pi: i for i, pi in enumerate(indices)}
        P = len(indices)
        xyt = np.stack([self._poses[pi] for pi in indices])
        cs = self._constraints
        ref = np.array([index_of[c["reference_index"]] for c in cs], np.int64)
        qry = np.array([index_of[c["query_index"]] for c in cs], np.int64)
        is_loop = np.array([1.0 if c["type"] == ConstraintType.LOOP else 0.0 for c in cs])
        L = int(is_loop.sum())
        dev, dtype = self.device, dtype or self.dtype
        tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        w3 = stack_sqrt_info([c["sqrt_info"] for c in cs], 3)
        edges = PoseGraph2DEdges(
            reference_indices=torch.as_tensor(ref, device=dev),
            query_indices=torch.as_tensor(qry, device=dev),
            relative_xyt=tensor(np.stack([c["relative_xyt"] for c in cs])),
            is_loop=tensor(is_loop),
            mask=torch.ones(len(cs), dtype=dtype, device=dev),
            sqrt_info=None if w3 is None else tensor(w3),
        )
        free = np.ones(P)
        for pi in self._constant:
            free[index_of[pi]] = 0.0
        return indices, index_of, P, L, xyt, free, ref, qry, is_loop, edges

    def _sparse_symbolic(self, P, ref_np, qry_np, xyt) -> multifrontal.Plan:
        """Cached nested-dissection plan (``solvers/multifrontal.py``); the
        (x, y) pose positions seed the geometric median cuts. The cache key
        is the topology (endpoint arrays), not the pose values, so the
        plan's device index maps upload once per topology."""
        key = (P, len(ref_np), ref_np.tobytes(), qry_np.tobytes())
        if self._sparse_plan is not None and self._sparse_plan[0] == key:
            return self._sparse_plan[1]
        plan = multifrontal.symbolic(
            P, ref_np, qry_np, d=3, coords=np.asarray(xyt[:, :2], np.float64),
            leaf_size=32,
        )
        self._sparse_plan = (key, plan)
        return plan

    def solve(self, options: Optional[Options] = None):
        """Optimize all registered poses and write them back with theta
        wrapped to (-pi, pi]. Returns (summary, switch_values); the
        summary's tensors stay on the solve's device."""
        if options is None:
            options = Options().replace(max_iterations=500)
        if not self._constraints:
            raise ValueError(
                "PoseGraphOptimizer2D.solve: no constraints registered; add "
                "edges with set_constraint() before solving"
            )
        indices, index_of, P, L, xyt, free, ref_np, qry_np, is_loop, edges = self._flat_2d()
        dev, dtype = self.device, self.dtype
        tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        switches0 = torch.ones(L, dtype=dtype, device=dev)
        common = (self.switch_penalty, self.edge_loss, P, L)

        solver = self.solver
        if solver == "auto":
            # no SE(2) tridiag path exists; a tight band covers chains
            solver, self.last_selection = select_solver(
                P, ref_np, qry_np, is_loop, 3,
                plan_fn=lambda: self._sparse_symbolic(P, ref_np, qry_np, xyt),
                allow_tridiag=False,
            )
        self.last_solver_choice = solver

        if solver == "sparse":
            plan = self._sparse_symbolic(P, ref_np, qry_np, xyt)
            out_xyt, sw, summary = _pose_graph_solve_sparse(
                tensor(xyt), switches0, edges, tensor(free), *common, plan, options, self.mesh,
            )
        elif solver == "banded":
            # host symbolic phase (the 3D optimizer's _flatten_banded
            # recipe): the RCM pose ordering bounds the block bandwidth
            perm, inv, bandwidth = _rcm_perm_bandwidth(P, ref_np, qry_np)
            ssize = max(bandwidth, 8)
            K = -(-P // ssize)
            itemsize = torch.empty((), dtype=dtype).element_size()
            panel_bytes = K * (ssize * 3) ** 2 * itemsize
            if panel_bytes > 2 << 30:
                raise ValueError(
                    f"banded solver: RCM bandwidth {bandwidth} over {P} "
                    f"poses needs ~{2 * panel_bytes / 1e9:.1f} GB of "
                    "superblock panels; use solver='cg' instead"
                )
            index = lambda a: torch.as_tensor(a, device=dev)
            edges_p = edges._replace(
                reference_indices=index(inv[ref_np]), query_indices=index(inv[qry_np])
            )
            xyt_p, sw, summary = _pose_graph_solve_banded(
                tensor(xyt[perm]), switches0, edges_p, tensor(free[perm]), *common,
                ssize, options,
            )
            out_xyt = xyt_p[index(inv)]
        elif solver == "cg":
            out_xyt, sw, summary = _pose_graph_solve_cg(
                tensor(xyt), switches0, edges, tensor(free), *common, options,
                self.cg_iterations, self.cg_precond, self.mesh,
            )
        else:
            out_xyt, sw, summary = _pose_graph_solve(
                tensor(xyt)[None], switches0[None], edges, tensor(free), *common, options,
                floor=1e-10,
            )
            out_xyt, sw, summary = out_xyt[0], sw[0], lm.instance(summary, 0)
        # one device-to-host copy of the solved state
        state = torch.cat([out_xyt.reshape(-1), sw]).cpu().numpy().astype(np.float64)
        out = state[: 3 * P].reshape(P, 3).copy()
        # wrap theta on write-back (the SE(2) analog of quaternion
        # renormalization)
        out[:, 2] = np.arctan2(np.sin(out[:, 2]), np.cos(out[:, 2]))
        for i, pi in enumerate(indices):
            self._poses[pi] = out[i].copy()
        sw = state[3 * P:].copy()
        self._last_switches = sw.copy()
        return summary, sw

    def solve_batch(
        self,
        batch_size: Optional[int] = None,
        initial_xyt=None,  # (B, P, 3), pose_indices() order
        relative_xyt=None,  # (B, E, 3), constraints() order
        options: Optional[Options] = None,
    ):
        """B independent instances sharing THIS graph's topology on the
        dense direct path at once: the SE(2) analog of
        :meth:`PoseGraphOptimizer.solve_batch` (which see: shared
        topology, gauge and weights, per-instance starts and edge
        measurements, registry NOT written back). Returns ``(xyt (B, P, 3)
        theta-wrapped, switches (B, L), summary)``, numpy, from one
        device-to-host copy."""
        if self.solver not in ("dense", "auto"):
            raise ValueError(
                "solve_batch runs on the dense direct path; construct the "
                "optimizer with solver='dense'"
            )
        if self.solver == "auto" and 3 * len(self._poses) > 6000:
            raise ValueError(
                "solve_batch materializes B dense (3P+L)^2 systems — at "
                f"{len(self._poses)} poses that is far past the dense "
                "envelope; construct with solver='dense' explicitly to "
                "override"
            )
        if options is None:
            options = Options().replace(max_iterations=500)
        if not self._constraints:
            raise ValueError(
                "PoseGraphOptimizer2D.solve_batch: no constraints registered"
            )
        indices, index_of, P, L, xyt, free, _, _, _, edges = self._flat_2d()
        E = edges.num_edges
        B = _batch_size(batch_size, initial_xyt, relative_xyt)
        batched = _batched_input(B, self.dtype, self.device)
        xyt_b = batched(initial_xyt, xyt, (P, 3), "initial_xyt")
        rel_b = batched(relative_xyt, edges.relative_xyt, (E, 3), "relative_xyt")
        out_xyt, sw, summary = _pose_graph_solve(
            xyt_b, torch.ones((B, L), dtype=self.dtype, device=self.device),
            edges._replace(relative_xyt=rel_b),
            torch.as_tensor(free, dtype=self.dtype, device=self.device),
            self.switch_penalty, self.edge_loss, P, L, options, floor=1e-10,
        )
        (out, sw), summary = _fetch((out_xyt, sw), summary)
        out = out.astype(np.float64)
        out[:, :, 2] = np.arctan2(np.sin(out[:, :, 2]), np.cos(out[:, :, 2]))
        return out, sw.astype(np.float64), summary

    def covariance(
        self,
        indices: Optional[List[int]] = None,
        method: str = "auto",
    ) -> Dict[int, np.ndarray]:
        """Marginal 3x3 (x, y, theta) covariance blocks per pose: the SE(2)
        analog of :meth:`PoseGraphOptimizer.covariance` (which see; SE(2)
        needs no tangent chart, the ambient coordinates are the chart),
        linearized at the current estimates with the last solve's switch
        values, on the optimizer's device in float64.

        ``method``: "dense" (full (3P+L)^2 inverse), "banded" (RCM
        superblock selected-inverse recurrence), "sparse" (multifrontal
        selected inverse over the dissection tree), or "auto": dense up to
        500 poses, else banded when its panels pass the memory guard, else
        sparse. All return the same blocks to float64 roundoff."""
        if method not in ("auto", "dense", "banded", "sparse"):
            raise ValueError(f"unknown covariance method {method!r}")
        if not self._constraints:
            raise ValueError("covariance: no constraints registered")
        if not self._constant:
            raise ValueError(
                "covariance: gauge-free graph has unbounded covariance; "
                "fix at least one pose with set_pose_constant()"
            )
        indices_all, index_of, P, L, xyt, free, ref_np, qry_np, _, edges = self._flat_2d(
            torch.float64)
        last = getattr(self, "_last_switches", None)
        if last is None or len(last) != L:
            last = np.ones(L)
        tensor = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=self.device)
        graph = _Graph(edges, tensor(free), P, L, self.switch_penalty, self.edge_loss)
        _, J_ref, J_qry, J_s, _ = graph.linearize(tensor(xyt), tensor(last))

        rcm = plan = None
        if method == "auto" and P <= 500:
            method = "dense"
        if method in ("auto", "banded"):
            perm, inv, bw = _rcm_perm_bandwidth(P, ref_np, qry_np)
            if method == "auto":
                method = "banded" if _banded_covariance_fits(P, bw, 3) else "sparse"
            rcm = (perm, inv, max(bw, 8))
        if method == "sparse":
            plan = self._sparse_symbolic(P, ref_np, qry_np, xyt)
        if indices is None:
            indices = indices_all
        want = np.array([index_of[pi] for pi in indices], np.int64)
        blocks = _marginal_blocks(method, J_ref, J_qry, J_s, graph.ref_i, graph.qry_i,
                                  graph.loop_slot, free, want, L, rcm=rcm, plan=plan)
        return {pi: blocks[k] for k, pi in enumerate(indices)}
