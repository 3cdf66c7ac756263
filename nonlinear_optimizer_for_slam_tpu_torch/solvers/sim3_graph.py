"""Sim(3) pose graph (PyTorch port of the JAX package's
``solvers/sim3_graph.py``): scale-drift-aware loop-closure optimization for
monocular SLAM (Strasdat et al., "Scale Drift-Aware Large Scale Monocular
SLAM", RSS 2010: the essential-graph optimization ORB-SLAM runs at every
loop closure).

Monocular odometry drifts in SCALE as well as pose; closing a loop with an
SE(3) graph forces the scale error into the translations. The Sim(3) state
adds one log-scale per keyframe and the edge residual measures relative
similarity transforms, so the optimizer can absorb drift where it actually
happened. State per pose: [p (3), q (4, ambient), log_s].

Edge residual for measurement (t_rel, q_rel, s_rel) on edge (i, j), with
the similarity T = (s R, p) acting as x -> s R x + p:

    S_ij = T_i^-1 T_j:  s_ij = s_j / s_i,
                        R_ij = R_i^T R_j,
                        t_ij = (1 / s_i) R_i^T (p_j - p_i)
    r = [ t_ij - t_rel ; 2 vec(q_rel^-1 q_i^-1 q_j) ;
          log(s_ij) - log(s_rel) ]                      (7,)

whitened by an optional sqrt-information (scalar / (3,) = (t, rot, scale)
/ (7,) diagonal). Jacobians come from one per-edge ``torch.func.jacfwd``
vmapped over the edges (17 ambient inputs, 7 residual rows). The dense path
sums the 8x8 edge blocks into the (8P)^2 normal matrix by one
``index_put_(accumulate=True)`` over the block index; the sparse path hands
them to the nested-dissection multifrontal solver
(``solvers/multifrontal.py``, d = 8). The canonical ``lm.solve`` loop
drives both. An SE(3) measurement is the s_rel = 1 special case, so
ordinary odometry edges and loop closures mix freely.

The JAX package's float64 polish runs on the host CPU under a scoped x64
context, a TPU measure (the TPU emulates float64). Here the polish runs in
float64 on the optimizer's own device, with the same solver family and
schedule; see :meth:`Sim3GraphOptimizer.solve`.

The reference has nothing Sim(3); its pose graph is SE(3)-only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.options import ConvergenceHandle, OptimizationHandle, Options
from ..core.pose import Pose, np_quat_to_rotmat
from . import lm, multifrontal
from .pose_graph import _fetch

Tensor = torch.Tensor


class Sim3Edges(NamedTuple):
    reference_indices: Tensor  # (E,) int64
    query_indices: Tensor  # (E,) int64
    rel_t: Tensor  # (E, 3)
    rel_q: Tensor  # (E, 4) wxyz
    rel_log_s: Tensor  # (E,)
    mask: Tensor  # (E,)
    sqrt_info: Optional[Tensor] = None  # (E, 7) diagonal


def sim3_edge_residual(x_ref: Tensor, x_query: Tensor, meas: Tensor) -> Tensor:
    """7-D residual of one edge; states (8,) = [p, q, log_s], measurement
    (8,) = [t_rel, q_rel, log_s_rel]."""
    p_r, q_r, ls_r = x_ref[:3], x_ref[3:7], x_ref[7]
    p_q, q_q, ls_q = x_query[:3], x_query[3:7], x_query[7]
    t_rel, q_rel, ls_rel = meas[:3], meas[3:7], meas[7]
    n_r = lie.quat_normalize(q_r)
    n_q = lie.quat_normalize(q_q)
    t_ij = torch.exp(-ls_r) * lie.quat_rotate(lie.quat_conjugate(n_r), p_q - p_r)
    err_q = lie.quat_multiply(
        lie.quat_conjugate(q_rel), lie.quat_multiply(lie.quat_conjugate(n_r), n_q)
    )
    err_q = torch.where(err_q[0] < 0, -err_q, err_q)
    return torch.cat([t_ij - t_rel, 2.0 * err_q[1:], ((ls_q - ls_r) - ls_rel)[None]])


def _one_edge(xr, xq, m):
    return (
        sim3_edge_residual(xr, xq, m),
        torch.func.jacfwd(sim3_edge_residual, argnums=0)(xr, xq, m),
        torch.func.jacfwd(sim3_edge_residual, argnums=1)(xr, xq, m),
    )


# (r (E, 7), J_ref (E, 7, 8), J_qry (E, 7, 8)) of every edge
_res_and_jac = torch.func.vmap(_one_edge)


def _meas(edges: Sim3Edges) -> Tensor:
    return torch.cat([edges.rel_t, edges.rel_q, edges.rel_log_s[:, None]], dim=1)


def _column_mask(free_mask: Tensor, scale_free: Tensor) -> Tensor:
    """(P, 8) per-component column mask: the pose block gated by
    free_mask, the scale by free_mask * scale_free (a fully fixed pose
    fixes both)."""
    P = free_mask.shape[0]
    return torch.cat([free_mask[:, None].expand(P, 7), (free_mask * scale_free)[:, None]], dim=1)


def _linearize(xs: Tensor, edges: Sim3Edges, meas: Tensor, colm: Tensor, edge_loss):
    """Whitened, masked and robustified (r, J_ref, J_qry, cost) of every
    edge at states ``xs`` (P, 8)."""
    ref_i, qry_i = edges.reference_indices, edges.query_indices
    r, J_ref, J_qry = _res_and_jac(xs[ref_i], xs[qry_i], meas)
    if edges.sqrt_info is not None:
        w = edges.sqrt_info
        r = r * w
        J_ref = J_ref * w[:, :, None]
        J_qry = J_qry * w[:, :, None]
    m = edges.mask
    r = r * m[:, None]
    # COLUMN masking by the per-component free mask: a pose with only its
    # scale frozen (set_scale_constant) contributes no gradient and no H
    # coupling through that column
    J_ref = J_ref * m[:, None, None] * colm[ref_i][:, None, :]
    J_qry = J_qry * m[:, None, None] * colm[qry_i][:, None, :]
    if edge_loss is not None:
        rho, wts, _ = edge_loss.evaluate(torch.sum(r * r, dim=1))
        cost = torch.sum(rho)
        sw = torch.sqrt(wts)
        r = r * sw[:, None]
        J_ref = J_ref * sw[:, None, None]
        J_qry = J_qry * sw[:, None, None]
    else:
        cost = torch.sum(r * r)
    return r, J_ref, J_qry, cost


def _sim3_solve(
    x0,  # (P, 8)
    edges: Sim3Edges,
    free_mask,  # (P,)
    scale_free,  # (P,) 1.0 = log-scale free (the gauge may pin one scale)
    edge_loss,
    num_poses: int,
    options: Options,
):
    """Dense LM over the (8P)^2 normal matrix with the Jacobi-equilibrated
    Cholesky step (``solve_linear`` below)."""
    P = num_poses
    dtype, device = x0.dtype, x0.device
    ref_i, qry_i = edges.reference_indices, edges.query_indices
    meas = _meas(edges)
    colm = _column_mask(free_mask, scale_free)
    col = colm.reshape(-1)
    dim = 8 * P
    block_at = torch.cat([ref_i * P + ref_i, ref_i * P + qry_i, qry_i * P + ref_i, qry_i * P + qry_i])
    grad_at = torch.cat([ref_i, qry_i])

    def quad(x):
        r, J_ref, J_qry, cost = _linearize(x.reshape(P, 8), edges, meas, colm, edge_loss)
        B_rq = J_ref.mT @ J_qry
        Hb = torch.zeros((P * P, 8, 8), dtype=dtype, device=device)
        Hb.index_put_((block_at,), torch.cat([J_ref.mT @ J_ref, B_rq, B_rq.mT, J_qry.mT @ J_qry]),
                      accumulate=True)
        H = Hb.view(P, P, 8, 8).permute(0, 2, 1, 3).reshape(dim, dim)
        diag = H.diagonal()
        diag.add_(1.0 - col)
        diag.add_(1e-8)
        g = torch.zeros((P, 8), dtype=dtype, device=device)
        g.index_put_((grad_at,), torch.cat([(J_ref.mT @ r[..., None])[..., 0],
                                            (J_qry.mT @ r[..., None])[..., 0]]), accumulate=True)
        return H, g.reshape(dim), cost

    def retract(x, delta):
        return x + delta * col

    def solve_linear(H, g, lamb):
        """The reference damping and a JACOBI-SCALED Cholesky.

        The Sim(3) normal matrix mixes translation, quaternion and
        log-scale columns whose diagonals differ by exp(2 * accumulated
        drift) (e^8 on the 52x-drift essential graph); in float32 the
        unscaled damped Cholesky loses the small columns to roundoff and LM
        creeps. Symmetric diagonal equilibration D^-1/2 H D^-1/2 is exact in
        real arithmetic (the same steps, the same LM policy) and restores
        float32 solvability. A failed factorization gives a NaN step (the
        LM guard makes it a zero step), as in the JAX package."""
        Hd = H.clone()
        d = Hd.diagonal()
        d.mul_(1.0 + lamb)
        s = torch.rsqrt(torch.clamp(d, min=1e-30))
        Hs = Hd * (s[:, None] * s[None, :])
        L, info = torch.linalg.cholesky_ex(Hs)
        y = torch.cholesky_solve(-(g * s)[:, None], L)[:, 0]
        step = y * s
        return torch.where(info == 0, step, torch.full_like(step, float("nan")))

    x, summary = lm.solve(quad, retract, x0.reshape(-1), options, solve_linear=solve_linear)
    return x.reshape(P, 8), summary


def _sim3_solve_sparse(
    x0,  # (P, 8)
    edges: Sim3Edges,
    free_mask,  # (P,)
    scale_free,  # (P,)
    edge_loss,
    num_poses: int,
    plan,  # multifrontal.Plan (d = 8)
    options: Options,
    acc_rounds,  # (kmax, P) multifrontal.accumulate_rounds maps
):
    """Sim(3) LM with the NESTED-DISSECTION MULTIFRONTAL linear solver: the
    dense path materializes the (8P)^2 normal matrix, fine to a few hundred
    keyframes, infeasible at ORB-SLAM-scale essential graphs (10k keyframes
    would be 80k^2 = 51 GB in float64), while an essential graph's
    covisibility edges are the loop-rich sparse topology
    ``solvers/multifrontal.py`` was built for. Per-edge 8x8 blocks feed
    the level-batched frontal Cholesky directly; per-pose sums are the
    ``accumulate_rounds`` gathers (a fixed order, no scatter)."""
    P = num_poses
    dtype, device = x0.dtype, x0.device
    ref_i, qry_i = edges.reference_indices, edges.query_indices
    meas = _meas(edges)
    colm = _column_mask(free_mask, scale_free)

    def accumulate(contrib_ref, contrib_qry):
        src = torch.cat([contrib_ref, contrib_qry,
                         torch.zeros((1,) + contrib_ref.shape[1:], dtype=dtype, device=device)])
        out = src[acc_rounds[0]]
        for t in range(1, acc_rounds.shape[0]):
            out = out + src[acc_rounds[t]]
        return out

    def quad(xs):
        r, J_ref, J_qry, cost = _linearize(xs, edges, meas, colm, edge_loss)
        g = accumulate((J_ref.mT @ r[..., None])[..., 0], (J_qry.mT @ r[..., None])[..., 0])
        d_p = accumulate(torch.sum(J_ref * J_ref, dim=1), torch.sum(J_qry * J_qry, dim=1))
        return (J_ref, J_qry, d_p), g, cost

    def solve_linear(H_rep, g, lam):
        J_ref, J_qry, d_p = H_rep
        # JACOBI EQUILIBRATION in edge-block form (the dense path's
        # rationale): s = D^-1/2 of the TOTAL damped diagonal; scale the
        # edge blocks by s_a (x) s_b, solve the ~unit-diagonal system,
        # unscale the step. Exact in real arithmetic.
        dtot = (1.0 + lam) * (d_p + (1.0 - colm) + 1e-8)
        s = torch.rsqrt(dtot)  # (P, 8)
        sa, sb = s[ref_i], s[qry_i]
        B_aa = (J_ref.mT @ J_ref) * (sa[:, :, None] * sa[:, None, :])
        B_bb = (J_qry.mT @ J_qry) * (sb[:, :, None] * sb[:, None, :])
        B_ab = (J_ref.mT @ J_qry) * (sa[:, :, None] * sb[:, None, :])
        # the total diagonal matches the dense path's damped diagonal
        # (d_p + (1-col) + 1e-8)(1+lam), Jacobi-scaled to exactly 1: the
        # scaled B blocks already carry s^2 d_p on the diagonal, so the
        # separate term is s^2 (dtot - d_p) = 1 - s^2 d_p
        dvec = 1.0 - s * s * d_p
        dp_scaled = multifrontal.solve(plan, ref_i, qry_i, B_aa, B_bb, B_ab, dvec, -(g * s))
        return dp_scaled * s

    def retract(xs, delta):
        return xs + delta * colm

    return lm.solve(quad, retract, x0, options, solve_linear=solve_linear)


def _default_options() -> Options:
    """The device stage's default schedule (beyond the reference): a low
    lambda floor with a fast decrease, and a relative plateau stop (the
    reference's absolute tolerances cannot fire at float32 noise scale)."""
    return Options().replace(
        max_iterations=200,
        optimization_handle=OptimizationHandle(
            min_lambda=1e-10, initial_lambda=1e-3, lambda_decrease_factor=0.25,
        ),
        convergence_handle=ConvergenceHandle(relative_function_tolerance=1e-7),
    )


def _polish_options() -> Options:
    return Options().replace(
        max_iterations=20,
        optimization_handle=OptimizationHandle(
            min_lambda=1e-12, initial_lambda=1e-7, lambda_decrease_factor=0.1,
        ),
        convergence_handle=ConvergenceHandle(relative_function_tolerance=1e-8),
    )


class Sim3GraphOptimizer:
    """Registry and solve() for the Sim(3) essential graph (the API shape of
    ``PoseGraphOptimizer``, with a scale per pose).

    ``device`` defaults to "cuda" (raising without a GPU unless the caller
    asks for "cpu"); ``dtype`` to float64, as in the JAX package."""

    def __init__(self, dtype: Optional[torch.dtype] = None, edge_loss=None,
                 solver: str = "auto", device="cuda"):
        """``solver``: "dense" materializes the (8P)^2 normal matrix (best
        below a few hundred keyframes); "sparse" is the nested-dissection
        multifrontal path over the essential graph's edge sparsity (the
        scale at which dense is infeasible); "auto" (the default) picks
        sparse above 600 keyframes."""
        if solver not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown solver {solver!r}")
        self.solver = solver
        self.sparse_threshold = 600  # auto picks sparse above this P
        self.device = resolve_device(device)
        self.dtype = torch.float64 if dtype is None else dtype
        self.edge_loss = edge_loss
        self._poses: Dict[int, np.ndarray] = {}  # (8,) [p, q, log_s]
        self._constant: set = set()
        self._fix_scale: set = set()
        self._constraints: List[dict] = []
        self._sparse_plan = None  # (key, (plan, acc_rounds)) topology cache

    # -- registry ------------------------------------------------------
    def set_pose(self, index: int, pose: Pose, scale: float = 1.0) -> None:
        if scale <= 0.0:
            raise ValueError(f"scale must be positive, got {scale}")
        self._poses[index] = np.concatenate(
            [pose.translation, pose.quaternion(), [np.log(scale)]]
        )

    def set_pose_constant(self, index: int) -> None:
        """Freeze pose AND scale (the Sim(3) gauge has 7 dof: 6 pose + 1
        global scale; one fully fixed keyframe pins all of it)."""
        if index not in self._poses:
            raise KeyError(f"pose {index} not registered")
        self._constant.add(index)

    def set_scale_constant(self, index: int) -> None:
        """Freeze only the scale of a pose (for example to anchor the metric
        scale at a keyframe whose depth is known)."""
        if index not in self._poses:
            raise KeyError(f"pose {index} not registered")
        self._fix_scale.add(index)

    def set_constraint(
        self,
        reference_index: int,
        query_index: int,
        relative_pose: Pose,
        relative_scale: float = 1.0,
        sqrt_info=None,
    ) -> None:
        """Sim(3) edge: an SE(3) measurement and the relative scale s_j/s_i
        (1.0 = an ordinary rigid odometry edge). ``sqrt_info``: scalar,
        (3,) = (trans, rot, scale), or (7,) diagonal."""
        if reference_index not in self._poses or query_index not in self._poses:
            raise KeyError("constraint endpoints must be registered poses")
        if reference_index == query_index:
            raise ValueError("self-constraint is not allowed")
        if relative_scale <= 0.0:
            raise ValueError(f"relative_scale must be positive, got {relative_scale}")
        w = None
        if sqrt_info is not None:
            a = np.asarray(sqrt_info, np.float64).reshape(-1)
            if a.size == 1:
                w = np.full(7, a[0])
            elif a.size == 3:
                w = np.concatenate([np.full(3, a[0]), np.full(3, a[1]), [a[2]]])
            elif a.size == 7:
                w = a.copy()
            else:
                raise ValueError(f"sqrt_info must be scalar/(3,)/(7,), got {a.size}")
        self._constraints.append(
            dict(
                reference_index=reference_index,
                query_index=query_index,
                rel_t=relative_pose.translation.copy(),
                rel_q=relative_pose.quaternion(),
                rel_log_s=float(np.log(relative_scale)),
                sqrt_info=w,
            )
        )

    def get_pose(self, index: int) -> Pose:
        x = self._poses[index]
        q = x[3:7] / np.linalg.norm(x[3:7])
        return Pose(np_quat_to_rotmat(q), x[:3].copy())

    def get_scale(self, index: int) -> float:
        return float(np.exp(self._poses[index][7]))

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    # -- initialization -------------------------------------------------
    def initialize(self, method: str = "chordal", cg_iterations: int = 300) -> None:
        """Sim(3) chordal initialization (the scale-aware analog of
        ``PoseGraphOptimizer.initialize``: LM only converges to the basin it
        starts in, and a dead-reckoned monocular spiral starts far outside
        it). Three exactly solvable stages:

        1. **log-scales**: the edge model ls_q - ls_ref = log s_rel is
           LINEAR in ls, solved exactly by the anchored graph Laplacian on
           the host (scipy's sparse solve);
        2. **rotations**: the SE(3) chordal relaxation unchanged (scales do
           not enter the rotation equations);
        3. **translations**: the translation Laplacian with scale-corrected
           edge vectors p_q - p_ref = s_ref R_ref t_rel
           (``graph_init.chordal_init`` on the optimizer's device, with
           rel_t pre-multiplied by the stage-1 s_ref).
        """
        if method != "chordal":
            raise ValueError(f"unknown init method {method!r} (chordal)")
        if not self._constraints:
            raise ValueError("initialize: no constraints registered")
        from scipy.sparse import lil_matrix
        from scipy.sparse.linalg import spsolve

        from .graph_init import chordal_init

        ids = sorted(self._poses)
        of = {pi: i for i, pi in enumerate(ids)}
        P, E = len(ids), len(self._constraints)
        ref = np.array([of[c["reference_index"]] for c in self._constraints])
        qry = np.array([of[c["query_index"]] for c in self._constraints])
        rel_q = np.stack([c["rel_q"] for c in self._constraints])
        rel_t = np.stack([c["rel_t"] for c in self._constraints])
        rel_ls = np.array([c["rel_log_s"] for c in self._constraints])

        anchor_ids = sorted(self._constant) or [ids[0]]
        # stage 1: log-scales (anchored at fully fixed and scale-fixed poses)
        ls_fixed = {of[pi]: self._poses[pi][7] for pi in set(anchor_ids) | self._fix_scale}
        free = np.array([i not in ls_fixed for i in range(P)])
        nf = int(free.sum())
        if nf:
            col = -np.ones(P, np.int64)
            col[free] = np.arange(nf)
            L = lil_matrix((nf, nf))
            b = np.zeros(nf)
            ls_anchor = np.zeros(P)
            for i, v in ls_fixed.items():
                ls_anchor[i] = v
            for e in range(E):
                i, j, m = int(ref[e]), int(qry[e]), rel_ls[e]
                # residual ls_j - ls_i - m; normal equations
                for (a, sa) in ((j, 1.0), (i, -1.0)):
                    if not free[a]:
                        continue
                    ca = col[a]
                    L[ca, ca] += 1.0
                    b[ca] += sa * m
                    for (bb, sb) in ((j, 1.0), (i, -1.0)):
                        if bb == a:
                            continue
                        if free[bb]:
                            L[ca, col[bb]] += sa * sb
                        else:
                            b[ca] -= sa * sb * ls_anchor[bb]
            ls = ls_anchor.copy()
            ls[free] = spsolve(L.tocsr(), b)
        else:
            ls = np.array([ls_fixed[i] for i in range(P)])

        # stages 2+3: chordal rotations, then the translation Laplacian with
        # scale-corrected edge vectors
        anchors = {
            of[pi]: (
                np_quat_to_rotmat(self._poses[pi][3:7] / np.linalg.norm(self._poses[pi][3:7])),
                self._poses[pi][:3].copy(),
            )
            for pi in anchor_ids
        }
        rel_t_scaled = rel_t * np.exp(ls[ref])[:, None]
        pos, quat = chordal_init(
            ref, qry, rel_q, rel_t_scaled, P, anchors,
            cg_iterations=cg_iterations, device=self.device,
        )
        for i, pi in enumerate(ids):
            self._poses[pi] = np.concatenate([pos[i], quat[i], [ls[i]]])

    # -- solve ---------------------------------------------------------
    def _edges(self, dtype: torch.dtype, of) -> Sim3Edges:
        c = self._constraints
        E = len(c)
        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        index = lambda key: torch.as_tensor(
            np.array([of[e[key]] for e in c], np.int64), device=self.device
        )
        w_rows = [e["sqrt_info"] for e in c]
        return Sim3Edges(
            index("reference_index"),
            index("query_index"),
            tensor(np.stack([e["rel_t"] for e in c])),
            tensor(np.stack([e["rel_q"] for e in c])),
            tensor(np.array([e["rel_log_s"] for e in c])),
            torch.ones((E,), dtype=dtype, device=self.device),
            sqrt_info=(
                tensor(np.stack([w if w is not None else np.ones(7) for w in w_rows]))
                if any(w is not None for w in w_rows)
                else None
            ),
        )

    def _masks(self, of, dtype):
        P = len(of)
        free = np.ones(P)
        for pi in self._constant:
            free[of[pi]] = 0.0
        scale_free = np.ones(P)
        for pi in self._fix_scale:
            scale_free[of[pi]] = 0.0
        tensor = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        return tensor(free), tensor(scale_free)

    def _run(self, x0: Tensor, of, solver: str, options: Options, coords: np.ndarray):
        """One LM stage in x0's dtype on the device; returns (x (P, 8),
        summary), both on the device. ``coords``: host positions for a new
        sparse plan."""
        P = len(of)
        dtype = x0.dtype
        edges = self._edges(dtype, of)
        free, scale_free = self._masks(of, dtype)
        if solver == "sparse":
            plan, acc = self._sparse_symbolic(coords)
            return _sim3_solve_sparse(
                x0, edges, free, scale_free, self.edge_loss, P, plan, options, acc,
            )
        return _sim3_solve(x0, edges, free, scale_free, self.edge_loss, P, options)

    def solve(self, options: Optional[Options] = None, polish: str = "auto"):
        """Solve the graph: the device stage in ``dtype``, then, by
        ``polish``, a float64 polish on the same device.

        The JAX package's convergence diagnosis on the 200-keyframe,
        52x-drift essential graph (scipy TRF oracle: cost 1.5800e-2):

        - the reference lambda clamp [1e-6, 1e-2] (an SE(3)-parity quirk)
          STALLS Sim(3) LM: multiplicative damping adds min_lambda diag(H),
          the translation diagonals carry exp(2 drift) ~ e^8, and the 1e-6
          floor swamps the soft loop-error-distribution mode. In float64 a
          1e-10 floor with a 0.25 decrease factor reaches 1.58005e-2.
        - a float32 stage cannot take those low-damping steps (the float32
          Cholesky noise exceeds the soft-mode curvature), while a float64
          solve of the same system descends: the limit is the solve
          precision, not the evaluation.

        Hence ``polish``: after the device stage, at most 20 float64 LM
        iterations with the low-floor schedule, from the device stage's
        state, with the same linear-solver family (a sparse graph keeps its
        multifrontal solve). "auto" (the default) polishes when the device
        stage ran below float64; "always" and "never" force it. The JAX
        package runs this stage on the host CPU, as a TPU emulates float64;
        the H100 has float64, so it runs on the optimizer's device and the
        state never leaves it between the stages.

        Explicit ``options`` apply to the device stage unchanged (reference
        clamps included); the polish always uses its low-floor schedule.
        Returns the summary (numpy): the polish stage's cost and records
        when it ran, with the iterations of both stages summed."""
        if polish not in ("auto", "always", "never"):
            raise ValueError(f"unknown polish mode {polish!r}")
        if options is None:
            options = _default_options()
        if not self._constraints:
            raise ValueError("Sim3GraphOptimizer.solve: no constraints registered")
        ids = sorted(self._poses)
        of = {pi: i for i, pi in enumerate(ids)}
        P = len(ids)
        x0_np = np.stack([self._poses[pi] for pi in ids])
        x0 = torch.as_tensor(x0_np, dtype=self.dtype, device=self.device)

        solver = self.solver
        if solver == "auto":
            solver = "sparse" if P > self.sparse_threshold else "dense"
        self.last_solver_choice = solver
        x, summary = self._run(x0, of, solver, options, x0_np[:, :3])
        if polish == "always" or (polish == "auto" and self.dtype != torch.float64):
            x, psummary = self._run(x.to(torch.float64), of, solver, _polish_options(),
                                    x0_np[:, :3])
            # combined reporting: the polish's cost and records, the
            # iterations of both stages
            summary = psummary._replace(iterations=psummary.iterations + summary.iterations)
        (x,), summary = _fetch((x,), summary)
        x = np.array(x, np.float64)
        x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
        for i, pi in enumerate(ids):
            self._poses[pi] = x[i]
        return summary

    def _sparse_symbolic(self, coords: np.ndarray):
        """Cached (plan, accumulate_rounds on the device) for the d = 8
        dissection over the essential graph's edges, keyed on topology;
        ``coords`` (P, 3) host positions guide a new plan's cuts."""
        ids = sorted(self._poses)
        of = {pi: i for i, pi in enumerate(ids)}
        P = len(ids)
        ref = np.array([of[c["reference_index"]] for c in self._constraints], np.int64)
        qry = np.array([of[c["query_index"]] for c in self._constraints], np.int64)
        key = (P, len(ref), ref.tobytes(), qry.tobytes())
        if self._sparse_plan is not None and self._sparse_plan[0] == key:
            return self._sparse_plan[1]
        plan = multifrontal.symbolic(
            P, ref, qry, d=8, coords=np.asarray(coords, np.float64), leaf_size=16,
        )
        acc = torch.as_tensor(multifrontal.accumulate_rounds(P, ref, qry).astype(np.int64),
                              device=self.device)
        self._sparse_plan = (key, (plan, acc))
        return plan, acc
