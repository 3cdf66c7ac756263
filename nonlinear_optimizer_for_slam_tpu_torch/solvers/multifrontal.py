"""Nested-dissection multifrontal block-sparse Cholesky (PyTorch port of
the JAX package's ``solvers/multifrontal.py``).

The reference's pose-graph analytic path is an unimplemented stub whose
comments name "Sparse Cholesky" as the intended linear solver
(pose_graph_optimizer_analytic.cc:12-51). The solver here is the
MULTIFRONTAL method with statically planned, level-batched dense fronts:

  1. HOST symbolic phase (:func:`symbolic`), once per graph topology:
     recursive nested dissection (a geometric median cut when vertex
     coordinates are given, a reverse Cuthill-McKee linearization cut
     otherwise; the smaller separator wins) produces a separator tree.
     Every tree node gets its interior variables and its boundary (the
     ancestor variables its subtree couples to after fill-in, by the
     bottom-up recurrence bnd(n) = (U bnd(children) U N(vars(n))) \\
     subtree(n)), and flat index maps: edge block -> (front, row, col)
     slot, variable -> (front, slot), child boundary slot -> parent slot.

  2. DEVICE numeric phase (:func:`factor` / :func:`solve_factored`), per
     LM iteration: fronts at one tree depth are padded to a common size
     and processed as one batched tensor per depth: a batched Cholesky of
     the interior block, a batched triangular solve for the coupling
     panel, one batched matmul for the Schur complement, and an
     extend-add into the parent depth. ceil(log2(P / leaf)) batched steps
     replace the P sequential pivots of a scalar sparse factorization.

Work matches nested dissection: O(P^{3/2}) flops on planar SLAM graphs
against O(P b^2) for the RCM-banded solver, whose bandwidth b grows with
the arena diameter on loop-rich city graphs (Olson's Manhattan worlds).

On the GPU the factor runs in the solve's own dtype (float64 is native on
the H100), so the JAX package's float32 factor with two sweeps of
iterative refinement is not carried. Front assembly is one
``index_put_(accumulate=True)`` per depth (summed in a fixed order: a sort
on CUDA, no float atomics); the extend-add places each child's Schur
complement in its parent's coordinates by ``index_put_`` without
accumulation (a child's boundary slots are distinct; its pad slots go to
a dummy slot that is sliced off) and adds the two children of a front in
a fixed order. The plan's index arrays are host numpy; their device
copies are made once per device and cached on the plan.

  3. The SELECTED INVERSE (:func:`selected_inverse_diag`,
     :func:`selected_inverse_pairs`): the Takahashi recurrence top-down
     over the same fronts, one batched level per depth, each child's
     boundary covariance gathered from its parent's front through the
     extend-add's column map. It gives the per-vertex diagonal blocks of
     A^{-1} (and requested edge blocks) at the cost of one factorization.

Used by ``solvers/pose_graph.py`` (solver="sparse" and the sparse
marginal covariances, SE(3) and SE(2)); generic over the per-vertex block
dimension d.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..parallel import all_gather_rows, row_block

Tensor = torch.Tensor


class _DepthPlan(NamedTuple):
    """Per-depth static index maps (host numpy)."""

    num_fronts: int
    ni: int  # padded interior block count
    nb: int  # padded boundary block count
    row_off: int  # offset of this depth in the flat ROW buffer
    # assembly at this depth, as block-coordinate scatters into the
    # depth's (nF, m, m) front tensor
    asm_src: np.ndarray  # (na,) rows into concat[B_uu,B_vv,B_uv,B_vu,diag]
    asm_f: np.ndarray  # (na,) front index
    asm_r: np.ndarray  # (na,) row BLOCK slot
    asm_c: np.ndarray  # (na,) col BLOCK slot
    # variable assembly (solution slots)
    va_pid: np.ndarray  # (nv,) vertex ids
    va_f: np.ndarray  # (nv,)
    va_slot: np.ndarray  # (nv,) interior slot
    pad_diag: np.ndarray  # (num_fronts, (ni+nb)*d) 1.0 at padded interior
    # extend-add of the CHILD depth (depth+1) into this depth (binary
    # dissection: <= 2 children per front). Dummy child index = nF_child
    # (a zero panel); pad slots map to block slot ni+nb (sliced off).
    child_of: np.ndarray  # (num_fronts, 2) index into the child depth
    ch_map: np.ndarray  # (nC, nb_child) parent BLOCK slot; pads -> ni+nb
    # boundary gather for back-substitution (pads -> 0; harmless, the
    # corresponding W columns are exactly zero)
    bnd_pid: np.ndarray  # (num_fronts, nb)


@dataclasses.dataclass(eq=False)  # identity hash/eq: plans are cached
class Plan:
    """Symbolic factorization: static shapes and index maps per depth.

    ``depths[0]`` is the ROOT; the numeric phase processes
    ``depths[-1] .. depths[0]`` (leaves up) then back down."""

    P: int
    d: int
    E: int
    swap: np.ndarray  # (E,) True where endpoint b is eliminated first
    depths: List[_DepthPlan]
    tot_row: int  # total d-rows across all depths
    rhs_idx: np.ndarray  # (P,) flat row index of each vertex (unique)
    # device copies of the index maps, one set per device
    _device_maps: Dict[torch.device, tuple] = dataclasses.field(
        default_factory=dict, repr=False
    )
    # each vertex's (depth, front, interior slot), for the selected inverse
    _vertex_slots: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def num_levels(self) -> int:
        return len(self.depths)

    def stats(self) -> dict:
        """Shape diagnostics for solver selection / logging."""
        fronts = [(dp.num_fronts, dp.ni, dp.nb) for dp in self.depths]
        flops = sum(
            nf * ((ni * self.d) ** 3 / 3.0 + (ni * self.d) ** 2 * (nb * self.d))
            for nf, ni, nb in fronts
        )
        mem = sum(nf * ((ni + nb) * self.d) ** 2 for nf, ni, nb in fronts)
        return dict(
            levels=len(fronts),
            fronts=fronts,
            factor_flops=flops,
            front_elems=mem,
            max_front=max((ni + nb) * self.d for _, ni, nb in fronts),
        )


class _Node:
    __slots__ = ("vars", "children", "depth", "bnd", "parent", "_subtree")

    def __init__(self, vars_, children):
        self.vars = vars_  # np.int64 array
        self.children = children  # list of _Node
        self.depth = 0
        self.bnd = None
        self.parent = None


def _rcm_order(V, sa, sb):
    """Reverse Cuthill-McKee linearization of the subgraph (V, sa-sb):
    its median cut is a narrow frontier on chain-like topology."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = len(V)
    local = np.full(int(V.max()) + 1 if n else 1, -1, np.int64)
    local[V] = np.arange(n)
    A = coo_matrix(
        (np.ones(len(sa)), (local[sa], local[sb])), shape=(n, n)
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def _candidate_orders(V, sa, sb, coords):
    """Cut oracles to try: geometric (widest coordinate axis, best for
    arena-style graphs) and RCM (best for chains: a random-walk path
    crosses any coordinate plane many times, so a geometric cut of a chain
    yields a huge separator)."""
    orders = []
    if coords is not None:
        c = coords[V]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        orders.append(np.argsort(c[:, axis], kind="stable"))
    orders.append(_rcm_order(V, sa, sb))
    return orders


def _bisect(V, sa, sb, coords, leaf_size, scratch):
    """Recursive nested dissection. (sa, sb) are the edges with BOTH
    endpoints in V; ``scratch`` is a reusable (P,) work array."""
    if len(V) <= leaf_size:
        return _Node(V, [])
    best = None
    for order in _candidate_orders(V, sa, sb, coords):
        half = len(V) // 2
        A, B = V[order[:half]], V[order[half:]]
        # side[v]: 0 for A, 1 for B
        scratch[A] = 0
        scratch[B] = 1
        side_a, side_b = scratch[sa], scratch[sb]
        # separator: A-side endpoints of every A-B edge (then A\S and B
        # are edge-disjoint, so S separates them)
        cut = side_a != side_b
        sep_vs = np.unique(
            np.concatenate([sa[cut & (side_a == 0)], sb[cut & (side_b == 0)]])
        )
        if best is None or len(sep_vs) < len(best[0]):
            best = (sep_vs, A, B)
    sep_vs, A, B = best
    scratch[A] = 0
    scratch[sep_vs] = 2
    S = sep_vs
    A2 = A[scratch[A] != 2]
    children = []
    for part in (A2, B):
        if not len(part):
            continue
        scratch[V] = 0
        scratch[part] = 1
        keep = (scratch[sa] == 1) & (scratch[sb] == 1)
        children.append(
            _bisect(part, sa[keep], sb[keep], coords, leaf_size, scratch)
        )
    if not children:  # cannot happen (len(V) > leaf_size >= 1) but be safe
        return _Node(V, [])
    return _Node(S, children)


def symbolic(
    num_vertices: int,
    e_a: np.ndarray,
    e_b: np.ndarray,
    d: int,
    coords: Optional[np.ndarray] = None,
    leaf_size: int = 32,
    max_front_bytes: int = 4 << 30,
) -> Plan:
    """Build the separator tree and every static index map.

    Args:
      num_vertices: P vertices, each a d-dimensional parameter block.
      e_a, e_b: (E,) endpoint vertex ids of the coupling edges.
      coords: optional (P, >=2) vertex coordinates for geometric cuts
        (pose positions: the natural nested-dissection oracle for SLAM).
      leaf_size: stop recursion at subgraphs this small; the leaf front
        becomes one dense panel.
      max_front_bytes: raise ValueError when the padded fronts would need
        more than this many bytes at 4 bytes an entry (the JAX package's
        guard, kept as it is so that the two packages veto the same
        graphs in solver selection).
    """
    P, E = int(num_vertices), len(e_a)
    e_a = np.asarray(e_a, np.int64)
    e_b = np.asarray(e_b, np.int64)
    # CSR adjacency (both directions)
    src = np.concatenate([e_a, e_b])
    dst = np.concatenate([e_b, e_a])
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    indptr = np.zeros(P + 1, np.int64)
    np.add.at(indptr, src_s + 1, 1)
    indptr = np.cumsum(indptr)
    indices = dst_s

    scratch = np.zeros(P, np.int8)
    root = _bisect(
        np.arange(P, dtype=np.int64), e_a, e_b,
        None if coords is None else np.asarray(coords, np.float64),
        leaf_size, scratch,
    )

    # depth assignment + bottom-up boundary sets
    nodes: List[_Node] = []
    stack = [(root, 0, None)]
    while stack:
        n, dep, par = stack.pop()
        n.depth, n.parent = dep, par
        nodes.append(n)
        for c in n.children:
            stack.append((c, dep + 1, n))
    max_depth = max(n.depth for n in nodes)

    node_of = np.full(P, -1, np.int64)
    for idx, n in enumerate(nodes):
        node_of[n.vars] = idx

    # bottom-up: subtree sets + boundary sets (sorted np arrays)
    for n in sorted(nodes, key=lambda n: -n.depth):
        sub = n.vars
        bnd = np.zeros(0, np.int64)
        for c in n.children:
            sub = np.union1d(sub, c._subtree)  # type: ignore[attr-defined]
            bnd = np.union1d(bnd, c.bnd)
        if len(n.vars):
            nb_list = [indices[indptr[v]:indptr[v + 1]] for v in n.vars]
            if nb_list:
                bnd = np.union1d(bnd, np.unique(np.concatenate(nb_list)))
        n.bnd = np.setdiff1d(bnd, sub)
        n._subtree = sub  # type: ignore[attr-defined]
    if len(root.bnd):
        raise AssertionError("root boundary must be empty")

    # slot maps (vertex -> (node, slot)); bnd slots offset by PADDED ni
    by_depth: List[List[_Node]] = [[] for _ in range(max_depth + 1)]
    for n in nodes:
        by_depth[n.depth].append(n)
    ni_pad = [max(1, max(len(n.vars) for n in lvl)) for lvl in by_depth]
    nb_pad = [max(len(n.bnd) for n in lvl) for lvl in by_depth]

    slot_of = {}  # (node id) -> {vertex: slot}
    front_idx = {}
    for dep, lvl in enumerate(by_depth):
        for f, n in enumerate(lvl):
            front_idx[id(n)] = f
            m = {int(v): i for i, v in enumerate(n.vars)}
            for j, v in enumerate(n.bnd):
                m[int(v)] = ni_pad[dep] + j
            slot_of[id(n)] = m

    node_depth = np.array([n.depth for n in nodes])

    # edge orientation: u = endpoint at the DEEPER node (eliminated first)
    na = node_of[e_a]
    nb_ = node_of[e_b]
    da, db = node_depth[na], node_depth[nb_]
    bad = (da == db) & (na != nb_)
    if bad.any():
        raise AssertionError(
            "edge between unrelated tree nodes — separator property violated"
        )
    swap = db > da  # b eliminated first
    u = np.where(swap, e_b, e_a)
    v = np.where(swap, e_a, e_b)
    host_node = np.where(swap, nb_, na)

    # row-buffer offsets + memory guard (fronts are (nF, m, m) per depth)
    row_offs = []
    tot_blk = tot_row = 0
    for dep, lvl in enumerate(by_depth):
        nblk = ni_pad[dep] + nb_pad[dep]
        row_offs.append(tot_row)
        tot_blk += len(lvl) * nblk * nblk
        tot_row += len(lvl) * nblk
    if tot_blk * d * d * 4 > max_front_bytes:
        raise ValueError(
            f"multifrontal: padded fronts need "
            f"~{tot_blk * d * d * 4 / 1e9:.1f} GB of f32 — the separator "
            "sizes this dissection found are not sparse-friendly (an "
            "expander-like graph, or pathological level-size variance); "
            "use solver='cg' (matrix-free) instead"
        )

    # per-edge assembly entries (4 blocks: uu, vv, uv, vu), grouped by
    # hosting depth; source row indexes concat[B_uu,B_vv,B_uv,B_vu,diag]
    asm_by_depth = [[] for _ in by_depth]  # (src, f, r, c)
    for e in range(E):
        n = nodes[host_node[e]]
        dep = n.depth
        sm = slot_of[id(n)]
        f = front_idx[id(n)]
        ru, rv = sm[int(u[e])], sm[int(v[e])]
        if ru >= ni_pad[dep]:
            raise AssertionError("u endpoint not interior at its own node")
        a = asm_by_depth[dep]
        a.append((e, f, ru, ru))
        a.append((E + e, f, rv, rv))
        a.append((2 * E + e, f, ru, rv))
        a.append((3 * E + e, f, rv, ru))

    depths: List[_DepthPlan] = []
    rhs_idx = np.empty(P, np.int64)
    for dep, lvl in enumerate(by_depth):
        ni, nbp = ni_pad[dep], nb_pad[dep]
        nblk = ni + nbp
        nF = len(lvl)
        va_pid, va_f, va_slot = [], [], []
        pad_diag = np.zeros((nF, nblk * d), np.float64)
        bnd_pid = np.zeros((nF, nbp), np.int64)
        asm = asm_by_depth[dep]
        for f, n in enumerate(lvl):
            for i, vtx in enumerate(n.vars):
                va_pid.append(int(vtx))
                va_f.append(f)
                va_slot.append(i)
                asm.append((4 * E + int(vtx), f, i, i))
                rhs_idx[vtx] = row_offs[dep] + f * nblk + i
            pad_diag[f, len(n.vars) * d: ni * d] = 1.0
            bnd_pid[f, : len(n.bnd)] = n.bnd
        asm_arr = np.asarray(asm, np.int64).reshape(-1, 4)
        # extend-add maps: child bnd slot -> parent slot, per parent front
        # and child position (binary tree: <= 2)
        if dep + 1 <= max_depth:
            child_lvl = by_depth[dep + 1]
            nbc = nb_pad[dep + 1]
            nCc = len(child_lvl)
            child_of = np.full((nF, 2), nCc, np.int32)  # dummy = zero panel
            ch_map = np.full((nCc, nbc), nblk, np.int32)  # pad -> dummy col
            child_count = np.zeros(nF, np.int64)
            for c_idx, c in enumerate(child_lvl):
                p = c.parent
                if p.depth != dep:
                    raise AssertionError("tree parent depth mismatch")
                fp = front_idx[id(p)]
                k = child_count[fp]
                if k >= 2:
                    raise AssertionError("non-binary separator tree")
                child_count[fp] = k + 1
                child_of[fp, k] = c_idx
                psm = slot_of[id(p)]
                for j, w in enumerate(c.bnd):
                    ch_map[c_idx, j] = psm[int(w)]
        else:
            child_of = np.zeros((nF, 2), np.int32)
            ch_map = np.zeros((0, 0), np.int32)
        depths.append(
            _DepthPlan(
                num_fronts=nF,
                ni=ni,
                nb=nbp,
                row_off=row_offs[dep],
                asm_src=asm_arr[:, 0].astype(np.int32),
                asm_f=asm_arr[:, 1].astype(np.int32),
                asm_r=asm_arr[:, 2].astype(np.int32),
                asm_c=asm_arr[:, 3].astype(np.int32),
                va_pid=np.asarray(va_pid, np.int64),
                va_f=np.asarray(va_f, np.int32),
                va_slot=np.asarray(va_slot, np.int32),
                pad_diag=pad_diag,
                child_of=child_of,
                ch_map=ch_map,
                bnd_pid=bnd_pid,
            )
        )
    return Plan(
        P=P, d=d, E=E, swap=swap, depths=depths,
        tot_row=tot_row, rhs_idx=rhs_idx,
    )


# ---------------------------------------------------------------------------
# numeric phase (device; the plan's index maps are uploaded once per device)
# ---------------------------------------------------------------------------


class _DepthMaps(NamedTuple):
    """Device copies of one depth's index maps, in the forms the numeric
    phase indexes with."""

    asm_src: Tensor  # (na,)
    asm_flat: Tensor  # (na, d, d) flat (front, row, col) index into F
    va_pid: Tensor  # (nv,)
    va_f: Tensor  # (nv,)
    va_slot: Tensor  # (nv,)
    pad_diag: Tensor  # (nF, m) float64; cast to the solve's dtype per call
    child_of0: Tensor  # (nF,)
    child_of1: Tensor  # (nF,)
    ch_front: Tensor  # (nC, 1) child index, for the extend-add placement
    ch_cols: Tensor  # (nC, nbc * d) parent scalar column; pads >= m
    bnd_pid: Tensor  # (nF, nb)
    parent_of: Tensor  # (nF,) front of the parent depth holding each front


def _device_maps(plan: Plan, device: torch.device):
    """The plan's index maps on ``device``, uploaded on first use and
    cached on the plan (a host-to-device copy per topology and device,
    never per LM iteration). Returns (swap (E,), rhs_idx (P,), per-depth
    :class:`_DepthMaps`)."""
    device = torch.device(device)
    cached = plan._device_maps.get(device)
    if cached is not None:
        return cached
    d = plan.d
    up = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    rng_d = np.arange(d, dtype=np.int64)
    maps = []
    for dep, dp in enumerate(plan.depths):
        m = (dp.ni + dp.nb) * d
        parent_of = np.zeros(dp.num_fronts, np.int64)
        if dep:
            child_of = plan.depths[dep - 1].child_of
            for k in range(2):
                real = child_of[:, k] < dp.num_fronts  # the dummy child is nF
                parent_of[child_of[real, k]] = np.flatnonzero(real)
        rows = dp.asm_r.astype(np.int64)[:, None] * d + rng_d  # (na, d)
        cols = dp.asm_c.astype(np.int64)[:, None] * d + rng_d
        flat = (
            (dp.asm_f.astype(np.int64)[:, None, None] * m + rows[:, :, None]) * m
            + cols[:, None, :]
        )
        nC, nbc = dp.ch_map.shape
        ch_cols = (dp.ch_map.astype(np.int64)[:, :, None] * d + rng_d).reshape(nC, nbc * d)
        maps.append(
            _DepthMaps(
                asm_src=up(dp.asm_src),
                asm_flat=up(flat),
                va_pid=up(dp.va_pid),
                va_f=up(dp.va_f),
                va_slot=up(dp.va_slot),
                pad_diag=torch.as_tensor(dp.pad_diag, device=device),
                child_of0=up(dp.child_of[:, 0]),
                child_of1=up(dp.child_of[:, 1]),
                ch_front=up(np.arange(nC)[:, None]),
                ch_cols=up(ch_cols),
                bnd_pid=up(dp.bnd_pid),
                parent_of=up(parent_of),
            )
        )
    cached = (
        torch.as_tensor(plan.swap, device=device),
        up(plan.rhs_idx),
        maps,
    )
    plan._device_maps[device] = cached
    return cached


def _extend(values: Tensor, dm: _DepthMaps, m: int, d: int) -> Tensor:
    """Children's boundary values in their parents' coordinates, the two
    children of each front added in a fixed order.

    ``values`` is (nC, nbc d, nbc d) Schur complements or (nC, nbc d)
    right-hand-side updates. Each child's values are placed by
    ``index_put_`` without accumulation (a child's boundary slots are
    distinct; its pad slots all land in the dummy slots m..m+d-1, which
    are sliced off), a zero panel at index nC stands for a missing child,
    and then T[child_of[:, 0]] + T[child_of[:, 1]] per parent front."""
    nC = values.shape[0]
    md = m + d
    if values.dim() == 3:
        T = values.new_zeros((nC + 1, md, md))
        T.index_put_(
            (dm.ch_front[:, :, None], dm.ch_cols[:, :, None], dm.ch_cols[:, None, :]),
            values,
        )
        T = T[:, :m, :m]
    else:
        T = values.new_zeros((nC + 1, md))
        T.index_put_((dm.ch_front, dm.ch_cols), values)
        T = T[:, :m]
    return T[dm.child_of0] + T[dm.child_of1]


def factor(plan: Plan, B_aa: Tensor, B_bb: Tensor, B_ab: Tensor, diag: Tensor,
           mesh=None):
    """Assemble and factor the block-sparse SPD system.

    A[a,a] += B_aa[e], A[b,b] += B_bb[e], A[a,b] += B_ab[e] (and its
    transpose) for each edge e = (a, b), plus ``diag`` (P, d) on the
    diagonal, or (P, d, d) full per-vertex blocks. Returns an opaque factor
    for :func:`solve_factored`, in the dtype of the inputs.

    A front whose interior block is not positive definite gets a NaN
    factor (``cholesky_ex`` reports it in ``info``; nothing waits on the
    host), which reaches every entry of the solution through the Schur
    complements and the back-substitution: the LM loop's guard then
    rejects the step, as a NaN ``jnp.linalg.cholesky`` does in the JAX
    package.

    ``mesh``: a ``parallel.FactorMesh``. Every rank assembles each level's
    fronts, factors its own block of them (``parallel.row_block``), and
    one ``all_gather`` per level hands every rank the whole level's
    factor and Schur complements: every rank holds the whole factor, the
    factors of the unsharded call front by front. (The JAX package's
    ``_front_sharding`` is a layout hint to XLA with no numerical
    effect.)"""
    d = plan.d
    dtype, device = B_aa.dtype, B_aa.device
    swap, _, maps = _device_maps(plan, device)
    sw = swap[:, None, None]
    B_uu = torch.where(sw, B_bb, B_aa)
    B_vv = torch.where(sw, B_aa, B_bb)
    B_uv = torch.where(sw, B_ab.mT, B_ab)
    if diag.dim() == 3:
        diag_blocks = diag
    else:
        diag_blocks = torch.diag_embed(diag)
    blocks = torch.cat([B_uu, B_vv, B_uv, B_uv.mT, diag_blocks], dim=0)

    levels = []
    S_prev = None  # child Schur complements, dense (nC, mb_c, mb_c)
    for dep in range(plan.num_levels - 1, -1, -1):
        dp, dm = plan.depths[dep], maps[dep]
        m = (dp.ni + dp.nb) * d
        mi = dp.ni * d
        F = torch.zeros((dp.num_fronts, m, m), dtype=dtype, device=device)
        if len(dp.asm_src):
            F.view(-1).index_put_(
                (dm.asm_flat.reshape(-1),), blocks[dm.asm_src].reshape(-1),
                accumulate=True,
            )
        if S_prev is not None:
            F += _extend(S_prev, dm, m, d)
        F.diagonal(dim1=-2, dim2=-1).add_(dm.pad_diag.to(dtype))
        Fr = F if mesh is None else F[row_block(mesh, dp.num_fronts)]  # this rank's fronts
        A11 = Fr[:, :mi, :mi]
        L11, info = torch.linalg.cholesky_ex(A11)
        L11 = L11.masked_fill((info != 0)[:, None, None], float("nan"))
        if dp.nb:
            W = torch.linalg.solve_triangular(L11, Fr[:, :mi, mi:], upper=False)
            S_prev = Fr[:, mi:, mi:] - W.mT @ W
        else:
            W = Fr.new_zeros((Fr.shape[0], mi, 0))
            S_prev = None
        if mesh is not None:
            mine = (L11, W, S_prev)
            whole = all_gather_rows(mesh, mine, dp.num_fronts)
            # the gathered fronts arrive row-major; each takes the layout
            # of this rank's own (the unsharded factor's), since the later
            # triangular solves round by the layout of their operands
            L11, W, S_prev = (
                x if own is None or own.stride(-1) == 1 else x.mT.contiguous().mT
                for x, own in zip(whole, mine)
            )
        levels.append((L11, W))
    levels.reverse()  # levels[dep] aligns with plan.depths[dep]
    return tuple(levels)


def solve_factored(plan: Plan, fact, b: Tensor) -> Tensor:
    """Solve A x = b against a :func:`factor` result. b, x: (P, d)."""
    d = plan.d
    dtype, device = b.dtype, b.device
    _, rhs_idx, maps = _device_maps(plan, device)
    # one unique scatter seeds every front's interior rows
    rows = torch.zeros((plan.tot_row, d), dtype=dtype, device=device)
    rows[rhs_idx] = b
    # forward pass: eliminate interiors leaves-up
    zs = [None] * plan.num_levels
    u_prev = None  # child rhs updates, dense (nC, mb_c)
    for dep in range(plan.num_levels - 1, -1, -1):
        dp, dm = plan.depths[dep], maps[dep]
        L11, W = fact[dep]
        nblk = dp.ni + dp.nb
        m = nblk * d
        rflat = rows[dp.row_off: dp.row_off + dp.num_fronts * nblk].reshape(dp.num_fronts, m)
        if u_prev is not None:
            rflat = rflat + _extend(u_prev, dm, m, d)
        mi = dp.ni * d
        z = torch.linalg.solve_triangular(L11, rflat[:, :mi, None], upper=False)[..., 0]
        zs[dep] = z
        if dp.nb:
            u_prev = rflat[:, mi:] - (z[:, None, :] @ W)[:, 0]
        else:
            u_prev = None
    # backward pass: root-down back-substitution
    x = torch.zeros((plan.P, d), dtype=dtype, device=device)
    for dep in range(plan.num_levels):
        dp, dm = plan.depths[dep], maps[dep]
        L11, W = fact[dep]
        z = zs[dep]
        if dp.nb:
            xb = x[dm.bnd_pid].reshape(dp.num_fronts, -1)
            t = z - (W @ xb[..., None])[..., 0]
        else:
            t = z
        x1 = torch.linalg.solve_triangular(L11.mT, t[..., None], upper=True)[..., 0]
        if len(dp.va_pid):
            x1b = x1.reshape(dp.num_fronts, dp.ni, d)
            x[dm.va_pid] = x1b[dm.va_f, dm.va_slot]
    return x


def accumulate_rounds(P: int, e_a, e_b) -> np.ndarray:
    """(kmax, P) gather maps for scatter-free per-pose accumulation of
    per-edge contributions: ``sum over edges at pose p`` as kmax rounds of
    row gathers from ``concat[contrib_a, contrib_b, zero-pad]`` (pad id =
    2E; kmax = max pose degree). Host numpy, built once per topology; use
    as::

        src = torch.cat([c_a, c_b, zeros((1, ...))])
        out = sum(src[rounds[t]] for t in range(rounds.shape[0]))

    (The port's pose-graph paths sum per pose by ``index_put_`` with
    ``accumulate=True`` instead; the maps stay for callers of the JAX
    package's API.)"""
    e_a = np.asarray(e_a, np.int64)
    e_b = np.asarray(e_b, np.int64)
    E = len(e_a)
    dest = np.concatenate([e_a, e_b])
    order = np.argsort(dest, kind="stable").astype(np.int64)
    sd = dest[order]
    uniq, starts = np.unique(sd, return_index=True)
    counts = np.diff(np.r_[starts, len(sd)])
    kmax = int(counts.max()) if len(counts) else 1
    rounds = np.full((max(kmax, 1), P), 2 * E, np.int32)
    for t in range(kmax):
        sel = counts > t
        rounds[t, uniq[sel]] = order[starts[sel] + t]
    return rounds


def edge_matvec(
    e_a, e_b, B_aa: Tensor, B_bb: Tensor, B_ab: Tensor, diag: Tensor, x: Tensor
) -> Tensor:
    """y = A x with A given in edge-block form (the residual product of
    iterative refinement: one edge-block product instead of a second
    factorization). ``e_a``/``e_b`` are (E,) index tensors on x's device;
    the per-vertex sums are ``index_put_(accumulate=True)``."""
    xa, xb = x[e_a], x[e_b]
    ya = (B_aa @ xa[..., None])[..., 0] + (B_ab @ xb[..., None])[..., 0]
    yb = (xa[:, None, :] @ B_ab)[:, 0] + (B_bb @ xb[..., None])[..., 0]
    base = (diag @ x[..., None])[..., 0] if diag.dim() == 3 else diag * x
    return base.index_put_((torch.cat([e_a, e_b]),), torch.cat([ya, yb]), accumulate=True)


def solve(
    plan: Plan,
    e_a,
    e_b,
    B_aa: Tensor,
    B_bb: Tensor,
    B_ab: Tensor,
    diag: Tensor,
    b: Tensor,
    mesh=None,
) -> Tensor:
    """Factor and solve in the dtype of the inputs. The JAX package factors
    float64 input in float32 and recovers float64 accuracy by two sweeps of
    iterative refinement through :func:`edge_matvec`, a TPU measure
    (float64 panel products are emulated there); the H100 computes float64
    natively, so the port factors in float64 and solves once. ``e_a`` and
    ``e_b`` are taken for the JAX package's signature; ``mesh`` goes to
    :func:`factor`."""
    fact = factor(plan, B_aa, B_bb, B_ab, diag, mesh=mesh)
    return solve_factored(plan, fact, b)


# ---------------------------------------------------------------------------
# selected inverse (covariance)
# ---------------------------------------------------------------------------


def _vertex_slots(plan: Plan):
    """Host lookup of each vertex's (depth, front, interior slot), built
    once and cached on the plan."""
    if plan._vertex_slots is None:
        vdep = np.full(plan.P, -1, np.int64)
        vfront = np.full(plan.P, -1, np.int64)
        vslot = np.full(plan.P, -1, np.int64)
        for dep, dp in enumerate(plan.depths):
            vdep[dp.va_pid] = dep
            vfront[dp.va_pid] = dp.va_f
            vslot[dp.va_pid] = dp.va_slot
        plan._vertex_slots = (vdep, vfront, vslot)
    return plan._vertex_slots


def selected_inverse_pairs(plan: Plan, fact, pair_a, pair_b):
    """Diagonal blocks (P, d, d) of A^{-1} and the off-diagonal blocks
    Sigma[a, b] (npairs, d, d) of the requested vertex pairs.

    The pairs must be edges of the graph given to :func:`symbolic`: the
    filled pattern of the factorization then contains them (when the
    first-eliminated endpoint is interior in its front, the other endpoint
    is interior in the same front or among its boundary vars, and the
    Takahashi recurrence forms the whole front covariance). One top-down
    sweep shared with the diagonal extraction, on the device; the host
    only sorts the requests by depth."""
    d = plan.d
    pair_a = np.asarray(pair_a, np.int64)
    pair_b = np.asarray(pair_b, np.int64)
    npairs = len(pair_a)
    vdep, vfront, vslot = _vertex_slots(plan)

    # per-depth request lists: (front, slot_row, slot_col, out_idx, T?)
    req = [[] for _ in range(plan.num_levels)]
    for k in range(npairs):
        a, b = int(pair_a[k]), int(pair_b[k])
        trans = vdep[b] > vdep[a]  # the deeper vertex is eliminated first
        if trans:
            a, b = b, a
        dep = int(vdep[a])
        dp = plan.depths[dep]
        f, sa = int(vfront[a]), int(vslot[a])
        if vdep[b] == dep and vfront[b] == f:
            sb = int(vslot[b])
        else:
            hits = np.flatnonzero(dp.bnd_pid[f] == b)
            if len(hits) == 0:
                raise ValueError(
                    f"selected_inverse_pairs: pair ({pair_a[k]}, "
                    f"{pair_b[k]}) is not in the factorization's filled "
                    "pattern — pass only edges of the symbolic graph"
                )
            sb = dp.ni + int(hits[0])
        req[dep].append((f, sa, sb, k, trans))

    L0 = fact[0][0]
    dtype, device = L0.dtype, L0.device
    up = lambda a, **kw: torch.as_tensor(np.asarray(a), device=device, **kw)
    out = torch.zeros((plan.P, d, d), dtype=dtype, device=device)
    out_pairs = torch.zeros((npairs, d, d), dtype=dtype, device=device)
    Sig_prev = None
    for dep in range(plan.num_levels):
        Sig_front = _takahashi_front_cov(plan, fact, dep, Sig_prev, dtype)
        _diag_blocks(plan, dep, Sig_front, out)
        if req[dep]:
            rf, ra, rb, ridx, rtr = (np.asarray(col) for col in zip(*req[dep]))
            dp = plan.depths[dep]
            nblk = dp.ni + dp.nb
            blk = Sig_front.reshape(dp.num_fronts, nblk, d, nblk, d)[up(rf), up(ra), :, up(rb), :]
            blk = torch.where(up(rtr, dtype=torch.bool)[:, None, None], blk.mT, blk)
            out_pairs[up(ridx)] = blk
        Sig_prev = Sig_front
    return out, out_pairs


def _takahashi_front_cov(plan: Plan, fact, dep: int, Sig_prev, dtype):
    """One depth of the Takahashi recurrence: the (nF, m, m) front
    covariances at ``dep`` from the parent depth's ``Sig_prev`` (shared by
    the diagonal and pairwise sweeps).

    The parent's covariance at a child's boundary is a gather through the
    extend-add's child-to-parent column map (``_DepthMaps.ch_cols`` of the
    parent depth), with the pad slots (>= m) reading a zero border: the
    JAX package forms it as one-hot selection products, a TPU measure."""
    dp = plan.depths[dep]
    d = plan.d
    L11, W = fact[dep]
    device = L11.device
    mi = dp.ni * d
    eye = torch.eye(mi, dtype=dtype, device=device).expand(dp.num_fronts, mi, mi)
    Linv = torch.linalg.solve_triangular(L11, eye, upper=False)
    Sig11 = Linv.mT @ Linv  # L11^-T L11^-1
    if not dp.nb:
        return Sig11
    _, _, maps = _device_maps(plan, device)
    pdm = maps[dep - 1]
    # zero border of d rows and columns: the pad slots' column index
    Sig_par = torch.nn.functional.pad(Sig_prev, (0, d, 0, d))[maps[dep].parent_of]
    cols = pdm.ch_cols
    Sig_bnd = Sig_par[pdm.ch_front[:, :, None], cols[:, :, None], cols[:, None, :]]
    G = torch.linalg.solve_triangular(L11.mT, W, upper=True)  # L11^-T W
    GS = G @ Sig_bnd
    Sig11 = Sig11 + GS @ G.mT
    return torch.cat(
        [torch.cat([Sig11, -GS], dim=2), torch.cat([-GS.mT, Sig_bnd], dim=2)], dim=1
    )


def _diag_blocks(plan: Plan, dep: int, Sig_front: Tensor, out: Tensor) -> None:
    """Write the (d, d) diagonal blocks of the interior vertices of depth
    ``dep`` from its front covariances into ``out`` (P, d, d)."""
    dp = plan.depths[dep]
    if not len(dp.va_pid):
        return
    d = plan.d
    nblk = dp.ni + dp.nb
    dm = _device_maps(plan, Sig_front.device)[2][dep]
    blocks = Sig_front.reshape(dp.num_fronts, nblk, d, nblk, d)[
        dm.va_f, dm.va_slot, :, dm.va_slot, :
    ]
    out[dm.va_pid] = blocks


def selected_inverse_diag(plan: Plan, fact) -> Tensor:
    """Per-vertex diagonal (d, d) blocks of A^{-1}: the multifrontal
    selected inverse (Takahashi on the separator tree), top-down:

        Sigma_root = (L L^T)^{-1}
        per front:  G = L11^{-T} W
                    Sigma_11 = L11^{-T} L11^{-1} + G Sigma_bnd G^T
                    Sigma_12 = -G Sigma_bnd

    where Sigma_bnd is gathered from the parent front's covariance through
    the extend-add's child-to-parent map. One batched level per tree
    depth, on the device with no host read, in the factor's dtype; cost
    and memory match one factorization. Pass the ``fact`` returned by
    :func:`factor`. Returns (P, d, d)."""
    L0 = fact[0][0]
    out = torch.zeros((plan.P, plan.d, plan.d), dtype=L0.dtype, device=L0.device)
    Sig_prev = None  # parent-depth front covariances (nF, m, m)
    for dep in range(plan.num_levels):
        Sig_prev = _takahashi_front_cov(plan, fact, dep, Sig_prev, L0.dtype)
        _diag_blocks(plan, dep, Sig_prev, out)
    return out
