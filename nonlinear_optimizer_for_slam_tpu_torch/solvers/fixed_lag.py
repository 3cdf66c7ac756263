"""Fixed-lag smoother: online sliding-window SE(3) pose-graph optimization
with Gaussian marginalization (PyTorch port of the JAX package's
``solvers/fixed_lag.py``).

A new capability: the reference is batch-only (its pose-graph module
re-solves the whole history, pose_graph_optimizer.h:21-108). A fixed-lag
smoother keeps compute and memory bounded for online SLAM: only the most
recent ``lag`` poses stay active; older poses are marginalized into a
dense Gaussian prior over the poses they were connected to, so their
information is kept (unlike plain windowing) while each update solves a
problem of constant size.

Division of labour:

- the WINDOW optimization is the dense pose-graph solve
  (``solvers.pose_graph._pose_graph_solve``) on the device, with the
  marginal prior folded in as an extra quadratic factor (``prior_sqrt``,
  ``prior_mean``, ``prior_sel``, ``prior_offset``);
- MARGINALIZATION runs on the host in float64 numpy (a handful of edges
  once per update), through the numpy twin of the edge linearization,
  ``ops.relative_pose.np_edge_residuals_and_jacobians``.

Marginalization is the Schur complement of the Gauss-Newton information of
every factor that touches a leaving pose, linearized at the current
(post-optimization) estimate:

    Lambda_b = H_bb - H_bm (H_mm + eps I)^{-1} H_mb
    g_b'     = g_b  - H_bm (H_mm + eps I)^{-1} g_m

assembled on the 6-DoF TANGENT chart at the current estimate (per pose
dphi = [dp ; dtheta] with x(dphi) = [p + dp ; n(q) (x) (1, dtheta/2)]) and
stored in AFFINE RESIDUAL form

    r_p(x) = S dphi(x) + c,   S = w^{1/2} V^T,   c = w^{-1/2} V^T g_b'

(Lambda = V diag(w) V^T with the eigenvalues clipped at 0). Both choices
carry the JAX package's findings: a raw-ambient 7-dim quadratic in q has
exact quaternion-scale null directions plus normalization curvature, in
which LM wandered and the window random-walked away; and the textbook mean
x_bar = x_lin - Lambda^+ g_b' amplifies g along near-null eigendirections
by 1/w (the prior minimum was seen catapulted 1-3 m from the estimate),
whereas each component of c is bounded by the absorbed residual norm.

Switch variables of absorbed loop closures are marginalized with their
edges.

Constant shapes: every window solve pads the pose count to at least
``lag + 1`` (padded poses are gauge-fixed identities), the odometry rows
to a multiple of 8 and the loop rows to a multiple of 2 (masked rows add
nothing) and the prior's support to a multiple of 2 (zero rows). Each such
bucket keeps one pair of device buffers (the float SoA of the window and
the edge and prior indices), refilled by one host-to-device copy each per
update, so a long run reuses a handful of them.

Default dtype: float64, which the H100 has natively (the JAX package's
float32 default on a TPU is a TPU workaround).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.lie import np_quat_conjugate as _np_quat_conj
from ..core.lie import np_quat_left_matrix as _np_quat_left
from ..core.lie import np_quat_multiply as _np_quat_mul
from ..core.options import Options
from ..core.pose import Pose, np_quat_to_rotmat
from ..ops.relative_pose import (
    SWITCH_PENALTY_SCALE,
    PoseGraphEdges,
    np_edge_residuals_and_jacobians,
    stack_sqrt_info,
)
from . import lm
from .pose_graph import _expand_sqrt_info, _fetch, _pose_graph_solve


def _pack(pose: Pose) -> np.ndarray:
    return np.concatenate([pose.translation, pose.quaternion()])


def _edge_w6(edges_all) -> Optional[np.ndarray]:
    """(E, 6) or (E, 6, 6) whitening stack from 7-tuples (w6 last), or None
    if unset."""
    return stack_sqrt_info([e[6] for e in edges_all], 6)


def _bucket(n: int, m: int) -> int:
    """``n`` rounded up to a multiple of ``m`` (0 stays 0)."""
    return ((n + m - 1) // m) * m


class FixedLagSmoother:
    """Sliding-window smoother over consecutively indexed poses.

    Usage (one odometry step per frame, loops optional):

        sm = FixedLagSmoother(lag=15, switch_penalty=0.03)
        sm.add_pose(0, first_pose)
        for k in odometry_stream:
            sm.add_pose(k, prediction)
            sm.add_odometry(k - 1, k, rel_pose)
            if loop_found:
                sm.add_loop(i, k, rel_pose)
            summary = sm.update()

    ``get_pose(i)`` returns the current window estimate, or the final
    (frozen) estimate of a marginalized pose.

    ``edge_loss`` is not supported: a robust loss has no consistent
    quadratic marginal (its curvature depends on the residual it is
    evaluated at); use switchable loop constraints instead.

    ``device`` defaults to "cuda" (the window solve runs there; the
    marginalization stays on the host); ``dtype`` to float64.
    """

    def __init__(
        self,
        lag: int,
        dtype: Optional[torch.dtype] = None,
        switch_penalty: Optional[float] = None,
        max_iterations: int = 50,
        marginalize_every: int = 1,
        device="cuda",
    ):
        """``marginalize_every``: the flush cadence of :meth:`update_async`.
        1 (the default) is the blocking semantics exactly: each update is
        fetched and marginalized before the next frame's registry calls,
        with results bit for bit those of :meth:`update`. N > 1 amortizes:
        a window solve runs every frame (each solves the FULL current
        window, superseding the previous one), but the fetch, write-back
        and marginalization run every N frames. The window grows to
        lag + N - 1 between flushes and the absorbed factors are linearized
        at the flush state (a deferred-marginalization smoother). Reads
        (``get_pose``, ``window``, ``loop_switches``, ``covariance``) flush
        first, so published state is always a window MAP."""
        if lag < 2:
            raise ValueError("lag must be >= 2")
        if marginalize_every < 1:
            raise ValueError("marginalize_every must be >= 1")
        self.lag = lag
        self.marginalize_every = marginalize_every
        self._pending_age = 0
        self.device = resolve_device(device)
        self.dtype = torch.float64 if dtype is None else dtype
        self.switch_penalty = (
            SWITCH_PENALTY_SCALE if switch_penalty is None else switch_penalty
        )
        self.max_iterations = max_iterations
        self._window: List[int] = []  # consecutive pose ids, oldest first
        self._est: Dict[int, np.ndarray] = {}  # id -> packed (7,) [p, q]
        self._history: Dict[int, np.ndarray] = {}  # marginalized finals
        # odometry: (ref, qry, rel_t (3,), rel_q (4,), sqrt_info); loops are
        # dicts with a switch
        self._odom: List[Tuple] = []
        self._loops: List[dict] = []  # ref, qry, rel_t, rel_q, switch, sqrt_info
        # prior: (support ids ascending, S (6B, 6B) over tangent coords,
        # x_lin (B, 7) [p, unit q], c (6B,))
        self._prior: Optional[Tuple[List[int], np.ndarray, np.ndarray, np.ndarray]] = None
        self._gauge: Optional[int] = None  # fixed pose until a prior exists
        # the solved-but-not-fetched window solve of update_async
        self._pending: Optional[dict] = None
        self._last_summary: Optional[lm.Summary] = None
        # shape bucket -> (float buffer, index buffer) on the device
        self._uploads: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    # -- registry -----------------------------------------------------------
    def add_pose(self, index: int, pose: Pose) -> None:
        if self.marginalize_every == 1:
            self.flush()  # keep the blocking path's marginalization timing
        if self._window and index != self._window[-1] + 1:
            raise ValueError(
                f"poses must be added consecutively (expected "
                f"{self._window[-1] + 1}, got {index})"
            )
        self._window.append(index)
        self._est[index] = _pack(pose)
        if self._gauge is None and self._prior is None:
            self._gauge = index

    def _check_edge(self, ref: int, qry: int) -> None:
        if self.marginalize_every == 1:
            self.flush()  # edges to poses a pending flush marginalizes raise
        if ref not in self._est or qry not in self._est:
            raise KeyError("edge endpoints must be in the active window")
        if ref == qry:
            raise ValueError("self-edge is not allowed")

    def add_odometry(self, reference_index: int, query_index: int, relative_pose: Pose,
                     sqrt_info=None) -> None:
        """``sqrt_info``: optional whitening, a scalar, (2,) (translation,
        rotation), (6,) or a (6, 6) matrix; see
        ``PoseGraphOptimizer.set_constraint``."""
        self._check_edge(reference_index, query_index)
        self._odom.append((
            reference_index,
            query_index,
            relative_pose.translation.copy(),
            relative_pose.quaternion(),
            _expand_sqrt_info(sqrt_info),
        ))

    def add_loop(self, reference_index: int, query_index: int, relative_pose: Pose,
                 sqrt_info=None) -> None:
        self._check_edge(reference_index, query_index)
        self._loops.append(dict(
            ref=reference_index,
            qry=query_index,
            rel_t=relative_pose.translation.copy(),
            rel_q=relative_pose.quaternion(),
            switch=1.0,
            sqrt_info=_expand_sqrt_info(sqrt_info),
        ))

    def get_pose(self, index: int) -> Pose:
        self.flush()
        x = self._est.get(index)
        if x is None:
            x = self._history[index]
        q = x[3:] / np.linalg.norm(x[3:])
        return Pose(np_quat_to_rotmat(q), x[:3].copy())

    def loop_switches(self) -> np.ndarray:
        """Current switch values of the ACTIVE (not marginalized) loops."""
        self.flush()
        return np.array([l["switch"] for l in self._loops])

    @property
    def window(self) -> List[int]:
        self.flush()
        return list(self._window)

    @property
    def active_ids(self) -> List[int]:
        """Window pose ids WITHOUT flushing a pending :meth:`update_async`:
        membership bookkeeping for streaming pipelines (a per-frame
        ``window`` read would flush every frame and defeat
        ``marginalize_every``). Ids change only at a flush; poses the
        pending flush will marginalize are still listed, which is right
        for edge eligibility (their factors get absorbed). Use
        :attr:`window` for the published (flushed) state."""
        return list(self._window)

    def covariance(self, indices: Optional[List[int]] = None) -> Dict[int, np.ndarray]:
        """Marginal 6x6 TANGENT-space covariance blocks of active window
        poses, from ALL active factors (odometry, loops at their current
        switch values, the marginal prior), linearized at the current
        estimates. Host-side float64, O((6W)^3) for a window of W poses.

        Returns {pose index: (6, 6) array}; the gauge pose (fixed while no
        prior exists yet) gets a zero block. Marginalized poses have none."""
        self.flush()
        W = len(self._window)
        if W == 0:
            raise ValueError("covariance: no poses in the window")
        local = {pi: i for i, pi in enumerate(self._window)}
        est = np.stack([self._est[pi] for pi in self._window]).astype(np.float64)
        est[:, 3:] /= np.linalg.norm(est[:, 3:], axis=1, keepdims=True)
        Tq = 0.5 * _np_quat_left(est[:, 3:])[:, :, 1:]  # (W, 4, 3)

        L = len(self._loops)
        dim = 6 * W + L
        H = np.zeros((dim, dim))

        edges_all = [(a, b, t, q, 0.0, 1.0, w) for (a, b, t, q, w) in self._odom] + [
            (l["ref"], l["qry"], l["rel_t"], l["rel_q"], 1.0, l["switch"], l["sqrt_info"])
            for l in self._loops
        ]
        if not edges_all and self._prior is None:
            raise ValueError("covariance: no factors registered")
        if edges_all:
            ref_i = np.array([local[e[0]] for e in edges_all])
            qry_i = np.array([local[e[1]] for e in edges_all])
            r, J_ref, J_qry, J_s = np_edge_residuals_and_jacobians(
                est[:, :3], est[:, 3:],
                np.array([e[5] for e in edges_all]),
                ref_i, qry_i,
                np.stack([e[2] for e in edges_all]),
                np.stack([e[3] for e in edges_all]),
                np.array([e[4] for e in edges_all]),
                self.switch_penalty,
                sqrt_info=_edge_w6(edges_all),
            )
            J_ref = np.concatenate([J_ref[:, :, :3], J_ref[:, :, 3:] @ Tq[ref_i]], axis=2)
            J_qry = np.concatenate([J_qry[:, :, :3], J_qry[:, :, 3:] @ Tq[qry_i]], axis=2)
            n_odom = len(self._odom)
            for k in range(len(edges_all)):
                if self._prior is None and edges_all[k][0] == self._gauge:
                    J_ref[k] = 0.0
                if self._prior is None and edges_all[k][1] == self._gauge:
                    J_qry[k] = 0.0
                ra, rb = 6 * ref_i[k], 6 * qry_i[k]
                Ja, Jb = J_ref[k], J_qry[k]
                H[ra:ra + 6, ra:ra + 6] += Ja.T @ Ja
                H[rb:rb + 6, rb:rb + 6] += Jb.T @ Jb
                H[ra:ra + 6, rb:rb + 6] += Ja.T @ Jb
                H[rb:rb + 6, ra:ra + 6] += Jb.T @ Ja
                if k >= n_odom:
                    sc = 6 * W + (k - n_odom)
                    Js = J_s[k]
                    H[ra:ra + 6, sc] += Ja.T @ Js
                    H[sc, ra:ra + 6] += Ja.T @ Js
                    H[rb:rb + 6, sc] += Jb.T @ Js
                    H[sc, rb:rb + 6] += Jb.T @ Js
                    H[sc, sc] += Js @ Js

        if self._prior is not None:
            sup, S, lin, c = self._prior
            rows = np.concatenate([np.arange(6 * local[pi], 6 * local[pi] + 6) for pi in sup])
            sel = np.array([local[pi] for pi in sup])
            A = _np_quat_mul(_np_quat_conj(lin[:, 3:]), est[sel, 3:])
            G = _np_quat_left(A)[:, 1:, 1:]
            Tblk = np.zeros((len(rows), len(rows)))
            for i in range(len(sup)):
                Tblk[6 * i:6 * i + 3, 6 * i:6 * i + 3] = np.eye(3)
                Tblk[6 * i + 3:6 * i + 6, 6 * i + 3:6 * i + 6] = G[i]
            J_p = S @ Tblk
            H[np.ix_(rows, rows)] += J_p.T @ J_p

        # the gauge pose (if any) is constant: drop its rows and columns
        keep = np.ones(dim, bool)
        if self._prior is None and self._gauge is not None:
            gi = 6 * local[self._gauge]
            keep[gi:gi + 6] = False
        try:
            Sigma_red = np.linalg.inv(H[np.ix_(keep, keep)])
        except np.linalg.LinAlgError as exc:
            raise ValueError(
                "covariance: window information is singular — the window is "
                "under-constrained"
            ) from exc
        Sigma = np.zeros((dim, dim))
        kk = np.nonzero(keep)[0]
        Sigma[np.ix_(kk, kk)] = Sigma_red

        if indices is None:
            indices = list(self._window)
        out = {}
        for pi in indices:
            if pi not in local:
                raise KeyError(
                    f"pose {pi} is not in the active window "
                    f"({self._window[0]}..{self._window[-1]})"
                )
            i = local[pi]
            out[pi] = Sigma[6 * i:6 * i + 6, 6 * i:6 * i + 6].copy()
        return out

    # -- update ---------------------------------------------------------------
    def update(self, options: Optional[Options] = None) -> lm.Summary:
        """Optimize the window, then marginalize poses older than the lag."""
        self.flush()
        self._pending = self._dispatch(options)
        return self.flush()

    def update_async(self, options: Optional[Options] = None) -> None:
        """Streaming update: solve the window and return without fetching
        the result; the fetch, write-back and marginalization run at the
        next ``update``/``update_async``/``add_*``/read or an explicit
        :meth:`flush`, every ``marginalize_every``-th frame at the latest.

        What is and is not overlapped: PyTorch has no deferred dispatch
        like JAX's, and the window solve's LM reads its `all done` flag on
        the host every iteration, so the device solve runs to its end
        inside this call; nothing of it overlaps the caller. What is
        deferred is the host's part: the one device-to-host copy of the
        solved window, the write-back and the float64 marginalization. With
        ``marginalize_every=1`` the results are bit for bit those of
        :meth:`update` (the same solve on the same inputs; only the fetch
        moves); with N > 1 the host part runs once every N frames
        (amortized semantics, see ``__init__``). The solve's summary is
        available after the flush, as :attr:`last_summary`."""
        if self._pending is not None:
            self._pending_age += 1
            if self._pending_age >= self.marginalize_every:
                self.flush()
        self._pending = self._dispatch(options)

    @property
    def last_summary(self) -> Optional[lm.Summary]:
        """Summary of the most recently FLUSHED update (None before the
        first flush), as numpy arrays."""
        return self._last_summary

    def flush(self) -> Optional[lm.Summary]:
        """Complete a pending :meth:`update_async`: one device-to-host copy,
        write-back, marginalization. A no-op without a pending update.
        Returns the flushed update's summary (or the last one)."""
        pending = self._pending
        if pending is None:
            return self._last_summary
        self._pending = None
        self._pending_age = 0
        if pending["kind"] == "empty":
            summary = pending["summary"]
        else:
            # one device-to-host copy of the solved window and its summary
            (pose, sw), summary = _fetch((pending["pose"], pending["sw"]), pending["summary"])
            pose = np.array(pose, np.float64)
            sw = np.array(sw, np.float64)
            pos, quat = pose[:, :3], pose[:, 3:]
            # renormalize at write-back (as pose_graph_optimizer.h:89-101):
            # the objective (edges and the tangent-space prior) is
            # invariant to the quaternion's scale, so this is free, and it
            # keeps every linearization chart on the unit sphere
            quat /= np.linalg.norm(quat, axis=1, keepdims=True)
            for i, pi in enumerate(pending["window"]):
                self._est[pi] = np.concatenate([pos[i], quat[i]])
            for l, s in zip(pending["loops"], sw[: pending["L"]]):
                l["switch"] = float(s)
        self._last_summary = summary
        cutoff = pending["window"][-1] - self.lag + 1
        if cutoff > pending["window"][0]:
            self._marginalize(cutoff)
        return summary

    # -- window solve ---------------------------------------------------------
    def _device_buffers(self, key: tuple, floats: np.ndarray, ints: np.ndarray):
        """The bucket's device buffers, filled with ``floats`` and ``ints``:
        one host-to-device copy each."""
        bufs = self._uploads.get(key)
        if bufs is None:
            bufs = (
                torch.empty(floats.shape[0], dtype=self.dtype, device=self.device),
                torch.empty(ints.shape[0], dtype=torch.int64, device=self.device),
            )
            self._uploads[key] = bufs
        bufs[0].copy_(torch.from_numpy(floats))
        bufs[1].copy_(torch.from_numpy(ints))
        return bufs

    def _dispatch(self, options: Optional[Options]) -> dict:
        """One window solve at the constant shapes of the module docstring;
        returns its result on the device, unfetched (see :meth:`flush`)."""
        if options is None:
            options = Options().replace(max_iterations=self.max_iterations)
        if not self._window:
            raise ValueError("update: no poses registered — add_pose() first")
        W = len(self._window)
        local = {pi: i for i, pi in enumerate(self._window)}

        if not self._odom and not self._loops:
            nan = np.full((options.max_iterations,), np.nan)
            zero = np.zeros(())
            return dict(
                kind="empty",
                window=list(self._window),
                summary=lm.Summary(
                    zero, zero, np.zeros((), np.int32), zero, np.asarray(True),
                    lm.IterationRecord(nan, nan, nan, nan),
                ),
            )

        # the window holds lag + 1 poses at solve time in the steady
        # per-frame loop (update() solves BEFORE marginalizing the newly
        # exceeded pose); bucket beyond that for callers that add several
        # poses per update
        P = max(self.lag + 1, _bucket(W, 4))
        est = np.zeros((P, 7))
        est[:, 3] = 1.0  # identity quaternions on padded slots
        est[:W] = np.stack([self._est[pi] for pi in self._window])

        E_o, L = len(self._odom), len(self._loops)
        E_op = _bucket(E_o, 8)
        L_p = _bucket(L, 2)
        E = E_op + L_p
        ref = np.zeros((E,), np.int64)
        qry = np.ones((E,), np.int64)  # pad rows: a masked 0 -> 1 edge
        rel_t = np.zeros((E, 3))
        rel_q = np.zeros((E, 4))
        rel_q[:, 0] = 1.0
        is_loop = np.zeros((E,))
        is_loop[E_op:] = 1.0  # padded loop rows too (the slot cumsum)
        mask = np.zeros((E,))
        mask[:E_o] = 1.0
        mask[E_op:E_op + L] = 1.0
        w_entries = [None] * E
        for k, (a, b, t, q, w) in enumerate(self._odom):
            ref[k], qry[k] = local[a], local[b]
            rel_t[k], rel_q[k] = t, q
            w_entries[k] = w
        sw0 = np.ones((L_p,))
        for k, l in enumerate(self._loops):
            ref[E_op + k], qry[E_op + k] = local[l["ref"]], local[l["qry"]]
            rel_t[E_op + k], rel_q[E_op + k] = l["rel_t"], l["rel_q"]
            sw0[k] = l["switch"]
            w_entries[E_op + k] = l["sqrt_info"]
        w6 = stack_sqrt_info(w_entries, 6)
        free = np.zeros(P)
        free[:W] = 1.0
        if self._prior is None and self._gauge is not None:
            free[local[self._gauge]] = 0.0

        floats = [est, sw0, rel_t, rel_q, is_loop, mask, free]
        ints = [ref, qry]
        B_p = None
        if self._prior is not None:
            sup, S, x_lin, c = self._prior
            B, B_p = len(sup), _bucket(len(sup), 2)
            S_pad = np.zeros((6 * B_p, 6 * B_p))
            S_pad[:6 * B, :6 * B] = S
            lin_pad = np.zeros((B_p, 7))
            lin_pad[:, 3] = 1.0  # identity quaternions on padded support slots
            lin_pad[:B] = x_lin
            c_pad = np.zeros((6 * B_p,))
            c_pad[:6 * B] = c
            sel_pad = np.zeros((B_p,), np.int64)
            sel_pad[:B] = [local[pi] for pi in sup]
            floats += [S_pad, lin_pad, c_pad]
            ints.append(sel_pad)
        if w6 is not None:
            floats.append(w6)
        key = (P, E_op, L_p, B_p, None if w6 is None else w6.shape)
        fbuf, ibuf = self._device_buffers(
            key,
            np.concatenate([a.reshape(-1) for a in floats]).astype(np.float64),
            np.concatenate(ints),
        )
        # views of the buffers, in the order they were packed
        views, at = [], 0
        for a in floats:
            views.append(fbuf[at:at + a.size].view(a.shape))
            at += a.size
        est_d, sw0_d, rel_t_d, rel_q_d, is_loop_d, mask_d, free_d = views[:7]
        edges = PoseGraphEdges(
            reference_indices=ibuf[:E],
            query_indices=ibuf[E:2 * E],
            relative_translations=rel_t_d,
            relative_quaternions=rel_q_d,
            is_loop=is_loop_d,
            mask=mask_d,
            sqrt_info=views[-1] if w6 is not None else None,
        )
        prior = (None, None, None, None)
        if B_p is not None:
            prior = (views[7], views[8], ibuf[2 * E:], views[9])

        pose, sw, summary = _pose_graph_solve(
            est_d[None], sw0_d[None], edges, free_d, self.switch_penalty,
            None,  # edge_loss unsupported (see the class docstring)
            P, L_p, options, *prior,
        )
        return dict(
            kind="solve",
            window=list(self._window),
            loops=list(self._loops),
            L=L,
            pose=pose[0],
            sw=sw[0],
            summary=lm.instance(summary, 0),
        )

    # -- marginalization --------------------------------------------------------
    def _marginalize(self, cutoff: int) -> None:
        """Schur-complement marginalization in TANGENT coordinates, on the
        host in float64.

        All absorbed information is assembled on the 6-DoF local chart at
        the current (quaternion-normalized) estimate, per pose
        x(dphi) = [p + dp ; n(q) (x) (1, dtheta/2)], not on the raw 7-dim
        ambient coordinates (see the module docstring). Ambient edge
        Jacobians chain onto the chart with
        T_i = blkdiag(I_3, 0.5 L(n(q_i))[:, 1:]) (7x6 per pose).
        """
        leaving = {pi for pi in self._window if pi < cutoff}

        absorb_odom = [e for e in self._odom if e[0] in leaving or e[1] in leaving]
        absorb_loops = [l for l in self._loops if l["ref"] in leaving or l["qry"] in leaving]
        prior_support = list(self._prior[0]) if self._prior is not None else []

        # every pose touched by an absorbed factor or the prior, and every
        # leaving pose (isolated ones add nothing but must still go)
        V: List[int] = sorted(
            leaving
            | {e[0] for e in absorb_odom} | {e[1] for e in absorb_odom}
            | {l["ref"] for l in absorb_loops} | {l["qry"] for l in absorb_loops}
            | set(prior_support)
        )
        slot = {pi: i for i, pi in enumerate(V)}
        n_sw = len(absorb_loops)
        nV = len(V)
        dim = 6 * nV + n_sw

        est = np.stack([self._est[pi] for pi in V]).astype(np.float64)
        est[:, 3:] /= np.linalg.norm(est[:, 3:], axis=1, keepdims=True)
        # chart map per pose: d(ambient) / d(tangent rotation), (4, 3)
        Tq = 0.5 * _np_quat_left(est[:, 3:])[:, :, 1:]  # (V, 4, 3)

        H = np.zeros((dim, dim))
        g = np.zeros(dim)

        edges_all = [(e[0], e[1], e[2], e[3], 0.0, 1.0, e[4]) for e in absorb_odom] + [
            (l["ref"], l["qry"], l["rel_t"], l["rel_q"], 1.0, l["switch"], l["sqrt_info"])
            for l in absorb_loops
        ]
        if edges_all:
            ref_i = np.array([slot[e[0]] for e in edges_all])
            qry_i = np.array([slot[e[1]] for e in edges_all])
            r, J_ref, J_qry, J_s = np_edge_residuals_and_jacobians(
                est[:, :3],
                est[:, 3:],
                np.array([e[5] for e in edges_all]),
                ref_i,
                qry_i,
                np.stack([e[2] for e in edges_all]),
                np.stack([e[3] for e in edges_all]),
                np.array([e[4] for e in edges_all]),
                self.switch_penalty,
                sqrt_info=_edge_w6(edges_all),
            )
            # chain the ambient (E, 7, 7) blocks onto the chart: (E, 7, 6)
            J_ref = np.concatenate([J_ref[:, :, :3], J_ref[:, :, 3:] @ Tq[ref_i]], axis=2)
            J_qry = np.concatenate([J_qry[:, :, :3], J_qry[:, :, 3:] @ Tq[qry_i]], axis=2)
            # the gauge pose (fixed while no prior exists) is a constant:
            # zero its Jacobian columns so it adds no information
            for k, (a, b, *_rest) in enumerate(edges_all):
                if self._prior is None and a == self._gauge:
                    J_ref[k] = 0.0
                if self._prior is None and b == self._gauge:
                    J_qry[k] = 0.0
            n_odom = len(absorb_odom)
            for k in range(len(edges_all)):
                ra = 6 * ref_i[k]
                rb = 6 * qry_i[k]
                Ja, Jb, rk = J_ref[k], J_qry[k], r[k]
                H[ra:ra + 6, ra:ra + 6] += Ja.T @ Ja
                H[rb:rb + 6, rb:rb + 6] += Jb.T @ Jb
                H[ra:ra + 6, rb:rb + 6] += Ja.T @ Jb
                H[rb:rb + 6, ra:ra + 6] += Jb.T @ Ja
                g[ra:ra + 6] += Ja.T @ rk
                g[rb:rb + 6] += Jb.T @ rk
                if k >= n_odom:  # a loop: its switch column
                    sc = 6 * nV + (k - n_odom)
                    Js = J_s[k]
                    H[ra:ra + 6, sc] += Ja.T @ Js
                    H[sc, ra:ra + 6] += Ja.T @ Js
                    H[rb:rb + 6, sc] += Jb.T @ Js
                    H[sc, rb:rb + 6] += Jb.T @ Js
                    H[sc, sc] += Js @ Js
                    g[sc] += Js @ rk

        if self._prior is not None:
            # the old prior r_p = S dphi_prior(x) + c, linearized on the
            # CURRENT chart: translation block I, rotation block
            # L(A)[1:, 1:] with A = q_lin^-1 (x) n(q_est)
            sup, S, lin, c = self._prior
            rows = np.concatenate([np.arange(6 * slot[pi], 6 * slot[pi] + 6) for pi in sup])
            sel = np.array([slot[pi] for pi in sup])
            A = _np_quat_mul(_np_quat_conj(lin[:, 3:]), est[sel, 3:])  # (B, 4)
            dphi = np.concatenate([est[sel, :3] - lin[:, :3], 2.0 * A[:, 1:]], axis=1).reshape(-1)
            r_p = S @ dphi + c
            G = _np_quat_left(A)[:, 1:, 1:]  # (B, 3, 3)
            Tblk = np.zeros((len(rows), len(rows)))
            for i in range(len(sup)):
                Tblk[6 * i:6 * i + 3, 6 * i:6 * i + 3] = np.eye(3)
                Tblk[6 * i + 3:6 * i + 6, 6 * i + 3:6 * i + 6] = G[i]
            J_p = S @ Tblk
            H[np.ix_(rows, rows)] += J_p.T @ J_p
            g[rows] += J_p.T @ r_p

        # partition: m = leaving poses + absorbed switches; b = retained
        m_rows = np.concatenate(
            [np.arange(6 * slot[pi], 6 * slot[pi] + 6) for pi in V if pi in leaving]
            + [np.arange(6 * nV, dim)]
        ).astype(int)
        retained = [pi for pi in V if pi not in leaving]
        b_rows = np.concatenate(
            [np.arange(6 * slot[pi], 6 * slot[pi] + 6) for pi in retained]
        ).astype(int) if retained else np.zeros((0,), int)

        if len(b_rows):
            H_mm = H[np.ix_(m_rows, m_rows)] + 1e-10 * np.eye(len(m_rows))
            H_bm = H[np.ix_(b_rows, m_rows)]
            sol = np.linalg.solve(H_mm, np.concatenate([H_bm.T, g[m_rows][:, None]], axis=1))
            Lam = H[np.ix_(b_rows, b_rows)] - H_bm @ sol[:, :-1]
            g_b = g[b_rows] - H_bm @ sol[:, -1]
            Lam = 0.5 * (Lam + Lam.T)
            w, Vec = np.linalg.eigh(Lam)
            w = np.clip(w, 0.0, None)
            S_new = np.sqrt(w)[:, None] * Vec.T
            # the residual offset c = w^{-1/2} V^T g (0 on the null space):
            # each component is <= the absorbed residual norm
            keep = w > 1e-12 * max(w.max(), 1.0)
            c_new = np.where(keep, (Vec.T @ g_b) / np.sqrt(np.maximum(w, 1e-300)), 0.0)
            lin_new = np.stack([est[slot[pi]] for pi in retained])
            self._prior = (retained, S_new, lin_new, c_new)
        else:
            self._prior = None

        # slide the registry
        for pi in sorted(leaving):
            self._history[pi] = self._est.pop(pi)
        self._window = [pi for pi in self._window if pi not in leaving]
        # by identity: the entries hold numpy arrays, whose == is elementwise
        absorbed = {id(e) for e in absorb_odom} | {id(l) for l in absorb_loops}
        self._odom = [e for e in self._odom if id(e) not in absorbed]
        self._loops = [l for l in self._loops if id(l) not in absorbed]
        self._gauge = None  # the prior carries the gauge from here on
