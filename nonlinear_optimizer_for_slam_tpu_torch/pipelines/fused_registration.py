"""Device-resident NDT registration (PyTorch port of the JAX package's
``pipelines/fused_registration.py``): ``NdtRegistrar`` keeps the map on the
device and runs the whole outer ICP loop (matching, inner LM solves, outer
convergence) as one flat state machine over device tensors.

One machine for one scan and for a batch
----------------------------------------
The machine is batched: its state is (B, ...) tensors, one lane per scan,
and ``register`` runs it at B = 1. Each step is one damped Gauss-Newton
iteration for every lane, with the reference's policy
(mahalanobis_distance_minimizer_analytic.cc:84-152, outer check
simple_optimization_test.cc:563-568). A lane that finishes its inner solve
WAITS, frozen (pose, lambda, counters and records stop changing), and a
finished registration is DONE. Once every live lane waits (``sync``), all
lanes are re-matched at their frozen poses in one batched matching, and go
on. This is the JAX package's lockstep machine
(``_fused_register_lockstep_impl``): a frozen lane's rematch depends only
on its own frozen pose, so each lane follows exactly the trajectory of the
serial machine (``_fused_register_impl``): the same poses, outer counts
and per-outer inner counts. At B = 1 the lane is never frozen past its
own sync, so the machine IS the serial one.

``register_batch(mode="vmap")`` runs the same machine as the JAX
package's second oracle, ``jax.vmap`` of the serial machine
(``_fused_register_batched``): no lane waits; after every step every lane
is matched at its new pose, and a lane that has just ended its inner
solve keeps the new correspondences (a per-lane select, the lowering that
``jax.vmap`` gives the serial machine's ``lax.cond``). Each lane then
follows its serial trajectory too, at the price of one batched matching
per step.

Blocks of K steps
-----------------
The host drives the machine in blocks of ``BLOCK_STEPS`` (K) steps. Inside
a block nothing is read on the host: every decision is a ``torch.where``
mask, the loss parameters and constants are on the device before the
first block, the linear solve is ``cholesky_ex`` (no check of ``info`` on
the host). After each block the host reads two flags in one copy:
``all_done`` and ``sync``. The rematch runs only after a read that shows
``sync``; a lane that finishes inside a block waits, frozen, until then.
Freezing makes the extra steps of a block change nothing, so the
trajectory is the lockstep one above, whatever K is. K trades wasted
masked steps (at most K - 1 per outer iteration) against host reads
(about evaluations / K + outer iterations).

On the kernel path (``eval_backend="cuda"``) the block is replayed from
a CUDA graph. Its key is everything the captured kernels fix: lanes B,
the correspondence buffer's shape and strides, the dtypes, ``planar``,
``objective``, the device, K, the options and the outer iteration cap.
The first block of a shape that the registrar has no graph for runs
eagerly (it warms cuBLAS, cuSOLVER and the kernels' workspaces); the
next captures the graph and replays it, and every later block of that
shape, in this run and the next, replays it. A registrar keeps one
graph: a new key captures a new one in the old one's memory and drops
the old, since ``register`` does not pad N and a stream of scans seldom
meets the same N twice. The graph reads the state and the buffer from
static tensors it owns and copies the new state back into them, so
replays chain with nothing copied on the host's side; a rematch copies
the new buffer into its static one. A run's results are copies, never
the static tensors. A replayed block gives the eager block's bits, and
``ck.LAUNCHES`` counts the kernels a replay runs. The "torch" path, a
mesh (whose sum over ranks may run on gloo) and the vmap mode (which
matches inside the block) run eagerly.

Evaluation
----------
Matching writes a float32 correspondence buffer whatever the registrar's
dtype, as the JAX package does: the maha6 layout (16 rows, N * k lanes)
for the Mahalanobis objective, full or planar, and the p2p layout (10 rows,
N lanes, one plane per point) for point-to-plane. ``eval_backend="cuda"``
evaluates it with the hand-written kernels (``maha6``, ``maha3``, ``p2p``
in ``ops/cuda_kernels``), one launch per step for all B lanes, finished or
not; ``"torch"`` unpacks it once per match and evaluates with the plain
PyTorch factor code (the JAX ``"jnp"`` backend). On a CUDA device the
default is ``"cuda"``; on the CPU ``"torch"`` is the only path.

Host matching
-------------
``HybridRegistrar`` is the reference's host/device split (the JAX
package's class of that name): the native C++ matcher (``native.py``)
writes the maha6 buffer on the host each outer iteration, the buffer goes
to the device in one copy, and ``_packed_lm_solve`` runs the inner LM over
it with one kernel launch per LM evaluation.

Sharding
--------
``NdtRegistrar(mesh=)`` (a ``parallel.FactorMesh``) runs one registration
over the ranks of a ``torch.distributed`` group, as the JAX package's
``_fused_register_sharded`` runs it over a device mesh: every rank calls
``register`` with the full scan, the scan points are padded with masked
zeros to a multiple of the world size, each rank matches its own block
against the whole map and evaluates it, and each step's (H, g, cost)
partials are summed across ranks (``parallel.all_sum``, the same bits on
every rank). The machine, its blocks and its one host read per block are
then the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..core import lie
from ..core.device import resolve_device
from ..core.losses import LossFunction
from ..core.options import Options
from ..core.pose import Pose, np_quat_to_rotmat, np_rotmat_to_quat
from ..ops import cuda_kernels as ck
from ..ops import mahalanobis as maha_ops
from ..ops import point_to_plane as p2p_ops
from ..ops.quadratic import _symmetric_gather
from ..parallel import FactorMesh, factor_sharding, reducer
from ..solvers import lm
from ..solvers import minimizers as mins
from ..solvers.linear import damp_hessian, solve_normal_equations
from ..solvers.manifolds import SE2Params, SE3Params, se2_retract, se3_retract
from ..utils import tracing
from . import matching
from . import ndt as ndt_mod
from .ndt import NdtMap
from .registration import OUTER_MAX_ITERATIONS, OUTER_TOLERANCE

Tensor = torch.Tensor

# LM steps per block between two host reads (see the module docstring).
BLOCK_STEPS = 8

EVAL_BACKENDS = ("cuda", "torch")


@dataclasses.dataclass
class FusedRegistrationResult:
    pose: Pose
    outer_iterations: int
    final_cost: float
    inner_iterations: np.ndarray  # (max_outer,) per-outer inner LM counts
    costs: np.ndarray  # (max_outer,) final cost per outer iteration


class RegistrarMap(NamedTuple):
    """The map state a registrar keeps on the device, in its dtype; the
    same arrays, under the same names, as the JAX ``NdtRegistrar``."""

    means_T: Tensor  # (3, M) valid voxel means
    infos_T: Tensor  # (9, M) sqrt-informations, row-major
    normals_T: Optional[Tensor] = None  # (3, M) unit plane normals (p2p)
    voxel_weights: Optional[Tensor] = None  # (M,) 1.0 = usable plane (p2p)
    map_mask: Optional[Tensor] = None  # (M,) 1.0 = real voxel (map padding)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def build_map_state(
    ndt_map: NdtMap,
    objective: str = "maha",
    max_flatness: float = 0.2,
    max_thickness: Optional[float] = None,
    map_pad_multiple: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> RegistrarMap:
    """The registrar's device map from an NDT map: its valid voxels, the
    voxel planes for ``objective="p2p"`` (``ndt.voxel_normals`` gated by
    ``max_flatness`` and ``max_thickness``), and with ``map_pad_multiple``
    the voxel count padded to a multiple of it with masked voxels (mean 0,
    identity sqrt-information, normal +z, weight 0)."""
    valid = ndt_map.valid_only()
    means = valid.means
    sqinfos = valid.sqrt_informations
    normals = weights = map_mask = None
    if objective == "p2p":
        normals, flatness, thickness = ndt_mod.voxel_normals(valid)
        ok = flatness <= max_flatness
        if max_thickness is not None:
            ok &= thickness <= max_thickness
        weights = ok.astype(np.float64)
    if map_pad_multiple is not None:
        M = means.shape[0]
        Mp = max(map_pad_multiple, _round_up(M, map_pad_multiple))
        if Mp != M:
            means = np.concatenate([means, np.zeros((Mp - M, 3))])
            sqinfos = np.concatenate([sqinfos, np.broadcast_to(np.eye(3), (Mp - M, 3, 3))])
            if normals is not None:
                pad_n = np.zeros((Mp - M, 3))
                pad_n[:, 2] = 1.0
                normals = np.concatenate([normals, pad_n])
                weights = np.concatenate([weights, np.zeros(Mp - M)])
        map_mask = (np.arange(means.shape[0]) < M).astype(np.float64)
    as_t = lambda a: None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), dtype=dtype, device=device
    )
    return RegistrarMap(
        means_T=as_t(means.T),
        infos_T=as_t(sqinfos.reshape(-1, 9).T),
        normals_T=as_t(None if normals is None else normals.T),
        voxel_weights=as_t(weights),
        map_mask=as_t(map_mask),
    )


class _State(NamedTuple):
    """The machine's (B, ...) state; see the module docstring."""

    t: Tensor  # (B, 3)
    q: Tensor  # (B, 4) wxyz
    lam: Tensor  # (B,)
    prev_cost: Tensor  # (B,)
    inner_it: Tensor  # (B,) int32
    t_anchor: Tensor  # (B, 3) pose at the start of the inner solve
    q_anchor: Tensor  # (B, 4)
    outer_it: Tensor  # (B,) int32
    waiting: Tensor  # (B,) bool: inner solve finished, rematch pending
    done: Tensor  # (B,) bool
    inner_its: Tensor  # (B, max_outer) int32
    costs: Tensor  # (B, max_outer)
    final_cost: Tensor  # (B,)
    active_steps: Tensor  # () int64: steps in which some lane ran


def _can_capture(device: torch.device) -> bool:
    """Whether work on ``device`` can be captured in a CUDA graph now: a
    CUDA device, and no capture already under way."""
    return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()


# The side stream of each device that captures run on: one, so that
# cuBLAS and cuSOLVER keep one workspace for captures, not one a stream.
_CAPTURE_STREAMS: dict = {}


def _capture(body: Callable[[], None], device: torch.device, share=None):
    """The work of ``body()`` on ``device`` captured in a CUDA graph
    (nothing runs); its ``replay()`` runs that work. Captured on a side
    stream, as ``torch.cuda.graph`` does, without its synchronise and its
    emptying of the allocator's cache, which a registrar that meets a new
    shape on every call would pay on every call. ``share``: a graph whose
    memory pool the new graph takes over (it must not replay again)."""
    graph = torch.cuda.CUDAGraph()
    side = _CAPTURE_STREAMS.get(device)
    if side is None:
        side = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):  # on ``device``, which it makes current
        graph.capture_begin(pool=None if share is None else share.pool())
        try:
            body()
        finally:
            graph.capture_end()
    main.wait_stream(side)
    return graph


class _BlockGraph:
    """A machine's block captured in a CUDA graph over static tensors it
    owns: the state, the correspondence buffer and the (all_done, sync)
    flags, loaded with ``st`` and ``data``. A replay runs the block on the
    static state and copies the new state and the flags back into them.
    ``key``: the machine's key of the graph; ``launches``: the kernel
    launches of one replay, by kernel. ``previous``: the graph this one
    replaces, whose memory it takes over."""

    def __init__(self, machine: "_Machine", key: tuple, st: _State, data: Tensor,
                 previous: Optional["_BlockGraph"] = None):
        self.key = key
        self.state = _State(*(a.clone() for a in st))
        # laid out as ``data`` (on the card: the kernels' padded rows)
        self.data = data.clone() if data.is_contiguous() else ck.lane_aligned(data.clone())
        self.flags = torch.zeros(2, dtype=torch.bool, device=data.device)

        def body():
            new, _, flags = machine._block(self.state, self.data)
            for static, a in zip(self.state, new):
                static.copy_(a)
            self.flags.copy_(flags)

        before = dict(ck.LAUNCHES)
        self.graph = _capture(body, data.device, previous and previous.graph)
        # the capture ran nothing: its launches count on each replay
        self.launches = {k: n - before[k] for k, n in ck.LAUNCHES.items() if n != before[k]}
        ck.LAUNCHES.update(before)
        tracing.count("graph.captures")
        self.load(st, data)

    def load(self, st: _State, data: Tensor) -> None:
        for static, a in zip(self.state, st):
            static.copy_(a)
        self.data.copy_(data)

    def replay(self) -> None:
        with tracing.span("nls.graph.replay"):
            self.graph.replay()
        for k, n in self.launches.items():
            ck.LAUNCHES[k] += n
        tracing.count("graph.replays")


class _Machine:
    """The batched state machine of the module docstring, over the
    correspondences that a subclass's ``operand(t, q)`` builds for every
    lane at its pose: packed float32 rows for ``eval_backend="cuda"``, the
    objective's (B, N, ...) data for ``"torch"``. ``NdtRegistrar`` and
    ``fused_d2d.D2dRegistrar`` drive it."""

    def _init_machine(
        self, options, loss, max_outer_iterations, outer_tolerance, dtype, device,
        eval_backend, planar=False, objective="maha",
    ):
        self.device = resolve_device(device)
        if eval_backend is None:
            eval_backend = "cuda" if self.device.type == "cuda" else "torch"
        if eval_backend not in EVAL_BACKENDS:
            raise ValueError(f"unknown eval_backend {eval_backend!r}; use one of {EVAL_BACKENDS}")
        if eval_backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"eval_backend 'cuda' runs the CUDA kernels and needs a CUDA "
                f"device, not {self.device}; use eval_backend='torch'"
            )
        self.dtype = dtype
        self.planar = planar
        self.objective = objective
        self.eval_backend = eval_backend
        self.options = options
        self.loss = loss
        self.max_outer_iterations = max_outer_iterations
        self._last_run: Optional[dict] = None
        self.mesh: Optional[FactorMesh] = None
        self._reduce = lambda hgc: hgc  # the sum over a mesh's ranks
        self._graph: Optional[_BlockGraph] = None  # the block's graph (module docstring)

        # everything the blocks read, on the device before the first block
        scalar = lambda v: torch.full((), v, dtype=dtype, device=self.device)
        self._outer_tol = scalar(outer_tolerance)
        self._initial_lambda = scalar(options.optimization_handle.initial_lambda)
        self._fmax = scalar(torch.finfo(dtype).max)
        self._slots = torch.arange(max_outer_iterations, dtype=torch.int32, device=self.device)
        self._loss_code, self._loss_ab = (
            ck.maha6_loss_ab(loss, self.device) if eval_backend == "cuda" else (None, None)
        )
        # the kernels' H unpacking index, cached per device ("cuda:0", as a
        # tensor names it, not "cuda"): built here, it is no host-to-device
        # copy inside the first block
        _symmetric_gather(3 if planar else 6, self._fmax.device)

    @staticmethod
    def finalize(device_out) -> FusedRegistrationResult:
        return _Machine.finalize_batch(device_out)[0]

    @staticmethod
    @tracing.traced("nls.batch.finalize")
    def finalize_batch(device_out) -> list:
        """Copy a run's device tensors to the host and unpack them into
        one ``FusedRegistrationResult`` per scan; q is renormalised in
        float64."""
        ts, qs, its, inner_its, costs, final_costs = (
            tracing.host_read(a).numpy() for a in device_out
        )
        results = []
        for b in range(ts.shape[0]):
            qn = np.asarray(qs[b], np.float64)
            qn = qn / np.linalg.norm(qn)
            results.append(
                FusedRegistrationResult(
                    pose=Pose(np_quat_to_rotmat(qn), np.asarray(ts[b], np.float64)),
                    outer_iterations=int(its[b]),
                    final_cost=float(final_costs[b]),
                    inner_iterations=np.asarray(inner_its[b]),
                    costs=np.asarray(costs[b]),
                )
            )
        return results

    def run_stats(self) -> dict:
        """Of the last run: steps run, wasted steps (every lane frozen),
        host reads of the two flags, blocks replayed from a graph."""
        s = dict(self._last_run)
        active = int(s.pop("active_steps"))
        return {**s, "wasted_steps": s["steps"] - active}

    def _graph_key(self, data, vmap: bool) -> Optional[tuple]:
        """The key of the block's graph for the buffer ``data``, or None
        where the block runs eagerly (see the module docstring)."""
        if (vmap or self.mesh is not None or self.eval_backend != "cuda"
                or not _can_capture(self.device)):
            return None
        return (tuple(data.shape), data.stride(), data.dtype, self.dtype, self.planar,
                self.objective, str(self.device), BLOCK_STEPS, self.options,
                self.max_outer_iterations)

    def _drive(self, operand, t0: Tensor, q0: Tensor, vmap: bool = False):
        """Run the machine from (B, 3) ``t0`` and (B, 4) ``q0``: returns (t,
        q, outer_it, inner_its, costs, final_cost), (B, ...) device tensors.
        ``vmap`` rematches each lane as soon as its own inner solve ends
        (see :meth:`_block`) instead of at the lockstep sync. Blocks replay
        from a graph where the module docstring says."""
        B = t0.shape[0]
        dev, dt = self.device, self.dtype
        zeros_i = torch.zeros(B, dtype=torch.int32, device=dev)
        false = torch.zeros(B, dtype=torch.bool, device=dev)
        max_outer = self.max_outer_iterations
        st = _State(
            t=t0, q=q0,
            lam=self._initial_lambda.expand(B).clone(),
            prev_cost=self._fmax.expand(B).clone(),
            inner_it=zeros_i, t_anchor=t0, q_anchor=q0,
            outer_it=zeros_i, waiting=false, done=false,
            inner_its=torch.zeros((B, max_outer), dtype=torch.int32, device=dev),
            costs=torch.full((B, max_outer), float("nan"), dtype=dt, device=dev),
            final_cost=torch.full((B,), float("nan"), dtype=dt, device=dev),
            active_steps=torch.zeros((), dtype=torch.int64, device=dev),
        )

        def match(t, q):
            with tracing.span("nls.match"):
                return operand(t, q)

        data = match(t0, q0)
        key = self._graph_key(data, vmap)
        graph = self._graph if self._graph is not None and self._graph.key == key else None
        if graph is not None:
            graph.load(st, data)
        steps = reads = replays = 0
        while True:
            with tracing.span("nls.block"):
                if graph is None and key is not None and reads:
                    graph = self._graph = _BlockGraph(self, key, st, data, self._graph)
                if graph is None:
                    st, data, flags = self._block(st, data, match if vmap else None)
                else:
                    graph.replay()
                    replays += 1
                    flags = graph.flags
            steps += BLOCK_STEPS
            all_done, sync = tracing.host_read(flags, Tensor.tolist)  # the one read of the block
            reads += 1
            if all_done:
                break
            if sync and graph is None:
                data = match(st.t, st.q)
                st = st._replace(waiting=false)
            elif sync:
                graph.data.copy_(match(graph.state.t, graph.state.q))
                graph.state.waiting.zero_()
        if graph is not None:  # the caller's own tensors: the next run overwrites the static ones
            st = _State(*(a.clone() for a in graph.state))
        self._last_run = {"steps": steps, "host_reads": reads, "graph_blocks": replays,
                          "active_steps": st.active_steps}
        return st.t, st.q, st.outer_it, st.inner_its, st.costs, st.final_cost

    def _block(self, st: _State, data, rematch=None):
        """BLOCK_STEPS steps and the (all_done, sync) flags, with no host
        read: the part a CUDA graph can capture. Returns (state, data,
        flags).

        With ``rematch`` (the vmap mode) every step matches EVERY lane at
        its new pose and keeps the new correspondences of the lanes that
        just ended an inner solve, by a select: the lowering that
        ``jax.vmap`` gives the JAX machine's per-lane ``lax.cond``. No lane
        then waits, so ``sync`` stays false."""
        for _ in range(BLOCK_STEPS):
            st = self._step(st, data)
            if rematch is not None:
                data = self._select_lanes(st.waiting, rematch(st.t, st.q), data)
                st = st._replace(waiting=torch.zeros_like(st.waiting))
        all_done = torch.all(st.done)
        sync = torch.all(st.done | st.waiting) & ~all_done
        return st, data, torch.stack([all_done, sync])

    def _select_lanes(self, lanes: Tensor, new, old):
        """Per lane ``lanes ? new : old`` over a packed buffer or the fields
        of an objective's data; a packed buffer is laid out again as the
        kernels read it."""
        pick = lambda a, b: torch.where(lanes.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        if isinstance(new, Tensor):
            out = pick(new, old)
            return ck.lane_aligned(out) if self.eval_backend == "cuda" else out
        return type(new)(*(pick(a, b) for a, b in zip(new, old)))

    def _step(self, st: _State, data) -> _State:
        """One LM step of every lane, applied on the lanes that run an inner
        solve; the lockstep body of the JAX package, line for line."""
        oh = self.options.optimization_handle
        ch = self.options.convergence_handle
        t_new, q_new, cost, step_norm, grad_norm = self._lm_step(st.t, st.q, data, st.lam)

        act = ~(st.waiting | st.done)
        lm_conv = (step_norm < ch.parameter_tolerance) | (grad_norm < ch.gradient_tolerance)
        inner_fin = act & (lm_conv | (st.inner_it + 1 >= self.options.max_iterations))

        # the step lands on active lanes (reference: update, THEN check)
        t_upd = torch.where(act[:, None], t_new, st.t)
        q_upd = torch.where(act[:, None], q_new, st.q)

        adapted = torch.where(
            cost > st.prev_cost,
            st.lam * oh.lambda_increase_factor,
            st.lam * oh.lambda_decrease_factor,
        )
        adapted = torch.clamp(adapted, oh.min_lambda, oh.max_lambda)

        # outer convergence: diff = new^{-1} * anchor (reference :563-568)
        dq = lie.quat_multiply(lie.quat_conjugate(q_upd), st.q_anchor)
        dt = (lie.quat_to_rotmat(q_upd).mT @ (st.t_anchor - t_upd)[:, :, None])[:, :, 0]
        outer_conv = (_norm(dt) < self._outer_tol) & (_norm(dq[:, 1:]) < self._outer_tol)
        outer_fin = outer_conv | (st.outer_it + 1 >= self.max_outer_iterations)
        done = st.done | (inner_fin & outer_fin)

        # records at each lane's inner-solve completion
        rec_iters = torch.where(lm_conv, st.inner_it, st.inner_it + 1)
        write = inner_fin[:, None] & (st.outer_it[:, None] == self._slots)
        fin = inner_fin[:, None]
        return _State(
            t=t_upd,
            q=q_upd,
            lam=torch.where(inner_fin, self._initial_lambda, torch.where(act, adapted, st.lam)),
            prev_cost=torch.where(inner_fin, self._fmax, torch.where(act, cost, st.prev_cost)),
            inner_it=torch.where(
                inner_fin, 0, torch.where(act, st.inner_it + 1, st.inner_it)
            ).to(torch.int32),
            t_anchor=torch.where(fin, t_upd, st.t_anchor),
            q_anchor=torch.where(fin, q_upd, st.q_anchor),
            outer_it=st.outer_it + inner_fin.to(torch.int32),
            waiting=(st.waiting | inner_fin) & ~done,
            done=done,
            inner_its=torch.where(write, rec_iters[:, None], st.inner_its),
            costs=torch.where(write, cost[:, None], st.costs),
            final_cost=torch.where(inner_fin, cost, st.final_cost),
            active_steps=st.active_steps + torch.any(act),
        )

    def _lm_step(self, t: Tensor, q: Tensor, data, lam: Tensor):
        """One damped-GN step per lane: (t', q', cost, |delta|, |g|)."""
        if not self.planar:
            H, g, cost = self._eval(lie.quat_to_rotmat(q), t, data)
            delta = self._solve(H, g, lam)
            params = se3_retract(SE3Params(t, q), delta)
            return params.translation, params.quaternion, cost, _norm(delta), _norm(g)
        # planar: (x, y, yaw), z / roll / pitch frozen (.._analytic_3dof.cc:22-25)
        theta = 2.0 * torch.atan2(q[:, 3], q[:, 0])
        H, g, cost = self._eval(lie.rot2(theta), t[:, :2], data)
        delta = self._solve(H, g, lam)
        p2 = se2_retract(SE2Params(t[:, :2], theta), delta)
        half = 0.5 * p2.theta
        zero = torch.zeros_like(half)
        q_new = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)
        t_new = torch.cat([p2.translation, t[:, 2:]], dim=-1)
        return t_new, q_new, cost, _norm(delta), _norm(g)

    def _solve(self, H: Tensor, g: Tensor, lam: Tensor) -> Tensor:
        delta = solve_normal_equations(
            damp_hessian(H, lam), -g, self.options.linear_solver_type
        )
        # a singular damped H gives a non-finite step: take a zero step
        finite = torch.all(torch.isfinite(delta), dim=-1, keepdim=True)
        return torch.where(finite, delta, torch.zeros_like(delta))

    def _eval(self, R: Tensor, t: Tensor, data):
        """(H, g, cost) of every lane, in the registrar's dtype, summed over
        the ranks of a mesh."""
        if self.eval_backend == "torch":
            if self.objective == "p2p":
                hgc = p2p_ops.eval_quadratic(R, t, data, self.loss)
            elif self.planar:
                hgc = maha_ops.eval_quadratic_3dof(R, t, data, self.loss)
            else:
                hgc = maha_ops.eval_quadratic(R, t, data, self.loss)
            return self._reduce(hgc)
        if self.planar:
            params = ck.maha3_params(R, t, self._loss_ab)
            out, dim = ck.maha3_partials(params, data, self._loss_code), 3
        else:
            params = ck.maha6_params(R, t, self._loss_ab)
            partials = ck.p2p_partials if self.objective == "p2p" else ck.maha6_partials
            out, dim = partials(params, data, self._loss_code), 6
        return ck.unpack_out(self._reduce(out.to(self.dtype)), dim)


class NdtRegistrar(_Machine):
    """Scan-to-map registrar with device-resident map state.

    The map goes to the device once, at construction; each ``register``
    call copies only the scan and the pose, and runs the machine of the
    module docstring. ``ndt_map`` is an ``NdtMap``, or a ``RegistrarMap``
    already built (for example from the JAX registrar's arrays through
    ``interop.from_reference``); ``max_flatness``, ``max_thickness`` and
    ``map_pad_multiple`` shape only a map built here.

    ``objective``: "maha" (point-to-NDT) or "p2p" (point-to-plane against
    the voxel planes, ``max_flatness``/``max_thickness`` gates, the best of
    k nearest voxels by perpendicular distance, trimmed at
    ``trim_distance``; build the map with ``identity_moment=False``).
    ``planar`` (x, y, yaw; z, roll and pitch kept) is Mahalanobis-only.
    ``map_pad_multiple`` pads the voxel count to a bucket with masked
    voxels. ``device`` defaults to "cuda"; ``eval_backend`` to "cuda" (the
    kernels) on a CUDA device and "torch" (the plain versions) otherwise.
    ``mesh`` shards each registration's scan points over a process group
    (see the module docstring); it takes neither ``register_batch`` nor
    ``map_pad_multiple``, as in the JAX package.
    """

    def __init__(
        self,
        ndt_map: Union[NdtMap, RegistrarMap],
        options: Options,
        loss: Optional[LossFunction] = None,
        search_radius: float = 1.0,
        num_neighbors: Optional[int] = None,
        max_outer_iterations: int = OUTER_MAX_ITERATIONS,
        outer_tolerance: float = OUTER_TOLERANCE,
        dtype: torch.dtype = torch.float32,
        planar: bool = False,
        map_pad_multiple: Optional[int] = None,
        objective: str = "maha",
        max_flatness: float = 0.2,
        max_thickness: Optional[float] = None,
        trim_distance: float = 0.3,
        device="cuda",
        eval_backend: Optional[str] = None,
        mesh: Optional[FactorMesh] = None,
    ):
        if objective not in ("maha", "p2p"):
            raise ValueError(f"unknown objective {objective!r} (maha | p2p)")
        if objective == "p2p" and planar:
            raise NotImplementedError("planar mode is mahalanobis-only")
        if map_pad_multiple is not None and mesh is not None:
            raise NotImplementedError("map_pad_multiple with mesh sharding is not supported")
        self._init_machine(
            options, loss, max_outer_iterations, outer_tolerance, dtype, device,
            eval_backend, planar, objective,
        )
        self.mesh = mesh
        if mesh is not None:
            self._reduce = reducer(mesh)
        if isinstance(ndt_map, RegistrarMap):
            self.map = RegistrarMap(
                *(None if a is None else a.to(dtype=dtype, device=self.device) for a in ndt_map)
            )
        else:
            self.map = build_map_state(
                ndt_map, objective, max_flatness, max_thickness, map_pad_multiple,
                dtype, self.device,
            )
        if objective == "p2p" and self.map.normals_T is None:
            raise ValueError("objective 'p2p' needs a map with normals_T and voxel_weights")
        # defaults of the host-loop pipelines: maha 2 (the reference's
        # FLANN search), p2p 4 (the candidates of the plane selection)
        if num_neighbors is None:
            num_neighbors = 4 if objective == "p2p" else 2
        self.num_neighbors = num_neighbors
        self.trim_distance = trim_distance
        self._search_radius = torch.full((), search_radius, dtype=dtype, device=self.device)

        means_T, map_mask = self.map.means_T, self.map.map_mask
        if map_mask is None:
            centroid = torch.mean(means_T, dim=1, keepdim=True)  # (3, 1)
        else:  # over real voxels only: the padding sits at the origin
            centroid = torch.sum(means_T * map_mask, dim=1, keepdim=True) / torch.sum(map_mask)
        self._centroid = centroid[:, 0]
        self._means_c_T = means_T - centroid
        means_sq = torch.sum(self._means_c_T * self._means_c_T, dim=0)  # (M,)
        if map_mask is not None:  # padding never wins the match nor the radius
            means_sq = means_sq + (1.0 - map_mask) * 1e10
        self._means_sq = means_sq

    # ------------------------------------------------------------------
    # public API (the JAX package's)
    # ------------------------------------------------------------------

    @tracing.traced("nls.register")
    def register(self, local_points, initial_pose: Pose) -> FusedRegistrationResult:
        return self.finalize(self.register_async(local_points, initial_pose))

    def register_async(self, local_points, initial_pose: Pose):
        """Run the machine and return its device tensors without the final
        copy to the host; pass them to :meth:`finalize`. The two-flag reads
        between blocks still wait for the device."""
        return self._launch([local_points], [initial_pose])

    @tracing.traced("nls.register")
    def register_batch(self, local_points_batch, initial_poses, mode: str = "lockstep") -> list:
        """Register B scans (a (B, N, 3) array or a list of ragged (N_b, 3)
        arrays, padded with masked rows) in one run of the machine. Each
        result equals what :meth:`register` gives for that scan.

        ``mode="lockstep"`` (the serving path): a lane that ends its inner
        solve waits, frozen, until every live lane has, and then all lanes
        are rematched in one batched matching. ``mode="vmap"`` (the JAX
        package's vmapped whole-ICP oracle, ``_fused_register_batched``):
        each lane rematches as soon as its own inner solve ends, and the
        matching runs on every step for every lane; its cost is reported,
        not optimised."""
        return self.finalize_batch(
            self.register_batch_async(local_points_batch, initial_poses, mode)
        )

    def register_batch_async(self, local_points_batch, initial_poses, mode: str = "lockstep"):
        """:meth:`register_batch` without the final copy; see
        :meth:`finalize_batch`."""
        if mode not in ("lockstep", "vmap"):
            raise ValueError(f"unknown mode {mode!r} (lockstep | vmap)")
        if self.mesh is not None:
            raise NotImplementedError(
                "register_batch shards over the batch axis implicitly; "
                "use one NdtRegistrar per replica instead of mesh="
            )
        if self.map.map_mask is not None:
            raise NotImplementedError(
                "register_batch with map_pad_multiple is not wired; "
                "construct the registrar without map padding for serving"
            )
        scans = list(local_points_batch)
        if len(initial_poses) != len(scans):
            raise ValueError(f"{len(initial_poses)} poses for batch of {len(scans)}")
        return self._launch(scans, initial_poses, vmap=mode == "vmap")

    def information(self, local_points, pose: Pose) -> np.ndarray:
        """Gauss-Newton information J^T W J (6, 6) of this registrar's
        objective at ``pose`` (see ``MahalanobisDistanceMinimizer.
        information``): one matching and one plain evaluation."""
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)
        pts = as_t(local_points)
        pmask = torch.ones(pts.shape[0], dtype=self.dtype, device=self.device)
        R, t = as_t(pose.rotation), as_t(pose.translation)
        m = self.map
        radius = float(self._search_radius)
        kw = dict(search_radius=radius, num_neighbors=self.num_neighbors, map_mask=m.map_mask)
        if self.objective == "p2p":
            data = matching.match_point_to_plane(
                m.means_T.T, m.normals_T.T, m.voxel_weights, pts, pmask, R, t,
                trim_distance=self.trim_distance, **kw,
            )
            minimizer = mins.PointToPlaneMinimizer(dtype=self.dtype, device=self.device)
        else:
            data = matching.match_point_cloud(
                m.means_T.T, m.infos_T.T.reshape(-1, 3, 3), pts, pmask, R, t, **kw
            )
            minimizer = mins.MahalanobisDistanceMinimizer(dtype=self.dtype, device=self.device)
        return minimizer.set_loss_function(self.loss).information(data, pose)

    # ------------------------------------------------------------------
    # the machine
    # ------------------------------------------------------------------

    def _launch(self, scans, initial_poses, vmap: bool = False):
        """Pad the scans to one N with masked rows and run the machine:
        returns (t, q, outer_it, inner_its, costs, final_cost), (B, ...)
        device tensors. Under a mesh N is a multiple of the world size and
        the machine runs on this rank's block of the points."""
        return self._run(*self._upload(scans, initial_poses), vmap)

    @tracing.traced("nls.batch.upload")
    def _upload(self, scans, initial_poses):
        """The scans padded to one N, their masks and the initial poses, on
        the device: (points (B, N, 3), mask (B, N), t0 (B, 3), q0 (B, 4))."""
        scans = [np.asarray(s) for s in scans]
        B, n_max = len(scans), max(s.shape[0] for s in scans)
        if self.mesh is not None:
            n_max = _round_up(n_max, self.mesh.size)
        pts = np.zeros((B, n_max, 3))
        mask = np.zeros((B, n_max))
        for b, s in enumerate(scans):
            pts[b, : s.shape[0]] = s
            mask[b, : s.shape[0]] = 1.0
        if self.mesh is not None:
            rows = factor_sharding(self.mesh, n_max)
            pts, mask = pts[:, rows], mask[:, rows]
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        points = as_t(pts)
        pmask = as_t(mask)
        t0 = as_t(np.stack([p.translation for p in initial_poses]))
        q0 = as_t(np.stack([p.quaternion() for p in initial_poses]))
        return points, pmask, t0, q0

    def _run(self, points: Tensor, pmask: Tensor, t0: Tensor, q0: Tensor, vmap: bool = False):
        k = self.num_neighbors
        points_T = points.mT.contiguous()  # (B, 3, N)
        # the point rows of the maha buffer never change: each point k times
        p_rows = torch.repeat_interleave(points_T, k, dim=-1) if self.objective == "maha" else None

        def operand(t, q):
            if self.objective == "p2p":
                packed = self._match_p2p(points, points_T, pmask, t, q)
                unpack = p2p_ops.unpack_p2p
            else:
                packed = self._match_maha(points, p_rows, pmask, t, q)
                unpack = maha_ops.unpack_maha6
            # the "torch" path unpacks once per match, not once per step
            return packed if self.eval_backend == "cuda" else unpack(packed).astype(self.dtype)

        return self._drive(operand, t0, q0, vmap)

    # ------------------------------------------------------------------
    # matching: dense (B, N, M) distances + k nearest, on the device
    # ------------------------------------------------------------------

    def _centred_d2(self, points: Tensor, t: Tensor, q: Tensor):
        """Warped points centred on the map centroid (B, N, 3) and their
        squared distances to every centred voxel mean (B, N, M)."""
        R = lie.quat_to_rotmat(q)
        warped = points @ R.mT + t[:, None, :] - self._centroid
        d2 = (
            torch.sum(warped * warped, dim=-1, keepdim=True)
            - 2.0 * warped @ self._means_c_T
            + self._means_sq
        )
        return warped, d2

    def _match_maha(self, points, p_rows, pmask, t, q) -> Tensor:
        """(B, 16, N * k) float32 maha6 buffer of the k nearest voxels."""
        B, n = points.shape[:2]
        k = self.num_neighbors
        _, d2 = self._centred_d2(points, t, q)
        near_d2, idx = matching.k_nearest(d2, k)  # (B, N, k)
        within = near_d2 <= self._search_radius * self._search_radius
        mask = within.to(self.dtype) * pmask[:, :, None]
        flat_idx = idx.reshape(B, n * k)
        mu_rows = self.map.means_T[:, flat_idx].transpose(0, 1)  # (B, 3, N*k)
        s_rows = self.map.infos_T[:, flat_idx].transpose(0, 1)  # (B, 9, N*k)
        packed = torch.cat([p_rows, mu_rows, s_rows, mask.reshape(B, 1, n * k)], dim=1)
        packed = packed.to(torch.float32)
        # the kernels read 16-byte-aligned rows; the plain path's buffer
        # stays as it is
        return ck.lane_aligned(packed) if self.eval_backend == "cuda" else packed.contiguous()

    def _match_p2p(self, points, points_T, pmask, t, q) -> Tensor:
        """(B, 10, N) float32 p2p buffer: per point the plane, of its k
        nearest usable voxels, nearest perpendicularly (the first on a tie),
        trimmed at ``trim_distance``."""
        warped, d2 = self._centred_d2(points, t, q)
        near_d2, idx = matching.k_nearest(d2, self.num_neighbors)  # (B, N, k)
        within = near_d2 <= self._search_radius * self._search_radius
        cand_ok = within & (self.map.voxel_weights[idx] > 0.0)
        cand_mu = self._means_c_T.T[idx]  # (B, N, k, 3) centred
        cand_n = self.map.normals_T.T[idx]
        plane_d = torch.abs(torch.sum(cand_n * (warped[:, :, None, :] - cand_mu), dim=-1))
        plane_d = torch.where(cand_ok, plane_d, torch.inf)
        best = torch.argmin(plane_d, dim=-1, keepdim=True)  # (B, N, 1)
        best_d = torch.gather(plane_d, -1, best)[..., 0]
        pick = lambda a: torch.gather(a, 2, best[..., None].expand(-1, -1, 1, 3))[:, :, 0]
        mask = (best_d <= self.trim_distance).to(self.dtype) * pmask
        mu_rows = (pick(cand_mu) + self._centroid).mT  # (B, 3, N), un-centred
        n_rows = pick(cand_n).mT
        packed = torch.cat([points_T, mu_rows, n_rows, mask[:, None, :]], dim=1)
        packed = packed.to(torch.float32)
        # as in _match_maha: 16-byte-aligned rows for the kernel only
        return ck.lane_aligned(packed) if self.eval_backend == "cuda" else packed.contiguous()


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def register_ndt_fused(
    ndt_map: NdtMap,
    local_points: np.ndarray,
    initial_pose: Pose,
    options: Options,
    loss: Optional[LossFunction] = None,
    search_radius: float = 1.0,
    num_neighbors: int = 2,
    max_outer_iterations: int = OUTER_MAX_ITERATIONS,
    outer_tolerance: float = OUTER_TOLERANCE,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> FusedRegistrationResult:
    """One scan-to-map registration through a fresh :class:`NdtRegistrar`."""
    registrar = NdtRegistrar(
        ndt_map, options, loss, search_radius, num_neighbors,
        max_outer_iterations, outer_tolerance, dtype, device=device,
    )
    return registrar.register(local_points, initial_pose)


# ----------------------------------------------------------------------------
# Hybrid registrar: native host matching, device LM
# ----------------------------------------------------------------------------


def _packed_lm_solve(t0: Tensor, q0: Tensor, packed: Tensor, loss, options: Options,
                     planar: bool = False):
    """LM over a prepacked (16, N) correspondence buffer (the maha6 layout,
    for example ``native.match_and_pack``'s rows; float32, or bfloat16 from
    ``ck.pack_maha6(..., buffer_dtype=torch.bfloat16)``, which the kernels'
    bf16-row instantiations read): 6-DoF through the maha6 kernel,
    ``planar`` (x, y, yaw; z, roll and pitch kept) through maha3, one launch
    per LM evaluation. ``t0`` (3,) and ``q0`` (4,) are on ``packed``'s
    device in the LM's dtype; the loss tail is built once per solve. On the
    card ``packed`` is laid out as ``ck.lane_aligned`` makes it (a (16, N)
    view of a (16, ld) buffer with 16-byte rows, 16-byte aligned); on the
    CPU the plain versions run. Returns (t, q, iterations, final_cost),
    tensors on the device."""
    code, loss_ab = ck.maha6_loss_ab(loss, packed.device)
    batch = packed[None]  # a batch of one problem

    if not planar:
        def quad(params: SE3Params):
            R = lie.quat_to_rotmat(params.quaternion)
            kparams = ck.maha6_params(R, params.translation, loss_ab)[None]
            out = ck.maha6_partials(kparams, batch, code)[0]
            return ck.unpack_out(out.to(t0.dtype), 6)

        params, summary = lm.solve(quad, se3_retract, SE3Params(t0, q0), options)
        return params.translation, params.quaternion, summary.iterations, summary.final_cost

    theta0 = 2.0 * torch.atan2(q0[3], q0[0])

    def quad2(params: SE2Params):
        kparams = ck.maha3_params(lie.rot2(params.theta), params.translation, loss_ab)[None]
        out = ck.maha3_partials(kparams, batch, code)[0]
        return ck.unpack_out(out.to(t0.dtype), 3)

    p2, summary = lm.solve(quad2, se2_retract, SE2Params(t0[:2], theta0), options)
    half = 0.5 * p2.theta
    zero = torch.zeros_like(half)
    q_new = torch.stack([torch.cos(half), zero, zero, torch.sin(half)])
    return torch.cat([p2.translation, t0[2:]]), q_new, summary.iterations, summary.final_cost


class HybridRegistrar:
    """Scan-to-map registration with the reference's host/device split
    (MatchPointCloud / Solve, SURVEY section 3.1): each outer iteration the
    native C++ matcher (``native.match_and_pack``) writes the (16, N k)
    maha6 buffer on the host, it goes to the device in one copy, and
    :func:`_packed_lm_solve` runs the inner LM with one kernel launch per
    evaluation, in float32. The same API and outer loop as the JAX
    package's ``HybridRegistrar``; results are ``FusedRegistrationResult``.

    The host buffer is a pinned torch tensor that the matcher writes
    through a numpy view; it and the device buffer are allocated once per
    lane count (N k rounded up to ``ck.LANE_ALIGN``, so the C++ rows are
    already the kernels' layout). ``num_threads=0`` runs the matcher on
    every host CPU. ``device`` defaults to "cuda"; on the CPU the buffer is
    not copied and the plain versions of the kernels run."""

    def __init__(
        self,
        ndt_map: NdtMap,
        options: Options,
        loss: Optional[LossFunction] = None,
        search_radius: float = 1.0,
        num_neighbors: int = 2,
        max_outer_iterations: int = OUTER_MAX_ITERATIONS,
        outer_tolerance: float = OUTER_TOLERANCE,
        planar: bool = False,
        num_threads: int = 0,
        device="cuda",
    ):
        from .. import native

        native.load()  # raise early if the native library does not build
        self.device = resolve_device(device)
        valid = ndt_map.valid_only()
        self.means = np.ascontiguousarray(valid.means)
        self.sqrt_infos = np.ascontiguousarray(valid.sqrt_informations)
        self.options = options
        self.loss = loss
        self.search_radius = search_radius
        self.num_neighbors = num_neighbors
        self.max_outer_iterations = max_outer_iterations
        self.outer_tolerance = outer_tolerance
        self.planar = planar
        self.num_threads = num_threads
        self._host: Optional[Tensor] = None  # (16, lanes) pinned, reused
        self._dev: Optional[Tensor] = None  # (16, lanes) on the device, reused

    def _buffers(self, lanes: int):
        if self._host is None or self._host.shape[1] != lanes:
            on_card = self.device.type == "cuda"
            self._host = torch.empty((16, lanes), dtype=torch.float32, pin_memory=on_card)
            self._dev = (
                torch.empty((16, lanes), dtype=torch.float32, device=self.device)
                if on_card else self._host
            )
        return self._host, self._dev

    @tracing.traced("nls.register")
    def register(self, local_points, initial_pose: Pose) -> FusedRegistrationResult:
        from .. import native

        pts = np.ascontiguousarray(np.asarray(local_points, np.float64))
        k = self.num_neighbors
        nk = pts.shape[0] * k
        host, dev = self._buffers(_round_up(nk, ck.LANE_ALIGN))
        host_np = host.numpy()
        packed = dev[:, :nk]  # the kernel's N is the real lane count

        pose = initial_pose.copy()
        last = pose.copy()
        max_outer = self.max_outer_iterations
        inner_its = np.zeros(max_outer, np.int32)
        costs = np.full(max_outer, np.nan)
        outer_it = 0
        final_cost = np.nan
        for outer_it in range(max_outer):
            # The copy below is queued on the current stream and reads the
            # pinned buffer after this call returns. The next iteration's
            # match_and_pack overwrites that buffer only after the LM below
            # has read its result on the host (lm.solve reads `all done`
            # every iteration, and the final read copies t, q, the count
            # and the cost), which waits for every earlier op on the
            # stream, the copy included. Nothing else orders the two.
            with tracing.span("nls.match"):
                native.match_and_pack(
                    pts, pose.rotation, pose.translation, self.means, self.sqrt_infos,
                    self.search_radius, k, host.shape[1], out=host_np,
                    num_threads=self.num_threads,
                )
                if dev is not host:
                    dev.copy_(host, non_blocking=True)
            x0 = torch.as_tensor(
                np.concatenate([pose.translation, pose.quaternion()]),
                dtype=torch.float32, device=self.device,
            )
            t, q, iters, cost = _packed_lm_solve(
                x0[:3], x0[3:], packed, self.loss, self.options, self.planar
            )
            out = torch.cat([t, q, iters.reshape(1).to(t.dtype), cost.reshape(1)])
            out = tracing.host_read(out).numpy().astype(np.float64)  # the one host read
            qn = out[3:7] / np.linalg.norm(out[3:7])
            pose = Pose(np_quat_to_rotmat(qn), out[:3].copy())
            inner_its[outer_it] = int(out[7])
            costs[outer_it] = final_cost = float(out[8])

            diff = pose.inverse() * last
            dq = np_rotmat_to_quat(diff.rotation)
            if (
                np.linalg.norm(diff.translation) < self.outer_tolerance
                and np.linalg.norm(dq[1:]) < self.outer_tolerance
            ):
                break
            last = pose.copy()

        return FusedRegistrationResult(
            pose=pose,
            outer_iterations=outer_it + 1,
            final_cost=final_cost,
            inner_iterations=inner_its,
            costs=costs,
        )
