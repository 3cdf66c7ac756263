"""The port's relative-pose factor, block-tridiagonal solver and LM
``solve_linear`` hook against the JAX package.

Inputs come from the module's seeded numpy rng; both sides run in float64.
- ``edge_residuals`` and the closed-form ``edge_residuals_and_jacobians``
  equal the JAX functions within rtol 1e-12 (atol 1e-12) for odometry and
  loop edges, masked edges, non-unit quaternions, and no, diagonal or full
  ``sqrt_info``; the closed form equals ``torch.func.jacfwd`` of the port's
  ``edge_residuals`` within 1e-12; the numpy twin and the quaternion
  helpers equal the JAX ones within 1e-13 (``quat_rotate`` 1e-15).
- ``block_tridiag.solve`` equals the JAX module within rtol 1e-10, and
  ``factor``/``solve_factored`` repeat its bits and solve a second
  right-hand side (block rows within 1e-9), for P in {1, 2, 7, 300, 513}, k in {7, 35}, 1 and
  9 right-hand sides (one at the pose-graph paths' dense cutoffs, nine at
  a cutoff of 4: up to seven reduction levels).
- ``_scatter_banded_blocks`` equals the JAX host twin within 1e-12.
- ``lm.solve`` with ``solve_linear=None`` gives, bit for bit, the
  trajectory of the loop as it was before the hook (a frozen copy below),
  and a ``solve_linear`` that takes the damped normal-equation step gives
  the same bits through the tuple path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu as nls
from nonlinear_optimizer_for_slam_tpu.core import lie as jlie
from nonlinear_optimizer_for_slam_tpu.ops import relative_pose as jrp
from nonlinear_optimizer_for_slam_tpu.solvers import block_tridiag as jbt
from nonlinear_optimizer_for_slam_tpu.solvers import pose_graph as jpg
from nonlinear_optimizer_for_slam_tpu_torch.core import lie as tlie
from nonlinear_optimizer_for_slam_tpu_torch.core import options as topt
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis as tmaha
from nonlinear_optimizer_for_slam_tpu_torch.ops import relative_pose as trp
from nonlinear_optimizer_for_slam_tpu_torch.solvers import block_tridiag as tbt
from nonlinear_optimizer_for_slam_tpu_torch.solvers import linear as tlinear
from nonlinear_optimizer_for_slam_tpu_torch.solvers import lm as tlm
from nonlinear_optimizer_for_slam_tpu_torch.solvers import manifolds as tman
from nonlinear_optimizer_for_slam_tpu_torch.solvers import pose_graph as tpg
import nonlinear_optimizer_for_slam_tpu_torch as port

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many tiny ops, which more
    threads only slow down when test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def graph(rng):
    P, E = 9, 16
    positions = rng.normal(size=(P, 3))
    # deliberately non-unit quaternions: the ambient parameterization lets
    # them drift, and the normalization Jacobian must handle that
    quats = rng.normal(size=(P, 4)) + np.array([2.0, 0, 0, 0])
    ref = rng.integers(0, P, E)
    qry = (ref + 1 + rng.integers(0, P - 1, E)) % P
    rel_q = rng.normal(size=(E, 4))
    rel_q /= np.linalg.norm(rel_q, axis=1, keepdims=True)
    is_loop = (rng.uniform(size=E) < 0.5).astype(float)
    is_loop[:2] = (0.0, 1.0)  # both kinds always present
    mask = (rng.uniform(size=E) < 0.85).astype(float)
    diag = rng.uniform(0.5, 3.0, size=(E, 6))
    full = np.triu(rng.normal(size=(E, 6, 6))) + 3.0 * np.eye(6)
    return dict(
        positions=positions, quats=quats, ref=ref, qry=qry,
        rel_t=rng.normal(size=(E, 3)), rel_q=rel_q, is_loop=is_loop, mask=mask,
        switches=rng.uniform(0.2, 1.0, E), sqrt_info={"none": None, "diag": diag, "full": full},
    )


def _edges(g, kind, module):
    w = g["sqrt_info"][kind]
    if module == "jax":
        return jrp.PoseGraphEdges(
            jnp.asarray(g["ref"], jnp.int32), jnp.asarray(g["qry"], jnp.int32),
            jnp.asarray(g["rel_t"]), jnp.asarray(g["rel_q"]), jnp.asarray(g["is_loop"]),
            jnp.asarray(g["mask"]), None if w is None else jnp.asarray(w),
        )
    return trp.PoseGraphEdges(
        _t(g["ref"], torch.long), _t(g["qry"], torch.long), _t(g["rel_t"]), _t(g["rel_q"]),
        _t(g["is_loop"]), _t(g["mask"]), None if w is None else _t(w),
    )


SQRT_KINDS = ["none", "diag", "full"]
SCALES = [jrp.SWITCH_PENALTY_SCALE, 0.03]


@pytest.mark.parametrize("kind", SQRT_KINDS)
@pytest.mark.parametrize("scale", SCALES)
def test_residuals_and_jacobians_match_jax(graph, kind, scale):
    g = graph
    je, te = _edges(g, kind, "jax"), _edges(g, kind, "torch")
    jargs = (jnp.asarray(g["positions"]), jnp.asarray(g["quats"]), jnp.asarray(g["switches"]))
    targs = (_t(g["positions"]), _t(g["quats"]), _t(g["switches"]))
    np.testing.assert_allclose(
        trp.edge_residuals(*targs, te, scale).numpy(),
        np.asarray(jrp.edge_residuals(*jargs, je, scale)), rtol=1e-12, atol=1e-12,
    )
    got = trp.edge_residuals_and_jacobians(*targs, te, scale)
    want = jrp.edge_residuals_and_jacobians(*jargs, je, scale)
    for a, b, name in zip(got, want, ("r", "J_ref", "J_query", "J_s")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12, err_msg=name)


def _jacfwd_oracle(positions, quats, switches, edges, scale):
    """Per-edge forward-mode Jacobians of the port's ``edge_residuals``
    (the counterpart of the JAX package's ``edge_residuals_and_jacobians_ad``)."""
    E = edges.num_edges
    out = []
    for e in range(E):
        one = trp.PoseGraphEdges(
            torch.tensor([0]), torch.tensor([1]), edges.relative_translations[e:e + 1],
            edges.relative_quaternions[e:e + 1], edges.is_loop[e:e + 1], edges.mask[e:e + 1],
            None if edges.sqrt_info is None else edges.sqrt_info[e:e + 1],
        )
        i, j = int(edges.reference_indices[e]), int(edges.query_indices[e])

        def res(p_r, q_r, p_q, q_q, s):
            return trp.edge_residuals(
                torch.stack([p_r, p_q]), torch.stack([q_r, q_q]), s[None], one, scale
            )[0]

        args = (positions[i], quats[i], positions[j], quats[j], switches[e])
        jp_r, jq_r, jp_q, jq_q, js = torch.func.jacfwd(res, argnums=(0, 1, 2, 3, 4))(*args)
        out.append((res(*args), torch.cat([jp_r, jq_r], -1), torch.cat([jp_q, jq_q], -1), js))
    return [torch.stack(x) for x in zip(*out)]


@pytest.mark.parametrize("kind", SQRT_KINDS)
def test_closed_form_matches_jacfwd(graph, kind):
    g = graph
    te = _edges(g, kind, "torch")
    args = (_t(g["positions"]), _t(g["quats"]), _t(g["switches"]))
    got = trp.edge_residuals_and_jacobians(*args, te, 0.03)
    want = _jacfwd_oracle(*args, te, 0.03)
    for a, b, name in zip(got, want, ("r", "J_ref", "J_query", "J_s")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("kind", SQRT_KINDS)
def test_numpy_twin_and_helpers_match_jax(graph, kind):
    g = graph
    args = (g["positions"], g["quats"], g["switches"], g["ref"], g["qry"], g["rel_t"],
            g["rel_q"], g["is_loop"], 0.03)
    got = trp.np_edge_residuals_and_jacobians(*args, sqrt_info=g["sqrt_info"][kind])
    want = jrp.np_edge_residuals_and_jacobians(*args, sqrt_info=g["sqrt_info"][kind])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13)
    q, b = g["quats"], g["rel_q"][: len(g["quats"])]
    np.testing.assert_allclose(tlie.np_quat_left_matrix(q), jrp.np_quat_left_matrix(q), rtol=0, atol=0)
    np.testing.assert_allclose(tlie.np_quat_conjugate(q), jrp.np_quat_conjugate(q), rtol=0, atol=0)
    np.testing.assert_allclose(tlie.np_quat_multiply(q, b), jrp.np_quat_multiply(q, b), rtol=1e-13, atol=1e-13)
    n = q / np.linalg.norm(q, axis=1, keepdims=True)
    v = g["positions"]
    np.testing.assert_allclose(
        tlie.quat_rotate(_t(n), _t(v)).numpy(),
        np.asarray(jlie.quat_rotate(jnp.asarray(n), jnp.asarray(v))), rtol=1e-15, atol=1e-15,
    )


def test_stack_and_apply_sqrt_info_match_jax(graph):
    g = graph
    entries = [None, np.full(6, 2.0), g["sqrt_info"]["full"][0], None]
    for sel in (entries[:1], entries[:2], entries):
        got, want = trp.stack_sqrt_info(sel, 6), jrp.stack_sqrt_info(sel, 6)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    for kind in ("diag", "full"):
        w = g["sqrt_info"][kind]
        r = g["rel_t"].repeat(2, axis=1)
        np.testing.assert_allclose(
            trp.apply_sqrt_info(_t(w), _t(r)).numpy(), jrp.apply_sqrt_info(w, r), rtol=1e-14
        )


# one compiled program per shape (the JAX module's eager ops would compile
# each level's shapes one by one)
_jax_tridiag_solve = jax.jit(jbt.solve, static_argnums=3)


def _tridiag_system(rng, P, k):
    """A random SPD block-tridiagonal system: D_i = A_i A_i^T + k I and
    small couplings, diagonally dominant at every size."""
    A = rng.normal(size=(P, k, k))
    D = A @ np.swapaxes(A, 1, 2) / k + 4.0 * np.eye(k)
    O = 0.3 * rng.normal(size=(max(P - 1, 0), k, k)) / np.sqrt(k)
    return D, O


@pytest.mark.parametrize("P", [1, 2, 7, 300, 513])
@pytest.mark.parametrize("k", [7, 35])
@pytest.mark.parametrize("m", [1, 9])
def test_block_tridiag_matches_jax(rng, P, k, m):
    # one right-hand side at the pose-graph paths' dense cutoffs (256 block
    # rows for 7x7 blocks, 4096 // k for superblocks), nine at a cutoff of
    # 4: up to seven reduction levels
    cutoff = 4 if m > 1 else (256 if k == 7 else 4096 // k)
    D, O = _tridiag_system(rng, P, k)
    B = rng.normal(size=(P, k, m))
    B2 = rng.normal(size=(P, k))
    want = np.asarray(_jax_tridiag_solve(jnp.asarray(D), jnp.asarray(O), jnp.asarray(B), cutoff))
    got = tbt.solve(_t(D), _t(O), _t(B), cutoff).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # the factor is reusable: the same bits again, and a (P, k) right-hand
    # side that satisfies the block rows
    fact = tbt.factor(_t(D), _t(O), cutoff)
    assert np.array_equal(tbt.solve_factored(fact, _t(B)).numpy(), got)
    for rhs, x in ((B, got), (B2[..., None], tbt.solve_factored(fact, _t(B2)).numpy()[..., None])):
        Tx = np.einsum("pij,pjm->pim", D, x)
        Tx[:-1] += np.einsum("pij,pjm->pim", O, x[1:])
        Tx[1:] += np.einsum("pji,pjm->pim", O, x[:-1])
        np.testing.assert_allclose(Tx, rhs, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("s", [3, 8])
def test_scatter_banded_blocks_matches_jax_host_twin(rng, s):
    P, d, E = 20, 7, 45
    lo = rng.integers(0, P - 1, E)
    hi = np.minimum(lo + 1 + rng.integers(0, s, E), P - 1)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    E = len(lo)
    B_ll, B_hh, B_hl = (rng.normal(size=(E, d, d)) for _ in range(3))
    diag = rng.uniform(1.0, 2.0, P)
    K, m, D, O = jpg._scatter_banded_blocks(P, d, s, lo, hi, B_ll, B_hh, B_hl, diag)
    tK, tm, tD, tO = tpg._scatter_banded_blocks(
        P, d, s, _t(lo, torch.long), _t(hi, torch.long), _t(B_ll), _t(B_hh), _t(B_hl),
        _t(diag)[:, None].expand(P, d),
    )
    assert (tK, tm) == (K, m) and tO.shape[0] == K - 1
    np.testing.assert_allclose(tD.numpy(), D, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tO.numpy(), O[: K - 1], rtol=1e-12, atol=1e-12)


# ---- the LM loop: solve_linear=None keeps every bit ------------------------


def _solve_before(eval_quadratic, retract, params0, options):
    """The port's ``lm.solve`` as it was before ``solve_linear`` (B = 1,
    the plateau stop off), kept verbatim in its arithmetic."""
    oh, ch, max_it = options.optimization_handle, options.convergence_handle, options.max_iterations
    params = type(params0)(*(x[None] for x in params0))
    dtype = params[0].dtype
    full = lambda v: torch.full((1,), v, dtype=dtype)
    big = torch.finfo(dtype).max
    records = [torch.full((1, max_it), float("nan"), dtype=dtype) for _ in range(4)]
    lam, previous_cost, last_cost = full(oh.initial_lambda), full(big), full(big)
    done = torch.zeros(1, dtype=torch.bool)
    count = torch.zeros(1, dtype=torch.int32)
    for iteration in range(max_it):
        active = ~done
        p = type(params)(*(x[0] for x in params))
        hessian, gradient, cost = (x[None] for x in eval_quadratic(p))
        damped = hessian + lam[..., None, None] * hessian * torch.eye(hessian.shape[-1], dtype=dtype)
        delta = tlinear.solve_normal_equations(damped, -gradient, options.linear_solver_type)
        finite = torch.all(torch.isfinite(delta), dim=-1, keepdim=True)
        delta = torch.where(finite, delta, torch.zeros_like(delta))
        new = retract(p, delta[0])
        new_params = type(new)(*(x[None] for x in new))
        step_norm = torch.sqrt(torch.sum(delta * delta, dim=-1))
        grad_norm = torch.sqrt(torch.sum(gradient * gradient, dim=-1))
        converged = (step_norm < ch.parameter_tolerance) | (grad_norm < ch.gradient_tolerance)
        increase = cost > previous_cost
        adapted = torch.where(increase, lam * oh.lambda_increase_factor, lam * oh.lambda_decrease_factor)
        adapted = torch.clamp(adapted, oh.min_lambda, oh.max_lambda)
        for rec, value in zip(records, (cost, lam, grad_norm, step_norm)):
            rec[:, iteration] = value
        keep = active & ~converged
        lam = torch.where(keep, adapted, lam)
        previous_cost = torch.where(keep, cost, previous_cost)
        params = type(params)(*(torch.where(active[:, None], x, y) for x, y in zip(new_params, params)))
        last_cost = torch.where(active, cost, last_cost)
        count = count + active.to(torch.int32)
        done = done | converged
        if bool(torch.all(done)):
            break
    ran = torch.arange(max_it) < count[:, None]
    records = [torch.where(ran, r, torch.full_like(r, float("nan")))[0] for r in records]
    return type(params)(*(x[0] for x in params)), records, float(last_cost[0]), int(count[0])


@pytest.fixture(scope="module")
def se3_problem(rng):
    n = 150
    true = nls.Pose.from_axis_angle(0.8, [0.3, -0.2, 1.0], [0.5, -0.3, 0.4])
    points = rng.normal(size=(n, 3)) * 2.0
    means = true.apply(points) + 0.3 * rng.normal(size=(n, 3))
    sqrt_infos = np.eye(3) + 0.2 * rng.normal(size=(n, 3, 3))
    d = tmaha.MahalanobisData(*(_t(a) for a in (points, means, sqrt_infos, np.ones(n))))
    loss = port.ExponentialLoss(1.0, 1.0)

    def quad(p):
        return tmaha.eval_quadratic(tlie.quat_to_rotmat(p.quaternion), p.translation, d, loss)

    p0 = tman.SE3Params(torch.zeros(3, dtype=F64), torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=F64))
    return quad, p0


def test_lm_without_solve_linear_keeps_its_bits(se3_problem):
    quad, p0 = se3_problem
    options = topt.Options()
    before, records, last_cost, count = _solve_before(quad, tman.se3_retract, p0, options)
    after, summary = tlm.solve(quad, tman.se3_retract, p0, options)
    assert count == int((~torch.isnan(summary.records.cost)).sum()) > 3
    for got, want in zip(summary.records, records):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert float(summary.final_cost) == last_cost
    assert torch.equal(after.translation, before.translation)
    assert torch.equal(after.quaternion, before.quaternion)

    # the same step through the tuple path of solve_linear
    def linear(H, g, lam):
        step = tlinear.solve_normal_equations(
            tlinear.damp_hessian(H, lam), -g[0], options.linear_solver_type
        )
        return (step,)

    hooked, s2 = tlm.solve(
        lambda p: (lambda H, g, c: (H, (g,), c))(*quad(p)),
        lambda p, delta: tman.se3_retract(p, delta[0]), p0, options, solve_linear=linear,
    )
    for got, want in zip(s2.records, summary.records):
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(hooked.translation, after.translation)
