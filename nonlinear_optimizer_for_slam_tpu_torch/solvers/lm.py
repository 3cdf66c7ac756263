"""Generic damped Gauss-Newton / Levenberg-Marquardt loop (PyTorch port
of the JAX package's ``solvers/lm.py``).

One loop, :func:`solve_batch`, drives B independent problems at once (the
counterpart of ``jax.vmap`` of the JAX package's ``lm.solve``);
:func:`solve` is that loop at B = 1. The iteration loop is a Python loop on
the host. Every quantity it carries (parameters, lambda, costs, records)
stays a tensor on the device; the host reads one boolean per iteration,
``all done``, to decide whether to go on. Keeping the loop itself on the
device is later work.

The control policy reproduces the reference loop EXACTLY
(reference: mahalanobis_distance_minimizer_analytic.cc:84-152):

  1. (H, g, cost) <- evaluate at current params
  2. H[k,k] *= (1 + lambda)
  3. delta = solve(H, -g)
  4. params <- retract(params, delta)        # update happens BEFORE checks
  5. break if ||delta|| < parameter_tolerance
  6. break if ||g|| < gradient_tolerance
  7. lambda *= (cost > previous_cost ? 2.0 : 0.6), clamped to
     [min_lambda, max_lambda]; previous_cost <- cost

Note the quirks kept for trace parity: convergence is checked AFTER the
update; ``previous_cost`` starts at dtype-max (so the first adaptation
always shrinks lambda); a converging iteration leaves lambda and
previous_cost untouched; ``function_tolerance`` exists in Options but is
never read by the reference loop — same here.

Beyond the reference: ``relative_function_tolerance`` (default 0.0 = off)
adds an opt-in relative cost-plateau stop. With it on, the loop also
carries the monotone-best (cost, params) pair and a plateau exit returns
THAT state, not the last step (LM is not a descent method under the
reference's lambda <= 1e-2 clamp). ``Summary.plateau_stop`` tells the two
exit kinds apart.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.options import MinimizerType, Options
from ..utils import tracing
from .linear import damp_hessian, solve_normal_equations

Tensor = torch.Tensor


class IterationRecord(NamedTuple):
    """Per-iteration records, NaN past the last executed iteration."""

    cost: Tensor  # (max_iterations,)
    lam: Tensor
    gradient_norm: Tensor
    step_norm: Tensor


class Summary(NamedTuple):
    """Solve summary; every field is a tensor on the solve's device."""

    final_cost: Tensor  # cost evaluated in the last executed iteration;
    # on a plateau stop, the monotone best evaluated cost instead
    reported_cost: Tensor  # the reference's "COST:" print = previous_cost,
    # which lags final_cost by one iteration (dtype max if the solve
    # converges in its first iteration)
    iterations: Tensor  # the reference's iteration counter at exit
    final_lambda: Tensor
    converged: Tensor  # True if a tolerance fired before max_iterations
    records: IterationRecord
    plateau_stop: Optional[Tensor] = None  # only with the plateau stop on
    best_cost: Optional[Tensor] = None


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree of tuples (NamedTuples included);
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def instance(tree, b: int):
    """Instance ``b`` of a batched tree of tensors: params, or a
    :class:`Summary` with its records (an absent field stays None)."""
    return tree_map(lambda x: x[b], tree)


def _batch_of_one(tree):
    return tree_map(lambda x: x[None], tree)


def solve(
    eval_quadratic: Callable,
    retract: Callable,
    params0,
    options: Options,
    solve_linear: Optional[Callable] = None,
) -> Tuple[NamedTuple, Summary]:
    """Run the solver on one problem. ``params0`` is a tuple or NamedTuple
    of tensors (for example ``SE3Params``); ``eval_quadratic(params) -> (H,
    g, cost)`` and ``retract(params, delta) -> params`` applies a local step
    on the parameter manifold. This is :func:`solve_batch` at B = 1, so a
    problem solved alone and the same problem in a batch follow one policy.

    ``solve_linear(H, g, lam) -> delta`` replaces the damped normal
    equations, as in the JAX package's ``lm.solve``: ``H`` is then whatever
    ``eval_quadratic`` returned first (any tuple of operator parts, such as
    a pose graph's per-edge Jacobian blocks), and ``g`` and ``delta`` may
    be tuples of tensors; step and gradient norms run over all of them."""
    linear = None
    if solve_linear is not None:
        linear = lambda H, g, lam: _batch_of_one(
            solve_linear(instance(H, 0), instance(g, 0), lam[0])
        )
    params, summary = solve_batch(
        lambda p: _batch_of_one(eval_quadratic(instance(p, 0))),
        lambda p, delta: _batch_of_one(retract(instance(p, 0), instance(delta, 0))),
        _batch_of_one(params0),
        options,
        solve_linear=linear,
    )
    return instance(params, 0), instance(summary, 0)


def _lane_norm(tree, B: int) -> Tensor:
    """(B,) L2 norm of each instance over every tensor of a tree."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum((x * x).reshape(B, -1), dim=1) for x in leaves))


def solve_batch(
    eval_quadratic: Callable,
    retract: Callable,
    params0,
    options: Options,
    solve_linear: Optional[Callable] = None,
) -> Tuple[NamedTuple, Summary]:
    """The LM policy above for B independent problems at once.

    ``params0`` is a tuple or NamedTuple of (B, ...) tensors;
    ``eval_quadratic`` returns (H (B, P, P), g (B, P), cost (B,)) for all
    B, one evaluation per iteration for the whole batch. Each instance
    keeps its own lambda, previous cost, plateau state and done flag; once
    it is done its params, lambda, costs, records and iteration count
    freeze, while the loop runs until every instance is done (as a vmapped
    while_loop masks finished lanes). The host reads one boolean per
    iteration, ``all done``. Every field of the returned Summary has a
    leading B, the records (B, max_iterations).

    ``solve_linear(H, g, lam (B,)) -> delta`` replaces the damped normal
    equations (see :func:`solve`); H, g and delta are then trees of (B,
    ...) tensors."""
    oh = options.optimization_handle
    ch = options.convergence_handle
    max_it = options.max_iterations
    first = tree_leaves(params0)[0]
    B, dtype, device = first.shape[0], first.dtype, first.device
    full = lambda v: torch.full((B,), v, dtype=dtype, device=device)
    big = torch.finfo(dtype).max

    records = IterationRecord(
        *(torch.full((B, max_it), float("nan"), dtype=dtype, device=device)
          for _ in range(4))
    )
    track_best = ch.relative_function_tolerance > 0.0

    params = params0
    lam = full(oh.initial_lambda)
    previous_cost = full(big)
    last_cost = full(big)
    best_cost = full(big)
    best_params = params0
    stall = torch.zeros(B, dtype=torch.int32, device=device)
    plateau = torch.zeros(B, dtype=torch.bool, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    count = torch.zeros(B, dtype=torch.int32, device=device)

    def lanes(mask: Tensor, like: Tensor) -> Tensor:
        return mask.reshape(mask.shape + (1,) * (like.dim() - 1))

    def select(mask, a, b):
        return tree_map(lambda x, y: torch.where(lanes(mask, x), x, y), a, b)

    for iteration in range(max_it):
        with tracing.span("nls.lm.iter"):
            active = ~done
            hessian, gradient, cost = eval_quadratic(params)

            if options.minimizer_type == MinimizerType.GRADIENT_DESCENT:
                delta = tree_map(lambda g: -oh.gradient_descent_step * g, gradient)
            elif solve_linear is not None:
                delta = solve_linear(hessian, gradient, lam)
            else:
                damped = damp_hessian(hessian, lam)
                delta = solve_normal_equations(
                    damped, -gradient, options.linear_solver_type
                )
            # Degenerate-system guard: a singular damped H yields a non-finite
            # step; take a zero step instead, so the instance converges in place.
            finite = torch.ones(B, dtype=torch.bool, device=device)
            for leaf in tree_leaves(delta):
                finite = finite & torch.all(torch.isfinite(leaf.reshape(B, -1)), dim=1)
            delta = tree_map(lambda d: torch.where(lanes(finite, d), d, torch.zeros_like(d)), delta)
            step_norm = _lane_norm(delta, B)
            grad_norm = _lane_norm(gradient, B)

            new_params = retract(params, delta)

            ref_converged = (step_norm < ch.parameter_tolerance) | (
                grad_norm < ch.gradient_tolerance
            )
            converged = ref_converged
            if track_best:
                # three consecutive iterations that do not beat the best cost
                # by the relative tolerance end the solve (see the JAX lm.py);
                # ``cost`` was evaluated at ``params``, the pre-step point
                improved = (best_cost - cost) > (
                    ch.relative_function_tolerance * best_cost
                )
                new_stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
                converged = converged | (new_stall >= 3)
                best_params = select(active & (cost < best_cost), params, best_params)
                stall = torch.where(active, new_stall, stall)
                plateau = torch.where(active, converged & ~ref_converged, plateau)
            best_cost = torch.where(active, torch.minimum(best_cost, cost), best_cost)

            increase = cost > previous_cost
            adapted = torch.where(
                increase, lam * oh.lambda_increase_factor,
                lam * oh.lambda_decrease_factor,
            )
            adapted = torch.clamp(adapted, oh.min_lambda, oh.max_lambda)
            # a finished instance's columns are written too, and reset to NaN
            # past its own count at exit
            for rec, value in zip(records, (cost, lam, grad_norm, step_norm)):
                rec[:, iteration] = value
            # A converging iteration breaks before the lambda/previous_cost
            # update (reference: .._analytic.cc:138-148).
            keep = active & ~converged
            lam = torch.where(keep, adapted, lam)
            previous_cost = torch.where(keep, cost, previous_cost)
            params = select(active, new_params, params)
            last_cost = torch.where(active, cost, last_cost)
            count = count + active.to(torch.int32)
            done = done | converged  # a finished instance stays done
            if tracing.host_read(torch.all(done), bool):  # the one host read of the iteration
                break

    ran = torch.arange(max_it, device=device) < count[:, None]
    records = IterationRecord(
        *(torch.where(ran, rec, torch.full_like(rec, float("nan"))) for rec in records)
    )

    # The reference reports previous_cost and its 0-based iteration counter
    # at exit (.._analytic.cc:150-151): on a tolerance break that is
    # iteration - 1.
    iterations = torch.where(done, count - 1, count)
    final_cost = last_cost
    if track_best:
        params = select(plateau, best_params, params)
        final_cost = torch.where(plateau, best_cost, last_cost)
    summary = Summary(
        final_cost=final_cost,
        reported_cost=previous_cost,
        iterations=iterations,
        final_lambda=lam,
        converged=done,
        records=records,
        plateau_stop=plateau if track_best else None,
        best_cost=best_cost if track_best else None,
    )
    return params, summary
