"""Sharded solving over a ``torch.distributed`` group.

Strategy (SURVEY section 2.8): factors are data-parallel. Each rank
evaluates the fused quadratic on its block of the correspondence batch and
the (H, g, cost) partials (28 floats for 6-DoF) are summed across ranks.
The whole LM loop runs on every rank: after the sum every rank holds the
same (H, g, cost), so lambda adaptation, convergence flags and the
parameters stay replicated, and each rank's host reads the same flags.

The sum is an ``all_gather`` of every rank's flat partials followed by a
sum in rank order, not an ``all_reduce``, whose order of summation is not
fixed: every rank then holds bitwise the same result, the replication the
loop rests on. A world of one adds its one partial, so its result is
bitwise the unsharded one.

This replaces the reference's thread fan-out + future-sum reduction
(mahalanobis_distance_minimizer_analytic.cc:97-120).
"""

from __future__ import annotations

import functools
from typing import Callable, List

import torch
import torch.distributed as dist

from ..solvers.lm import tree_leaves, tree_map
from .mesh import FactorMesh, factor_sharding

Tensor = torch.Tensor


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in order, from ``leaves``."""
    leaves = iter(leaves)
    return tree_map(lambda _: next(leaves), tree)


def _gather_flat(mesh: FactorMesh, flat: Tensor) -> List[Tensor]:
    """Every rank's ``flat`` (1-D, the same length on every rank), in rank
    order, on ``flat``'s device: one ``all_gather``, through host memory
    when ``mesh.host_staged``."""
    sent = flat.cpu() if mesh.host_staged else flat
    parts = [torch.empty_like(sent) for _ in range(mesh.size)]
    dist.all_gather(parts, sent, group=mesh.group)
    return [part.to(flat.device) for part in parts]


def all_sum(mesh: FactorMesh, tree):
    """The sum over ranks of a tree of tensors (tuples and NamedTuples of
    tensors of one dtype; None stays None), bitwise equal on every rank:
    one ``all_gather`` of the flattened leaves, then a sum in rank order.
    Through host memory when ``mesh.host_staged``; a mesh made without a
    process group returns ``tree`` as it is."""
    if mesh.backend is None:
        return tree
    leaves = tree_leaves(tree)
    parts = _gather_flat(mesh, torch.cat([x.reshape(-1) for x in leaves]))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    pieces = torch.split(total, [x.numel() for x in leaves])
    return _rebuild(tree, (p.reshape(x.shape) for p, x in zip(pieces, leaves)))


def row_block(mesh: FactorMesh, num_rows: int) -> slice:
    """This rank's block of ``num_rows`` rows when they need not split
    evenly: blocks of ceil(num_rows / size) rows in rank order, the last
    ones short or empty."""
    block = -(-num_rows // mesh.size)
    return slice(min(mesh.rank * block, num_rows), min((mesh.rank + 1) * block, num_rows))


def all_gather_rows(mesh: FactorMesh, tree, num_rows: int):
    """The whole tensors on every rank, from each rank's :func:`row_block`
    of their ``num_rows`` rows (``tree``: this rank's blocks, a tuple of
    tensors of one dtype, None staying None). One ``all_gather``; the
    values are copied, not added, so every rank holds the same bits as
    the rank that computed them."""
    if mesh.backend is None:
        return tree
    leaves = tree_leaves(tree)
    block = -(-num_rows // mesh.size)
    padded = [
        torch.cat([x, x.new_zeros((block - x.shape[0],) + tuple(x.shape[1:]))]) for x in leaves
    ]
    parts = _gather_flat(mesh, torch.cat([x.reshape(-1) for x in padded]))
    per_rank = [torch.split(part, [x.numel() for x in padded]) for part in parts]
    whole = (
        torch.cat([pieces[i].reshape(x.shape) for pieces in per_rank])[:num_rows]
        for i, x in enumerate(padded)
    )
    return _rebuild(tree, whole)


def reducer(mesh: FactorMesh) -> Callable:
    """``reduce(tree) -> tree``: :func:`all_sum` over ``mesh``, the
    counterpart of ``jax.lax.psum`` over the factor axis."""
    return functools.partial(all_sum, mesh)


def shard_rows(mesh: FactorMesh, data):
    """This rank's block of rows (axis 0) of every tensor of ``data``, a
    tensor or a (Named)tuple of tensors with equal row counts."""
    rows = factor_sharding(mesh, tree_leaves(data)[0].shape[0])
    return tree_map(lambda x: x[rows], data)


def shard_solve(solve_fn, mesh: FactorMesh, data, *args):
    """``solve_fn(data_shard, *args, reduce=...)`` on this rank's rows of
    ``data`` (whose rows are a multiple of the world size); ``reduce`` sums
    a tree of tensors over the ranks, so ``solve_fn``'s outputs are the
    same on every rank. The JAX package's ``psum_axis`` becomes
    ``reduce``."""
    return solve_fn(shard_rows(mesh, data), *args, reduce=reducer(mesh))


def sharded_quadratic(eval_fn, mesh: FactorMesh):
    """Wrap a local ``eval_fn(data, *args) -> (H, g, cost)`` into a sharded
    one: each rank evaluates its rows and the results are summed (an
    evaluation fan-out for a caller that keeps its LM loop unsharded)."""

    def call(data, *args):
        return all_sum(mesh, eval_fn(shard_rows(mesh, data), *args))

    return call
