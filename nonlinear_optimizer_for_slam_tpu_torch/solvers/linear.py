"""Dense linear solvers for the damped normal equations (PyTorch port of the
JAX package's ``solvers/linear.py``), batched over leading dimensions.

The reference hard-codes its linear solve per module and never reads its
``LinearSolverType`` enum; here the enum dispatches for real. No solver
synchronises with the host: a failed factorization yields a non-finite
step, which the LM loop's guard turns into a zero step, as a failed
``cho_factor`` does in the JAX package. The Cholesky path is
``cholesky_ex`` and two triangular solves, none of which reads ``info`` on
the host.

Batch invariance: with torch 2.11.0+cu128 on an H100, ``cholesky_ex``
factors one matrix (a batch of one included) with cuSOLVER's ``potrf`` and
a batch of two or more with ``potrfBatched``, which rounds otherwise and
gives a matrix the same bits in any batch of two or more. A lone matrix is
therefore factored as a batch of two, so that a batched LM solve gives
each instance the bits of its serial solve, as ``jax.vmap`` does for the
JAX package's batched solvers. That dispatch is torch's choice, not a
documented contract: ``chip_smoke.py``'s ``cholesky_probe`` holds it, and
the rest of the solve, on every run and names this function when it fails.
The rule holds for lone matrices of at most ``_PAIR_MAX`` rows only: the
batched solvers' systems are 3x3 to 6x6, while a large lone system (a
pose graph's dense 7P+L normal matrix, 564 to 17,500 rows) has no batched
twin whose bits it must match, and pairing it would double its memory and
its factorization work.
"""

from __future__ import annotations

import torch

from ..core.options import LinearSolverType

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def _matvec(A: Tensor, x: Tensor) -> Tensor:
    return (A @ x[..., None])[..., 0]


def _cg(hessian: Tensor, rhs: Tensor, tol: float = 1e-5) -> Tensor:
    """Conjugate gradients from x0 = 0 with the stopping rule and iteration
    cap of ``jax.scipy.sparse.linalg.cg(..., maxiter=10 * n)``:
    ||r||^2 <= tol^2 ||b||^2. A fixed-count loop whose finished iterations
    keep their state, so the host never waits on the stopping test."""
    x = torch.zeros_like(rhs)
    r = rhs - _matvec(hessian, x)
    p = r
    gamma = _dot(r, r)
    atol2 = tol * tol * _dot(rhs, rhs)
    for _ in range(10 * rhs.shape[-1]):
        active = gamma > atol2
        Ap = _matvec(hessian, p)
        alpha = gamma / _dot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        gamma_new = _dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


# Largest lone matrix factored as a batch of two (see the module docstring).
_PAIR_MAX = 64


def _cholesky_ex(hessian: Tensor):
    """``torch.linalg.cholesky_ex`` with a small lone matrix factored as a
    batch of two (see the module docstring)."""
    n = hessian.shape[-1]
    if hessian.numel() != n * n or n > _PAIR_MAX:
        return torch.linalg.cholesky_ex(hessian)
    pair = hessian.reshape(1, n, n).expand(2, n, n)
    factor, info = torch.linalg.cholesky_ex(pair)
    return factor[0].reshape(hessian.shape), info[0].reshape(hessian.shape[:-2])


def solve_normal_equations(
    hessian: Tensor, rhs: Tensor, solver_type: LinearSolverType
) -> Tensor:
    """Solve H x = rhs for symmetric (damped) H: (..., n, n) and (..., n).

    DENSE_CHOLESKY: Cholesky (the ldlt analog,
        mahalanobis_distance_minimizer_analytic_simd.cc:85).
    DENSE_QR: QR-based solve (the Ceres DENSE_QR analog).
    SPARSE_CHOLESKY: dense Cholesky.
    CONJUGATE_GRADIENT: conjugate gradients.
    """
    if solver_type == LinearSolverType.DENSE_QR:
        q, r = torch.linalg.qr(hessian)
        return torch.linalg.solve_triangular(
            r, q.mT @ rhs[..., None], upper=True
        )[..., 0]
    if solver_type == LinearSolverType.CONJUGATE_GRADIENT:
        return _cg(hessian, rhs)
    # DENSE_CHOLESKY / SPARSE_CHOLESKY; cholesky_ex reports failure in
    # `info` instead of raising (raising would wait on the device)
    factor, info = _cholesky_ex(hessian)
    y = torch.linalg.solve_triangular(factor, rhs[..., None], upper=False)
    x = torch.linalg.solve_triangular(factor.mT, y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))


def damp_hessian(hessian: Tensor, lam: Tensor) -> Tensor:
    """Multiplicative diagonal damping H[k,k] *= (1 + lambda)
    (reference: mahalanobis_distance_minimizer_analytic.cc:126); ``lam``
    has the leading shape of ``hessian``. Only the diagonal is touched, so a
    large system needs no n x n identity or product; each damped entry is
    h + lambda h, the bits of ``H + lambda H * I``."""
    damped = hessian.clone()
    diagonal = damped.diagonal(dim1=-2, dim2=-1)
    diagonal.add_(lam[..., None] * diagonal)
    return damped
