"""Batched block-tridiagonal direct solver: cyclic reduction and a dense
tail (PyTorch port of the JAX package's ``solvers/block_tridiag.py``).

SLAM pose graphs are odometry chains plus a sparse set of loop closures:
the damped Gauss-Newton system is block-tridiagonal (7x7 pose blocks
coupling consecutive poses) up to a low-rank correction. Cyclic reduction
eliminates all odd-indexed block rows at once (batched block inverses and
block products), halving the system each level: log-depth batched levels
instead of P sequential pivots, and an exact solve.

Reduction stops at ``dense_cutoff`` block rows (256, as in the JAX
package; the selection tests hold the two packages to the same choices);
the remaining system is assembled dense and factored by one Cholesky.
Block products are batched matmuls on (..., k, k) tensors for every k.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Tensor = torch.Tensor

# Blocks at least this wide are inverted through Cholesky (as the JAX
# package's ``_binv_spd`` does); 7x7 pose blocks through LU.
_CHOLESKY_INVERSE_MIN = 32


def _binv_spd(A: Tensor) -> Tensor:
    """Batched inverse of SPD blocks (every block cyclic reduction inverts
    is a Schur complement of the damped SPD system). Large blocks
    (superblocks) go through Cholesky and a triangular solve; 7x7 blocks
    through ``torch.linalg.inv``."""
    if A.shape[-1] >= _CHOLESKY_INVERSE_MIN:
        L = torch.linalg.cholesky(A)
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return Linv.mT @ Linv
    return torch.linalg.inv(A)


def factor(D: Tensor, O: Tensor, dense_cutoff: int = 256):
    """The cyclic-reduction elimination matrices of T.

    The reduction levels depend only on (D, O), not on the right-hand
    side, so several right-hand-side batches solved against the same
    system (the chunked Woodbury correction, the CG preconditioner) share
    one factorization. Returns an opaque factor for :func:`solve_factored`.
    """
    P = D.shape[0]
    k = D.shape[-1]
    dtype, device = D.dtype, D.device
    zk = torch.zeros((1, k, k), dtype=dtype, device=device)
    if O.shape[0] == P - 1:
        O = torch.cat([O, zk], dim=0)

    # L[i] couples row i to i-1 (= O[i-1]^T), U[i] couples to i+1 (= O[i])
    L = torch.cat([zk, O[:-1].mT], dim=0)
    U = O.clone()
    U[P - 1] = 0.0

    n = P
    eye = torch.eye(k, dtype=dtype, device=device)
    levels: List[Tuple[bool, Tensor, Tensor, Tensor, Tensor, Tensor]] = []
    while n > max(dense_cutoff, 1):
        padded = n % 2 == 1
        if padded:
            # one decoupled identity row keeps the halving exact
            D = torch.cat([D, eye[None]], dim=0)
            L = torch.cat([L, zk], dim=0)
            U = torch.cat([U, zk], dim=0)
            U[n - 1] = 0.0
            n += 1

        D_odd, L_odd, U_odd = D[1::2], L[1::2], U[1::2]
        D_ev, L_ev, U_ev = D[0::2], L[0::2], U[0::2]
        Dinv_odd = _binv_spd(D_odd)

        # even row 2m couples left to odd 2m-1 (odd slot m-1; absent for
        # m = 0, where L_ev[0] = 0) and right to odd 2m+1 (odd slot m)
        Dinv_l = torch.cat([zk, Dinv_odd[:-1]], dim=0)
        L_l = torch.cat([zk, L_odd[:-1]], dim=0)
        U_l = torch.cat([zk, U_odd[:-1]], dim=0)
        LD_l = L_ev @ Dinv_l  # L_i D_{i-1}^{-1}
        UD_r = U_ev @ Dinv_odd  # U_i D_{i+1}^{-1}
        levels.append((padded, Dinv_odd, L_odd, U_odd, LD_l, UD_r))
        D = D_ev - LD_l @ U_l - UD_r @ L_odd
        L = -(LD_l @ L_l)
        U = -(UD_r @ U_odd)
        n = n // 2

    if n > 1:
        # dense tail: assemble once, Cholesky-factor once
        M = torch.zeros((n, k, n, k), dtype=dtype, device=device)
        idx = torch.arange(n, device=device)
        M[idx, :, idx, :] = D
        M[idx[:-1], :, idx[1:], :] = U[: n - 1]
        M[idx[1:], :, idx[:-1], :] = U[: n - 1].mT
        tail = ("cho", torch.linalg.cholesky(M.reshape(n * k, n * k)), n)
    else:
        tail = ("inv", _binv_spd(D), 1)
    return (k, levels, tail)


def solve_factored(fact, B: Tensor) -> Tensor:
    """Solve T x = B with a :func:`factor` of T; B is (P, k, m) or (P, k)."""
    k, levels, tail = fact
    squeeze = B.dim() == 2
    if squeeze:
        B = B[..., None]
    m = B.shape[-1]
    zkm = B.new_zeros((1, k, m))

    saved: List[Tensor] = []
    for padded, Dinv_odd, L_odd, U_odd, LD_l, UD_r in levels:
        if padded:
            B = torch.cat([B, zkm], dim=0)
        B_odd, B_ev = B[1::2], B[0::2]
        B_l = torch.cat([zkm, B_odd[:-1]], dim=0)
        saved.append(B_odd)
        B = B_ev - LD_l @ B_l - UD_r @ B_odd

    kind, data, n_tail = tail
    if kind == "cho":
        x = torch.cholesky_solve(B.reshape(n_tail * k, m), data).reshape(n_tail, k, m)
    else:
        x = data @ B

    # back-substitution, finest level last
    for (padded, Dinv_odd, L_odd, U_odd, _, _), B_odd in zip(reversed(levels), reversed(saved)):
        half = x.shape[0]
        # x_{2m+1} = Dinv (B_{2m+1} - L_{2m+1} x_{2m} - U_{2m+1} x_{2m+2})
        x_right = torch.cat([x[1:], zkm], dim=0)
        x_odd = Dinv_odd @ (B_odd - L_odd @ x - U_odd @ x_right)
        x = torch.stack([x, x_odd], dim=1).reshape(2 * half, k, m)
        if padded:
            x = x[:-1]

    if squeeze:
        x = x[..., 0]
    return x


def solve(D: Tensor, O: Tensor, B: Tensor, dense_cutoff: int = 256) -> Tensor:
    """Solve the SPD block-tridiagonal system T x = B.

    T has diagonal blocks ``D[i]`` (P, k, k) and off-diagonal blocks
    ``O[i]`` coupling row i to row i+1 (P-1 or P entries; a trailing entry
    is ignored): row i reads ``O[i-1]^T x[i-1] + D[i] x[i] + O[i] x[i+1] =
    B[i]``. ``B`` is (P, k, m), m right-hand sides solved together, or
    (P, k), returned squeezed. Each level halves the system; an odd-length
    level is padded with one decoupled identity row; reduction stops at
    ``dense_cutoff`` rows, whose system is factored dense."""
    return solve_factored(factor(D, O, dense_cutoff), B)
