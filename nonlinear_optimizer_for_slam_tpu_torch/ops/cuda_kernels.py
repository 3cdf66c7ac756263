"""Hand-written CUDA kernels for factor-quadratic evaluation (PyTorch
counterpart of the JAX package's ``ops/pallas_kernels.py``).

Five kernels, one per factor: ``maha6`` (6-DoF NDT), ``maha3`` (planar
3-DoF NDT over the maha6 rows), ``maha3c`` (planar 3-DoF NDT over the
compact Gram rows), ``reproj`` (pinhole reprojection) and ``p2p``
(point-to-plane). Each warps the points, forms residuals and analytic
Jacobians, applies the robust-loss weight and reduces the per-factor
(upper-triangle J^T J, J^T r, cost) terms, with nothing per-factor written
to device memory. Sources: ``csrc/<name>.cu`` (per-factor math in
``csrc/factor_math.cuh``, the one-launch reduction that all five share in
``csrc/onepass.cuh``), built by ``ops/_build.py``.

Every kernel has a plain PyTorch version beside it, with the same
arithmetic and output order. A wrapper given CPU tensors takes the plain
version; given CUDA tensors it launches the kernel or raises. Each launch
adds one to ``LAUNCHES[name]``, so a run can show that it went through the
kernel.

maha6 and maha3 also read bfloat16 rows (``pack_maha6(...,
buffer_dtype=torch.bfloat16)``, the TPU kernel's bf16-storage option):
their wrappers then launch the bf16-row instantiations of the same
kernels, counted as ``LAUNCHES["maha6_bf16"]`` and
``LAUNCHES["maha3_bf16"]``, which load bf16 and compute in float32; the
plain versions widen the same rows to float32 first.

Packed buffers are (B, rows, N) float32, one row per field:

    maha6, maha3 (16 rows): p 0-2, mu 3-5, S row-major 6-14, mask 15
    maha3c (10 rows):       u 0-1, mu_xy 2-3, M00 M01 M11 4-6, v 7-8, szz 9
                            (the mask folded into M, v and szz)
    reproj (6 rows):        X 0-2, pixel 3-4, mask 5
    p2p (10 rows):          p 0-2, mu 3-5, n 6-8, mask 9

Params are (B, 16) float32 [R row-major 9, t 3, loss a, loss b, 0, 0] for
maha6 and p2p; (B, 8) [R2 row-major 4, t2 2, loss a, loss b] for maha3 and
maha3c; (B, 20) [R row-major 9, t 3, inv_fx, inv_fy, cx, cy, loss a,
loss b, min depth, 0] for reproj.

On the card, the kernels read rows that start on 16-byte boundaries, so
their buffers are (B, rows, N) views whose rows start every ld elements,
ld a multiple of 4 floats (8 bf16), with the lanes past N zero:
:func:`lane_aligned` makes one, and the packers call it for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..core.losses import (
    CauchyLoss,
    DCSLoss,
    ExponentialLoss,
    GemanMcClureLoss,
    HuberLoss,
    LossFunction,
    TrivialLoss,
    TukeyLoss,
    exp_rounded,
)
from . import _build
from .mahalanobis import MahalanobisData
from .point_to_plane import PointToPlaneData
from .quadratic import unpack_symmetric
from .reprojection import MIN_DEPTH, CameraIntrinsics, ReprojectionData

Tensor = torch.Tensor

# The kernels that also read bfloat16 rows, each through an instantiation
# of its own (``<name>_bf16``, built from ``csrc/<name>.cu``).
BF16_ROWS = ("maha6", "maha3")

# Kernel launches since the last reset, by kernel name.
LAUNCHES: Dict[str, int] = {
    name: 0 for name in (*_build.KERNELS, *(f"{k}_bf16" for k in BF16_ROWS))
}

# (packed rows, params, outputs) of each kernel.
_SHAPES = {
    "maha6": (16, 16, 28),
    "maha3": (16, 8, 10),
    "maha3c": (10, 8, 10),
    "reproj": (6, 20, 28),
    "p2p": (10, 16, 28),
}

# The kernels built on csrc/onepass.cuh: one launch a call, rows that
# start on 16-byte boundaries.
ONE_PASS = ("maha6", "maha3", "maha3c", "reproj", "p2p")
# Lanes of one tile (onepass.cuh: kTile), the most tiles of a problem that
# takes the cluster finish (kClusterTiles), and the alignment of a row, in
# floats (16 bytes; 8 lanes of bf16 rows).
ONE_PASS_TILE = 512
ONE_PASS_CLUSTER_TILES = 16
LANE_ALIGN = 4


def _lane_align(dtype: torch.dtype) -> int:
    """Lanes of a 16-byte row alignment for rows of ``dtype``."""
    return 16 // torch.empty(0, dtype=dtype).element_size()


def onepass_num_tiles(n: int) -> int:
    """Tiles of a problem of ``n`` lanes: onepass.cuh's ``num_tiles``."""
    return -(-n // ONE_PASS_TILE) if n > 0 else 0


def onepass_cluster_blocks(n: int) -> int:
    """Blocks of the cluster that a problem of ``n`` lanes takes for the
    cluster finish, or 0 for the ticket's finish: onepass.cuh's
    ``cluster_blocks``."""
    tiles = onepass_num_tiles(n)
    return max(tiles, 1) if tiles <= ONE_PASS_CLUSTER_TILES else 0


def onepass_workspace_floats(batch: int, n: int, n_out: int) -> int:
    """Floats of tile sums a one-pass launch writes: onepass.cuh's
    ``workspace_floats``."""
    return batch * onepass_num_tiles(n) * n_out


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Loss codes baked into the kernel as template parameters (the order of
# csrc/factor_math.cuh:LossCode).
_LOSS_NONE, _LOSS_EXP, _LOSS_HUBER, _LOSS_CAUCHY = 0, 1, 2, 3
_LOSS_TUKEY, _LOSS_GM, _LOSS_DCS = 4, 5, 6
_NUM_LOSSES = 7


def _loss_static(loss: Optional[LossFunction]):
    """(code, (a, b)) for in-kernel loss evaluation; the parameters ride in
    the params vector."""
    if loss is None or isinstance(loss, TrivialLoss):
        return _LOSS_NONE, (0.0, 0.0)
    if isinstance(loss, ExponentialLoss):
        return _LOSS_EXP, (loss.c1, loss.c2)
    if isinstance(loss, HuberLoss):
        return _LOSS_HUBER, (loss.threshold, 0.0)
    if isinstance(loss, CauchyLoss):
        return _LOSS_CAUCHY, (loss.scale, 0.0)
    if isinstance(loss, TukeyLoss):
        return _LOSS_TUKEY, (loss.threshold, 0.0)
    if isinstance(loss, GemanMcClureLoss):
        return _LOSS_GM, (loss.scale, 0.0)
    if isinstance(loss, DCSLoss):
        return _LOSS_DCS, (loss.phi, 0.0)
    raise NotImplementedError(
        f"the cuda backend has no kernel variant for {type(loss).__name__}; "
        f"use backend='torch'"
    )


def _eval_loss(loss_code: int, sq: Tensor, a: Tensor, b: Tensor):
    """(rho, w) for squared residual norm sq: the kernel's eval_loss."""
    if loss_code == _LOSS_NONE:
        return sq, torch.ones_like(sq)
    if loss_code == _LOSS_EXP:
        exp_term = exp_rounded(-b * sq)
        return a - a * exp_term, 2.0 * a * b * exp_term
    if loss_code == _LOSS_CAUCHY:
        c2 = a * a
        return c2 * torch.log1p(sq / c2), 1.0 / (1.0 + sq / c2)
    if loss_code == _LOSS_TUKEY:
        b2 = a * a
        u = torch.clamp(1.0 - sq / b2, min=0.0)
        return (b2 / 3.0) * (1.0 - u * u * u), u * u
    if loss_code == _LOSS_GM:
        c2 = a * a
        inv = c2 / (c2 + sq)
        return sq * inv, inv * inv
    if loss_code == _LOSS_DCS:
        inlier = sq <= a
        return (
            torch.where(inlier, sq, a),
            torch.where(inlier, torch.ones_like(sq), torch.zeros_like(sq)),
        )
    if loss_code == _LOSS_HUBER:
        sq_delta = a * a
        outlier = sq > sq_delta
        root = torch.sqrt(torch.where(outlier, sq, sq_delta))
        rho = torch.where(outlier, 2.0 * a * root - sq_delta, sq)
        w = torch.where(outlier, a / root, torch.ones_like(sq))
        return rho, w
    raise ValueError(f"unknown loss code {loss_code}")


def maha6_loss_ab(loss: Optional[LossFunction], device) -> Tuple[int, Tensor]:
    """(loss code, the (4,) float32 params tail [a, b, 0, 0] on ``device``),
    for maha6, maha3, maha3c and p2p. Build it once per solve: it is a
    host-to-device copy."""
    code, (a, b) = _loss_static(loss)
    return code, torch.tensor([a, b, 0.0, 0.0], dtype=torch.float32, device=device)


def maha6_params(rotation: Tensor, translation: Tensor, loss_ab: Tensor) -> Tensor:
    """(..., 16) float32 params of maha6 and p2p [R row-major 9, t 3,
    loss a, loss b, 0, 0], built on the device. ``loss_ab`` is the (4,)
    tail of :func:`maha6_loss_ab`."""
    lead = rotation.shape[:-2]
    return torch.cat(
        [
            rotation.reshape(lead + (9,)).to(torch.float32),
            translation.to(torch.float32),
            loss_ab.expand(lead + (4,)),
        ],
        dim=-1,
    )


def maha3_params(rotation2: Tensor, translation2: Tensor, loss_ab: Tensor) -> Tensor:
    """(..., 8) float32 params of maha3 and maha3c [R2 row-major 4, t2 2,
    loss a, loss b], built on the device from the tail of
    :func:`maha6_loss_ab`."""
    lead = rotation2.shape[:-2]
    return torch.cat(
        [
            rotation2.reshape(lead + (4,)).to(torch.float32),
            translation2.to(torch.float32),
            loss_ab[:2].expand(lead + (2,)),
        ],
        dim=-1,
    )


def reproj_loss_ab(loss: Optional[LossFunction], device) -> Tuple[int, Tensor]:
    """(loss code, the (4,) float32 params tail [a, b, min depth, 0] of
    reproj on ``device``). Build it once per solve."""
    code, (a, b) = _loss_static(loss)
    return code, torch.tensor([a, b, MIN_DEPTH, 0.0], dtype=torch.float32, device=device)


def reproj_params(
    rotation: Tensor, translation: Tensor, intrinsics: CameraIntrinsics, loss_ab: Tensor
) -> Tensor:
    """(..., 20) float32 params of reproj [R row-major 9, t 3, inv_fx,
    inv_fy, cx, cy, loss a, loss b, min depth, 0], from the tail of
    :func:`reproj_loss_ab`. The intrinsics are floats or scalar tensors;
    tensors on the device cost no copy."""
    lead = rotation.shape[:-2]
    camera = torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=rotation.device)
        for v in (intrinsics.inv_fx, intrinsics.inv_fy, intrinsics.cx, intrinsics.cy)
    ])
    return torch.cat(
        [
            rotation.reshape(lead + (9,)).to(torch.float32),
            translation.to(torch.float32),
            camera.expand(lead + (4,)),
            loss_ab.expand(lead + (4,)),
        ],
        dim=-1,
    )


# ----------------------------------------------------------------------------
# The plain versions: each factor's terms, (B, outputs, N)
# ----------------------------------------------------------------------------


def _upper_products(J, w, r):
    """The kernel's output order: w J^T J upper triangle, w J^T r, from
    J[i][a] (residual row i, parameter a) and r[i]."""
    P = len(J[0])
    rows = range(len(J))
    terms = []
    for a_ in range(P):
        for b_ in range(a_, P):
            acc = J[0][a_] * J[0][b_]
            for i in rows[1:]:
                acc = acc + J[i][a_] * J[i][b_]
            terms.append(w * acc)
    for a_ in range(P):
        acc = J[0][a_] * r[0]
        for i in rows[1:]:
            acc = acc + J[i][a_] * r[i]
        terms.append(w * acc)
    return terms


def maha6_terms(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 28, N): every factor's 28 terms, the kernel's arithmetic (bf16
    rows widened to float32 first)."""
    packed = packed.float()
    prm = lambda k: params[:, k : k + 1]  # (B, 1), broadcasts over N
    R = [prm(k) for k in range(9)]
    t = [prm(9 + k) for k in range(3)]
    la, lb = prm(12), prm(13)
    f = lambda k: packed[:, k]  # (B, N)
    p = [f(k) for k in range(3)]
    mu = [f(3 + k) for k in range(3)]
    S = [f(6 + k) for k in range(9)]
    mask = f(15)

    e = [
        R[3 * i + 0] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2]
        + t[i] - mu[i]
        for i in range(3)
    ]
    r = [
        S[3 * i + 0] * e[0] + S[3 * i + 1] * e[1] + S[3 * i + 2] * e[2]
        for i in range(3)
    ]
    sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    rho, w = _eval_loss(loss_code, sq, la, lb)
    w = w * mask
    rho = rho * mask

    J = [[None] * 6 for _ in range(3)]
    for i in range(3):
        B = [
            S[3 * i + 0] * R[0 + j] + S[3 * i + 1] * R[3 + j] + S[3 * i + 2] * R[6 + j]
            for j in range(3)
        ]
        J[i][0] = S[3 * i + 0]
        J[i][1] = S[3 * i + 1]
        J[i][2] = S[3 * i + 2]
        J[i][3] = -(B[1] * p[2] - B[2] * p[1])
        J[i][4] = -(B[2] * p[0] - B[0] * p[2])
        J[i][5] = -(B[0] * p[1] - B[1] * p[0])
    return torch.stack(_upper_products(J, w, r) + [rho], dim=1)


def maha3_terms(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 10, N): every factor's 10 planar terms, the kernel's
    arithmetic (bf16 rows widened to float32 first)."""
    packed = packed.float()
    prm = lambda k: params[:, k : k + 1]
    R00, R01, R10, R11 = (prm(k) for k in range(4))
    f = lambda k: packed[:, k]
    p = [f(k) for k in range(3)]
    mu = [f(3 + k) for k in range(3)]
    S = [f(6 + k) for k in range(9)]
    mask = f(15)

    wx = R00 * p[0] + R01 * p[1] + prm(4)
    wy = R10 * p[0] + R11 * p[1] + prm(5)
    e = [wx - mu[0], wy - mu[1], p[2] - mu[2]]
    r = [
        S[3 * i + 0] * e[0] + S[3 * i + 1] * e[1] + S[3 * i + 2] * e[2]
        for i in range(3)
    ]
    sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    rho, w = _eval_loss(loss_code, sq, prm(6), prm(7))
    w = w * mask
    rho = rho * mask

    rx = R00 * -p[1] + R01 * p[0]
    ry = R10 * -p[1] + R11 * p[0]
    J = [[S[3 * i + 0], S[3 * i + 1], S[3 * i + 0] * rx + S[3 * i + 1] * ry] for i in range(3)]
    return torch.stack(_upper_products(J, w, r) + [rho], dim=1)


def maha3c_terms(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 10, N): every factor's 10 planar terms from the compact Gram
    rows, the kernel's arithmetic."""
    prm = lambda k: params[:, k : k + 1]
    R00, R01, R10, R11 = (prm(k) for k in range(4))
    f = lambda k: packed[:, k]
    u0, u1, M00, M01, M11, v0, v1 = f(0), f(1), f(4), f(5), f(6), f(7), f(8)

    e0 = R00 * u0 + R01 * u1 + prm(4) - f(2)
    e1 = R10 * u0 + R11 * u1 + prm(5) - f(3)
    Me0 = M00 * e0 + M01 * e1
    Me1 = M01 * e0 + M11 * e1
    sq = torch.clamp(e0 * Me0 + e1 * Me1 + 2.0 * (v0 * e0 + v1 * e1) + f(9), min=0.0)
    rho, w = _eval_loss(loss_code, sq, prm(6), prm(7))

    rs0 = -R00 * u1 + R01 * u0
    rs1 = -R10 * u1 + R11 * u0
    MR0 = M00 * rs0 + M01 * rs1
    MR1 = M01 * rs0 + M11 * rs1
    g0 = Me0 + v0
    g1 = Me1 + v1
    terms = [M00, M01, MR0, M11, MR1, rs0 * MR0 + rs1 * MR1, g0, g1, rs0 * g0 + rs1 * g1]
    return torch.stack([w * x for x in terms] + [rho], dim=1)


def reproj_terms(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 28, N): every correspondence's 28 terms, the kernel's
    arithmetic."""
    prm = lambda k: params[:, k : k + 1]
    R = [prm(k) for k in range(9)]
    f = lambda k: packed[:, k]
    X = [f(k) for k in range(3)]

    Xw = [
        R[3 * i + 0] * X[0] + R[3 * i + 1] * X[1] + R[3 * i + 2] * X[2] + prm(9 + i)
        for i in range(3)
    ]
    in_front = Xw[2] >= prm(18)
    valid = in_front.to(Xw[2].dtype)
    inv_z = 1.0 / torch.where(in_front, Xw[2], torch.ones_like(Xw[2]))
    inv_z2 = inv_z * inv_z
    r0 = (Xw[0] * inv_z - prm(12) * (f(3) - prm(14))) * valid
    r1 = (Xw[1] * inv_z - prm(13) * (f(4) - prm(15))) * valid
    rho, w = _eval_loss(loss_code, r0 * r0 + r1 * r1, prm(16), prm(17))
    m = f(5) * valid
    w = w * m
    rho = rho * m

    dx = -Xw[0] * inv_z2
    dy = -Xw[1] * inv_z2
    zero = torch.zeros_like(inv_z)
    cols = (
        [R[3 * i + 1] * X[2] - R[3 * i + 2] * X[1] for i in range(3)],
        [R[3 * i + 2] * X[0] - R[3 * i + 0] * X[2] for i in range(3)],
        [R[3 * i + 0] * X[1] - R[3 * i + 1] * X[0] for i in range(3)],
    )
    J = [
        [inv_z, zero, dx] + [-(inv_z * c[0] + dx * c[2]) for c in cols],
        [zero, inv_z, dy] + [-(inv_z * c[1] + dy * c[2]) for c in cols],
    ]
    return torch.stack(_upper_products(J, w, [r0, r1]) + [rho], dim=1)


def p2p_terms(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 28, N): every point-plane pair's 28 terms, the kernel's
    arithmetic."""
    prm = lambda k: params[:, k : k + 1]
    R = [prm(k) for k in range(9)]
    t = [prm(9 + k) for k in range(3)]
    f = lambda k: packed[:, k]
    p = [f(k) for k in range(3)]
    mu = [f(3 + k) for k in range(3)]
    n = [f(6 + k) for k in range(3)]
    mask = f(9)

    e = [
        R[3 * i + 0] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2]
        + t[i] - mu[i]
        for i in range(3)
    ]
    r = n[0] * e[0] + n[1] * e[1] + n[2] * e[2]
    rho, w = _eval_loss(loss_code, r * r, prm(12), prm(13))
    w = w * mask
    rho = rho * mask

    cols = (
        [R[3 * i + 1] * p[2] - R[3 * i + 2] * p[1] for i in range(3)],
        [R[3 * i + 2] * p[0] - R[3 * i + 0] * p[2] for i in range(3)],
        [R[3 * i + 0] * p[1] - R[3 * i + 1] * p[0] for i in range(3)],
    )
    J = n + [-(n[0] * c[0] + n[1] * c[1] + n[2] * c[2]) for c in cols]
    terms = [w * J[a_] * J[b_] for a_ in range(6) for b_ in range(a_, 6)]
    terms += [w * J[a_] * r for a_ in range(6)]
    return torch.stack(terms + [rho], dim=1)


_TERMS = {
    "maha6": maha6_terms,
    "maha3": maha3_terms,
    "maha3c": maha3c_terms,
    "reproj": reproj_terms,
    "p2p": p2p_terms,
}


def maha6_plain(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """Plain PyTorch version of the maha6 kernel: (B, 16) params and
    (B, 16, N) packed (float32, or bf16 rows widened to float32) ->
    (B, 28). The CPU path, and what the kernel is compared with on the
    card."""
    return maha6_terms(params, packed, loss_code).sum(dim=-1)


def maha3_plain(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """Plain PyTorch version of the maha3 kernel: (B, 8) params and
    (B, 16, N) packed (float32, or bf16 rows widened to float32) ->
    (B, 10)."""
    return maha3_terms(params, packed, loss_code).sum(dim=-1)


def maha3c_plain(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """Plain PyTorch version of the maha3c kernel: (B, 8) params and
    (B, 10, N) packed -> (B, 10)."""
    return maha3c_terms(params, packed, loss_code).sum(dim=-1)


def reproj_plain(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """Plain PyTorch version of the reproj kernel: (B, 20) params and
    (B, 6, N) packed -> (B, 28)."""
    return reproj_terms(params, packed, loss_code).sum(dim=-1)


def p2p_plain(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """Plain PyTorch version of the p2p kernel: (B, 16) params and
    (B, 10, N) packed -> (B, 28)."""
    return p2p_terms(params, packed, loss_code).sum(dim=-1)


# ----------------------------------------------------------------------------
# The wrappers
# ----------------------------------------------------------------------------


_ONE_PASS_ARGS = [
    ctypes.c_int,  # device
    ctypes.c_void_p,  # params
    ctypes.c_void_p,  # packed
    ctypes.c_int,  # batch
    ctypes.c_int64,  # n
    ctypes.c_int64,  # ld, the row stride
    ctypes.c_int,  # loss code
    ctypes.c_void_p,  # workspace: tile sums
    ctypes.c_void_p,  # counters
    ctypes.c_void_p,  # out
    ctypes.c_void_p,  # stream
]

# C function -> (argtypes, restype), for every function the wrappers call:
# the launches and the empty kernel.
_SIGNATURES = {
    **{f"nls_{k}_launch": (_ONE_PASS_ARGS, ctypes.c_int) for k in ONE_PASS},
    **{f"nls_{k}_bf16_launch": (_ONE_PASS_ARGS, ctypes.c_int) for k in BF16_ROWS},
    "nls_empty_launch": ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int),  # device, stream
}

# (kernel, C function) -> the typed ctypes function
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _fn(name: str, fn: str):
    """The C function ``fn`` of kernel ``name``'s library, typed; the
    library is built and loaded on first use."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(_build.load(name), fn)
        f.argtypes, f.restype = _SIGNATURES[fn]
        _FNS[(name, fn)] = f
    return f


def _check(name: str, params: Tensor, packed: Tensor, loss_code: int) -> Tuple[int, int]:
    """(batch, N) of a call of kernel ``name``, or a raise."""
    rows, n_params, _ = _SHAPES[name]
    if packed.dim() != 3 or packed.shape[1] != rows:
        raise ValueError(f"{name}: packed must be (B, {rows}, N), got {tuple(packed.shape)}")
    batch, n = packed.shape[0], packed.shape[2]
    if params.shape != (batch, n_params):
        raise ValueError(
            f"{name}: params must be ({batch}, {n_params}), got {tuple(params.shape)}"
        )
    row_types = (torch.float32, torch.bfloat16) if name in BF16_ROWS else (torch.float32,)
    if packed.dtype not in row_types or params.dtype != torch.float32:
        raise TypeError(
            f"{name} takes float32 params and "
            + ("float32 or bfloat16" if name in BF16_ROWS else "float32") + " packed"
        )
    if packed.device != params.device:
        raise ValueError("params and packed must be on one device")
    if not 0 <= loss_code < _NUM_LOSSES:
        raise ValueError(f"unknown loss code {loss_code}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {packed.device}")
    return batch, n


def _device_index(t: Tensor) -> int:
    return t.device.index if t.device.index is not None else 0


def _current_stream(index: int) -> int:
    """The handle of the current CUDA stream of device ``index``, without
    building a ``torch.cuda.Stream`` (which costs microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(index)


# (kernel, device index, stream) -> (tile sums, counters): the one-pass
# kernels' workspace for eager calls. Grown when a call needs more, never
# shared by two streams; the kernel leaves the counters at zero, so no call
# clears them.
_WORKSPACE: Dict[Tuple[str, int, int], Tuple[Tensor, Tensor]] = {}


def _workspace(name: str, device, index: int, stream: int, floats: int, batch: int):
    """(tile sums, counters) for a launch of one-pass kernel ``name`` on
    ``stream``. A call captured into a CUDA graph gets a workspace of its
    own from the graph's memory pool, its counters zeroed by a captured
    fill: a graph may replay on any stream, beside eager calls on its
    capture stream and beside other graphs, and no two launches that may
    run at once can share a counter."""
    if torch.cuda.is_current_stream_capturing():
        return (
            torch.empty(max(floats, 1), dtype=torch.float32, device=device),
            torch.zeros(batch, dtype=torch.int32, device=device),
        )
    ws = _WORKSPACE.get((name, index, stream))
    if ws is not None and ws[0].numel() >= floats and ws[1].numel() >= batch:
        return ws
    if ws is not None:
        floats = max(floats, 2 * ws[0].numel())
        batch = max(batch, 2 * ws[1].numel())
    ws = (
        torch.empty(max(floats, 1), dtype=torch.float32, device=device),
        torch.zeros(batch, dtype=torch.int32, device=device),
    )
    _WORKSPACE[(name, index, stream)] = ws
    return ws


def _one_pass_ld(name: str, packed: Tensor) -> int:
    """The row stride ld of a (B, rows, N) buffer that the one-pass kernel
    ``name`` can read: rows of unit stride starting every ld elements,
    ld a multiple of 16 bytes (4 floats, 8 bf16), problems every rows * ld
    elements, 16-byte aligned, and the last row's N lanes, rounded up to 16
    bytes (what the kernel reads), inside the storage. Raises otherwise."""
    batch, rows, n = packed.shape
    ld = packed.stride(1)
    if n == 0:
        return ld
    align = _lane_align(packed.dtype)
    end = packed.storage_offset() + (batch - 1) * packed.stride(0) + (rows - 1) * ld
    end += -(-n // align) * align  # past the last lane read
    if (
        packed.stride(2) != 1
        or ld < n
        or ld % align
        or (batch > 1 and packed.stride(0) != rows * ld)
        or packed.data_ptr() % 16
        or end * packed.element_size() > packed.untyped_storage().nbytes()
    ):
        raise ValueError(
            f"{name}: packed must be a (B, {rows}, N) view of a 16-byte-aligned "
            f"(B, {rows}, ld) buffer with ld % {align} == 0 (see lane_aligned), "
            f"got shape {tuple(packed.shape)}, strides {packed.stride()}"
        )
    return ld


def _onepass(name: str, params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """One-pass kernel ``name`` (:data:`ONE_PASS`, ``csrc/onepass.cuh``) on
    (B, params) and (B, rows, N) float32 (bf16 for :data:`BF16_ROWS`: the
    kernel's bf16-row instantiation) -> (B, out) float32: one device kernel
    on the current stream, not synchronised. CPU tensors take the plain
    version. A CUDA buffer must be laid out as :func:`lane_aligned` makes
    it, or the call raises."""
    batch, n = _check(name, params, packed, loss_code)
    if packed.device.type == "cpu":
        return _TERMS[name](params, packed, loss_code).sum(dim=-1)
    ld = _one_pass_ld(name, packed)
    if not params.is_contiguous():
        raise ValueError(f"{name} takes contiguous params")

    kernel = f"{name}_bf16" if packed.dtype == torch.bfloat16 else name
    n_out = _SHAPES[name][2]
    index = _device_index(packed)
    stream = _current_stream(index)
    # the cluster finish touches no workspace
    tile_sums = counters = None
    if onepass_cluster_blocks(n) == 0:
        floats = onepass_workspace_floats(batch, n, n_out)
        tile_sums, counters = _workspace(kernel, packed.device, index, stream, floats, batch)
    out = torch.empty((batch, n_out), dtype=torch.float32, device=packed.device)
    err = _fn(name, f"nls_{kernel}_launch")(
        index,
        params.data_ptr(),
        packed.data_ptr(),
        batch,
        n,
        ld,
        loss_code,
        None if tile_sums is None else tile_sums.data_ptr(),
        None if counters is None else counters.data_ptr(),
        out.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")
    LAUNCHES[kernel] += 1
    return out


def _empty_launch(device) -> None:
    """An empty kernel through the ctypes path the kernels take: the launch
    floor."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = _fn("maha6", "nls_empty_launch")(index, _current_stream(index))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError_t {err}")


def lane_aligned(packed: Tensor) -> Tensor:
    """``packed`` (..., rows, N) as the one-pass kernels read it on the
    card: the same values, as a view of a buffer whose rows start every
    ld = round_up(N, 4) floats (round_up(N, 8) bf16: 16-byte rows either
    way), 16-byte aligned, with lanes N .. ld - 1 zero (the mask row
    included). A contiguous buffer with N a multiple of the alignment comes
    back as it is. The packers call it for CUDA tensors only: PyTorch's
    sums on the CPU are not invariant to zero lanes, so CPU buffers stay as
    they are."""
    n = packed.shape[-1]
    pad = -n % _lane_align(packed.dtype)
    if pad:
        return torch.nn.functional.pad(packed, (0, pad))[..., :n]
    out = packed.contiguous()
    return out if out.data_ptr() % 16 == 0 else out.clone()


def maha6_partials(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 16) params and (B, 16, N) packed -> (B, 28) float32: per
    problem, the 21 upper-triangle entries of H, the 6 of g and the cost
    (``csrc/maha6.cu``; the plain version on the CPU). A CUDA buffer is laid
    out as :func:`lane_aligned` makes it; bf16 rows take the bf16-row
    instantiation (``LAUNCHES["maha6_bf16"]``)."""
    return _onepass("maha6", params, packed, loss_code)


def maha3_partials(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 8) params and (B, 16, N) packed -> (B, 10) float32: per problem,
    the 6 upper-triangle entries of the planar H, the 3 of g and the cost
    (``csrc/maha3.cu``; the plain version on the CPU). A CUDA buffer is laid
    out as :func:`lane_aligned` makes it; bf16 rows take the bf16-row
    instantiation (``LAUNCHES["maha3_bf16"]``)."""
    return _onepass("maha3", params, packed, loss_code)


def maha3c_partials(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 8) params and (B, 10, N) compact packed -> (B, 10) float32: per
    problem, the 6 upper-triangle entries of the planar H, the 3 of g and
    the cost (``csrc/maha3c.cu``; the plain version on the CPU). A CUDA
    buffer is laid out as :func:`lane_aligned` makes it."""
    return _onepass("maha3c", params, packed, loss_code)


def reproj_partials(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 20) params and (B, 6, N) packed -> (B, 28) float32: per problem,
    the 21 upper-triangle entries of H, the 6 of g and the cost
    (``csrc/reproj.cu``; the plain version on the CPU). A CUDA buffer is
    laid out as :func:`lane_aligned` makes it."""
    return _onepass("reproj", params, packed, loss_code)


def p2p_partials(params: Tensor, packed: Tensor, loss_code: int) -> Tensor:
    """(B, 16) params and (B, 10, N) packed -> (B, 28) float32: per
    problem, the 21 upper-triangle entries of H, the 6 of g and the cost
    (``csrc/p2p.cu``; the plain version on the CPU). A CUDA buffer is laid
    out as :func:`lane_aligned` makes it."""
    return _onepass("p2p", params, packed, loss_code)


def unpack_out(out: Tensor, dim: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(..., outputs) kernel output -> H (..., dim, dim), g (..., dim),
    cost (...)."""
    k = dim * (dim + 1) // 2
    return unpack_symmetric(out[..., :k], dim), out[..., k : k + dim], out[..., k + dim]


def unpack_maha6_out(out: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(..., 28) kernel output -> H (..., 6, 6), g (..., 6), cost (...)."""
    return unpack_out(out, 6)


# ----------------------------------------------------------------------------
# Packing and the JAX package's wrapper names
# ----------------------------------------------------------------------------


def pack_maha6(data: MahalanobisData, buffer_dtype: torch.dtype = torch.float32) -> Tensor:
    """(..., N, ...) SoA -> packed transposed (..., 16, N) rows (see the
    module docstring), for maha6 and maha3: contiguous on the CPU, laid out
    by :func:`lane_aligned` on the card. Once per solve, outside the LM
    loop.

    ``buffer_dtype=torch.bfloat16`` stores the rows in bf16 (half the bytes;
    the kernels widen them and compute in float32), the JAX package's
    ``pack_maha6(..., buffer_dtype=jnp.bfloat16)``: the data's values are
    rounded to bf16 once, to nearest even, from their own dtype. Float32
    is the default, and no solver of the port asks for bf16."""
    if buffer_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"buffer_dtype must be float32 or bfloat16, got {buffer_dtype}")
    infos = data.sqrt_infos.reshape(data.sqrt_infos.shape[:-2] + (9,))
    rows = torch.cat(
        [data.points, data.means, infos, data.mask[..., None]], dim=-1
    ).mT.to(buffer_dtype)  # (..., 16, N)
    return lane_aligned(rows) if rows.is_cuda else rows.contiguous()


def pack_maha3_compact(data: MahalanobisData) -> Tensor:
    """(N, ...) SoA -> compact (10, N) float32 rows for maha3c: u, mu_xy,
    and the pose-independent Gram quantities of each factor's residual
    rows r_i = a_i.(R2 u + t2 - mu_xy) + wz_i (a_i = S[i, :2],
    wz_i = S[i, 2] (p_z - mu_z)): M = sum_i a_i a_i^T, v = sum_i a_i wz_i,
    szz = sum_i wz_i^2. They are formed in the data's dtype and multiplied
    by the mask before the cast, as in the JAX package: contiguous on the
    CPU, laid out by :func:`lane_aligned` on the card. Once per solve."""
    S = data.sqrt_infos
    a0, a1 = S[:, :, 0], S[:, :, 1]  # (N, 3): the columns a_i[0], a_i[1]
    wz = S[:, :, 2] * (data.points[:, 2] - data.means[:, 2])[:, None]
    dot = lambda x, y: x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1] + x[:, 2] * y[:, 2]
    m = data.mask
    rows = torch.stack([
        data.points[:, 0], data.points[:, 1], data.means[:, 0], data.means[:, 1],
        dot(a0, a0) * m, dot(a0, a1) * m, dot(a1, a1) * m,
        dot(a0, wz) * m, dot(a1, wz) * m, dot(wz, wz) * m,
    ]).to(torch.float32)  # (10, N)
    return lane_aligned(rows) if rows.is_cuda else rows.contiguous()


def pack_reproj(data: ReprojectionData) -> Tensor:
    """(..., N, ...) SoA -> packed transposed (..., 6, N) float32 rows:
    contiguous on the CPU, laid out by :func:`lane_aligned` on the card.
    The JAX package's ``pack_reproj`` adds 2 zero rows, sublane padding for
    the TPU; they carry nothing and are left out."""
    rows = torch.cat(
        [data.local_points, data.matched_pixels, data.mask[..., None]], dim=-1
    )
    rows = rows.mT.to(torch.float32)
    return lane_aligned(rows) if rows.is_cuda else rows.contiguous()


def pack_p2p(data: PointToPlaneData) -> Tensor:
    """(..., N, ...) SoA -> packed transposed (..., 10, N) float32 rows:
    contiguous on the CPU, laid out by :func:`lane_aligned` on the card.
    The JAX package's ``pack_p2p`` adds 6 zero rows, sublane padding for
    the TPU; they carry nothing and are left out."""
    rows = torch.cat([data.points, data.means, data.normals, data.mask[..., None]], dim=-1)
    rows = rows.mT.to(torch.float32)
    return lane_aligned(rows) if rows.is_cuda else rows.contiguous()


def _eval(name, params_fn, dim, rotation, translation, packed, loss, loss_ab_fn=maha6_loss_ab):
    code, loss_ab = loss_ab_fn(loss, packed.device)
    params = params_fn(rotation, translation, loss_ab)
    lead = packed.dim() == 2  # one problem
    params = params[None] if lead else params.contiguous()
    out = _onepass(name, params, packed[None] if lead else packed, code)
    return unpack_out(out[0] if lead else out, dim)


def maha6_eval_quadratic_packed(rotation, translation, packed, loss):
    """(H (6, 6), g (6,), cost) from one (16, N) packed buffer: the
    counterpart of ``_maha6_pallas``. Inside an LM loop build the loss tail
    once with :func:`maha6_loss_ab` and call :func:`maha6_partials`."""
    return _eval("maha6", maha6_params, 6, rotation, translation, packed, loss)


def maha6_eval_quadratic_packed_v(rotation, translation, packed, loss):
    """Batched form, the counterpart of ``_maha6_pallas_v``: rotations
    (B, 3, 3), translations (B, 3) and packed (B, 16, N) -> H (B, 6, 6),
    g (B, 6), cost (B,), in one launch."""
    return _eval("maha6", maha6_params, 6, rotation, translation, packed, loss)


def maha6_eval_quadratic(rotation, translation, data: MahalanobisData, loss):
    """Drop-in replacement for ops.mahalanobis.eval_quadratic (packs on
    every call; an LM loop packs once)."""
    return maha6_eval_quadratic_packed(rotation, translation, pack_maha6(data), loss)


def maha3_eval_quadratic_packed(rotation2, translation2, packed, loss):
    """(H (3, 3), g (3,), cost) from one (16, N) packed buffer: the
    counterpart of ``_maha3_pallas``."""
    return _eval("maha3", maha3_params, 3, rotation2, translation2, packed, loss)


def maha3_eval_quadratic_packed_v(rotation2, translation2, packed, loss):
    """Batched form, the counterpart of ``_maha3_pallas_v``: (B, 2, 2),
    (B, 2) and (B, 16, N) -> H (B, 3, 3), g (B, 3), cost (B,)."""
    return _eval("maha3", maha3_params, 3, rotation2, translation2, packed, loss)


def maha3_eval_quadratic(rotation2, translation2, data: MahalanobisData, loss):
    """Drop-in replacement for ops.mahalanobis.eval_quadratic_3dof."""
    return maha3_eval_quadratic_packed(rotation2, translation2, pack_maha6(data), loss)


def maha3_eval_quadratic_compact(rotation2, translation2, packed_compact, loss):
    """(H (3, 3), g (3,), cost) from one (10, N) compact buffer
    (:func:`pack_maha3_compact`): the counterpart of ``_maha3c_pallas``.
    Agrees with :func:`maha3_eval_quadratic_packed` to float32 rounding:
    the Gram form reassociates the row-by-row sum."""
    return _eval("maha3c", maha3_params, 3, rotation2, translation2, packed_compact, loss)


def reproj_eval_quadratic_packed(rotation, translation, packed, intrinsics, loss):
    """(H (6, 6), g (6,), cost) from one (6, N) packed buffer: the
    counterpart of ``_reproj_pallas``."""
    params_fn = lambda R, t, loss_ab: reproj_params(R, t, intrinsics, loss_ab)
    return _eval("reproj", params_fn, 6, rotation, translation, packed, loss, reproj_loss_ab)


def reproj_eval_quadratic(rotation, translation, data: ReprojectionData, intrinsics, loss):
    """Drop-in replacement for ops.reprojection.eval_quadratic."""
    return reproj_eval_quadratic_packed(rotation, translation, pack_reproj(data), intrinsics, loss)


def p2p_eval_quadratic_packed(rotation, translation, packed, loss):
    """(H (6, 6), g (6,), cost) from one (10, N) packed buffer: the
    counterpart of ``_p2p_pallas``."""
    return _eval("p2p", maha6_params, 6, rotation, translation, packed, loss)


def p2p_eval_quadratic_packed_v(rotation, translation, packed, loss):
    """Batched form, the counterpart of ``_p2p_pallas_v``: (B, 3, 3),
    (B, 3) and (B, 10, N) -> H (B, 6, 6), g (B, 6), cost (B,)."""
    return _eval("p2p", maha6_params, 6, rotation, translation, packed, loss)


def p2p_eval_quadratic(rotation, translation, data: PointToPlaneData, loss):
    """Drop-in replacement for ops.point_to_plane.eval_quadratic."""
    return p2p_eval_quadratic_packed(rotation, translation, pack_p2p(data), loss)
