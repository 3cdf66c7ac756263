"""Plain NumPy reference of point-to-NDT scan registration: the semantics
of the upstream C++ test ``mahalanobis_distance_minimizer/tests/
simple_optimization_test.cc`` (map update, FLANN radius search, the
analytic minimizer's damped Gauss-Newton loop and the outer ICP loop),
written for the benchmark's check. It imports nothing of the program
under test and takes nothing it made: it builds the map again from the
same points.

What the C++ test does, and this file does again:

- voxel key ``floor(p * (1 / resolution))`` per axis; a voxel's second
  moment starts at the identity (``types.h``: ``moment{Identity()}``),
  then adds p p^T point by point in input order; valid voxels have at
  least 5 points and a largest eigenvalue of at least 0.01; the two
  smaller eigenvalues are floored at 0.01 of the largest;
- sqrt-information ``D^{-1/2} V`` with V's columns the eigenvectors of
  Eigen's ``SelfAdjointEigenSolver``. That product depends on the
  eigenvector basis (signs, and the rotation inside the degenerate
  in-plane subspace of a wall or floor voxel), so :func:`eigh3` follows
  Eigen's algorithm step for step: another eigensolver gives another
  objective;
- each warped point matches its 2 nearest voxel means within 1 m (ties
  to the lower voxel index); residual ``S (R p + t - mu)``, loss
  ``rho(s) = 1 - exp(-s)`` with the reference's ``rho' = 2 exp(-s)``;
- the LM loop of ``mahalanobis_distance_minimizer_analytic.cc``: H's
  diagonal times (1 + lambda), the step applied before the stop tests
  (step or gradient norm under 1e-6), lambda x2 on a cost increase and
  x0.6 otherwise, clamped to [1e-6, 1e-2], 40 iterations at most; the
  pose updated as t + dt, q (x) exp(dr);
- up to 10 outer iterations, ending when the pose moves by less than
  1e-5 in translation and in the quaternion's vector part.

``register`` runs in float64. With ``bf16_rows=True`` it is the
benchmark's control: the matched rows (points, means, sqrt-informations)
rounded to bfloat16 and everything computed in float32, as the kernels'
bf16-row instantiation would compute it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MIN_POINTS = 5
MIN_EIGENVALUE = 0.01
EIGENVALUE_RATIO = 0.01
SEARCH_RADIUS = 1.0
NEIGHBORS = 2
MAX_OUTER = 10
OUTER_TOLERANCE = 1e-5
MAX_ITERATIONS = 40
STEP_TOLERANCE = 1e-6
GRADIENT_TOLERANCE = 1e-6
LAMBDA0, LAMBDA_MIN, LAMBDA_MAX = 1e-3, 1e-6, 1e-2
LAMBDA_UP, LAMBDA_DOWN = 2.0, 0.6

_TINY = np.finfo(np.float64).tiny
_EPS = np.finfo(np.float64).eps


@dataclasses.dataclass
class Map:
    """The valid voxels: means (M, 3) and sqrt-informations (M, 3, 3)."""

    means: np.ndarray
    sqrt_infos: np.ndarray


@dataclasses.dataclass
class Registration:
    rotation: np.ndarray  # (3, 3)
    translation: np.ndarray  # (3,)
    final_cost: float
    outer_iterations: int
    trace: list  # (final cost, iterations) of each inner solve


# ---------------------------------------------------------------- the map


def _givens(p, q):
    """Eigen's ``JacobiRotation::makeGivens`` for reals: (c, s)."""
    if q == 0.0:
        return (-1.0 if p < 0.0 else 1.0), 0.0
    if p == 0.0:
        return 0.0, (1.0 if q < 0.0 else -1.0)
    if abs(p) > abs(q):
        t = q / p
        u = np.sqrt(1.0 + t * t)
        u = -u if p < 0.0 else u
        c = 1.0 / u
        return c, -t * c
    t = p / q
    u = np.sqrt(1.0 + t * t)
    u = -u if q < 0.0 else u
    s = -1.0 / u
    return -t * s, s


def _hypot(x, y):
    """Eigen's ``numext::hypot``: p sqrt(1 + (q / p)^2)."""
    x, y = abs(x), abs(y)
    p = max(x, y)
    if p == 0.0:
        return 0.0
    r = min(x, y) / p
    return p * np.sqrt(1.0 + r * r)


def eigh3(A):
    """Eigen's ``SelfAdjointEigenSolver<Matrix3d>::compute`` on the lower
    triangle of A: scale by the largest entry, Householder
    tridiagonalisation, implicit symmetric QR with Wilkinson shifts,
    selection sort ascending. Returns (eigenvalues (3,), eigenvectors as
    columns (3, 3))."""
    a00, a10, a20, a11, a21, a22 = A[0, 0], A[1, 0], A[2, 0], A[1, 1], A[2, 1], A[2, 2]
    scale = max(abs(a00), abs(a10), abs(a20), abs(a11), abs(a21), abs(a22)) or 1.0
    a00, a10, a20, a11, a21, a22 = (v / scale for v in (a00, a10, a20, a11, a21, a22))
    d = np.array([a00, 0.0, 0.0])
    e = np.zeros(2)
    if a20 * a20 <= _TINY:
        d[1], d[2], e[0], e[1] = a11, a22, a10, a21
        Q = np.eye(3)
    else:
        beta = np.sqrt(a10 * a10 + a20 * a20)
        inv_beta = 1.0 / beta
        h1, h2 = a10 * inv_beta, a20 * inv_beta
        w = 2.0 * h1 * a21 + h2 * (a22 - a11)
        d[1], d[2] = a11 + h2 * w, a22 - h2 * w
        e[0], e[1] = beta, a21 - h1 * w
        Q = np.array([[1.0, 0.0, 0.0], [0.0, h1, h2], [0.0, h2, -h1]])
    end, start, sweeps = 2, 0, 0
    while end > 0:
        for i in range(start, end):
            if abs(e[i]) < _TINY:
                e[i] = 0.0
            else:
                big = e[i] / _EPS
                if big * big <= abs(d[i]) + abs(d[i + 1]):
                    e[i] = 0.0
        while end > 0 and e[end - 1] == 0.0:
            end -= 1
        if end <= 0:
            break
        sweeps += 1
        if sweeps > 90:
            break
        start = end - 1
        while start > 0 and e[start - 1] != 0.0:
            start -= 1
        td = (d[end - 1] - d[end]) * 0.5
        ee = e[end - 1]
        mu = d[end]
        if td == 0.0:
            mu -= abs(ee)
        elif ee != 0.0:
            h = _hypot(td, ee)
            den = td + (h if td > 0.0 else -h)
            ee2 = ee * ee
            mu -= ee / (den / ee) if ee2 == 0.0 else ee2 / den
        x, z = d[start] - mu, e[start]
        for k in range(start, end):
            if z == 0.0:
                break
            c, s = _givens(x, z)
            sdk = s * d[k] + c * e[k]
            dk1 = s * e[k] + c * d[k + 1]
            d[k] = c * (c * d[k] - s * e[k]) - s * (c * e[k] - s * d[k + 1])
            d[k + 1] = s * sdk + c * dk1
            e[k] = c * sdk - s * dk1
            if k > start:
                e[k - 1] = c * e[k - 1] - s * z
            x = e[k]
            if k < end - 1:
                z = -s * e[k + 1]
                e[k + 1] = c * e[k + 1]
            qk, qk1 = Q[:, k].copy(), Q[:, k + 1].copy()
            Q[:, k] = c * qk - s * qk1
            Q[:, k + 1] = s * qk + c * qk1
    for i in range(2):
        k = i + int(np.argmin(d[i:]))
        if k > i:
            d[[i, k]] = d[[k, i]]
            Q[:, [i, k]] = Q[:, [k, i]]
    return d * scale, Q


def build_map(points: np.ndarray, resolution: float) -> Map:
    """The valid voxels of the C++ test's map update over ``points``."""
    points = np.asarray(points, np.float64)
    keys = np.floor(points * (1.0 / resolution)).astype(np.int64)
    _, voxel, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    voxel = voxel.reshape(-1)
    M = counts.shape[0]
    sums = np.zeros((M, 3))
    np.add.at(sums, voxel, points)  # point by point, in input order
    moments = np.tile(np.eye(3), (M, 1, 1))
    np.add.at(moments, voxel, points[:, :, None] * points[:, None, :])
    means = sums / counts[:, None]
    covs = moments / counts[:, None, None] - means[:, :, None] * means[:, None, :]
    means_out, sqrt_out = [], []
    for m in range(M):
        lam, V = eigh3(covs[m])
        if counts[m] < MIN_POINTS or lam[2] < MIN_EIGENVALUE:
            continue
        lam[:2] = np.maximum(lam[:2], EIGENVALUE_RATIO * lam[2])
        means_out.append(means[m])
        sqrt_out.append((1.0 / np.sqrt(lam))[:, None] * V)  # D^{-1/2} V
    return Map(np.array(means_out), np.array(sqrt_out))


def voxel_filter(points: np.ndarray, size: float) -> np.ndarray:
    """The C++ test's scan filter: the first point of each voxel of side
    ``size``, in input order."""
    keys = np.floor(np.asarray(points) * (1.0 / size)).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return np.asarray(points)[np.sort(first)]


# ---------------------------------------------------------- registration


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _quat_to_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=q.dtype)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dtype=a.dtype)


def _exp_quat(w):
    theta = np.sqrt(np.sum(w * w))
    if theta < 1e-6:
        return np.concatenate([[1.0], 0.5 * w]).astype(w.dtype)
    return np.concatenate([[np.cos(0.5 * theta)], np.sin(0.5 * theta) / theta * w]).astype(w.dtype)


def rot_to_quat(R):
    """(w, x, y, z) of a rotation matrix (Shepperd's largest pivot)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    pivots = [1.0 + tr, 1.0 + R[0, 0] - R[1, 1] - R[2, 2],
              1.0 - R[0, 0] + R[1, 1] - R[2, 2], 1.0 - R[0, 0] - R[1, 1] + R[2, 2]]
    i = int(np.argmax(pivots))
    s = 2.0 * np.sqrt(max(pivots[i], 0.0))
    a, b, c = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    d, f, g = R[0, 1] + R[1, 0], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1]
    q = [np.array([s / 4, a / s, b / s, c / s]), np.array([a / s, s / 4, d / s, f / s]),
         np.array([b / s, d / s, s / 4, g / s]), np.array([c / s, f / s, g / s, s / 4])][i]
    return q if q[0] >= 0.0 else -q


def match(ndt: Map, points, R, t, dtype):
    """The matched rows at pose (R, t): (points, means, sqrt-informations,
    mask) with 2 rows a point, the nearest voxel first."""
    warped = points @ R.T + t
    d2 = np.sum((warped[:, None, :] - ndt.means.astype(dtype)[None]) ** 2, axis=-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :NEIGHBORS]
    near = np.take_along_axis(d2, idx, axis=1)
    mask = (near <= SEARCH_RADIUS * SEARCH_RADIUS).astype(dtype).reshape(-1)
    flat = idx.reshape(-1)
    return (np.repeat(points, NEIGHBORS, axis=0), ndt.means[flat].astype(dtype),
            ndt.sqrt_infos[flat].astype(dtype), mask)


def _quadratic(rows, R, t):
    """(H, g, cost) of the matched rows at (R, t)."""
    p, mu, S, mask = rows
    dt = p.dtype
    r = np.einsum("nij,nj->ni", S, p @ R.T + t - mu)
    s = np.sum(r * r, axis=1)
    x = -s
    ex = np.where(x > -np.log(2.0), 1.0 + np.expm1(x), np.exp(x)).astype(dt)
    rho = (1.0 - ex) * mask
    w = 2.0 * ex * mask
    SR = S @ R  # (n, 3, 3)
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cross = np.stack([SR[:, :, 1] * pz - SR[:, :, 2] * py,
                      SR[:, :, 2] * px - SR[:, :, 0] * pz,
                      SR[:, :, 0] * py - SR[:, :, 1] * px], axis=-1)
    J = np.concatenate([S, -cross], axis=-1).reshape(-1, 6)  # (3 n, 6)
    Jw = J * np.repeat(w, 3)[:, None]
    return Jw.T @ J, Jw.T @ r.reshape(-1), np.sum(rho)


def _lm(rows, q, t):
    """The analytic minimizer's loop from (q, t): (q, t, final cost,
    iterations as the C++ counter reports them)."""
    dt = t.dtype
    lam, previous = LAMBDA0, np.finfo(dt).max
    cost, count, converged = None, 0, False
    for _ in range(MAX_ITERATIONS):
        H, g, cost = _quadratic(rows, _quat_to_rot(q), t)
        H = H.copy()
        H[np.diag_indices(6)] *= dt.type(1.0 + lam)
        delta = np.linalg.solve(H, -g)
        if not np.all(np.isfinite(delta)):
            delta = np.zeros_like(delta)
        t = t + delta[:3]
        q = _quat_mul(q, _exp_quat(delta[3:]))
        q = q / np.sqrt(np.sum(q * q))
        count += 1
        if np.sqrt(np.sum(delta * delta)) < STEP_TOLERANCE or np.sqrt(np.sum(g * g)) < GRADIENT_TOLERANCE:
            converged = True
            break
        lam = min(max(lam * (LAMBDA_UP if cost > previous else LAMBDA_DOWN), LAMBDA_MIN), LAMBDA_MAX)
        previous = cost
    return q, t, float(cost), count - 1 if converged else count


def register(ndt: Map, local_points: np.ndarray, bf16_rows: bool = False) -> Registration:
    """Register ``local_points`` against ``ndt`` from the identity."""
    dt = np.float32 if bf16_rows else np.float64
    ndt_dt = Map(ndt.means.astype(dt), ndt.sqrt_infos.astype(dt))
    points = np.asarray(local_points, dt)
    q = np.array([1.0, 0.0, 0.0, 0.0], dt)
    t = np.zeros(3, dt)
    last_R, last_t = np.eye(3), np.zeros(3)
    trace, outer = [], 0
    for outer in range(MAX_OUTER):
        rows = match(ndt_dt, points, _quat_to_rot(q), t, dt)
        if bf16_rows:
            rows = (bf16(rows[0]), bf16(rows[1]), bf16(rows[2]), rows[3])
        q, t, cost, iterations = _lm(rows, q, t)
        trace.append((cost, iterations))
        R = _quat_to_rot(q.astype(np.float64))
        t64 = t.astype(np.float64)
        d_rot = R.T @ last_R
        d_t = R.T @ (last_t - t64)
        if np.linalg.norm(d_t) < OUTER_TOLERANCE and np.linalg.norm(rot_to_quat(d_rot)[1:]) < OUTER_TOLERANCE:
            break
        last_R, last_t = R, t64
    q64 = q.astype(np.float64)
    q64 /= np.linalg.norm(q64)
    return Registration(_quat_to_rot(q64), t.astype(np.float64), trace[-1][0], outer, trace)
