"""Plain NumPy and SciPy reference of a 2-D pose-graph solve from a g2o
file, written for the benchmark's check. It imports nothing of the
program under test and takes nothing it made: it reads the same file and
works out its own start.

- the file: ``VERTEX_SE2 id x y theta``, ``EDGE_SE2 i j dx dy dtheta``
  with the upper triangle of the 3 x 3 information (I11 I12 I13 I22 I23
  I33), ``FIX id``; without a FIX the lowest id is held;
- the error of an edge is g2o's ``t2v(Z^-1 (X_i^-1 X_j))``:
  ``Rz^T (Ri^T (tj - ti) - tz)`` and ``wrap(th_j - th_i - th_z)``; the
  cost is the sum of ``e^T Info e``;
- the start: chordal relaxation, unweighted: the rotations as unit
  vectors by linear least squares (``v_j = R(th_z) v_i``), normalised,
  then the translations by linear least squares with the rotations held;
- the solve: Gauss-Newton on the sparse normal equations in float64
  (``scipy.sparse.linalg.splu``), with Levenberg-Marquardt damping
  raised only on a step that does not lower the cost, run until a step
  moves no coordinate by more than 1e-11 or the cost stops falling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

_TRI = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


@dataclasses.dataclass
class Graph:
    ids: np.ndarray  # (P,) vertex ids, sorted
    xyt: np.ndarray  # (P, 3) the file's vertices
    i: np.ndarray  # (E,) row of the reference vertex
    j: np.ndarray  # (E,) row of the query vertex
    z: np.ndarray  # (E, 3) measurements
    info: np.ndarray  # (E, 3, 3)
    fixed: np.ndarray  # (F,) rows held


def read_g2o(path) -> Graph:
    vertices, edges, fixed = {}, [], []
    with open(path) as f:
        for line in f:
            w = line.split()
            if not w:
                continue
            if w[0] == "VERTEX_SE2":
                vertices[int(w[1])] = [float(v) for v in w[2:5]]
            elif w[0] == "EDGE_SE2":
                edges.append((int(w[1]), int(w[2]), [float(v) for v in w[3:12]]))
            elif w[0] == "FIX":
                fixed.append(int(w[1]))
    ids = np.array(sorted(vertices))
    row = {v: k for k, v in enumerate(ids)}
    info = np.zeros((len(edges), 3, 3))
    for e, (_, _, vals) in enumerate(edges):
        for (a, b), v in zip(_TRI, vals[3:]):
            info[e, a, b] = info[e, b, a] = v
    return Graph(
        ids=ids,
        xyt=np.array([vertices[v] for v in ids]),
        i=np.array([row[a] for a, _, _ in edges]),
        j=np.array([row[b] for _, b, _ in edges]),
        z=np.array([vals[:3] for _, _, vals in edges]),
        info=info,
        fixed=np.array([row[v] for v in fixed] or [0]),
    )


def wrap(a):
    return (a + np.pi) % (2.0 * np.pi) - np.pi


def _lstsq(rows, cols, vals, rhs, n, free):
    """min |A x - rhs| over the free columns of the sparse A (the others
    are already moved into ``rhs``)."""
    A = sp.csc_matrix((vals, (rows, cols)), shape=(len(rhs), n))[:, free]
    x = np.zeros(n)
    x[free] = spla.splu((A.T @ A).tocsc()).solve(A.T @ rhs)
    return x


def chordal(g: Graph) -> np.ndarray:
    """The chordal start: (P, 3)."""
    P, E = len(g.ids), len(g.i)
    free = np.setdiff1d(np.arange(2 * P), np.concatenate([2 * g.fixed, 2 * g.fixed + 1]))
    c, s = np.cos(g.z[:, 2]), np.sin(g.z[:, 2])
    known = np.zeros(2 * P)
    known[2 * g.fixed] = np.cos(g.xyt[g.fixed, 2])
    known[2 * g.fixed + 1] = np.sin(g.xyt[g.fixed, 2])
    # v_j - R v_i = 0: rows 2e, 2e + 1
    e2 = 2 * np.arange(E)
    rows = np.concatenate([e2, e2 + 1, e2, e2, e2 + 1, e2 + 1])
    cols = np.concatenate([2 * g.j, 2 * g.j + 1, 2 * g.i, 2 * g.i + 1, 2 * g.i, 2 * g.i + 1])
    vals = np.concatenate([np.ones(E), np.ones(E), -c, s, -s, -c])
    A = sp.csc_matrix((vals, (rows, cols)), shape=(2 * E, 2 * P))
    v = _lstsq(rows, cols, vals, -(A @ known), 2 * P, free) + known
    v = v.reshape(P, 2)
    theta = np.arctan2(v[:, 1], v[:, 0])
    theta[g.fixed] = g.xyt[g.fixed, 2]
    # t_j - t_i = R(th_i) t_z
    ci, si = np.cos(theta[g.i]), np.sin(theta[g.i])
    rhs = np.empty(2 * E)
    rhs[0::2] = ci * g.z[:, 0] - si * g.z[:, 1]
    rhs[1::2] = si * g.z[:, 0] + ci * g.z[:, 1]
    rows = np.concatenate([e2, e2 + 1, e2, e2 + 1])
    cols = np.concatenate([2 * g.j, 2 * g.j + 1, 2 * g.i, 2 * g.i + 1])
    vals = np.concatenate([np.ones(E), np.ones(E), -np.ones(E), -np.ones(E)])
    known = np.zeros(2 * P)
    known[2 * g.fixed], known[2 * g.fixed + 1] = g.xyt[g.fixed, 0], g.xyt[g.fixed, 1]
    A = sp.csc_matrix((vals, (rows, cols)), shape=(2 * E, 2 * P))
    t = (_lstsq(rows, cols, vals, rhs - A @ known, 2 * P, free) + known).reshape(P, 2)
    return np.concatenate([t, theta[:, None]], axis=1)


def residuals(g: Graph, xyt: np.ndarray):
    """Whitened residuals (E, 3) and their Jacobians (E, 3, 3) by the
    reference and by the query vertex."""
    ti, tj, th = xyt[g.i, :2], xyt[g.j, :2], xyt[g.i, 2]
    c, s = np.cos(th), np.sin(th)
    cz, sz = np.cos(g.z[:, 2]), np.sin(g.z[:, 2])
    RiT = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], 1)  # (E, 2, 2)
    RzT = np.stack([np.stack([cz, sz], -1), np.stack([-sz, cz], -1)], 1)
    dRiT = np.stack([np.stack([-s, c], -1), np.stack([-c, -s], -1)], 1)
    d = tj - ti
    A = RzT @ RiT
    e = np.empty((len(g.i), 3))
    e[:, :2] = (A @ d[:, :, None])[:, :, 0] - (RzT @ g.z[:, :2, None])[:, :, 0]
    e[:, 2] = wrap(xyt[g.j, 2] - th - g.z[:, 2])
    Ji = np.zeros((len(g.i), 3, 3))
    Jj = np.zeros((len(g.i), 3, 3))
    Ji[:, :2, :2], Jj[:, :2, :2] = -A, A
    Ji[:, :2, 2] = (RzT @ dRiT @ d[:, :, None])[:, :, 0]
    Ji[:, 2, 2], Jj[:, 2, 2] = -1.0, 1.0
    LT = np.linalg.cholesky(g.info).transpose(0, 2, 1)  # info = L L^T, r = L^T e
    return (LT @ e[:, :, None])[:, :, 0], LT @ Ji, LT @ Jj


def cost(g: Graph, xyt: np.ndarray) -> float:
    r, _, _ = residuals(g, xyt)
    return float(np.sum(r * r))


def solve(g: Graph, xyt0: np.ndarray, max_iterations: int = 100):
    """(xyt, cost, iterations) from ``xyt0``, the fixed vertices held."""
    P, E = len(g.ids), len(g.i)
    free = np.setdiff1d(np.arange(3 * P), (3 * g.fixed[:, None] + np.arange(3)).ravel())
    xyt, lam = xyt0.copy(), 0.0
    r, Ji, Jj = residuals(g, xyt)
    f = float(np.sum(r * r))
    rows = np.repeat(3 * np.arange(E)[:, None] + np.arange(3), 3, axis=1)  # (E, 3, 3)
    cols_of = lambda v: np.broadcast_to(3 * v[:, None, None] + np.arange(3), (E, 3, 3))
    k = 0
    for k in range(1, max_iterations + 1):
        J = sp.csc_matrix(
            (np.concatenate([Ji.ravel(), Jj.ravel()]),
             (np.concatenate([rows.ravel(), rows.ravel()]),
              np.concatenate([cols_of(g.i).ravel(), cols_of(g.j).ravel()]))),
            shape=(3 * E, 3 * P))[:, free]
        H = (J.T @ J).tocsc()
        b = -(J.T @ r.ravel())
        while True:
            step = np.zeros(3 * P)
            step[free] = spla.splu((H + lam * sp.diags(H.diagonal())).tocsc()).solve(b)
            trial = xyt + step.reshape(P, 3)
            r2, Ji2, Jj2 = residuals(g, trial)
            f2 = float(np.sum(r2 * r2))
            if f2 <= f or lam > 1e8:
                break
            lam = max(1e-9, 10.0 * lam)
        if f2 > f:  # no descent at the largest damping: at the optimum
            break
        fell = f - f2
        xyt, r, Ji, Jj, f = trial, r2, Ji2, Jj2, f2
        lam *= 0.1
        if np.max(np.abs(step)) < 1e-11 or fell <= 1e-15 * f:
            break
    xyt[:, 2] = wrap(xyt[:, 2])
    return xyt, f, k
