"""The maha3 and p2p kernels' plain versions against the JAX package.

On the CPU the kernel wrappers of ``ops/cuda_kernels`` run their plain
PyTorch versions (the kernels' arithmetic and output order; the CUDA
sources are checked with g++ in tests/test_torch_factor_math.py). Here
those go up against the Pallas kernels themselves, ``pk.maha3_eval_quadratic``
and ``pk.p2p_eval_quadratic`` run in interpret mode as tests/test_pallas.py
runs them, and against the JAX plain evaluations
(``mahalanobis.eval_quadratic_3dof``, ``point_to_plane.eval_quadratic``):
at N = 700 (not a block multiple) for all 7 losses and for a batch of 3
ragged problems in one buffer, float32, with the tolerance of
tests/test_pallas.py:75-83 (rtol 2e-5, atol 1e-4: two float32 sums in
different orders). p2p's terms are also summed in the one-pass kernel's
order (``utils.testing.onepass_emulate``, ``csrc/onepass.cuh``) and held
to the Pallas kernel at N = 700 and 1,025 (three 512-lane tiles) for all 7
losses, with the same tolerance. The port's plain factor code (the
registrar's "torch" path) is held to the JAX one in float64 at 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core import losses as jlosses
from nonlinear_optimizer_for_slam_tpu.core import lie as jlie
from nonlinear_optimizer_for_slam_tpu.ops import mahalanobis as jmaha
from nonlinear_optimizer_for_slam_tpu.ops import pallas_kernels as pk
from nonlinear_optimizer_for_slam_tpu.ops import point_to_plane as jp2p
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.core import lie
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis as tmaha
from nonlinear_optimizer_for_slam_tpu_torch.ops import point_to_plane as tp2p
from nonlinear_optimizer_for_slam_tpu_torch.utils import testing

LOSS_ARGS = [
    ("TrivialLoss", ()),
    ("ExponentialLoss", (1.3, 0.4)),
    ("HuberLoss", (2.0,)),
    ("CauchyLoss", (1.5,)),
    ("TukeyLoss", (1.8,)),
    ("GemanMcClureLoss", (1.2,)),
    ("DCSLoss", (2.5,)),
]
SIZES = (700, 300, 1000)  # N of the single problem, then a ragged batch of 3
RTOL, ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny ops, which
    more threads only slow down, most of all when test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _losses(name, args):
    return getattr(port, name)(*args), getattr(jlosses, name)(*args)


def _maha_rows(rng, n):
    rows = np.concatenate(
        [rng.normal(size=(n, 6)), 0.5 * rng.normal(size=(n, 9)),
         (rng.uniform(size=(n, 1)) > 0.1).astype(np.float64)],
        axis=1,
    )
    return rows.astype(np.float32)  # (n, 16): p, mu, S, mask


def _p2p_rows(rng, n):
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    rows = np.concatenate(
        [rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), normals,
         (rng.uniform(size=(n, 1)) > 0.1).astype(np.float64)],
        axis=1,
    )
    return rows.astype(np.float32)  # (n, 10): p, mu, n, mask


@pytest.fixture(scope="module")
def problems(rng):
    """Per size: maha rows, p2p rows, a planar pose (theta, t2) and a 6-DoF
    pose (R, t), all float32."""
    out = []
    for n in SIZES:
        theta = rng.uniform(-0.5, 0.5)
        axis = rng.normal(size=3)
        pose = port.Pose.from_axis_angle(rng.uniform(0.1, 0.6), axis, 0.3 * rng.normal(size=3))
        out.append((
            _maha_rows(rng, n), _p2p_rows(rng, n),
            np.float32(theta), rng.normal(size=2).astype(np.float32),
            pose.rotation.astype(np.float32), pose.translation.astype(np.float32),
        ))
    return out


def _jax_maha(rows):
    n = rows.shape[0]
    return jmaha.MahalanobisData(
        jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3:6]),
        jnp.asarray(rows[:, 6:15].reshape(n, 3, 3)), jnp.asarray(rows[:, 15]),
    )


def _jax_p2p(rows):
    return jp2p.PointToPlaneData(
        jnp.asarray(rows[:, 0:3]), jnp.asarray(rows[:, 3:6]),
        jnp.asarray(rows[:, 6:9]), jnp.asarray(rows[:, 9]),
    )


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=[n for n, _ in LOSS_ARGS])
def test_maha3_plain_matches_pallas_and_jnp(problems, loss_name, loss_args):
    rows, _, theta, t2, _, _ = problems[0]
    tloss, jloss = _losses(loss_name, loss_args)
    R2 = jnp.asarray(np.array(jlie.rot2(jnp.asarray(theta))), jnp.float32)
    data = _jax_maha(rows)
    want_pallas = pk.maha3_eval_quadratic(R2, jnp.asarray(t2), data, jloss)
    want_jnp = jmaha.eval_quadratic_3dof(R2, jnp.asarray(t2), data, jloss)
    got = ck.maha3_eval_quadratic_packed(
        torch.as_tensor(np.array(R2)), torch.as_tensor(t2),
        torch.as_tensor(rows.T.copy()), tloss,
    )
    _close(got, want_pallas)
    _close(got, want_jnp)


@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=[n for n, _ in LOSS_ARGS])
def test_p2p_plain_matches_pallas_and_jnp(problems, loss_name, loss_args):
    _, rows, _, _, R, t = problems[0]
    tloss, jloss = _losses(loss_name, loss_args)
    data = _jax_p2p(rows)
    want_pallas = pk.p2p_eval_quadratic(jnp.asarray(R), jnp.asarray(t), data, jloss)
    want_jnp = jp2p.eval_quadratic(jnp.asarray(R), jnp.asarray(t), data, jloss)
    got = ck.p2p_eval_quadratic_packed(
        torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(rows.T.copy()), tloss
    )
    _close(got, want_pallas)
    _close(got, want_jnp)


@pytest.mark.parametrize("n", [700, 1025])
@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=[n for n, _ in LOSS_ARGS])
def test_p2p_onepass_order_matches_pallas(loss_name, loss_args, n):
    """The port's per-factor terms (``p2p_terms``, the kernel's arithmetic)
    added in the one-pass kernel's order, one float32 addition at a time,
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n)
    rows = _p2p_rows(rng, n)
    pose = port.Pose.from_axis_angle(rng.uniform(0.1, 0.6), rng.normal(size=3),
                                     0.3 * rng.normal(size=3))
    R, t = pose.rotation.astype(np.float32), pose.translation.astype(np.float32)
    tloss, jloss = _losses(loss_name, loss_args)
    code, loss_ab = ck.maha6_loss_ab(tloss, "cpu")
    params = ck.maha6_params(torch.as_tensor(R)[None], torch.as_tensor(t)[None], loss_ab)
    terms = ck.p2p_terms(params, torch.as_tensor(rows.T.copy())[None], code)[0].numpy()
    got = ck.unpack_out(torch.as_tensor(testing.onepass_emulate(terms)), 6)
    want = pk.p2p_eval_quadratic(jnp.asarray(R), jnp.asarray(t), _jax_p2p(rows), jloss)
    _close(got, want)


@pytest.mark.parametrize("kernel", ["maha3", "p2p"])
def test_ragged_batch_matches_pallas(problems, kernel):
    """Three problems of N = 700, 300 and 1000 in one zero-padded (3, rows,
    1000) buffer, one call of the batched wrapper, each against the Pallas
    kernel on its own rows."""
    tloss, jloss = _losses("ExponentialLoss", (1.0, 1.0))
    idx = 0 if kernel == "maha3" else 1
    rows_max = max(p[idx].shape[0] for p in problems)
    packed = np.zeros((3, problems[0][idx].shape[1], rows_max), np.float32)
    for b, p in enumerate(problems):
        packed[b, :, : p[idx].shape[0]] = p[idx].T
    packed = torch.as_tensor(packed)
    if kernel == "maha3":
        theta = torch.as_tensor(np.stack([p[2] for p in problems]))
        t2 = torch.as_tensor(np.stack([p[3] for p in problems]))
        got = ck.maha3_eval_quadratic_packed_v(lie.rot2(theta), t2, packed, tloss)
    else:
        R = torch.as_tensor(np.stack([p[4] for p in problems]))
        t = torch.as_tensor(np.stack([p[5] for p in problems]))
        got = ck.p2p_eval_quadratic_packed_v(R, t, packed, tloss)
    for b, p in enumerate(problems):
        if kernel == "maha3":
            R2 = jnp.asarray(np.asarray(lie.rot2(torch.as_tensor(p[2]))))
            want = pk.maha3_eval_quadratic(R2, jnp.asarray(p[3]), _jax_maha(p[0]), jloss)
        else:
            want = pk.p2p_eval_quadratic(
                jnp.asarray(p[4]), jnp.asarray(p[5]), _jax_p2p(p[1]), jloss
            )
        _close([g[b] for g in got], want)


def test_plain_factor_code_matches_jax_in_f64(problems):
    """The registrar's "torch" evaluation path, batched over problems:
    ``eval_quadratic_3dof`` and ``point_to_plane.eval_quadratic`` (and the
    residuals alone) against the JAX functions, float64."""
    rows_m, rows_p, theta, t2, R, t = problems[0]
    f64 = lambda a: np.asarray(a, np.float64)
    loss_t, loss_j = _losses("HuberLoss", (0.8,))
    jm = jmaha.MahalanobisData(*(jnp.asarray(f64(a)) for a in _jax_maha(rows_m)))
    jp = jp2p.PointToPlaneData(*(jnp.asarray(f64(a)) for a in _jax_p2p(rows_p)))
    tm = tmaha.unpack_maha6(torch.as_tensor(f64(rows_m).T.copy())[None])  # B = 1
    tp = tp2p.unpack_p2p(torch.as_tensor(f64(rows_p).T.copy())[None])
    R2 = np.asarray(jlie.rot2(jnp.asarray(np.float64(theta))))
    cases = [
        (tmaha.eval_quadratic_3dof(torch.as_tensor(R2)[None], torch.as_tensor(f64(t2))[None], tm, loss_t),
         jmaha.eval_quadratic_3dof(jnp.asarray(R2), jnp.asarray(f64(t2)), jm, loss_j)),
        ((tmaha.residuals_3dof(torch.as_tensor(R2)[None], torch.as_tensor(f64(t2))[None], tm),),
         (jmaha.residuals_3dof(jnp.asarray(R2), jnp.asarray(f64(t2)), jm),)),
        (tp2p.eval_quadratic(torch.as_tensor(f64(R))[None], torch.as_tensor(f64(t))[None], tp, loss_t),
         jp2p.eval_quadratic(jnp.asarray(f64(R)), jnp.asarray(f64(t)), jp, loss_j)),
        ((tp2p.residuals(torch.as_tensor(f64(R))[None], torch.as_tensor(f64(t))[None], tp),),
         (jp2p.residuals(jnp.asarray(f64(R)), jnp.asarray(f64(t)), jp),)),
    ]
    for got, want in cases:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)


def test_pack_unpack_and_se2(rng):
    """pack_p2p drops the JAX buffer's 6 zero rows and unpack_p2p reads its
    first 10; SE(2) retraction and rot2 match the JAX package."""
    n = 37
    rows = _p2p_rows(rng, n)
    data = tp2p.PointToPlaneData(*(torch.as_tensor(rows[:, s]) for s in
                                   (slice(0, 3), slice(3, 6), slice(6, 9), 9)))
    packed = ck.pack_p2p(data)
    assert packed.shape == (10, n) and packed.dtype == torch.float32
    jpacked = np.asarray(pk.pack_p2p(_jax_p2p(rows))).reshape(16, -1)
    np.testing.assert_array_equal(packed.numpy(), jpacked[:10, :n])
    assert not jpacked[10:].any()
    for a, b in zip(tp2p.unpack_p2p(packed), data):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(tp2p.unpack_p2p(torch.as_tensor(jpacked[:, :n].copy())), data):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    from nonlinear_optimizer_for_slam_tpu.solvers import manifolds as jman
    from nonlinear_optimizer_for_slam_tpu_torch.solvers import manifolds as tman

    theta, t2, delta = 0.7, rng.normal(size=2), rng.normal(size=3)
    got = tman.se2_retract(
        tman.SE2Params(torch.as_tensor(t2), torch.as_tensor(theta)), torch.as_tensor(delta)
    )
    want = jman.se2_retract(jman.SE2Params(jnp.asarray(t2), jnp.asarray(theta)), jnp.asarray(delta))
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-15)
    np.testing.assert_allclose(float(got.theta), float(want.theta), atol=1e-15)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-15)
    np.testing.assert_allclose(
        float(lie.angle_of_rot2(lie.rot2(torch.tensor(theta, dtype=torch.float64)))),
        float(jlie.angle_of_rot2(jlie.rot2(jnp.asarray(theta)))), atol=1e-15,
    )
