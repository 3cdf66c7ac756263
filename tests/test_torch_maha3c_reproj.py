"""The maha3c and reproj kernels' plain versions against the JAX package.

On the CPU the kernel wrappers of ``ops/cuda_kernels`` run their plain
PyTorch versions (the kernels' arithmetic and output order; the CUDA
sources are checked with g++ in tests/test_torch_factor_math.py). Here
those go up against the Pallas kernels themselves, run in interpret mode as
tests/test_pallas.py runs them, at N = 700 (not a block multiple) for all 7
losses and for a batch of 3 ragged problems in one buffer, float32:

- maha3c on ``pack_maha3_compact``: against ``pk.maha3_eval_quadratic_compact``
  with the tolerance of tests/test_pallas.py:306-312 (rtol 1e-4, atol 1e-5;
  two float32 sums of the Gram form in different orders), and against the
  float64 ``eval_quadratic_3dof`` oracle with rtol 1e-4 (:319-322);
- reproj: against ``pk.reproj_eval_quadratic`` with the tolerance of
  tests/test_pallas.py:105-107 (rtol 2e-4, atol 1e-3), with points on both
  sides of the depth gate;
- maha3c's and reproj's terms summed in the one-pass kernel's order
  (``utils.testing.onepass_emulate``, ``csrc/onepass.cuh``) against the
  Pallas kernels, at N = 700 and 1,025 (three 512-lane tiles) for all 7
  losses, each with its tolerance above.

The packings are held to the JAX ones row for row, and the port's
``ops/reprojection`` (the "torch" backend) to the JAX module in float64 at
1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core import losses as jlosses
from nonlinear_optimizer_for_slam_tpu.ops import mahalanobis as jmaha
from nonlinear_optimizer_for_slam_tpu.ops import pallas_kernels as pk
from nonlinear_optimizer_for_slam_tpu.ops import reprojection as jreproj
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.core import lie
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis as tmaha
from nonlinear_optimizer_for_slam_tpu_torch.ops import reprojection as treproj
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
LOSS_IDS = [n for n, _ in LOSS_ARGS]
SIZES = (700, 300, 1000)  # N of the single problem, then a ragged batch of 3
F32 = np.float32


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


def _maha_fields(rng, n):
    """points, means, sqrt_infos, mask as float32 numpy (the draws of
    tests/test_pallas.py:35-42)."""
    return (
        rng.normal(size=(n, 3)).astype(F32), rng.normal(size=(n, 3)).astype(F32),
        rng.normal(size=(n, 3, 3)).astype(F32), (rng.uniform(size=n) > 0.1).astype(F32),
    )


def _reproj_fields(rng, n):
    """local points around z = 4, a tenth of them near or behind the 0.03
    depth gate; pixels in a 640 x 480 image; a mask with some zeros."""
    pts = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 4.0])
    pts[: n // 10, 2] = rng.uniform(-1.0, 0.1, size=n // 10)  # at and behind the gate
    return (
        pts.astype(F32), rng.uniform(0, 640, size=(n, 2)).astype(F32),
        (rng.uniform(size=n) > 0.1).astype(F32),
    )


@pytest.fixture(scope="module")
def problems(rng):
    """Per size: maha fields, reproj fields, a planar pose (theta, t2) and
    a 6-DoF pose (R, t), all float32."""
    out = []
    for n in SIZES:
        pose = port.Pose.from_axis_angle(
            rng.uniform(0.05, 0.3), rng.normal(size=3), 0.2 * rng.normal(size=3)
        )
        out.append((
            _maha_fields(rng, n), _reproj_fields(rng, n),
            F32(rng.uniform(-0.5, 0.5)), rng.normal(size=2).astype(F32),
            pose.rotation.astype(F32), pose.translation.astype(F32),
        ))
    return out


INTRINSICS = (525.0, 525.0, 320.0, 240.0)


def _jax_intrinsics(dtype):
    return jreproj.CameraIntrinsics.create(*(jnp.asarray(v, dtype) for v in INTRINSICS))


def _port_intrinsics(dtype):
    return treproj.CameraIntrinsics.create(
        *(torch.tensor(v, dtype=dtype) for v in INTRINSICS)
    )


def _R2(theta):
    return np.asarray(lie.rot2(torch.tensor(theta)))


def _close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=LOSS_IDS)
def test_maha3c_plain_matches_pallas_and_f64(problems, loss_name, loss_args):
    fields, _, theta, t2, _, _ = problems[0]
    tloss, jloss = _losses(loss_name, loss_args)
    R2 = _R2(theta)
    jdata = jmaha.MahalanobisData(*(jnp.asarray(a) for a in fields))
    want = pk.maha3_eval_quadratic_compact(
        jnp.asarray(R2), jnp.asarray(t2), pk.pack_maha3_compact(jdata), jloss
    )
    packed = ck.pack_maha3_compact(tmaha.MahalanobisData(*(torch.as_tensor(a) for a in fields)))
    got = ck.maha3_eval_quadratic_compact(torch.as_tensor(R2), torch.as_tensor(t2), packed, tloss)
    _close(got, want, rtol=1e-4, atol=1e-5)

    H64, _, c64 = jmaha.eval_quadratic_3dof(
        jnp.asarray(R2, jnp.float64), jnp.asarray(t2, jnp.float64),
        jdata.astype(jnp.float64), jloss,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(H64), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(c64), rtol=1e-4)


@pytest.mark.parametrize("n", [700, 1025])
@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=LOSS_IDS)
def test_maha3c_onepass_order_matches_pallas(loss_name, loss_args, n):
    """The port's per-factor terms (``maha3c_terms``, the kernel's
    arithmetic) added in the one-pass kernel's order, one float32 addition
    at a time, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n)
    fields = _maha_fields(rng, n)
    theta, t2 = F32(rng.uniform(-0.5, 0.5)), rng.normal(size=2).astype(F32)
    tloss, jloss = _losses(loss_name, loss_args)
    R2 = _R2(theta)
    packed = ck.pack_maha3_compact(tmaha.MahalanobisData(*(torch.as_tensor(a) for a in fields)))
    code, loss_ab = ck.maha6_loss_ab(tloss, "cpu")
    params = ck.maha3_params(torch.as_tensor(R2)[None], torch.as_tensor(t2)[None], loss_ab)
    terms = ck.maha3c_terms(params, packed[None], code)[0].numpy()
    got = ck.unpack_out(torch.as_tensor(testing.onepass_emulate(terms)), 3)
    jdata = jmaha.MahalanobisData(*(jnp.asarray(a) for a in fields))
    want = pk.maha3_eval_quadratic_compact(
        jnp.asarray(R2), jnp.asarray(t2), pk.pack_maha3_compact(jdata), jloss
    )
    _close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=LOSS_IDS)
def test_reproj_plain_matches_pallas(problems, loss_name, loss_args):
    _, fields, _, _, R, t = problems[0]
    tloss, jloss = _losses(loss_name, loss_args)
    R, t = R.copy(), t.copy()
    t[2] = 0.5  # the drawn points straddle the gate at the drawn pose
    jdata = jreproj.ReprojectionData(*(jnp.asarray(a) for a in fields))
    xw_z = fields[0] @ R[2] + t[2]
    assert (xw_z < jreproj.MIN_DEPTH).sum() > 20 and (xw_z >= jreproj.MIN_DEPTH).sum() > 500
    want = pk.reproj_eval_quadratic(
        jnp.asarray(R), jnp.asarray(t), jdata, _jax_intrinsics(jnp.float32), jloss
    )
    tdata = treproj.ReprojectionData(*(torch.as_tensor(a) for a in fields))
    got = ck.reproj_eval_quadratic(
        torch.as_tensor(R), torch.as_tensor(t), tdata, _port_intrinsics(torch.float32), tloss
    )
    _close(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("n", [700, 1025])
@pytest.mark.parametrize("loss_name,loss_args", LOSS_ARGS, ids=LOSS_IDS)
def test_reproj_onepass_order_matches_pallas(loss_name, loss_args, n):
    """The port's per-factor terms (``reproj_terms``, the kernel's
    arithmetic) added in the one-pass kernel's order, one float32 addition
    at a time, against the Pallas kernel in interpret mode, with points on
    both sides of the depth gate."""
    rng = np.random.default_rng(n)
    fields = _reproj_fields(rng, n)
    pose = port.Pose.from_axis_angle(
        rng.uniform(0.05, 0.3), rng.normal(size=3), 0.2 * rng.normal(size=3)
    )
    R, t = pose.rotation.astype(F32), pose.translation.astype(F32)
    t[2] = 0.5  # the drawn points straddle the gate at the drawn pose
    xw_z = fields[0] @ R[2] + t[2]
    assert (xw_z < jreproj.MIN_DEPTH).sum() > 20 and (xw_z >= jreproj.MIN_DEPTH).sum() > 500
    tloss, jloss = _losses(loss_name, loss_args)
    packed = ck.pack_reproj(treproj.ReprojectionData(*(torch.as_tensor(a) for a in fields)))
    code, loss_ab = ck.reproj_loss_ab(tloss, "cpu")
    params = ck.reproj_params(
        torch.as_tensor(R)[None], torch.as_tensor(t)[None], _port_intrinsics(torch.float32),
        loss_ab,
    )
    terms = ck.reproj_terms(params, packed[None], code)[0].numpy()
    got = ck.unpack_out(torch.as_tensor(testing.onepass_emulate(terms)), 6)
    jdata = jreproj.ReprojectionData(*(jnp.asarray(a) for a in fields))
    want = pk.reproj_eval_quadratic(
        jnp.asarray(R), jnp.asarray(t), jdata, _jax_intrinsics(jnp.float32), jloss
    )
    _close(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("kernel", ["maha3c", "reproj"])
def test_ragged_batch_matches_pallas(problems, kernel):
    """Three problems of N = 700, 300 and 1000 in one zero-padded (3, rows,
    1000) buffer, one call of the batched wrapper, each against the Pallas
    kernel on its own rows."""
    tloss, jloss = _losses("ExponentialLoss", (1.0, 1.0))
    code, loss_ab = (ck.maha6_loss_ab if kernel == "maha3c" else ck.reproj_loss_ab)(tloss, "cpu")
    rows = 10 if kernel == "maha3c" else 6
    packed = torch.zeros((3, rows, max(SIZES)))
    params = []
    for b, (mf, rf, theta, t2, R, t) in enumerate(problems):
        n = SIZES[b]
        if kernel == "maha3c":
            packed[b, :, :n] = ck.pack_maha3_compact(
                tmaha.MahalanobisData(*(torch.as_tensor(a) for a in mf))
            )
            params.append(ck.maha3_params(torch.as_tensor(_R2(theta)), torch.as_tensor(t2), loss_ab))
        else:
            packed[b, :, :n] = ck.pack_reproj(
                treproj.ReprojectionData(*(torch.as_tensor(a) for a in rf))
            )
            params.append(ck.reproj_params(
                torch.as_tensor(R), torch.as_tensor(t), _port_intrinsics(torch.float32), loss_ab
            ))
    partials = ck.maha3c_partials if kernel == "maha3c" else ck.reproj_partials
    out = partials(torch.stack(params), packed, code)
    for b, (mf, rf, theta, t2, R, t) in enumerate(problems):
        if kernel == "maha3c":
            jdata = jmaha.MahalanobisData(*(jnp.asarray(a) for a in mf))
            want = pk.maha3_eval_quadratic_compact(
                jnp.asarray(_R2(theta)), jnp.asarray(t2), pk.pack_maha3_compact(jdata), jloss
            )
            got = ck.unpack_out(out[b], 3)
            _close(got, want, rtol=1e-4, atol=1e-5)
        else:
            jdata = jreproj.ReprojectionData(*(jnp.asarray(a) for a in rf))
            want = pk.reproj_eval_quadratic(
                jnp.asarray(R), jnp.asarray(t), jdata, _jax_intrinsics(jnp.float32), jloss
            )
            got = ck.unpack_out(out[b], 6)
            _close(got, want, rtol=2e-4, atol=1e-3)


def _gram_scale(fields):
    """(6, N) float64: for each Gram row of the compact packing, the sum of
    the magnitudes of the three products it adds."""
    p, mu, S, _ = (np.asarray(a, np.float64) for a in fields)
    a0, a1 = S[:, :, 0], S[:, :, 1]
    wz = S[:, :, 2] * (p[:, 2] - mu[:, 2])[:, None]
    pairs = [(a0, a0), (a0, a1), (a1, a1), (a0, wz), (a1, wz), (wz, wz)]
    return np.stack([np.abs(x * y).sum(axis=1) for x, y in pairs])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_packings_match_jax_row_for_row(problems, dtype):
    """pack_maha3_compact against the JAX packing's 10 rows (formed in the
    data's dtype, masked, then cast): u and mu_xy equal; each Gram row, a
    sum of three products, within 8 float32 unit roundoffs (2^-24) of the
    products' magnitudes, the worst-case gap between a three-term sum with
    fused multiply-adds and one without (XLA contracts some of these sums,
    PyTorch on the CPU does not). pack_reproj equals the JAX rows 0-5 (rows
    6-7 there are zero padding)."""
    mf, rf = problems[0][0], problems[0][1]
    n = SIZES[0]
    mf = tuple(a.astype(dtype) for a in mf)
    jm = np.asarray(pk.pack_maha3_compact(jmaha.MahalanobisData(*(jnp.asarray(a) for a in mf))))
    jm = jm.reshape(10, -1)
    tm = ck.pack_maha3_compact(tmaha.MahalanobisData(*(torch.as_tensor(a) for a in mf)))
    assert tm.shape == (10, n) and tm.dtype == torch.float32
    np.testing.assert_array_equal(tm[:4].numpy(), jm[:4, :n])
    err = np.abs(tm[4:].numpy().astype(np.float64) - jm[4:, :n])
    assert (err <= 8.0 * 2.0**-24 * _gram_scale(mf)).all(), err.max(axis=1)
    assert not jm[:, n:].any()
    # a masked factor packs to zero Gram rows
    masked = np.flatnonzero(mf[3] == 0)
    assert masked.size and not tm[4:, masked].any()

    rf = tuple(a.astype(dtype) for a in rf)
    jr = np.asarray(pk.pack_reproj(jreproj.ReprojectionData(*(jnp.asarray(a) for a in rf))))
    jr = jr.reshape(8, -1)
    tr = ck.pack_reproj(treproj.ReprojectionData(*(torch.as_tensor(a) for a in rf)))
    assert tr.shape == (6, n) and tr.dtype == torch.float32
    np.testing.assert_array_equal(tr.numpy(), jr[:6, :n])
    assert not jr[6:].any()


def test_reprojection_ops_match_jax_in_f64(problems):
    """The port's ops/reprojection against the JAX module, float64, at
    1e-10: residuals and Jacobians (the gate zeroes both for the points
    behind it), residuals, project_to_pixels, and eval_quadratic for all 7
    losses and without a loss. Also batched over a leading dimension."""
    _, rf, _, _, R, t = problems[0]
    f64 = lambda a: np.asarray(a, np.float64)
    R, t = f64(R), f64(t)
    t[2] = 0.5
    jdata = jreproj.ReprojectionData(*(jnp.asarray(f64(a)) for a in rf))
    tdata = treproj.ReprojectionData(*(torch.as_tensor(f64(a)) for a in rf))
    jintr, tintr = _jax_intrinsics(jnp.float64), _port_intrinsics(torch.float64)
    jR, jt, tR, tt = jnp.asarray(R), jnp.asarray(t), torch.as_tensor(R), torch.as_tensor(t)

    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-10
    )
    r, J = treproj.residuals_and_jacobians(tR, tt, tdata, tintr)
    jr, jJ = jreproj.residuals_and_jacobians(jR, jt, jdata, jintr)
    close(r, jr)
    close(J, jJ)
    gated = (f64(rf[0]) @ R[2] + t[2]) < treproj.MIN_DEPTH
    assert gated.sum() > 20
    assert not r[torch.as_tensor(gated)].any() and not J[torch.as_tensor(gated)].any()
    close(treproj.residuals(tR, tt, tdata, tintr), jreproj.residuals(jR, jt, jdata, jintr))
    cam = f64(rf[0])[~gated]
    close(
        treproj.project_to_pixels(torch.as_tensor(cam), tintr),
        jreproj.project_to_pixels(jnp.asarray(cam), jintr),
    )
    for name, args in LOSS_ARGS + [(None, ())]:
        tloss, jloss = _losses(name, args) if name else (None, None)
        got = treproj.eval_quadratic(tR, tt, tdata, tintr, tloss)
        want = jreproj.eval_quadratic(jR, jt, jdata, jintr, jloss)
        for a, b in zip(got, want):
            close(a, b)
    batched = treproj.eval_quadratic(
        tR[None].expand(2, 3, 3), tt[None].expand(2, 3),
        treproj.ReprojectionData(*(a[None].expand((2,) + a.shape) for a in tdata)), tintr, None,
    )
    for a, b in zip(batched, jreproj.eval_quadratic(jR, jt, jdata, jintr, None)):
        close(a[1], b)


def test_reprojection_data_pad_and_cast():
    n = 5
    data = treproj.ReprojectionData(torch.ones(n, 3), torch.ones(n, 2), torch.ones(n))
    assert data.num_factors == n
    padded = data.pad_to(8).astype(torch.float64)
    assert padded.num_factors == 8 and padded.mask.dtype == torch.float64
    assert float(padded.mask.sum()) == n and not padded.local_points[n:].any()
    assert data.pad_to(n) is data
    intr = treproj.CameraIntrinsics.create(500.0, 400.0, 1.0, 2.0, 64, 48)
    assert intr.inv_fx == 1.0 / 500.0 and intr.inv_fy == 1.0 / 400.0 and intr.width == 64
