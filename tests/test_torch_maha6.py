"""The maha6 kernel's plain version and the port's Mahalanobis ops against
the JAX package.

On the CPU the port's kernel wrapper takes the plain PyTorch version; the
JAX side runs its Pallas kernel interpreted, as tests/test_pallas.py does.
Both evaluate float32 factors and sum them in different orders, so they
agree to float32 summation error: rtol 2e-5, atol 1e-4 on H and g (the
tolerance of test_maha6_kernel_matches_jnp), rtol 2e-5 on the cost. The
"torch" backend and JAX's "jnp" backend are compared in float64, where only
summation order differs: rtol 1e-10.

The bf16 rows (``pack_maha6(..., buffer_dtype=torch.bfloat16)``): the port's
bf16 buffer is bitwise JAX's (float32 and float64 data, the plane layout
undone), and the bf16 plain maha6 and maha3 versions agree with JAX's
``_maha6_pallas`` and ``_maha3_pallas``, interpreted, on the same bf16 rows
at the float32 rows' tolerance above; they give the bits of the float32
plain versions on the rows widened to float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinear_optimizer_for_slam_tpu.core import losses as jlosses
from nonlinear_optimizer_for_slam_tpu.core import pose as jpose
from nonlinear_optimizer_for_slam_tpu.ops import mahalanobis as jmaha
from nonlinear_optimizer_for_slam_tpu.ops import pallas_kernels as pk
from nonlinear_optimizer_for_slam_tpu.ops import quadratic as jquad
import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis as tmaha
from nonlinear_optimizer_for_slam_tpu_torch.ops import quadratic as tquad

LOSS_CASES = [
    ("TrivialLoss", {}),
    ("ExponentialLoss", {"c1": 1.3, "c2": 0.4}),
    ("HuberLoss", {"threshold": 2.0}),
    ("CauchyLoss", {"scale": 1.5}),
    ("TukeyLoss", {"threshold": 1.8}),
    ("GemanMcClureLoss", {"scale": 1.2}),
    ("DCSLoss", {"phi": 2.5}),
]
IDS = [c[0] for c in LOSS_CASES]


def _make(rng, n, masked_frac=0.1):
    return {
        "points": rng.normal(size=(n, 3)),
        "means": rng.normal(size=(n, 3)),
        "sqrt_infos": rng.normal(size=(n, 3, 3)),
        "mask": (rng.uniform(size=n) > masked_frac).astype(np.float64),
    }


def _jax_data(d, dtype):
    return jmaha.MahalanobisData(*(jnp.asarray(d[f], dtype) for f in jmaha.MahalanobisData._fields))


def _torch_data(d, dtype):
    return tmaha.MahalanobisData(*(torch.as_tensor(d[f], dtype=dtype) for f in tmaha.MahalanobisData._fields))


@pytest.fixture(scope="module")
def pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return jpose.Pose.from_quat_trans(q, rng.normal(size=3))


@pytest.fixture(scope="module")
def factors(rng):
    return _make(rng, 700)  # not a multiple of the TPU kernel's lane block


def _port_plain(pose, d, name, params):
    loss = getattr(port, name)(**params)
    R = torch.as_tensor(pose.rotation, dtype=torch.float32)
    t = torch.as_tensor(pose.translation, dtype=torch.float32)
    return ck.maha6_eval_quadratic(R, t, _torch_data(d, torch.float32), loss)


def _jax_pallas(pose, d, name, params):
    loss = getattr(jlosses, name)(**params)
    R = jnp.asarray(pose.rotation, jnp.float32)
    t = jnp.asarray(pose.translation, jnp.float32)
    return pk.maha6_eval_quadratic(R, t, _jax_data(d, jnp.float32), loss)


def _assert_quadratic_close(got, want, rtol=2e-5, atol=1e-4, cost_rtol=2e-5):
    (H1, g1, c1), (H2, g2, c2) = got, want
    np.testing.assert_allclose(H1.numpy(), np.asarray(H2), rtol=rtol, atol=atol)
    np.testing.assert_allclose(g1.numpy(), np.asarray(g2), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(c1), float(c2), rtol=cost_rtol)


@pytest.mark.parametrize("name,params", LOSS_CASES, ids=IDS)
def test_plain_kernel_matches_pallas(pose, factors, name, params):
    ck.reset_launches()
    got = _port_plain(pose, factors, name, params)
    assert ck.LAUNCHES["maha6"] == 0  # the CPU takes the plain version
    _assert_quadratic_close(got, _jax_pallas(pose, factors, name, params))


def test_plain_kernel_ragged_n(pose, rng):
    """N one past the TPU kernel's 4096 lane block: the port takes any N."""
    d = _make(rng, 4097)
    case = ("ExponentialLoss", {"c1": 1.0, "c2": 1.0})
    _assert_quadratic_close(_port_plain(pose, d, *case), _jax_pallas(pose, d, *case))


@pytest.mark.parametrize("name,params", [LOSS_CASES[0], LOSS_CASES[2]], ids=IDS[:3:2])
def test_all_masked_tail_contributes_nothing(pose, factors, rng, name, params):
    """A tail of masked rows holding large finite garbage leaves H, g and
    the cost as without it (to float32 summation error: the longer sum is
    blocked differently)."""
    head = {k: v.copy() for k, v in factors.items()}
    tail = {k: 1e3 * v for k, v in _make(rng, 300).items()}
    tail["mask"] = np.zeros(300)
    both = {k: np.concatenate([head[k], tail[k]]) for k in head}
    with_tail = _port_plain(pose, both, name, params)
    _assert_quadratic_close(with_tail, _port_plain(pose, head, name, params))
    _assert_quadratic_close(with_tail, _jax_pallas(pose, both, name, params))


def test_pack_round_trip_and_layout(factors):
    data = _torch_data(factors, torch.float32)
    packed = ck.pack_maha6(data)
    assert packed.shape == (16, 700) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    back = tmaha.unpack_maha6(packed)
    for a, b in zip(back, data):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the same rows as the JAX package's packing, without its lane padding
    jpacked = np.asarray(pk.pack_maha6(_jax_data(factors, jnp.float32)))
    jpacked = jpacked.reshape(16, -1)[:, :700]
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    # JAX's unpack of the port's buffer gives the port's data back
    junpacked = jmaha.unpack_maha6(jnp.asarray(packed.numpy()))
    for a, b in zip(junpacked, data):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_batched_form_matches_single(pose, factors, rng):
    """maha6_eval_quadratic_packed_v over three problems in one padded
    buffer equals three single evaluations."""
    loss = port.ExponentialLoss(1.0, 1.0)
    sizes = [700, 333, 1]
    datas = [_torch_data(factors, torch.float32)] + [
        _torch_data(_make(rng, n), torch.float32) for n in sizes[1:]
    ]
    buf = torch.zeros((3, 16, 700))
    for b, d in enumerate(datas):
        buf[b, :, : d.num_factors] = ck.pack_maha6(d)
    Rs = torch.as_tensor(np.stack([pose.rotation, np.eye(3), pose.rotation.T]), dtype=torch.float32)
    ts = torch.as_tensor(rng.normal(size=(3, 3)), dtype=torch.float32)
    H, g, c = ck.maha6_eval_quadratic_packed_v(Rs, ts, buf, loss)
    assert H.shape == (3, 6, 6) and g.shape == (3, 6) and c.shape == (3,)
    for b, d in enumerate(datas):
        Hb, gb, cb = ck.maha6_eval_quadratic_packed(Rs[b], ts[b], ck.pack_maha6(d), loss)
        torch.testing.assert_close(H[b], Hb, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(g[b], gb, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(c[b], cb, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_inputs(factors):
    packed = ck.pack_maha6(_torch_data(factors, torch.float32))[None]
    code, ab = ck.maha6_loss_ab(None, "cpu")
    params = ck.maha6_params(torch.eye(3)[None], torch.zeros(1, 3), ab)
    with pytest.raises(ValueError):
        ck.maha6_partials(params, packed[0], code)  # not (B, 16, N)
    with pytest.raises(ValueError):
        ck.maha6_partials(params[:, :8], packed, code)  # params not (B, 16)
    with pytest.raises(TypeError):
        ck.maha6_partials(params.double(), packed.double(), code)
    with pytest.raises(ValueError):
        ck.maha6_partials(params, packed, 7)  # no such loss code
    with pytest.raises(NotImplementedError):
        ck.maha6_loss_ab(object(), "cpu")


def test_quadratic_packing_matches_jax(rng):
    H = rng.normal(size=(4, 6, 6))
    H = H + np.swapaxes(H, -1, -2)
    packed = tquad.pack_upper(torch.as_tensor(H))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jquad.pack_upper(jnp.asarray(H))))
    np.testing.assert_array_equal(
        tquad.unpack_symmetric(packed, 6).numpy(),
        np.asarray(jquad.unpack_symmetric(jnp.asarray(packed.numpy()), 6)),
    )
    assert tquad.upper_triangle_indices(6) == jquad.upper_triangle_indices(6)


@pytest.mark.parametrize("name,params", LOSS_CASES, ids=IDS)
def test_torch_backend_matches_jnp_f64(pose, factors, name, params):
    R, t = pose.rotation, pose.translation
    td, jd = _torch_data(factors, torch.float64), _jax_data(factors, jnp.float64)
    r1, J1 = tmaha.residuals_and_jacobians(torch.as_tensor(R), torch.as_tensor(t), td)
    r2, J2 = jmaha.residuals_and_jacobians(jnp.asarray(R), jnp.asarray(t), jd)
    np.testing.assert_allclose(r1.numpy(), np.asarray(r2), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(J1.numpy(), np.asarray(J2), rtol=1e-10, atol=1e-12)
    got = tmaha.eval_quadratic(
        torch.as_tensor(R), torch.as_tensor(t), td, getattr(port, name)(**params)
    )
    want = jmaha.eval_quadratic(
        jnp.asarray(R), jnp.asarray(t), jd, getattr(jlosses, name)(**params)
    )
    _assert_quadratic_close(got, want, rtol=1e-10, atol=1e-9, cost_rtol=1e-10)
    assert got[0].dtype == torch.float64


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pack_bf16_bitwise_jax(factors, dtype):
    data = _torch_data(factors, getattr(torch, dtype))
    packed = ck.pack_maha6(data, buffer_dtype=torch.bfloat16)
    assert packed.shape == (16, 700) and packed.dtype == torch.bfloat16
    jpacked = pk.pack_maha6(_jax_data(factors, getattr(jnp, dtype)), None, jnp.bfloat16)
    jrows = np.asarray(jpacked).reshape(16, -1)[:, :700]
    np.testing.assert_array_equal(packed.view(torch.int16).numpy().view(np.uint16),
                                  _bf16_bits(jrows))
    with pytest.raises(ValueError, match="buffer_dtype"):
        ck.pack_maha6(data, buffer_dtype=torch.float16)


def _bf16_rows(d):
    return ck.pack_maha6(_torch_data(d, torch.float32), buffer_dtype=torch.bfloat16)


@pytest.mark.parametrize("kernel", ["maha6", "maha3"])
@pytest.mark.parametrize("name,params", LOSS_CASES, ids=IDS)
def test_bf16_plain_matches_pallas(pose, factors, kernel, name, params):
    """The port's bf16 plain version against JAX's Pallas kernel,
    interpreted, on bitwise the same bf16 rows (JAX's packing, whose
    kernel loads upcast them): the float32 rows' tolerance."""
    rows = _bf16_rows(factors)
    jrows = pk.pack_maha6(_jax_data(factors, jnp.float32), None, jnp.bfloat16)
    tloss, jloss = getattr(port, name)(**params), getattr(jlosses, name)(**params)
    ck.reset_launches()
    if kernel == "maha6":
        R = torch.as_tensor(pose.rotation, dtype=torch.float32)
        t = torch.as_tensor(pose.translation, dtype=torch.float32)
        got = ck.maha6_eval_quadratic_packed(R, t, rows, tloss)
        want = pk.maha6_eval_quadratic_packed(
            jnp.asarray(pose.rotation, jnp.float32), jnp.asarray(pose.translation, jnp.float32),
            jrows, jloss,
        )
    else:
        theta = 0.3
        R2 = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
        t2 = pose.translation[:2]
        got = ck.maha3_eval_quadratic_packed(
            torch.as_tensor(R2, dtype=torch.float32), torch.as_tensor(t2, dtype=torch.float32),
            rows, tloss,
        )
        want = pk.maha3_eval_quadratic_packed(
            jnp.asarray(R2, jnp.float32), jnp.asarray(t2, jnp.float32), jrows, jloss,
        )
    assert not any(ck.LAUNCHES.values())  # the CPU takes the plain version
    _assert_quadratic_close(got, want)
    # the bf16 rows sum as the float32 plain version of the widened rows
    widened = rows.float()
    if kernel == "maha6":
        same = ck.maha6_eval_quadratic_packed(R, t, widened, tloss)
    else:
        same = ck.maha3_eval_quadratic_packed(
            torch.as_tensor(R2, dtype=torch.float32), torch.as_tensor(t2, dtype=torch.float32),
            widened, tloss,
        )
    for a, b in zip(got, same):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_rows_layout_and_wrapper_types(factors):
    """bf16 rows align to 8 lanes (16 bytes); only maha6 and maha3 take
    them."""
    rows = _bf16_rows(factors)[None]  # (1, 16, 700)
    aligned = ck.lane_aligned(rows)
    assert aligned.stride(1) == 704 and aligned.dtype == torch.bfloat16
    assert ck._one_pass_ld("maha6", aligned) == 704
    assert torch.equal(aligned, rows)
    whole = aligned.as_strided((1, 16, 704), (16 * 704, 704, 1))
    assert not whole[..., 700:].float().any()  # the padded lanes are zero
    with pytest.raises(ValueError, match="ld % 8"):
        ck._one_pass_ld("maha6", torch.zeros((1, 16, 1004), dtype=torch.bfloat16)[..., :700])
    code, ab = ck.maha6_loss_ab(None, "cpu")
    with pytest.raises(TypeError):
        ck.maha3c_partials(ck.maha3_params(torch.eye(2)[None], torch.zeros(1, 2), ab),
                           torch.zeros((1, 10, 8), dtype=torch.bfloat16), code)
    with pytest.raises(TypeError):
        ck.maha6_partials(ck.maha6_params(torch.eye(3)[None], torch.zeros(1, 3), ab),
                          rows.half(), code)
    assert set(ck.LAUNCHES) >= {"maha6_bf16", "maha3_bf16"}


def test_data_pad_and_cast(factors):
    d = _torch_data(factors, torch.float64)
    padded = d.pad_to(1024).astype(torch.float32)
    assert padded.num_factors == 1024 and padded.points.dtype == torch.float32
    assert float(padded.mask[700:].abs().sum()) == 0.0
    assert d.pad_to(700) is d
