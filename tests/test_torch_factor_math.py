"""The kernels' per-factor arithmetic, checked on the CPU.

``csrc/factor_math.cuh`` holds the arithmetic of one factor of each kernel
(maha6, maha3, maha3c, reproj, p2p: the robust loss, r, J and the
products) as ``__host__ __device__`` code. nvcc builds it into the CUDA
kernels; here g++ builds the same header into a tiny harness, whose
per-factor terms must agree with the plain PyTorch versions
(``ops.cuda_kernels.maha6_terms``, ``maha3_terms``, ``maha3c_terms``,
``reproj_terms``, ``p2p_terms``) for all 7 losses. So the kernels'
arithmetic is checked on a machine without a GPU.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import nonlinear_optimizer_for_slam_tpu_torch as port
from nonlinear_optimizer_for_slam_tpu_torch.core import lie
from nonlinear_optimizer_for_slam_tpu_torch.ops import cuda_kernels as ck
from nonlinear_optimizer_for_slam_tpu_torch.ops import mahalanobis as tmaha
from nonlinear_optimizer_for_slam_tpu_torch.ops import reprojection as treproj

CSRC = Path(port.__file__).resolve().parent / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <vector>

#include "factor_math.cuh"

#define FACTOR(Name, prefix, rows)                                        \
  struct Name {                                                           \
    static constexpr int kRows = rows;                                    \
    static constexpr int kParams = nls::prefix##Params;                   \
    static constexpr int kOut = nls::prefix##Out;                         \
    template <int kLoss>                                                  \
    static void accumulate(const float* p, const float* f, float* acc) { \
      nls::Name##_accumulate<kLoss>(p, f, acc);                           \
    }                                                                     \
  };
FACTOR(maha6, kMaha6, nls::kMaha6Rows)
FACTOR(maha3, kMaha3, nls::kMaha6Rows)
FACTOR(p2p, kP2p, nls::kP2pRows)
FACTOR(maha3c, kMaha3c, nls::kMaha3cRows)
FACTOR(reproj, kReproj, nls::kReprojRows)

// each factor's kOut terms on their own
template <class F, int kLoss>
void run(const float* prm, const float* rows, int n, float* out) {
  for (int i = 0; i < n; ++i) {
    float acc[F::kOut] = {0.0f};
    F::template accumulate<kLoss>(prm, rows + F::kRows * i, acc);
    for (int k = 0; k < F::kOut; ++k) out[F::kOut * i + k] = acc[k];
  }
}

// in:  int32 loss code, int32 n, float params[kParams], float rows[n][kRows]
// out: float terms[n][kOut]
template <class F>
int main_for(FILE* in, const char* out_path) {
  int header[2];
  float prm[F::kParams];
  if (std::fread(header, sizeof(int), 2, in) != 2) return 2;
  if (std::fread(prm, sizeof(float), F::kParams, in) != F::kParams) return 2;
  const int code = header[0], n = header[1];
  std::vector<float> rows(static_cast<size_t>(n) * F::kRows);
  if (std::fread(rows.data(), sizeof(float), rows.size(), in) != rows.size()) return 2;
  std::vector<float> out(static_cast<size_t>(n) * F::kOut);
  switch (code) {
    case nls::kLossNone: run<F, nls::kLossNone>(prm, rows.data(), n, out.data()); break;
    case nls::kLossExp: run<F, nls::kLossExp>(prm, rows.data(), n, out.data()); break;
    case nls::kLossHuber: run<F, nls::kLossHuber>(prm, rows.data(), n, out.data()); break;
    case nls::kLossCauchy: run<F, nls::kLossCauchy>(prm, rows.data(), n, out.data()); break;
    case nls::kLossTukey: run<F, nls::kLossTukey>(prm, rows.data(), n, out.data()); break;
    case nls::kLossGemanMcClure:
      run<F, nls::kLossGemanMcClure>(prm, rows.data(), n, out.data()); break;
    case nls::kLossDCS: run<F, nls::kLossDCS>(prm, rows.data(), n, out.data()); break;
    default: return 3;
  }
  FILE* o = std::fopen(out_path, "wb");
  if (!o) return 2;
  std::fwrite(out.data(), sizeof(float), out.size(), o);
  std::fclose(o);
  return 0;
}

// harness IN OUT [maha6 | maha3 | p2p | maha3c | reproj]
int main(int argc, char** argv) {
  if (argc != 3 && argc != 4) return 2;
  FILE* in = std::fopen(argv[1], "rb");
  if (!in) return 2;
  const char* kind = argc == 4 ? argv[3] : "maha6";
  int rc = 2;
  if (!std::strcmp(kind, "maha6")) rc = main_for<maha6>(in, argv[2]);
  if (!std::strcmp(kind, "maha3")) rc = main_for<maha3>(in, argv[2]);
  if (!std::strcmp(kind, "p2p")) rc = main_for<p2p>(in, argv[2]);
  if (!std::strcmp(kind, "maha3c")) rc = main_for<maha3c>(in, argv[2]);
  if (!std::strcmp(kind, "reproj")) rc = main_for<reproj>(in, argv[2]);
  std::fclose(in);
  return rc;
}
"""

LOSSES = [
    port.TrivialLoss(),
    port.ExponentialLoss(c1=1.3, c2=0.4),
    port.HuberLoss(2.0),
    port.CauchyLoss(1.5),
    port.TukeyLoss(1.8),
    port.GemanMcClureLoss(1.2),
    port.DCSLoss(2.5),
]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("factor_math")
    src = tmp / "harness.cc"
    src.write_text(HARNESS)
    exe = tmp / "harness"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-I", str(CSRC), "-o", str(exe), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    return exe, tmp


@pytest.fixture(scope="module")
def factors(rng):
    n = 513
    packed = rng.normal(size=(16, n)).astype(np.float32)
    packed[15] = (rng.uniform(size=n) > 0.1).astype(np.float32)  # some masked rows
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    pose = port.Pose.from_quat_trans(q, rng.normal(size=3))
    return packed, pose


def _run_harness(harness, kernel, code, params, rows, n_out):
    """The header's per-factor terms, (N, n_out), for (params,) float32 and
    rows (kRows, N)."""
    exe, tmp = harness
    n = rows.shape[1]
    inp = tmp / f"in_{kernel}_{code}.bin"
    out = tmp / f"out_{kernel}_{code}.bin"
    with open(inp, "wb") as f:
        f.write(np.asarray([code, n], np.int32).tobytes())
        f.write(params.numpy().astype(np.float32).tobytes())
        f.write(np.ascontiguousarray(rows.T).tobytes())
    subprocess.run([str(exe), str(inp), str(out), kernel], check=True, timeout=60)
    return np.fromfile(out, np.float32).reshape(n, n_out)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
def test_header_matches_plain_terms(harness, factors, loss):
    exe, tmp = harness
    packed, pose = factors
    n = packed.shape[1]
    code, loss_ab = ck.maha6_loss_ab(loss, "cpu")
    params = ck.maha6_params(
        torch.as_tensor(pose.rotation, dtype=torch.float32),
        torch.as_tensor(pose.translation, dtype=torch.float32),
        loss_ab,
    )
    inp = tmp / f"in_{code}.bin"
    out = tmp / f"out_{code}.bin"
    with open(inp, "wb") as f:
        f.write(np.asarray([code, n], np.int32).tobytes())
        f.write(params.numpy().astype(np.float32).tobytes())
        f.write(np.ascontiguousarray(packed.T).tobytes())
    subprocess.run([str(exe), str(inp), str(out)], check=True, timeout=60)
    got = np.fromfile(out, np.float32).reshape(n, 28)

    want = ck.maha6_terms(params[None], torch.as_tensor(packed)[None], code)[0].T.numpy()
    _assert_terms_close(got, want)


def _assert_terms_close(got, want):
    # Same float32 operations in the same order on both sides; only libm's
    # exp/log1p/sqrt and compiler reassociation may differ, by a few ulp of
    # each term: rtol 1e-5 of the largest |term| of each output.
    tol = 1e-5 * np.abs(want).max(axis=0, keepdims=True)
    err = np.abs(got - want)
    assert (err <= tol).all(), (err.max(axis=0), tol)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("kernel", ["maha3", "p2p"])
def test_planar_and_p2p_headers_match_plain_terms(harness, factors, kernel, loss):
    """maha3_accumulate over the maha6 rows (planar pose: the yaw and the
    xy of the 6-DoF pose), p2p_accumulate over 10 rows with unit normals."""
    exe, tmp = harness
    packed, pose = factors
    n = packed.shape[1]
    code, loss_ab = ck.maha6_loss_ab(loss, "cpu")
    if kernel == "maha3":
        q = pose.quaternion()
        R2 = lie.rot2(torch.tensor(2.0 * np.arctan2(q[3], q[0]), dtype=torch.float32))
        params = ck.maha3_params(R2, torch.as_tensor(pose.translation[:2], dtype=torch.float32), loss_ab)
        rows, n_out, terms = packed, 10, ck.maha3_terms
    else:
        params = ck.maha6_params(
            torch.as_tensor(pose.rotation, dtype=torch.float32),
            torch.as_tensor(pose.translation, dtype=torch.float32),
            loss_ab,
        )
        normals = packed[6:9] / np.linalg.norm(packed[6:9], axis=0, keepdims=True)
        rows = np.concatenate([packed[0:6], normals, packed[15:16]]).astype(np.float32)
        n_out, terms = 28, ck.p2p_terms
    inp = tmp / f"in_{kernel}_{code}.bin"
    out = tmp / f"out_{kernel}_{code}.bin"
    with open(inp, "wb") as f:
        f.write(np.asarray([code, n], np.int32).tobytes())
        f.write(params.numpy().astype(np.float32).tobytes())
        f.write(np.ascontiguousarray(rows.T).tobytes())
    subprocess.run([str(exe), str(inp), str(out), kernel], check=True, timeout=60)
    got = np.fromfile(out, np.float32).reshape(n, n_out)
    want = terms(params[None], torch.as_tensor(rows)[None], code)[0].T.numpy()
    _assert_terms_close(got, want)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("kernel", ["maha3c", "reproj"])
def test_compact_and_reproj_headers_match_plain_terms(harness, factors, kernel, loss):
    """maha3c_accumulate over the compact Gram rows that pack_maha3_compact
    makes of the maha6 rows (masked factors included); reproj_accumulate
    over 3D-2D rows, a tenth of them behind the 0.03 depth gate."""
    packed, pose = factors
    n = packed.shape[1]
    if kernel == "maha3c":
        code, loss_ab = ck.maha6_loss_ab(loss, "cpu")
        q = pose.quaternion()
        R2 = lie.rot2(torch.tensor(2.0 * np.arctan2(q[3], q[0]), dtype=torch.float32))
        params = ck.maha3_params(R2, torch.as_tensor(pose.translation[:2], dtype=torch.float32), loss_ab)
        rows = ck.pack_maha3_compact(tmaha.unpack_maha6(torch.as_tensor(packed))).numpy()
        n_out, terms = 10, ck.maha3c_terms
    else:
        code, loss_ab = ck.reproj_loss_ab(loss, "cpu")
        intr = treproj.CameraIntrinsics.create(525.0, 525.0, 320.0, 240.0)
        small = port.Pose.from_axis_angle(0.1, pose.rotation[:, 0], 0.1 * pose.translation)
        params = ck.reproj_params(
            torch.as_tensor(small.rotation, dtype=torch.float32),
            torch.as_tensor(small.translation, dtype=torch.float32), intr, loss_ab,
        )
        X = packed[0:3] + np.array([[0.0], [0.0], [4.0]], np.float32)
        X[2, : n // 10] = np.linspace(-1.0, 0.1, n // 10)  # near or behind the gate
        pixels = 320.0 + 100.0 * packed[3:5]
        rows = np.concatenate([X, pixels, packed[15:16]]).astype(np.float32)
        n_out, terms = 28, ck.reproj_terms
    got = _run_harness(harness, kernel, code, params, rows, n_out)
    want = terms(params[None], torch.as_tensor(rows)[None], code)[0].T.numpy()
    _assert_terms_close(got, want)
