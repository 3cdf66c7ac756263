// Per-factor arithmetic of the factor kernels (maha6, maha3, maha3c, reproj,
// p2p).
//
// The functions here are __host__ __device__ so that the same source is
// built by nvcc into the kernels (maha6.cu, maha3.cu, maha3c.cu, reproj.cu,
// p2p.cu) and by a plain C++ compiler into a CPU harness
// (tests/test_torch_factor_math.py), which checks the kernels' arithmetic
// without a GPU.
//
// Counterpart of _eval_loss and of the per-lane bodies of _maha6_kernel,
// _maha3_kernel, _maha3c_kernel, _reproj_kernel and _p2p_kernel in
// nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define NLS_HD __host__ __device__ __forceinline__
#define NLS_UNROLL _Pragma("unroll")
#else
#define NLS_HD inline
#define NLS_UNROLL
#endif

namespace nls {

// Loss codes; the order of ops/cuda_kernels.py:_loss_static.
enum LossCode : int {
  kLossNone = 0,
  kLossExp = 1,
  kLossHuber = 2,
  kLossCauchy = 3,
  kLossTukey = 4,
  kLossGemanMcClure = 5,
  kLossDCS = 6,
  kNumLosses = 7,
};

// Packed rows of one 6-DoF factor: p (0-2), mu (3-5), S row-major (6-14),
// mask (15). Params: R row-major (0-8), t (9-11), loss a (12), loss b (13).
constexpr int kMaha6Rows = 16;
constexpr int kMaha6Params = 16;
// Outputs: 21 upper-triangle entries of H (row-major), 6 of g, the cost.
constexpr int kMaha6Out = 28;

// exp(x), rounded near 1 as a correctly rounded exp rounds it (the
// plain versions' core/losses.py:exp_rounded): close to an optimum the
// exponential loss's cost is a sum of values a few ulps from 1. For
// x > -ln 2, 1 + expm1(x) rounds once from a value accurate far below an
// ulp of 1.
NLS_HD float exp_rounded(float x) {
  return x > -0.693147180559945f ? 1.0f + expm1f(x) : expf(x);
}

// (rho, w) for the squared residual norm sq; w is rho' with the
// exponential loss's factor 2 (reference loss_function.h:28-41).
template <int kLoss>
NLS_HD void eval_loss(float sq, float a, float b, float* rho, float* w) {
  if constexpr (kLoss == kLossNone) {
    *rho = sq;
    *w = 1.0f;
  } else if constexpr (kLoss == kLossExp) {
    const float exp_term = exp_rounded(-b * sq);
    *rho = a - a * exp_term;
    *w = 2.0f * a * b * exp_term;
  } else if constexpr (kLoss == kLossCauchy) {
    // a = scale; rho = a^2 log1p(s/a^2), w = 1/(1 + s/a^2)
    const float c2 = a * a;
    *rho = c2 * log1pf(sq / c2);
    *w = 1.0f / (1.0f + sq / c2);
  } else if constexpr (kLoss == kLossTukey) {
    // a = threshold b; saturates at b^2/3 with zero weight beyond
    const float b2 = a * a;
    const float u = fmaxf(1.0f - sq / b2, 0.0f);
    *rho = (b2 / 3.0f) * (1.0f - u * u * u);
    *w = u * u;
  } else if constexpr (kLoss == kLossGemanMcClure) {
    // a = scale c; rho = c^2 s / (c^2 + s), w = (c^2/(c^2+s))^2
    const float c2 = a * a;
    const float inv = c2 / (c2 + sq);
    *rho = sq * inv;
    *w = inv * inv;
  } else if constexpr (kLoss == kLossDCS) {
    // a = Phi; truncated quadratic with the sq <= Phi inlier test
    const bool inlier = sq <= a;
    *rho = inlier ? sq : a;
    *w = inlier ? 1.0f : 0.0f;
  } else {
    static_assert(kLoss == kLossHuber, "unknown loss code");
    // a = threshold; sqrt of a guarded value, as the JAX losses do
    const float sq_delta = a * a;
    const bool outlier = sq > sq_delta;
    const float root = sqrtf(outlier ? sq : sq_delta);
    *rho = outlier ? 2.0f * a * root - sq_delta : sq;
    *w = outlier ? a / root : 1.0f;
  }
}

// Adds one factor's 28 terms into acc: w J^T J (upper), w J^T r, rho.
// prm: the 16 params; f: the factor's 16 packed rows.
template <int kLoss>
NLS_HD void maha6_accumulate(const float* prm, const float* f, float* acc) {
  const float* R = prm;  // R[3*i+j]
  const float* t = prm + 9;
  const float* p = f;
  const float* mu = f + 3;
  const float* S = f + 6;  // S[3*i+j]
  const float mask = f[15];

  // e = R p + t - mu
  float e[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    e[i] = R[3 * i + 0] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2] +
           t[i] - mu[i];
  }
  // r = S e
  float r[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    r[i] = S[3 * i + 0] * e[0] + S[3 * i + 1] * e[1] + S[3 * i + 2] * e[2];
  }
  const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  float rho, w;
  eval_loss<kLoss>(sq, prm[12], prm[13], &rho, &w);
  w = w * mask;
  rho = rho * mask;

  // J = [S | -B skew(p)] with B = S R: the last three columns are cross
  // products of the rows of B with p
  // (mahalanobis_distance_minimizer_analytic.cc:170-185).
  float J[3][6];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    float B[3];
    NLS_UNROLL
    for (int j = 0; j < 3; ++j) {
      B[j] = S[3 * i + 0] * R[0 + j] + S[3 * i + 1] * R[3 + j] +
             S[3 * i + 2] * R[6 + j];
    }
    J[i][0] = S[3 * i + 0];
    J[i][1] = S[3 * i + 1];
    J[i][2] = S[3 * i + 2];
    J[i][3] = -(B[1] * p[2] - B[2] * p[1]);
    J[i][4] = -(B[2] * p[0] - B[0] * p[2]);
    J[i][5] = -(B[0] * p[1] - B[1] * p[0]);
  }

  int k = 0;
  NLS_UNROLL
  for (int a = 0; a < 6; ++a) {
    NLS_UNROLL
    for (int b = a; b < 6; ++b) {
      acc[k++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] + J[2][a] * J[2][b]);
    }
  }
  NLS_UNROLL
  for (int a = 0; a < 6; ++a) {
    acc[k++] += w * (J[0][a] * r[0] + J[1][a] * r[1] + J[2][a] * r[2]);
  }
  acc[k] += rho;
}

// Planar 3-DoF (x, y, yaw) over the same 16 packed rows as maha6. Params:
// R2 row-major (0-3), t2 (4-5), loss a (6), loss b (7).
constexpr int kMaha3Params = 8;
// Outputs: 6 upper-triangle entries of the 3x3 H, 3 of g, the cost.
constexpr int kMaha3Out = 10;

// Adds one factor's 10 planar terms into acc
// (reference: mahalanobis_distance_minimizer_analytic_3dof.cc:110-139).
template <int kLoss>
NLS_HD void maha3_accumulate(const float* prm, const float* f, float* acc) {
  const float R00 = prm[0], R01 = prm[1], R10 = prm[2], R11 = prm[3];
  const float* p = f;
  const float* mu = f + 3;
  const float* S = f + 6;  // S[3*i+j]
  const float mask = f[15];

  // warp xy only; z passes through, so the residual stays 3-D
  const float wx = R00 * p[0] + R01 * p[1] + prm[4];
  const float wy = R10 * p[0] + R11 * p[1] + prm[5];
  const float e[3] = {wx - mu[0], wy - mu[1], p[2] - mu[2]};
  float r[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    r[i] = S[3 * i + 0] * e[0] + S[3 * i + 1] * e[1] + S[3 * i + 2] * e[2];
  }
  const float sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  float rho, w;
  eval_loss<kLoss>(sq, prm[6], prm[7], &rho, &w);
  w = w * mask;
  rho = rho * mask;

  // dR/dtheta u = R [-u_y, u_x]; J = [S[:, :2] | S[:, :2] (R [-u_y, u_x])]
  const float rx = R00 * -p[1] + R01 * p[0];
  const float ry = R10 * -p[1] + R11 * p[0];
  float J[3][3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    J[i][0] = S[3 * i + 0];
    J[i][1] = S[3 * i + 1];
    J[i][2] = S[3 * i + 0] * rx + S[3 * i + 1] * ry;
  }

  int k = 0;
  NLS_UNROLL
  for (int a = 0; a < 3; ++a) {
    NLS_UNROLL
    for (int b = a; b < 3; ++b) {
      acc[k++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] + J[2][a] * J[2][b]);
    }
  }
  NLS_UNROLL
  for (int a = 0; a < 3; ++a) {
    acc[k++] += w * (J[0][a] * r[0] + J[1][a] * r[1] + J[2][a] * r[2]);
  }
  acc[k] += rho;
}

// Point-to-plane: packed rows p (0-2), mu (3-5), n (6-8), mask (9); the
// params and outputs of maha6.
constexpr int kP2pRows = 10;
constexpr int kP2pParams = kMaha6Params;
constexpr int kP2pOut = kMaha6Out;

// Adds one factor's 28 terms: r = n.(R p + t - mu),
// J = [n^T | -n^T R skew(p)] (reference: pose_optimizer/cost_functors.h:
// 106-157), the columns of R skew(p) as cross products.
template <int kLoss>
NLS_HD void p2p_accumulate(const float* prm, const float* f, float* acc) {
  const float* R = prm;  // R[3*i+j]
  const float* t = prm + 9;
  const float* p = f;
  const float* mu = f + 3;
  const float* n = f + 6;
  const float mask = f[9];

  float e[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    e[i] = R[3 * i + 0] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2] +
           t[i] - mu[i];
  }
  const float r = n[0] * e[0] + n[1] * e[1] + n[2] * e[2];
  float rho, w;
  eval_loss<kLoss>(r * r, prm[12], prm[13], &rho, &w);
  w = w * mask;
  rho = rho * mask;

  float J[6];
  J[0] = n[0];
  J[1] = n[1];
  J[2] = n[2];
  float col[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) col[i] = R[3 * i + 1] * p[2] - R[3 * i + 2] * p[1];
  J[3] = -(n[0] * col[0] + n[1] * col[1] + n[2] * col[2]);
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) col[i] = R[3 * i + 2] * p[0] - R[3 * i + 0] * p[2];
  J[4] = -(n[0] * col[0] + n[1] * col[1] + n[2] * col[2]);
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) col[i] = R[3 * i + 0] * p[1] - R[3 * i + 1] * p[0];
  J[5] = -(n[0] * col[0] + n[1] * col[1] + n[2] * col[2]);

  int k = 0;
  NLS_UNROLL
  for (int a = 0; a < 6; ++a) {
    NLS_UNROLL
    for (int b = a; b < 6; ++b) acc[k++] += w * J[a] * J[b];
  }
  NLS_UNROLL
  for (int a = 0; a < 6; ++a) acc[k++] += w * J[a] * r;
  acc[k] += rho;
}

// Planar 3-DoF over the compact Gram packing: rows u (0-1), mu_xy (2-3),
// M00 M01 M11 (4-6), v (7-8), szz (9), with M = sum_i a_i a_i^T,
// v = sum_i a_i wz_i, szz = sum_i wz_i^2 (a_i = S[i, :2],
// wz_i = S[i, 2] (p_z - mu_z)), each multiplied by the mask at pack time.
// The params and outputs of maha3.
constexpr int kMaha3cRows = 10;
constexpr int kMaha3cParams = kMaha3Params;
constexpr int kMaha3cOut = kMaha3Out;

// Adds one factor's 10 planar terms: e = R2 u + t2 - mu_xy,
// |r|^2 = e^T M e + 2 v.e + szz, H = [M | M rs; rs^T M rs], g = [M e + v;
// rs.(M e + v)] with rs = R2 (-u_y, u_x). A masked factor has M, v and szz
// zero, so |r|^2 = 0 and rho(0) = 0 for every loss: it adds nothing.
template <int kLoss>
NLS_HD void maha3c_accumulate(const float* prm, const float* f, float* acc) {
  const float R00 = prm[0], R01 = prm[1], R10 = prm[2], R11 = prm[3];
  const float u0 = f[0], u1 = f[1];
  const float M00 = f[4], M01 = f[5], M11 = f[6];
  const float v0 = f[7], v1 = f[8];

  const float e0 = R00 * u0 + R01 * u1 + prm[4] - f[2];
  const float e1 = R10 * u0 + R11 * u1 + prm[5] - f[3];
  const float Me0 = M00 * e0 + M01 * e1;
  const float Me1 = M01 * e0 + M11 * e1;
  // float32 cancellation may leave the quadratic form slightly below 0;
  // the square-root losses need it non-negative
  const float sq =
      fmaxf(e0 * Me0 + e1 * Me1 + 2.0f * (v0 * e0 + v1 * e1) + f[9], 0.0f);
  float rho, w;
  eval_loss<kLoss>(sq, prm[6], prm[7], &rho, &w);

  const float rs0 = -R00 * u1 + R01 * u0;
  const float rs1 = -R10 * u1 + R11 * u0;
  const float MR0 = M00 * rs0 + M01 * rs1;
  const float MR1 = M01 * rs0 + M11 * rs1;
  const float g0 = Me0 + v0;
  const float g1 = Me1 + v1;
  acc[0] += w * M00;
  acc[1] += w * M01;
  acc[2] += w * MR0;
  acc[3] += w * M11;
  acc[4] += w * MR1;
  acc[5] += w * (rs0 * MR0 + rs1 * MR1);
  acc[6] += w * g0;
  acc[7] += w * g1;
  acc[8] += w * (rs0 * g0 + rs1 * g1);
  acc[9] += rho;
}

// Pinhole reprojection: packed rows X (0-2), pixel (3-4), mask (5). Params:
// R row-major (0-8), t (9-11), inv_fx, inv_fy, cx, cy (12-15), loss a (16),
// loss b (17), min depth (18), 0 (19). Outputs: those of maha6.
constexpr int kReprojRows = 6;
constexpr int kReprojParams = 20;
constexpr int kReprojOut = kMaha6Out;

// Adds one factor's 28 terms: Xw = R X + t, r = Xw_xy / Xw_z -
// K^-1 (pixel - c), J = dpi/dXw [I | -R skew(X)] (reference:
// reprojection_error_minimizer_analytic.cc:105-172). A point with
// Xw_z < min depth is gated out: r = 0 and its weight and cost are 0.
template <int kLoss>
NLS_HD void reproj_accumulate(const float* prm, const float* f, float* acc) {
  const float* R = prm;  // R[3*i+j]
  const float* t = prm + 9;
  const float* X = f;

  float Xw[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) {
    Xw[i] = R[3 * i + 0] * X[0] + R[3 * i + 1] * X[1] + R[3 * i + 2] * X[2] + t[i];
  }
  const bool in_front = Xw[2] >= prm[18];
  const float valid = in_front ? 1.0f : 0.0f;
  const float inv_z = 1.0f / (in_front ? Xw[2] : 1.0f);
  const float inv_z2 = inv_z * inv_z;
  const float r0 = (Xw[0] * inv_z - prm[12] * (f[3] - prm[14])) * valid;
  const float r1 = (Xw[1] * inv_z - prm[13] * (f[4] - prm[15])) * valid;
  float rho, w;
  eval_loss<kLoss>(r0 * r0 + r1 * r1, prm[16], prm[17], &rho, &w);
  const float m = f[5] * valid;
  w = w * m;
  rho = rho * m;

  // dpi/dXw = [[inv_z, 0, dx], [0, inv_z, dy]]; the columns of R skew(X)
  // are cross products of the rows of R with X
  const float dx = -Xw[0] * inv_z2;
  const float dy = -Xw[1] * inv_z2;
  float J[2][6];
  J[0][0] = inv_z;
  J[0][1] = 0.0f;
  J[0][2] = dx;
  J[1][0] = 0.0f;
  J[1][1] = inv_z;
  J[1][2] = dy;
  float col[3];
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) col[i] = R[3 * i + 1] * X[2] - R[3 * i + 2] * X[1];
  J[0][3] = -(inv_z * col[0] + dx * col[2]);
  J[1][3] = -(inv_z * col[1] + dy * col[2]);
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) col[i] = R[3 * i + 2] * X[0] - R[3 * i + 0] * X[2];
  J[0][4] = -(inv_z * col[0] + dx * col[2]);
  J[1][4] = -(inv_z * col[1] + dy * col[2]);
  NLS_UNROLL
  for (int i = 0; i < 3; ++i) col[i] = R[3 * i + 0] * X[1] - R[3 * i + 1] * X[0];
  J[0][5] = -(inv_z * col[0] + dx * col[2]);
  J[1][5] = -(inv_z * col[1] + dy * col[2]);

  int k = 0;
  NLS_UNROLL
  for (int a = 0; a < 6; ++a) {
    NLS_UNROLL
    for (int b = a; b < 6; ++b) {
      acc[k++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b]);
    }
  }
  NLS_UNROLL
  for (int a = 0; a < 6; ++a) acc[k++] += w * (J[0][a] * r0 + J[1][a] * r1);
  acc[k] += rho;
}

}  // namespace nls
