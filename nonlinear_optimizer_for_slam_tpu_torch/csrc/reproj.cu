// Reprojection (PnP) factor quadratic on the GPU: for B problems, each a
// packed (6, N) buffer of 3D-2D correspondences (X 3, pixel 2, mask), the 21
// upper-triangle entries of the 6x6 H = sum w J^T J, the 6 of g and the
// cost, under one of 7 robust losses. Residuals are on the normalised image
// plane, r = Xw_xy / Xw_z - K^-1 (pixel - c) with Xw = R X + t; a point
// with Xw_z below the minimum depth (0.03) is gated out as a mask.
//
// Replaces nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:
// _reproj_kernel, with its wrapper _reproj_pallas. The TPU packing has 8
// rows, the last 2 zero (sublane padding); this one reads the 6 that carry
// values.
//
// params (B, 20): [R row-major 9, t 3, inv_fx, inv_fy, cx, cy, loss a,
// loss b, min depth, 0]. The per-factor arithmetic is reproj_accumulate in
// factor_math.cuh; the two-pass fixed-order reduction (bitwise repeatable)
// is partials.cuh. Built without --use_fast_math: 1/Xw_z is an IEEE
// division, as in the plain version.
//
// Why CUDA C++ and not Triton: the arithmetic lives in a __host__ __device__
// header that g++ builds into a CPU test harness, so the kernel's
// arithmetic is checked on machines without a GPU; the build is a few
// seconds of nvcc with a plain C interface.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32). Each factor reads
// 24 B (6 rows of 4 B) and does about 230 float operations: about 10
// operations a byte, under the card's 20, so bound by bytes at large N. At
// the PnP minimizer's N (630 correspondences padded to 1,024) that is
// 25 KB, under 0.01 us; the call is bound by the latency of its two
// launches.
#include "partials.cuh"

namespace {

struct Reproj {
  static constexpr int kRows = nls::kReprojRows;
  static constexpr int kParams = nls::kReprojParams;
  static constexpr int kOut = nls::kReprojOut;
  template <int kLoss>
  static NLS_HD void accumulate(const float* prm, const float* f, float* acc) {
    nls::reproj_accumulate<kLoss>(prm, f, acc);
  }
};

}  // namespace

extern "C" {

int nls_reproj_num_blocks(int64_t n) { return nls::num_blocks(n); }

// See nls::launch in partials.cuh: params (batch, 20), packed
// (batch, 6, n), partials (batch, nls_reproj_num_blocks(n), 28), out
// (batch, 28).
int nls_reproj_launch(int device, const float* params, const float* packed,
                      int batch, int64_t n, int loss_code, float* partials,
                      float* out, void* stream) {
  return nls::launch<Reproj>(device, params, packed, batch, n, loss_code,
                             partials, out, stream);
}

}  // extern "C"
