// Planar 3-DoF (x, y, yaw) Mahalanobis (NDT) factor quadratic over the
// compact Gram packing, on the GPU: for B problems, each a packed (10, N)
// buffer (u, mu_xy, M00 M01 M11, v, szz; the mask folded into M, v and szz
// by ops/cuda_kernels.pack_maha3_compact), the 6 upper-triangle entries of
// the 3x3 H, the 3 of g and the cost, under one of 7 robust losses.
//
// Replaces nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:
// _maha3c_kernel, with its wrapper _maha3c_pallas. The TPU kernel pads its
// output to 16 floats for alignment; this one writes the 10 that carry
// values. The Gram form reassociates maha3's row-by-row sum of |S e|^2, so
// the two agree to float32 rounding, not bit for bit.
//
// params (B, 8): [R2 row-major 4, t2 2, loss a, loss b], those of maha3. The
// per-factor arithmetic is maha3c_accumulate in factor_math.cuh; the
// two-pass fixed-order reduction (bitwise repeatable) is partials.cuh.
//
// Why CUDA C++ and not Triton: the arithmetic lives in a __host__ __device__
// header that g++ builds into a CPU test harness, so the kernel's
// arithmetic is checked on machines without a GPU; the build is a few
// seconds of nvcc with a plain C interface.
//
// Bound on an H100 SXM (3.35 TB/s). Each factor reads 40 B (10 rows of
// 4 B), against 64 B for maha3's rows, and does about 60 float operations:
// bound by bytes at large N. At the planar minimizer's N (18,712
// correspondences padded to 19,456) that is 0.78 MB, 0.23 us at
// 3.35 TB/s; like the other kernels, the call is bound by the latency of
// its two launches at these sizes, not by bytes or operations.
#include "partials.cuh"

namespace {

struct Maha3c {
  static constexpr int kRows = nls::kMaha3cRows;
  static constexpr int kParams = nls::kMaha3cParams;
  static constexpr int kOut = nls::kMaha3cOut;
  template <int kLoss>
  static NLS_HD void accumulate(const float* prm, const float* f, float* acc) {
    nls::maha3c_accumulate<kLoss>(prm, f, acc);
  }
};

}  // namespace

extern "C" {

int nls_maha3c_num_blocks(int64_t n) { return nls::num_blocks(n); }

// See nls::launch in partials.cuh: params (batch, 8), packed
// (batch, 10, n), partials (batch, nls_maha3c_num_blocks(n), 10), out
// (batch, 10).
int nls_maha3c_launch(int device, const float* params, const float* packed,
                      int batch, int64_t n, int loss_code, float* partials,
                      float* out, void* stream) {
  return nls::launch<Maha3c>(device, params, packed, batch, n, loss_code,
                             partials, out, stream);
}

}  // extern "C"
