// Planar 3-DoF (x, y, yaw) Mahalanobis (NDT) factor quadratic on the GPU:
// for B problems, each a packed (16, N) buffer in the maha6 layout, the 6
// upper-triangle entries of the 3x3 H = sum w J^T J, the 3 of g and the
// cost, under one of 7 robust losses. Only x and y are warped; z passes
// through, so the residual stays 3-D, and
// J = [S[:, :2] | S[:, :2] R2 (-p_y, p_x)].
//
// Replaces nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:
// _maha3_kernel, with its wrappers _maha3_pallas (one problem) and
// _maha3_pallas_v (a batch). The TPU kernel pads its output to 16 floats
// for alignment; this one writes the 10 that carry values. It reads the
// buffer that the registrar's matcher writes for the 6-DoF kernel, so the
// planar mode needs no packing of its own.
//
// params (B, 8): [R2 row-major 4, t2 2, loss a, loss b]. The per-factor
// arithmetic is maha3_accumulate in factor_math.cuh; the one-launch
// fixed-order reduction (bitwise repeatable, invariant to trailing zero
// lanes) is onepass.cuh.
//
// Why CUDA C++ and not Triton: the arithmetic lives in a __host__ __device__
// header that g++ builds into a CPU test harness, so the kernel's
// arithmetic is checked on machines without a GPU; the build is a few
// seconds of nvcc with a plain C interface.
//
// Bound on an H100 SXM (3.35 TB/s). Each factor reads 64 B (16 rows of
// 4 B) and does about 121 float operations: bytes bound it.
// - At the main path's N = 18,712: 1.2 MB, 0.36 us of bytes, far below a
//   launch's latency. The design takes one launch instead of two and
//   reduces the 10 outputs of a warp in 16 shuffles instead of 50.
// - At N = 1,000,003: 64 MB, 19.1 us of bytes. The design streams aligned
//   vector loads from persistent blocks that load their next tile while
//   they reduce the current one.
// - The bf16-row instantiation reads 32 B a factor: 9.6 us of bytes at
//   N = 1,000,003.
#include "onepass.cuh"

namespace {

struct Maha3 {
  static constexpr int kRows = nls::kMaha6Rows;
  static constexpr int kParams = nls::kMaha3Params;
  static constexpr int kOut = nls::kMaha3Out;
  template <int kLoss>
  static NLS_HD void accumulate(const float* prm, const float* f, float* acc) {
    nls::maha3_accumulate<kLoss>(prm, f, acc);
  }
};

// The same factor over bf16 maha6 rows (the TPU kernel's bf16-storage
// option): bf16 loads, float32 arithmetic.
struct Maha3Bf16 : Maha3 {
  using Elem = __nv_bfloat16;
};

}  // namespace

extern "C" {

// See nls::onepass::launch: params (batch, 8), packed (batch, 16, ld),
// workspace (batch, 10, num_tiles(n)) floats, counters (batch,) zero,
// out (batch, 10).
int nls_maha3_launch(int device, const float* params, const float* packed, int batch, int64_t n,
                     int64_t ld, int loss_code, float* workspace, unsigned int* counters,
                     float* out, void* stream) {
  return nls::onepass::launch<Maha3>(device, params, packed, batch, n, ld, loss_code, workspace,
                                     counters, out, stream);
}

// The same over bf16 rows: packed (batch, 16, ld) bf16, ld % 8 == 0.
int nls_maha3_bf16_launch(int device, const float* params, const void* packed, int batch,
                          int64_t n, int64_t ld, int loss_code, float* workspace,
                          unsigned int* counters, float* out, void* stream) {
  return nls::onepass::launch<Maha3Bf16>(device, params, packed, batch, n, ld, loss_code,
                                         workspace, counters, out, stream);
}

}  // extern "C"
