// 6-DoF Mahalanobis (NDT) factor quadratic on the GPU: for B problems,
// each a packed (16, N) buffer of correspondences, the 21 upper-triangle
// entries of H = sum w J^T J, the 6 of g = sum w J^T r and the cost
// sum rho, under one of 7 robust losses.
//
// Replaces nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:
// _maha6_kernel, with its wrappers _maha6_pallas (one problem) and
// _maha6_pallas_v (a batch). The TPU kernel's plane layout, lane-block
// padding and SMEM/VMEM wrapper twins are not carried over.
//
// Rows of packed: p (0-2), mu (3-5), S row-major (6-14), mask (15), each
// row starting every ld floats (ld a multiple of 4). params (B, 16):
// [R row-major 9, t 3, loss a, loss b, 0, 0]. The per-factor arithmetic is
// maha6_accumulate in factor_math.cuh; the one-launch fixed-order reduction
// (bitwise repeatable, invariant to trailing zero lanes) is onepass.cuh.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores). Each factor reads 64 B and does about 314 float operations, 5 a
// byte, far below the 20 a byte at which the float32 units would be the
// limit: bytes bound it, not operations.
// - At the main path's N = 18,712 (9,356 scan points x 2 neighbours) the
//   buffer is 1.2 MB: 0.36 us of bytes and 0.09 us of operations, far
//   below the latency of a launch. The design takes one launch (the last
//   block adds the tile sums) instead of two, issues a tile's 16 row loads
//   before it waits for the params, spreads the 37 tiles of 512 lanes over
//   37 SMs, and reduces the 28 outputs of a warp in 31 shuffles instead of
//   140.
// - At N = 1,000,003 the buffer is 64 MB: 19.1 us of bytes, 4.7 us of
//   operations. The design streams aligned vector loads from as many
//   persistent blocks as the card holds, each loading its next tile while
//   it reduces the current one.
// - The bf16-row instantiation halves the bytes (32 B a factor: 9.6 us of
//   bytes at N = 1,000,003, still above its 4.7 us of operations).
#include "onepass.cuh"

namespace {

struct Maha6 {
  static constexpr int kRows = nls::kMaha6Rows;
  static constexpr int kParams = nls::kMaha6Params;
  static constexpr int kOut = nls::kMaha6Out;
  template <int kLoss>
  static NLS_HD void accumulate(const float* prm, const float* f, float* acc) {
    nls::maha6_accumulate<kLoss>(prm, f, acc);
  }
};

// The same factor over bf16 rows (pack_maha6(..., buffer_dtype=bfloat16),
// the TPU kernel's bf16-storage option, pallas_kernels.py:285-304): bf16
// loads, float32 arithmetic.
struct Maha6Bf16 : Maha6 {
  using Elem = __nv_bfloat16;
};

}  // namespace

extern "C" {

// See nls::onepass::launch: params (batch, 16), packed (batch, 16, ld),
// workspace (batch, 28, num_tiles(n)) floats, counters (batch,) zero,
// out (batch, 28).
int nls_maha6_launch(int device, const float* params, const float* packed, int batch, int64_t n,
                     int64_t ld, int loss_code, float* workspace, unsigned int* counters,
                     float* out, void* stream) {
  return nls::onepass::launch<Maha6>(device, params, packed, batch, n, ld, loss_code, workspace,
                                     counters, out, stream);
}

// The same over bf16 rows: packed (batch, 16, ld) bf16, ld % 8 == 0.
int nls_maha6_bf16_launch(int device, const float* params, const void* packed, int batch,
                          int64_t n, int64_t ld, int loss_code, float* workspace,
                          unsigned int* counters, float* out, void* stream) {
  return nls::onepass::launch<Maha6Bf16>(device, params, packed, batch, n, ld, loss_code,
                                         workspace, counters, out, stream);
}

// An empty kernel through the same ctypes path: the launch floor.
int nls_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  nls::onepass::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
