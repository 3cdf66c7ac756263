// Point-to-plane factor quadratic on the GPU: for B problems, each a
// packed (10, N) buffer of point-plane pairs, the 21 upper-triangle
// entries of H = sum w J^T J, the 6 of g and the cost, under one of 7
// robust losses, with r = n.(R p + t - mu) and J = [n^T | -n^T R skew(p)].
//
// Replaces nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:
// _p2p_kernel, with its wrappers _p2p_pallas (one problem) and
// _p2p_pallas_v (a batch). Rows of packed: p (0-2), mu (3-5), n (6-8),
// mask (9), each row starting every ld floats (ld a multiple of 4). The
// TPU kernel's buffer has 6 more zero rows, sublane padding for the TPU's
// (8, 128) tiles; they carry nothing, and this layout drops them.
//
// params (B, 16), as maha6: [R row-major 9, t 3, loss a, loss b, 0, 0].
// The per-factor arithmetic is p2p_accumulate in factor_math.cuh; the
// one-launch fixed-order reduction (bitwise repeatable, invariant to
// trailing zero lanes) is onepass.cuh.
//
// Why CUDA C++ and not Triton: the arithmetic lives in a __host__ __device__
// header that g++ builds into a CPU test harness, so the kernel's
// arithmetic is checked on machines without a GPU; the build is a few
// seconds of nvcc with a plain C interface.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores). Each factor reads 40 B (10 rows of 4 B) and does about 165 float
// operations: bytes bound it.
// - At the main path's N = 9,356 (scan points, one plane each) the buffer
//   is 0.37 MB: 0.11 us of bytes and 0.02 us of operations, far below the
//   latency of a launch. The design takes one launch (the last block adds
//   the tile sums) instead of two, spreads the 19 tiles of 512 lanes over
//   19 SMs, and reduces the 28 outputs of a warp in 31 shuffles instead of
//   140.
// - At N = 1,000,003 the buffer is 40 MB: 11.9 us of bytes, 2.5 us of
//   operations. The design streams aligned vector loads from as many
//   persistent blocks as the card holds, each loading its next tile while
//   it reduces the current one.
#include "onepass.cuh"

namespace {

struct P2p {
  static constexpr int kRows = nls::kP2pRows;
  static constexpr int kParams = nls::kP2pParams;
  static constexpr int kOut = nls::kP2pOut;
  template <int kLoss>
  static NLS_HD void accumulate(const float* prm, const float* f, float* acc) {
    nls::p2p_accumulate<kLoss>(prm, f, acc);
  }
};

}  // namespace

extern "C" {

// See nls::onepass::launch: params (batch, 16), packed (batch, 10, ld),
// workspace (batch, 28, num_tiles(n)) floats, counters (batch,) zero,
// out (batch, 28).
int nls_p2p_launch(int device, const float* params, const float* packed, int batch, int64_t n,
                   int64_t ld, int loss_code, float* workspace, unsigned int* counters,
                   float* out, void* stream) {
  return nls::onepass::launch<P2p>(device, params, packed, batch, n, ld, loss_code, workspace,
                                   counters, out, stream);
}

}  // extern "C"
