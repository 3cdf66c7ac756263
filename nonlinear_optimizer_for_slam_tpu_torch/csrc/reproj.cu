// Reprojection (PnP) factor quadratic on the GPU: for B problems, each a
// packed (6, N) buffer of 3D-2D correspondences, the 21 upper-triangle
// entries of the 6x6 H = sum w J^T J, the 6 of g and the cost, under one
// of 7 robust losses. Residuals are on the normalised image plane,
// r = Xw_xy / Xw_z - K^-1 (pixel - c) with Xw = R X + t; a point with Xw_z
// below the minimum depth (0.03) is gated out as a mask.
//
// Replaces nonlinear_optimizer_for_slam_tpu/ops/pallas_kernels.py:
// _reproj_kernel, with its wrapper _reproj_pallas. Rows of packed: X (0-2),
// pixel (3-4), mask (5), each row starting every ld floats (ld a multiple
// of 4), problems 6 ld apart. The TPU kernel's buffer has 2 more zero
// rows, sublane padding for the TPU's (8, 128) tiles; they carry nothing,
// and this layout drops them.
//
// params (B, 20): [R row-major 9, t 3, inv_fx, inv_fy, cx, cy, loss a,
// loss b, min depth, 0]. The per-factor arithmetic is reproj_accumulate in
// factor_math.cuh; the one-launch fixed-order reduction (bitwise
// repeatable, invariant to trailing zero lanes) is onepass.cuh. A gated or
// masked lane adds only zeros: its weight and cost are +0, so each of its
// terms is +0 or -0, which leave sums that start at +0 unchanged. Built
// without --use_fast_math: 1/Xw_z is an IEEE division, as in the plain
// version.
//
// Why CUDA C++ and not Triton: the arithmetic lives in a __host__ __device__
// header that g++ builds into a CPU test harness, so the kernel's
// arithmetic is checked on machines without a GPU; the build is a few
// seconds of nvcc with a plain C interface.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores). Each factor reads 24 B (6 rows of 4 B) and does about 239 float
// operations: 10 a byte, under the 20 a byte at which the float32 units
// would be the limit, so bytes bound it.
// - At the PnP minimizer's N (630 correspondences padded to 1,024) the
//   buffer is 25 KB, under 0.01 us of bytes: the call is bound by latency.
//   The design takes one launch instead of two, of two blocks in one
//   cluster that add their tile sums through distributed shared memory
//   (onepass.cuh's cluster finish, no ticket and no L2 round trip), and
//   reduces the 28 outputs of a warp in 31 shuffles instead of 140. On an
//   H100 SXM at 700 W: 4.0 us, against 4.7 through the ticket's finish and
//   6.3 for the two launches of the two-pass design it replaced.
// - At N = 1,000,003 the buffer is 24 MB: 7.2 us of bytes, 3.6 us of
//   operations. The design streams aligned vector loads from as many
//   persistent blocks as the card holds (75-80 registers: 3 blocks of 256
//   an SM), each loading its next tile while it reduces the current one.
//   It reaches about a third of the bytes bound there (22.1 us on the same
//   card, 5 % under the two-pass design's 23.2), so the bytes do not set
//   that time.
#include "onepass.cuh"

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

// See nls::onepass::launch: params (batch, 20), packed (batch, 6, ld),
// workspace (batch, 28, num_tiles(n)) floats, counters (batch,) zero,
// out (batch, 28).
int nls_reproj_launch(int device, const float* params, const float* packed, int batch, int64_t n,
                      int64_t ld, int loss_code, float* workspace, unsigned int* counters,
                      float* out, void* stream) {
  return nls::onepass::launch<Reproj>(device, params, packed, batch, n, ld, loss_code, workspace,
                                      counters, out, stream);
}

}  // extern "C"
