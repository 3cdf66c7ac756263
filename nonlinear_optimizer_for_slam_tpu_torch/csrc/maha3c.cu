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
// params (B, 8): [R2 row-major 4, t2 2, loss a, loss b], those of maha3.
// Rows of packed start every ld floats (ld a multiple of 4). The per-factor
// arithmetic is maha3c_accumulate in factor_math.cuh; the one-launch
// fixed-order reduction (bitwise repeatable, invariant to trailing zero
// lanes) is onepass.cuh.
//
// No mask row: a masked factor, and a zero lane below N (the planar
// minimizer pads 18,712 correspondences to 19,456), has M, v and szz equal
// to +0 or -0, so |r|^2 is a zero, rho(0) is a zero for all 7 losses and
// every term is a zero. Sums start at +0, and adding +0 or -0 to a float
// leaves its bits alone: such a lane adds nothing, wherever it lies.
//
// Why CUDA C++ and not Triton: the arithmetic lives in a __host__ __device__
// header that g++ builds into a CPU test harness, so the kernel's
// arithmetic is checked on machines without a GPU; the build is a few
// seconds of nvcc with a plain C interface.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores). Each factor reads 40 B (10 rows of 4 B), against 64 B for maha3's
// rows, and does about 76 float operations: bytes bound it.
// - At the main path's N = 18,712 the buffer is 0.75 MB: 0.22 us of bytes
//   and 0.02 us of operations, far below the latency of a launch. The
//   design takes one launch (the last block adds the tile sums) instead of
//   two, spreads the 37 tiles of 512 lanes over 37 SMs, and reduces the 10
//   outputs of a warp in 16 shuffles instead of 50.
// - At N = 1,000,003 the buffer is 40 MB: 11.9 us of bytes. The design
//   streams aligned vector loads from as many persistent blocks as the card
//   holds, each loading its next tile while it reduces the current one.
#include "onepass.cuh"

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

// See nls::onepass::launch: params (batch, 8), packed (batch, 10, ld),
// workspace (batch, 10, num_tiles(n)) floats, counters (batch,) zero,
// out (batch, 10).
int nls_maha3c_launch(int device, const float* params, const float* packed, int batch, int64_t n,
                      int64_t ld, int loss_code, float* workspace, unsigned int* counters,
                      float* out, void* stream) {
  return nls::onepass::launch<Maha3c>(device, params, packed, batch, n, ld, loss_code, workspace,
                                      counters, out, stream);
}

}  // extern "C"
