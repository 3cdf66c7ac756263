// Two-pass, fixed-order reduction of per-factor terms: the reduction of
// reproj.cu, and of the two-pass exports that maha6.cu, maha3.cu, maha3c.cu
// and p2p.cu keep beside their one-pass kernels (onepass.cuh) to time the
// two designs against each other. A kernel file names its factor as a
// struct with kRows, kParams, kOut and a device function
// accumulate<kLoss>(prm, f, acc) that adds one factor's kOut terms into acc
// (csrc/factor_math.cuh), and exports nls::launch<Factor> through a plain C
// function.
//
// Layout. packed is row-major (B, kRows, N) float32, so for one field
// neighbouring threads read neighbouring addresses. params is a device
// (B, kParams) float32 tensor; it is a pointer, not a by-value argument, so
// the pose never crosses to the host.
//
// Reduction. Pass 1, grid (num_blocks, B) of 256 threads: a grid-stride
// loop with a bounds check takes any N; each thread keeps kOut float
// partials in registers, the block reduces them in a fixed order (warp
// shuffles, then shared memory across warps) and writes
// partials[b, block, 0:kOut]. Pass 2, one block per problem, sums the blocks
// in a fixed order into out[b, 0:kOut]. There are no float atomics and
// num_blocks is a pure function of N, so two runs on the same input are
// bitwise equal (LM traces are compared iteration by iteration), and every
// problem of a batch is reduced exactly as it would be alone at its N.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "factor_math.cuh"

namespace nls {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Enough blocks to fill the card at large N; a block's threads stride
// over the rest.
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <class Factor, int kLoss>
__global__ void __launch_bounds__(kThreads)
    partials_kernel(const float* __restrict__ params,
                    const float* __restrict__ packed, int64_t n,
                    float* __restrict__ partials) {
  constexpr int kRows = Factor::kRows;
  constexpr int kParams = Factor::kParams;
  constexpr int kOut = Factor::kOut;
  const int b = blockIdx.y;
  __shared__ float prm[kParams];
  if (threadIdx.x < kParams) prm[threadIdx.x] = params[b * kParams + threadIdx.x];
  __syncthreads();

  const float* base = packed + static_cast<int64_t>(b) * kRows * n;
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    float f[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) f[k] = base[k * n + i];
    Factor::template accumulate<kLoss>(prm, f, acc);
  }

  __shared__ float warp_partials[kWarps][kOut];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) warp_partials[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_partials[w][threadIdx.x];
    partials[(static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * kOut +
             threadIdx.x] = s;
  }
}

// One block per problem; warp w sums outputs w, w + 8, ... over the blocks
// (lane j takes blocks j, j + 32, ...), then shuffles: a fixed order.
template <int kOut>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ partials, int num_blocks,
                  float* __restrict__ out) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* src = partials + static_cast<int64_t>(b) * num_blocks * kOut;
  for (int k = warp; k < kOut; k += kWarps) {
    float s = 0.0f;
    for (int j = lane; j < num_blocks; j += 32) s += src[j * kOut + k];
    s = warp_sum(s);
    if (lane == 0) out[b * kOut + k] = s;
  }
}

// Blocks of pass 1 for N factors: a pure function of N, so the reduction
// order, and with it every bit of the result, depends on N alone.
inline int num_blocks(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

template <class Factor, int kLoss>
void launch_partials(dim3 grid, cudaStream_t stream, const float* params,
                     const float* packed, int64_t n, float* partials) {
  partials_kernel<Factor, kLoss>
      <<<grid, kThreads, 0, stream>>>(params, packed, n, partials);
}

// params (batch, kParams), packed (batch, kRows, n), partials
// (batch, num_blocks(n), kOut), out (batch, kOut): float32 device pointers.
// Launches on `stream` and does not synchronise. Returns a cudaError_t:
// cudaErrorInvalidValue for a bad loss code or batch, else
// cudaGetLastError() after the launches.
template <class Factor>
int launch(int device, const float* params, const float* packed, int batch,
           int64_t n, int loss_code, float* partials, float* out,
           void* stream) {
  if (batch < 1 || batch > 65535 || n < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = num_blocks(n);
  const dim3 grid(blocks, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss_code) {
    case kLossNone:
      launch_partials<Factor, kLossNone>(grid, s, params, packed, n, partials);
      break;
    case kLossExp:
      launch_partials<Factor, kLossExp>(grid, s, params, packed, n, partials);
      break;
    case kLossHuber:
      launch_partials<Factor, kLossHuber>(grid, s, params, packed, n, partials);
      break;
    case kLossCauchy:
      launch_partials<Factor, kLossCauchy>(grid, s, params, packed, n, partials);
      break;
    case kLossTukey:
      launch_partials<Factor, kLossTukey>(grid, s, params, packed, n, partials);
      break;
    case kLossGemanMcClure:
      launch_partials<Factor, kLossGemanMcClure>(grid, s, params, packed, n,
                                                 partials);
      break;
    case kLossDCS:
      launch_partials<Factor, kLossDCS>(grid, s, params, packed, n, partials);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<Factor::kOut><<<batch, kThreads, 0, s>>>(partials, blocks, out);
  return cudaGetLastError();
}

}  // namespace nls
