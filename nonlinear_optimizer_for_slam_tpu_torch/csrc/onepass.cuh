// One-launch, fixed-order reduction of per-factor terms for Hopper, used by
// maha6.cu, maha3.cu, maha3c.cu, reproj.cu and p2p.cu. A kernel file names
// its factor as a struct with kRows, kParams, kOut and a device function
// accumulate<kLoss>(prm, f, acc) that adds one factor's kOut terms into acc
// (csrc/factor_math.cuh), and exports nls::onepass::launch<Factor> through
// a plain C function. params is a device (B, kParams) float32 tensor, a
// pointer and not a by-value argument, so the pose never crosses to the
// host.
//
// Layout. packed is (B, kRows, ld) float32 with N <= ld lanes in use: row r
// of problem b starts at (b kRows + r) ld. ld is a multiple of 4 and the
// buffer is 16-byte aligned (the wrapper checks both and raises otherwise),
// so a thread's lanes of a row are one aligned vector load. Lanes past N are
// never added: the one
// vector that straddles N is read whole (it lies inside the row, since
// ld >= round_up(N, 4)) and its lanes >= N skipped. A factor that names
// Elem = __nv_bfloat16 (maha6's and maha3's bf16-row instantiations) reads
// bf16 rows instead, ld a multiple of 8 (16-byte rows again): a thread's
// 2 lanes of a row are one 4-byte __nv_bfloat162 load, widened by
// __bfloat1622float2. Everything after the load, the order of summation
// included, is the float32 rows', so bf16 rows give the bits of the float32
// kernel on the same rows widened to float32.
//
// The order of the sum, which fixes every bit of the result, depends on the
// lane index alone:
//  1. A tile is kTile = 512 consecutive lanes, all rows. Thread t of the
//     block that takes a tile adds lanes 2t and 2t + 1, in index order, into
//     kOut float sums that start at +0.
//  2. Each warp reduces its threads' sums by reduce-scatter: the kOut sums
//     are padded to kWidth (a power of two) and halved at shuffle offsets
//     16, 8, ...: in each round a lane keeps one half of its values
//     (keeps_upper) and adds its partner's copy of that half. Output k ends
//     on lane owner(k): 31 shuffles for 28 outputs (maha6, reproj, p2p), 16
//     for 10 (maha3, maha3c), against 5 an output for a shuffle-down tree
//     of each.
//  3. The 8 warps' sums are added in warp order through shared memory, and
//     the tile's sum goes to its own slot, tile_partials[b, k, tile].
//  4. One block of a problem adds the tiles (the last to finish, or the
//     first of its cluster: see below): lane j of the warp that owns output
//     k takes tiles j, j + 32, ... in order, then the 32 lane sums meet in a
//     butterfly (offsets 16, 8, 4, 2, 1).
// Blocks are persistent (block x takes tiles x, x + gridDim.x, ...), and
// the grid is as many blocks as the card holds at once, capped at the tile
// count; as each tile's sum has its own slot, the grid never enters the
// bits. Trailing zero lanes add +0 to sums that start at +0, and trailing
// zero tiles add +0 at the end of a lane's chain: neither changes a bit, so
// a problem padded inside a ragged batch sums exactly as it does alone.
//
// The tile. 1,024 lanes (4 a thread, float4 loads) and 512 (2 a thread,
// float2 loads) were timed against each other on an H100 while this design
// was chosen: at the main path's N = 18,712, where a call is latency bound,
// the 512-lane tile spreads the work over twice the SMs and halves each
// thread's chain of factors, and was faster for both kernels; at
// N = 1,000,003 the two were within a few percent. Two other variants were
// slower at both N and were dropped: the next tile's loads issued before
// the current tile's factors (a double buffer in registers, which leaves
// room for one block an SM) and a cap of 3 blocks an SM (which spills). So
// was a ring of 3 shared-memory stages of 32 KB filled by cp.async.bulk
// under an mbarrier: the same bits, but slower at every N timed, as its
// stages leave fewer warps resident an SM than the register path.
//
// One launch. A block that has written its tile sums fences them
// (__threadfence) and takes a ticket from counters[b] (an integer
// atomicAdd); the block that draws the last ticket reads every tile's sums
// through L2 (__ldcg), writes out[b] and sets counters[b] back to 0. The
// ticket decides who adds, never the order, and no float is added
// atomically. The next launch on the stream starts after that reset, so
// the counters need no memset per call. Two launches that may run at once
// must never share a counter: the wrapper keeps one workspace per (kernel,
// device, stream) for eager calls, and gives a call captured into a CUDA
// graph a workspace of its own from the graph's memory pool, its counters
// zeroed by a captured fill (a graph replays on any stream, beside eager
// calls and other graphs). A launch that faults may leave a counter
// non-zero: that poisons only a CUDA context that the fault has already
// lost.
//
// The cluster finish. A problem of at most kClusterTiles = 16 tiles
// (N <= 8,192) takes one block a tile, and its blocks form one thread block
// cluster (16 is above the portable 8, so the kernel allows non-portable
// sizes). Each block writes its tile sum into the shared memory of the
// cluster's first block through distributed shared memory, which it may do
// only once every block of the cluster has started: it arrives at the
// cluster's barrier when it starts and waits before that write, so the
// wait overlaps its loads and factors. After a second barrier the first
// block adds the tiles as step 4 does (lane j takes tile j, then the
// butterfly), by the same code. So the bits are those of the ticket's
// finish, with no counter, no fence and no L2 round trip. On an H100 at
// 700 W it took reproj 4.2 us at 2 and 8 tiles and 4.4 at 16, against
// 5.0-5.2 for the ticket's finish on the same problems zero-padded to 17
// tiles. Larger problems keep the ticket: a cluster holds at most 16
// blocks, and the cluster finish takes one block a tile.
//
// No tensor cores. H = sum w J^T J is a (6 x N) by (N x 6) product of depth
// N, which the tensor cores take only in TF32 or bf16; evaluation paths stay
// in full float32 (reduced precision stalls LM). And it does about 5 float
// operations a byte, far below the float32 units' 20: a large N is bound by
// bytes, a small one by latency.
#pragma once

#include <stdint.h>

#include "factor_math.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>
#endif

namespace nls {
namespace onepass {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerThread = 2;
constexpr int kTile = kThreads * kLanesPerThread;
// Tile sums a lane of the finishing block reads before it adds them.
constexpr int kFinishBatch = 8;

// Tiles of a problem of n lanes.
NLS_HD int64_t num_tiles(int64_t n) { return n > 0 ? (n + kTile - 1) / kTile : 0; }

// The most tiles a problem may have for the cluster finish: one block a
// tile, all in one cluster.
constexpr int kClusterTiles = 16;

// Blocks of the cluster a problem of n lanes takes for the cluster finish,
// or 0 for the ticket's finish.
NLS_HD int64_t cluster_blocks(int64_t n) {
  const int64_t tiles = num_tiles(n);
  return tiles <= kClusterTiles ? (tiles > 0 ? tiles : 1) : 0;
}

// Floats of tile_partials that a launch over batch problems of n lanes and
// k_out outputs writes.
NLS_HD int64_t workspace_floats(int64_t batch, int64_t n, int k_out) {
  return batch * num_tiles(n) * k_out;
}

// The reduce-scatter's width: k_out padded to a power of two, at most 32.
NLS_HD constexpr int scatter_width(int k_out) {
  int w = 1;
  while (w < k_out) w *= 2;
  return w;
}

// In the halving round at shuffle offset `off`, a lane keeps the upper half
// of its values iff its lane index has the bit `off`.
NLS_HD constexpr bool keeps_upper(int lane, int off) { return (lane & off) != 0; }

// After the reduce-scatter of `width` values, lane `lane` holds output
// lane / (32 / width); output k is read from lane owner(k).
NLS_HD constexpr int held_output(int lane, int width) { return lane / (32 / width); }
NLS_HD constexpr int owner(int k, int width) { return k * (32 / width); }

#ifdef __CUDACC__

__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The halving rounds from kHalf values kept at shuffle offset kOff down to
// one, as compile-time recursion so that every index of v is a constant
// and v stays in registers.
template <int kHalf, int kOff, int kWidth>
__device__ __forceinline__ void halve(float (&v)[kWidth], int lane) {
  if constexpr (kHalf >= 1) {
    const bool upper = keeps_upper(lane, kOff);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
    }
    halve<kHalf / 2, kOff / 2>(v, lane);
  }
}

// Sum of v[k] over the warp, landing on lane owner(k); returns this lane's.
template <int kWidth>
__device__ __forceinline__ float reduce_scatter(float (&v)[kWidth], int lane) {
  static_assert(kWidth >= 1 && kWidth <= 32 && (kWidth & (kWidth - 1)) == 0,
                "the width is a power of two up to 32");
  halve<kWidth / 2, 16>(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = 16 / kWidth; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The storage type of a factor's packed rows: Factor::Elem where the
// factor names one (the bf16-row instantiations of maha6 and maha3), float
// otherwise. The arithmetic is float32 either way.
template <class Factor, class = void>
struct ElemOf {
  using type = float;
};
template <class Factor>
struct ElemOf<Factor, std::void_t<typename Factor::Elem>> {
  using type = typename Factor::Elem;
};

// A thread's 2 lanes of one row: one load, 8 bytes of float32 or 4 of
// bf16, widened to a float2 where the lanes are read.
template <class Elem>
struct Lanes;
template <>
struct Lanes<float> {
  using Vec = float2;
  static __device__ __forceinline__ float2 widen(const float2& v) { return v; }
};
template <>
struct Lanes<__nv_bfloat16> {
  using Vec = __nv_bfloat162;
  static __device__ __forceinline__ float2 widen(const __nv_bfloat162& v) {
    return __bfloat1622float2(v);
  }
};
template <class Factor>
using VecOf = typename Lanes<typename ElemOf<Factor>::type>::Vec;
static_assert(sizeof(Lanes<float>::Vec) == kLanesPerThread * sizeof(float), "one load a row");
static_assert(sizeof(Lanes<__nv_bfloat16>::Vec) == kLanesPerThread * sizeof(__nv_bfloat16),
              "one load a row");

__device__ __forceinline__ float lane_of(const float2& v, int j) { return j == 0 ? v.x : v.y; }

// Adds the first m of a thread's kLanesPerThread lanes, in index order.
template <class Factor, int kLoss, int kWidth>
__device__ __forceinline__ void add_lanes(const float* prm, const VecOf<Factor> (&v)[Factor::kRows],
                                          int64_t m, float (&acc)[kWidth]) {
  using L = Lanes<typename ElemOf<Factor>::type>;
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    if (j < m) {
      float f[Factor::kRows];
#pragma unroll
      for (int r = 0; r < Factor::kRows; ++r) f[r] = lane_of(L::widen(v[r]), j);
      Factor::template accumulate<kLoss>(prm, f, acc);
    }
  }
}

// The block's sum of every thread's acc into dst[k * stride] (k < kOut),
// in the fixed order of steps 2 and 3. Ends with a barrier, after which
// warp_out may be reused.
template <int kOut, int kWidth>
__device__ __forceinline__ void write_tile_sum(float (&acc)[kWidth],
                                               float (&warp_out)[kWarps][kOut], float* dst,
                                               int64_t stride) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float s = reduce_scatter<kWidth>(acc, lane);
  const int k = held_output(lane, kWidth);
  if (lane == owner(k, kWidth) && k < kOut) warp_out[warp][k] = s;
  __syncthreads();
  if (threadIdx.x < kOut) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_out[w][threadIdx.x];
    dst[threadIdx.x * stride] = t;
  }
  __syncthreads();
}

// Step 4: out[k] = the sum of load(k, t) over the tiles t, for k < kOut:
// lane j of warp k % kWarps takes tiles j, j + 32, ... in order, then the
// butterfly. Both finishes call it, so they add in one order.
template <int kOut, class Load>
__device__ __forceinline__ void add_tiles(int64_t tiles, Load load, float* out) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kPer = (kOut + kWarps - 1) / kWarps;  // outputs of a warp
  float s[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) s[q] = 0.0f;
  for (int64_t t0 = lane; t0 < tiles; t0 += 32 * kFinishBatch) {
    float x[kPer][kFinishBatch];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = warp + q * kWarps;
#pragma unroll
      for (int u = 0; u < kFinishBatch; ++u) {
        const int64_t t = t0 + 32 * u;
        x[q][u] = (k < kOut && t < tiles) ? load(k, t) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
#pragma unroll
      for (int u = 0; u < kFinishBatch; ++u) s[q] += x[q][u];
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = warp + q * kWarps;
    const float total = butterfly_sum(s[q]);
    if (k < kOut && lane == 0) out[k] = total;
  }
}

// The ticket's finish: the block that draws the last ticket of its problem
// adds the tiles, read through L2, and resets the counter.
template <int kOut>
__device__ __forceinline__ void finish_if_last(const float* partials, int64_t tiles,
                                               unsigned int* counter, float* out,
                                               unsigned int* ticket) {
  __threadfence();  // this block's tile sums, visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (*ticket != gridDim.x - 1) return;
  __threadfence();  // every other block's tile sums, visible to this one
  add_tiles<kOut>(
      tiles, [&](int k, int64_t t) { return __ldcg(partials + k * tiles + t); }, out);
  if (threadIdx.x == 0) *counter = 0u;
}

// A thread's loads of its lanes of one tile: one vector a row.
template <int kRows, class Elem, class Vec>
__device__ __forceinline__ void load_tile(Vec (&v)[kRows], const Elem* base, int64_t ld,
                                          int64_t tile, int64_t lane0) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    v[r] = __ldg(reinterpret_cast<const Vec*>(base + r * ld + tile * kTile + lane0));
  }
}

// Grid (blocks, B) of kThreads; see the file comment. params (B, kParams),
// packed (B, kRows, ld), tile_partials (B, kOut, num_tiles(n)), counters
// (B,) zero on entry and on exit, out (B, kOut).
template <class Factor, int kLoss>
__global__ void __launch_bounds__(kThreads)
    onepass_kernel(const float* __restrict__ params,
                   const typename ElemOf<Factor>::type* __restrict__ packed, int64_t n,
                   int64_t ld, float* __restrict__ tile_partials,
                   unsigned int* __restrict__ counters, float* __restrict__ out) {
  constexpr int kRows = Factor::kRows;
  constexpr int kParams = Factor::kParams;
  constexpr int kOut = Factor::kOut;
  constexpr int kWidth = scatter_width(kOut);
  static_assert(kOut <= kThreads && kParams <= kThreads, "one thread per output");
  __shared__ float prm[kParams];
  __shared__ float warp_out[kWarps][kOut];
  __shared__ unsigned int ticket;

  const int b = blockIdx.y;
  const int64_t tiles = num_tiles(n);
  const auto* base = packed + static_cast<int64_t>(b) * kRows * ld;
  float* partials = tile_partials + static_cast<int64_t>(b) * kOut * tiles;
  const int64_t lane0 = kLanesPerThread * static_cast<int64_t>(threadIdx.x);

  // The first tile's loads go out before the wait for the params.
  VecOf<Factor> v[kRows];
  int64_t tile = blockIdx.x;
  if (tile < tiles && tile * kTile + lane0 < n) load_tile<kRows>(v, base, ld, tile, lane0);
  if (threadIdx.x < kParams) prm[threadIdx.x] = params[b * kParams + threadIdx.x];
  __syncthreads();

  for (; tile < tiles; tile += gridDim.x) {
    float acc[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) acc[k] = 0.0f;
    const int64_t i0 = tile * kTile + lane0;
    if (i0 < n) add_lanes<Factor, kLoss, kWidth>(prm, v, n - i0, acc);
    // The block's next tile loads while this one is reduced.
    const int64_t next = tile + gridDim.x;
    if (next < tiles && next * kTile + lane0 < n) load_tile<kRows>(v, base, ld, next, lane0);
    write_tile_sum<kOut, kWidth>(acc, warp_out, partials + tile, tiles);
  }
  finish_if_last<kOut>(partials, tiles, counters + b, out + b * kOut, &ticket);
}

// The cluster's barrier in two halves (PTX barrier.cluster). A block may
// write another block's shared memory only once every block of the
// cluster has started: it arrives when it starts and waits before its
// first such write. Relaxed: the arrival publishes nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Grid (cluster_blocks(n), B) in clusters of (cluster_blocks(n), 1, 1):
// block x takes tile x of problem blockIdx.y, and the cluster's first block
// adds the tiles (the cluster finish of the file comment). params, packed
// and out as for onepass_kernel.
template <class Factor, int kLoss>
__global__ void __launch_bounds__(kThreads)
    onepass_cluster_kernel(const float* __restrict__ params,
                           const typename ElemOf<Factor>::type* __restrict__ packed, int64_t n,
                           int64_t ld, float* __restrict__ out) {
  constexpr int kRows = Factor::kRows;
  constexpr int kParams = Factor::kParams;
  constexpr int kOut = Factor::kOut;
  constexpr int kWidth = scatter_width(kOut);
  __shared__ float prm[kParams];
  __shared__ float warp_out[kWarps][kOut];
  __shared__ float tile_sums[kClusterTiles][kOut];  // the first block's are read

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited for after this block's factors
  const int b = blockIdx.y;
  const int64_t tiles = num_tiles(n);
  const int64_t tile = blockIdx.x;
  const auto* base = packed + static_cast<int64_t>(b) * kRows * ld;
  const int64_t lane0 = kLanesPerThread * static_cast<int64_t>(threadIdx.x);

  VecOf<Factor> v[kRows];
  const bool has_lanes = tile < tiles && tile * kTile + lane0 < n;
  if (has_lanes) load_tile<kRows>(v, base, ld, tile, lane0);
  if (threadIdx.x < kParams) prm[threadIdx.x] = params[b * kParams + threadIdx.x];
  __syncthreads();

  float acc[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) acc[k] = 0.0f;
  if (has_lanes) add_lanes<Factor, kLoss, kWidth>(prm, v, n - (tile * kTile + lane0), acc);
  cluster_wait();  // every block of the cluster has started
  if (tile < tiles) {
    float* first = cluster.map_shared_rank(&tile_sums[0][0], 0);
    write_tile_sum<kOut, kWidth>(acc, warp_out, first + tile * kOut, 1);
  }
  cluster.sync();  // every tile sum written, and visible to the first block
  if (cluster.block_rank() == 0) {
    add_tiles<kOut>(tiles, [&](int k, int64_t t) { return tile_sums[t][k]; }, out + b * kOut);
  }
}

template <class Factor, int kLoss>
cudaError_t launch_cluster(int device, int blocks, const float* params,
                           const typename ElemOf<Factor>::type* packed, int batch, int64_t n,
                           int64_t ld, float* out, cudaStream_t stream) {
  const auto kernel = onepass_cluster_kernel<Factor, kLoss>;
  // Clusters above the portable 8 blocks, allowed once on each device (the
  // attribute acts on the current one; devices past 64 set it every call).
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if ((allowed.load() & bit) == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, batch);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, params, packed, n, ld, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class Factor, int kLoss>
cudaError_t launch_loss(int device, const float* params,
                        const typename ElemOf<Factor>::type* packed, int batch, int64_t n,
                        int64_t ld, float* tile_partials, unsigned int* counters, float* out,
                        cudaStream_t stream) {
  const int64_t cluster = cluster_blocks(n);
  if (cluster > 0) {
    return launch_cluster<Factor, kLoss>(device, static_cast<int>(cluster), params, packed,
                                         batch, n, ld, out, stream);
  }
  const auto kernel = onepass_kernel<Factor, kLoss>;
  // Blocks resident on the card at once, queried on the first call of each
  // instantiation: a query per launch would cost microseconds.
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int64_t tiles = num_tiles(n);
  const int blocks = static_cast<int>(tiles < 1 ? 1 : tiles < resident ? tiles : resident);
  kernel<<<dim3(blocks, batch), kThreads, 0, stream>>>(params, packed, n, ld, tile_partials,
                                                       counters, out);
  return cudaGetLastError();
}

// params (batch, kParams), packed (batch, kRows, ld) of ElemOf<Factor>
// (float32, or bf16 for the bf16-row instantiations), tile_partials
// (workspace_floats(batch, n, kOut)), counters (batch,) zero, out
// (batch, kOut): device pointers (the cluster finish, cluster_blocks(n) > 0,
// leaves tile_partials and counters alone, and they may be null then).
// Rows start on 16-byte boundaries: ld is a multiple of 16 bytes of
// elements (4 floats, 8 bf16). Launches on `stream` and does not
// synchronise.
// Returns a cudaError_t: cudaErrorInvalidValue for a bad loss code, batch,
// n, ld or alignment, else cudaGetLastError() after the launch.
template <class Factor>
int launch(int device, const float* params, const void* packed_rows, int batch, int64_t n,
           int64_t ld, int loss_code, float* tile_partials, unsigned int* counters, float* out,
           void* stream) {
  using Elem = typename ElemOf<Factor>::type;
  constexpr int64_t kAlign = 16 / sizeof(Elem);
  const Elem* packed = static_cast<const Elem*>(packed_rows);
  if (batch < 1 || batch > 65535 || n < 0 || ld < n) return cudaErrorInvalidValue;
  if (n > 0 && (ld % kAlign != 0 || reinterpret_cast<uintptr_t>(packed) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NLS_ONEPASS_CASE(code)                                                              \
  case code:                                                                                \
    return launch_loss<Factor, code>(device, params, packed, batch, n, ld, tile_partials,   \
                                     counters, out, s);
  switch (loss_code) {
    NLS_ONEPASS_CASE(kLossNone)
    NLS_ONEPASS_CASE(kLossExp)
    NLS_ONEPASS_CASE(kLossHuber)
    NLS_ONEPASS_CASE(kLossCauchy)
    NLS_ONEPASS_CASE(kLossTukey)
    NLS_ONEPASS_CASE(kLossGemanMcClure)
    NLS_ONEPASS_CASE(kLossDCS)
    default:
      return cudaErrorInvalidValue;
  }
#undef NLS_ONEPASS_CASE
}

__global__ void empty_kernel() {}

#endif  // __CUDACC__

}  // namespace onepass
}  // namespace nls
