// The dense cull and queue: each tile's front-to-back cluster queue.
//
// Replaces no Pallas kernel: the JAX package left this step to XLA
// (rayaccel_tpu/ops/trace_pallas.py:_cull_and_queue, :186-262), and the
// port ran it as plain torch (ops/trace_dense.py:cull_and_queue_plain),
// which writes the entry distance of every (ray, box) pair of a wave as an
// (R, n_c) tensor and runs some 28 elementwise passes over it before the
// per-tile minimum folds it to (T, n_c). Same function, word for word: for
// each tile, the minimum over its rays of each box's slab entry over
// [tmin, tmax_eff] (3e38 where no ray enters), cluster 0's clamped to 0;
// the clusters entered below 3e38 sorted by (entry, id), as a stable sort
// orders them, clamped to tile_cap and padded to it by repeating the
// farthest; the count padded to a multiple of k_step and clamped; the
// clusters the clamp drops added to the overflow count. One difference: an
// entry of -0.0 comes out as +0.0 (as in K2, select_nearest.cu).
//
// What bounds it on the H100: instruction rate. A (ray, box) pair costs 6
// subtractions and 6 products (no FMA: the plain version's bits), 6
// minima and maxima, a compare and a running minimum: 20 instructions, 8
// of them on the half-rate pipe of compares, minima and maxima, with no
// reuse across the tile's rays. Memory is small: 32 bytes a ray, 24 a box,
// 4 bytes a (tile, box) minimum and the queue rows. The bound prices 24
// operations a pair at the fp32 peak, as K2's does (PERF.md).
//
// Design. Two launches on the stream.
// - cull_kernel: a CTA takes one tile and a chunk of kCullBoxes boxes, four
//   a lane, held in registers with the planes of each axis in order (lo <=
//   hi: the slab test is symmetric in an axis's two planes, so this changes
//   no answer). The tile's rays are staged into shared memory kChunkRays at
//   a time, 32 bytes a ray, grouped by the signs of their inverse direction
//   (an octant), and a lane whose window is empty or NaN (tmin <= tmax_eff
//   false: an inactive lane) is left out, since it enters no box. Within an
//   octant the near and far plane of every axis are known at compile time,
//   so min(tn, tf) and max(tn, tf) are one product each, picked by address
//   and not by arithmetic (common.cuh:slab, the test K1's and K4's gate
//   shares); a warp walks every kCullWarps-th ray of each octant, all
//   lanes reading the same ray (a broadcast). The minima and
//   maxima propagate NaN, as torch.maximum and torch.minimum do. A lane
//   keeps the least entry of each of its boxes over its rays in a register;
//   the warps' minima meet in shared memory, and the CTA writes its boxes'
//   (T, n_c) tile minima. Nothing (R, n_c) is written.
// - queue_kernel: a CTA a tile. It counts the row's entries below 3e38, and
//   where they exceed tile_cap finds the tile_cap-th smallest 64-bit key
//   (entry bits << 32 | cluster id) by a radix select, eight 8-bit digits
//   on shared-memory histograms. The keys at most that one (or all the
//   counted ones) go to shared memory, each takes its position by counting
//   the keys below it, and the row is written and padded. Neither kernel
//   depends on the cluster count beyond the grid.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

constexpr int kCullWarps = 8;
constexpr int kCullThreads = 32 * kCullWarps;
constexpr int kLaneBoxes = 4;                       // boxes a lane holds
constexpr int kCullBoxes = 32 * kLaneBoxes;         // boxes of one CTA
constexpr int kChunkRays = 1024;                    // rays staged at a time
constexpr int kQueueThreads = 256;
constexpr int kQueueWarps = kQueueThreads / 32;
// The largest tile_cap: a row's kept keys, 8 bytes each, in one CTA's
// shared memory (ops/trace_dense.py: QUEUE_MAX_CAP).
constexpr int kMaxCap = 16384;

// 3e38 as float32, the cull's "no overlap" entry (ops/trace_mxu.py: INF).
__device__ __forceinline__ float no_entry() { return 3e38f; }

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// Warp-wide: reserves a slot in counter[octant] for each lane with an
// octant (>= 0), one atomic a warp and octant; returns the lane's slot.
__device__ __forceinline__ int claim(int octant, int* counter, int lane) {
  int slot = -1;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned m = __ballot_sync(0xffffffffu, octant == q);
    if (m != 0) {
      const int leader = __ffs(m) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(counter + q, __popc(m));
      at = __shfl_sync(0xffffffffu, at, leader);
      if (octant == q) slot = at + __popc(m & lanes_below(lane));
    }
  }
  return slot;
}

// The octant of ray r (bit a: inverse direction a has its sign bit set),
// or -1 where it enters no box: past the chunk, or tmin <= tmax_eff false.
__device__ __forceinline__ int octant_of(const float* inv, const float* tmin,
                                         const float* tmax, size_t r,
                                         bool in_chunk) {
  if (!in_chunk || !(tmin[r] <= tmax[r])) return -1;
  return (__float_as_uint(inv[3 * r]) >> 31) |
         ((__float_as_uint(inv[3 * r + 1]) >> 31) << 1) |
         ((__float_as_uint(inv[3 * r + 2]) >> 31) << 2);
}

// A warp's share of the staged rays of octant O, [begin, end), against
// the lane's boxes: for each box the least entry t0 of a ray whose window
// meets it (t0 <= t1, which a NaN fails).
template <int O>
__device__ __forceinline__ void walk(const float4* rays, int begin, int end,
                                     int warp,
                                     const float (&lo)[kLaneBoxes][3],
                                     const float (&hi)[kLaneBoxes][3],
                                     float (&m)[kLaneBoxes]) {
#pragma unroll 2
  for (int k = begin + warp; k < end; k += kCullWarps) {
    const float4 a = rays[2 * k], b = rays[2 * k + 1];
    const float o[3] = {a.x, a.y, a.z};
    const float inv[3] = {a.w, b.x, b.y};
#pragma unroll
    for (int i = 0; i < kLaneBoxes; ++i) {
      float t0 = b.z, t1 = b.w;
      slab(o, inv, lo[i], hi[i], O, t0, t1);
      if (t0 <= t1) m[i] = fminf(m[i], t0);
    }
  }
}

// Grid: T * n_chunks CTAs, CTA t * n_chunks + chunk. Writes tile_bits[t,
// c], the bits of tile t's entry into box c (non-negative, +0.0 for a
// zero; 3e38 where no ray enters), and zeroes the overflow count.
__global__ void __launch_bounds__(kCullThreads)
cull_kernel(const float* __restrict__ o, const float* __restrict__ inv,
            const float* __restrict__ tmin, const float* __restrict__ tmax,
            const float* __restrict__ bbmin, const float* __restrict__ bbmax,
            int* __restrict__ tile_bits,
            unsigned long long* __restrict__ overflow, int tile, int n_c,
            int n_chunks) {
  __shared__ float4 rays[2 * kChunkRays];
  __shared__ int oct_n[8], oct_at[8], oct_start[9];
  __shared__ int least[kCullBoxes];
  const int t = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - t * n_chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0ull;
  if (threadIdx.x < kCullBoxes)
    least[threadIdx.x] = __float_as_int(no_entry());

  float lo[kLaneBoxes][3], hi[kLaneBoxes][3], m[kLaneBoxes];
#pragma unroll
  for (int i = 0; i < kLaneBoxes; ++i) {
    const int c = chunk * kCullBoxes + 32 * i + lane;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      // A box past the last is NaN: it meets no window.
      const float a = c < n_c ? bbmin[3 * c + ax] : __int_as_float(kIntMax);
      const float b = c < n_c ? bbmax[3 * c + ax] : __int_as_float(kIntMax);
      lo[i][ax] = min_nan(a, b);
      hi[i][ax] = max_nan(a, b);
    }
    m[i] = no_entry();
  }

  for (int base = 0; base < tile; base += kChunkRays) {
    const int n = min(kChunkRays, tile - base);
    const size_t r0 = static_cast<size_t>(t) * tile + base;
    if (threadIdx.x < 8) oct_n[threadIdx.x] = 0;
    __syncthreads();
    for (int j0 = 32 * warp; j0 < n; j0 += kCullThreads) {
      const int j = j0 + lane;
      claim(octant_of(inv, tmin, tmax, r0 + j, j < n), oct_n, lane);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int at = 0;
      for (int q = 0; q < 8; ++q) {
        oct_start[q] = oct_at[q] = at;
        at += oct_n[q];
      }
      oct_start[8] = at;
    }
    __syncthreads();
    for (int j0 = 32 * warp; j0 < n; j0 += kCullThreads) {
      const int j = j0 + lane;
      const size_t r = r0 + j;
      const int q = octant_of(inv, tmin, tmax, r, j < n);
      const int slot = claim(q, oct_at, lane);
      if (q >= 0) {
        rays[2 * slot] = make_float4(o[3 * r], o[3 * r + 1], o[3 * r + 2],
                                     inv[3 * r]);
        rays[2 * slot + 1] =
            make_float4(inv[3 * r + 1], inv[3 * r + 2], tmin[r], tmax[r]);
      }
    }
    __syncthreads();
    walk<0>(rays, oct_start[0], oct_start[1], warp, lo, hi, m);
    walk<1>(rays, oct_start[1], oct_start[2], warp, lo, hi, m);
    walk<2>(rays, oct_start[2], oct_start[3], warp, lo, hi, m);
    walk<3>(rays, oct_start[3], oct_start[4], warp, lo, hi, m);
    walk<4>(rays, oct_start[4], oct_start[5], warp, lo, hi, m);
    walk<5>(rays, oct_start[5], oct_start[6], warp, lo, hi, m);
    walk<6>(rays, oct_start[6], oct_start[7], warp, lo, hi, m);
    walk<7>(rays, oct_start[7], oct_start[8], warp, lo, hi, m);
    __syncthreads();  // the next chunk overwrites the staged rays
  }

  // The entry is max(t0, 0) of the nearest ray; min and max(., 0) commute.
  // Adding +0.0 turns a -0.0 into +0.0, so the bits order as the floats.
#pragma unroll
  for (int i = 0; i < kLaneBoxes; ++i)
    atomicMin(least + 32 * i + lane, __float_as_int(fmaxf(m[i], 0.0f) + 0.0f));
  __syncthreads();
  const int c = chunk * kCullBoxes + threadIdx.x;
  if (threadIdx.x < kCullBoxes && c < n_c)
    tile_bits[static_cast<size_t>(t) * n_c + c] = least[threadIdx.x];
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kQueueWarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// Entry bits of cluster j in a row of tile minima: cluster 0's clamped to
// at most 0.0, so it is in every row.
__device__ __forceinline__ int row_entry(const int* row, int j) {
  return j == 0 ? 0 : row[j];
}

__device__ __forceinline__ unsigned long long row_key(int e, int j) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(e)) << 32) |
         static_cast<unsigned>(j);
}

// The cap-th smallest key of the row's counted entries (there are more
// than cap): a radix select, 8 bits a pass from the top.
__device__ unsigned long long select_key(const int* row, int n_c, int cap,
                                         int limit, int* hist, int* found) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long prefix = 0;
  int need = cap;  // the rank, from 1, of the wanted key among those left
  for (int shift = 56; shift >= 0; shift -= 8) {
    const unsigned long long high = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int i = threadIdx.x; i < 256; i += kQueueThreads) hist[i] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n_c; j += kQueueThreads) {
      const int e = row_entry(row, j);
      const unsigned long long key = row_key(e, j);
      if (e < limit && (key & high) == prefix)
        atomicAdd(hist + ((key >> shift) & 255), 1);
    }
    __syncthreads();
    if (warp == 0) {
      int v[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += (v[q] = hist[8 * lane + q]);
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int acc = incl - sum;
      if (acc < need && need <= incl) {
        for (int q = 0; q < 8; ++q) {
          if (acc + v[q] >= need) {
            found[0] = 8 * lane + q;
            found[1] = need - acc;
            break;
          }
          acc += v[q];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(found[0]) << shift;
    need = found[1];
  }
  return prefix;
}

// Grid: T CTAs, one a tile.
__global__ void __launch_bounds__(kQueueThreads)
queue_kernel(const int* __restrict__ tile_bits, int* __restrict__ q_cluster,
             int* __restrict__ q_entry, int* __restrict__ q_count,
             unsigned long long* __restrict__ overflow, int n_c, int k_step,
             int cap) {
  extern __shared__ unsigned long long keys[];  // the kept keys, <= cap
  __shared__ int scratch[kQueueWarps], hist[256], found[2], n_kept;
  __shared__ unsigned long long last;
  const int t = blockIdx.x;
  const int* row = tile_bits + static_cast<size_t>(t) * n_c;
  const int limit = __float_as_int(no_entry());

  int mine = 0;
  for (int j = threadIdx.x; j < n_c; j += kQueueThreads)
    mine += row_entry(row, j) < limit;
  const int count = block_sum(mine, scratch);  // >= 1: cluster 0
  const int s = min(count, cap);
  const unsigned long long top =
      count > cap ? select_key(row, n_c, cap, limit, hist, found) : ~0ull;

  if (threadIdx.x == 0) n_kept = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n_c; j += kQueueThreads) {
    const int e = row_entry(row, j);
    const unsigned long long key = row_key(e, j);
    if (e < limit && key <= top) keys[atomicAdd(&n_kept, 1)] = key;
  }
  __syncthreads();

  int* qc = q_cluster + static_cast<size_t>(t) * cap;
  int* qe = q_entry + static_cast<size_t>(t) * cap;
  for (int i = threadIdx.x; i < s; i += kQueueThreads) {
    const unsigned long long key = keys[i];
    int rank = 0;
#pragma unroll 8
    for (int k = 0; k < s; ++k) rank += keys[k] < key;
    qc[rank] = static_cast<int>(static_cast<unsigned>(key));
    qe[rank] = static_cast<int>(key >> 32);
    if (rank == s - 1) last = key;
  }
  __syncthreads();
  for (int p = s + threadIdx.x; p < cap; p += kQueueThreads) {
    qc[p] = static_cast<int>(static_cast<unsigned>(last));
    qe[p] = static_cast<int>(last >> 32);
  }
  if (threadIdx.x == 0) {
    const int kept = min((count + k_step - 1) / k_step * k_step, cap);
    q_count[t] = kept;
    if (count > kept)
      atomicAdd(overflow, static_cast<unsigned long long>(count - kept));
  }
}

}  // namespace
}  // namespace racc

// o, inv (R, 3), tmin, tmax (R,) float32 with R = T * tile; bbmin, bbmax
// (n_c, 3); tile_bits (T, n_c) int32 scratch; q_cluster, q_entry
// (T, cap) int32; q_count (T,) int32; overflow () int64.
extern "C" int racc_cull_queue(const float* o, const float* inv,
                               const float* tmin, const float* tmax,
                               const float* bbmin, const float* bbmax,
                               int* tile_bits, int* q_cluster, int* q_entry,
                               int* q_count, long long* overflow, int T,
                               int tile, int n_c, int k_step, int cap,
                               void* stream) {
  using namespace racc;
  if (T < 0 || tile < 1 || n_c < 1 || k_step < 1 || cap < k_step ||
      cap % k_step != 0 || cap > kMaxCap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ov = reinterpret_cast<unsigned long long*>(overflow);
  if (T == 0)
    return static_cast<int>(cudaMemsetAsync(ov, 0, sizeof(*ov), st));
  const int n_chunks = (n_c + kCullBoxes - 1) / kCullBoxes;
  if (static_cast<long long>(T) * n_chunks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cull_kernel<<<T * n_chunks, kCullThreads, 0, st>>>(
      o, inv, tmin, tmax, bbmin, bbmax, tile_bits, ov, tile, n_c, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = cap * static_cast<int>(sizeof(unsigned long long));
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(queue_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  queue_kernel<<<T, kQueueThreads, smem, st>>>(
      tile_bits, q_cluster, q_entry, q_count, ov, n_c, k_step, cap);
  return static_cast<int>(cudaGetLastError());
}
