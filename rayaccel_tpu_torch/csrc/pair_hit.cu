// K3: the sparse engine's pair kernel.
//
// Replaces rayaccel_tpu/ops/trace_sparse.py:_kernel (:77-174), launched by
// _make_call (:177-203) from _sparse_pass. Same function: a work item is
// a run of cluster-sorted (ray, cluster) pairs that share one cluster
// inside one SP-pair block; for every pair of the run whose lane word
// (cluster | rank << 20, raw bits in feature column 12) names that
// cluster, intersect the pair's ray with the cluster's C triangles and
// write min(MISS, packed (score | rank | column)) for the pair. A candidate
// is valid when the sign bits of u and v agree with det's, |u + v| <=
// |det|, t > tmin exactly (tmin is the restart window's lower edge) and,
// with guard_tmax, t < tmax; its score is t * (1 / |det|) with an IEEE
// reciprocal.
//
// What bounds it on the H100: the fp32 FMA rate, as in K1: 40 FMAs and ~15
// decode operations per (pair, triangle). Device memory traffic is one
// 64-byte feature row and one output word per pair; a cluster's columns
// (24 KB live) come from L2 once per CTA that meets it.
//
// Design. The Pallas grid ran in order and initialised a pair block on its
// first item. Every pair lane belongs to at most one item, so items are
// independent and the wrapper pre-fills the output with the miss marker.
//
// - Work units (walk_units). A run is cut into units of at most kUnitPairs
//   pairs, so 1,666 uneven runs become ~15,000 even pieces. A one-CTA pass
//   (pair_hit_units_kernel) writes the exclusive prefix of each item's unit
//   count; the main kernel's grid is sized to the card (the CTAs that are
//   resident at once) and CTA b takes the b-th contiguous share of the
//   units, so a long run does not set the time and neighbouring units,
//   which mostly share a cluster, fall to one CTA.
// - K1's thread shape (common.cuh): a CTA tests a unit's 64 pairs at once;
//   each thread holds two pairs, so a column read from shared memory feeds
//   both pairs' FMAs, and kColSplit = 8 threads hold the same two pairs and
//   take every 8th column; their packed minima merge by shuffles (the word
//   carries its column, so the merge picks the winner one thread would). A
//   5-pair item puts 8 threads on 16 columns each, not 5 threads on 128.
// - Staging. Clusters land by cp.async in K1's two-stage ring (the 48 live
//   bytes of each 64-byte G3 row). The CTA looks ahead along its units for
//   the next change of cluster and starts that copy while it tests the
//   units of the present one; consecutive units of one cluster (a run cut
//   in pieces, or a cluster on both sides of an SP boundary) are staged
//   once.
// - No TF32 at precision "highest" (the TPU kernel's Precision.HIGHEST).
//
// The bf16 variant (precision "default", Precision.DEFAULT: one bf16
// pass) is K1's bf16 design (csrc/dense_hit.cu, common.cuh:mma_rays) on
// the same work units: a warp's 16 pairs of a unit are one A fragment,
// built once a unit from Fp (rows past the unit zeroed), and the ring
// stages the scene's bf16 fragment copy (ClusterScene.G3b, 16 KB a cluster
// at C = 128) as it is, so a lane loads the B fragments of a group of 4
// triangles with one 16-byte shared load and holds two whole (pair,
// triangle) pairs: no shuffle and no conversion in the loop. The column
// loop takes kPairGroups groups at a time with no branch (loads and
// products first, then the decodes, __frcp_rn's slow path only where a
// lane needs it), and a failed candidate packs the miss marker instead of
// skipping the minimum. A CTA is 4 warps, one 64-pair unit, so the units
// and the counters are the fp32 form's. The result does not depend on the
// order of the columns (every pair meets every column), so the plain
// version needs no group. The groups in flight were chosen on the card
// (tools/bf16_variants.py, PERF.md).
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

constexpr int kRankShift = 20;
constexpr int kClusterMask = (1 << kRankShift) - 1;
constexpr int kMissBits = 0x7F000000;
constexpr int kUnitPairs = kCtaRays;   // the pairs a CTA tests at once
constexpr int kScanThreads = 1024;
// CTAs an SM should hold: caps the registers at 80 a thread (chosen on the
// card among 2, 3 and 4: PERF.md).
constexpr int kPairMinCtas = 3;
// Groups of 4 triangles the bf16 variant's column loop takes at once: their
// loads and products (8 at kFrags = 1) issued before any result is read.
// Chosen on the card among 2, 4, 8 and 16 (PERF.md).
constexpr int kPairGroups = 4;

// ustart[i] = the work units of items before i; ustart[n_items] = all. An
// item that names no cluster of the scene or no pair of the array has none.
__global__ void __launch_bounds__(kScanThreads)
pair_hit_units_kernel(const int* __restrict__ items, int n_items, int n_c,
                      int P, int* __restrict__ ustart) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_items; base += kScanThreads) {
    const int i = base + threadIdx.x;
    int v = 0;
    if (i < n_items) {
      const int s = items[3 * i], e = items[3 * i + 1], cl = items[3 * i + 2];
      if (s >= 0 && e > s && e <= P && cl >= 0 && cl < n_c)
        v = (e - s + kUnitPairs - 1) / kUnitPairs;
    }
    int x = v;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += y;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    if (i < n_items) ustart[i] = before;
    __syncthreads();  // every thread has read carry and warp_sum
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) ustart[n_items] = carry;
}

struct Unit {
  int p0, p1, cluster;  // pairs [p0, p1) of one item's run
};

// Walks this CTA's share of the work units: stage(dst, cluster) starts the
// CTA's copies of a cluster's `stage_f4` 16-byte chunks into dst, and
// test(g, unit) tests a unit against its staged cluster g. `ring` is
// kRingStages * stage_f4 chunks of dynamic shared memory. Every thread of
// the CTA calls it. stats (nullable) gains the units, 1 if there were any,
// and the clusters staged.
template <class Stage, class Test>
__device__ __forceinline__ void walk_units(
    const int* __restrict__ items, const int* __restrict__ ustart,
    unsigned long long* __restrict__ stats, int n_items, int stage_f4,
    float4* ring, Stage stage, Test test) {
  static_assert(kRingStages == 2, "the waits below assume two stages");
  const long long total = ustart[n_items];
  const int u0 = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int u1 = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;

  // The item of unit u0: the last whose prefix is at most u0.
  int first = 0;
  for (int hi = n_items; hi - first > 1;) {
    const int mid = (first + hi) >> 1;
    if (ustart[mid] <= u0) first = mid; else hi = mid;
  }
  // Unit u, walking `item` forward from the unit before (units rise).
  auto locate = [&](int u, int& item) {
    while (ustart[item + 1] <= u) ++item;
    Unit w;
    w.p0 = items[3 * item] + (u - ustart[item]) * kUnitPairs;
    w.p1 = min(w.p0 + kUnitPairs, items[3 * item + 1]);
    w.cluster = items[3 * item + 2];
    return w;
  };

  // Staging walks ahead of the tests: each call finds the next unit whose
  // cluster differs from the last one staged and starts its copy into the
  // next ring stage. One commit group a call, empty or not, so the waits
  // can count.
  int staged = 0, s_unit = u0, s_item = first, s_cluster = -1;
  auto stage_next = [&]() {
    for (; s_unit < u1; ++s_unit) {
      const Unit w = locate(s_unit, s_item);
      if (w.cluster != s_cluster) {
        stage(ring + (staged % kRingStages) * stage_f4, w.cluster);
        s_cluster = w.cluster;
        ++staged;
        ++s_unit;
        break;
      }
    }
    cp_async_commit();
  };

  stage_next();
  stage_next();
  cp_async_wait<1>();  // the first cluster has landed
  __syncthreads();
  int item = first, segment = -1, cluster = -1;
  for (int u = u0; u < u1; ++u) {
    const Unit w = locate(u, item);
    if (w.cluster != cluster) {
      if (segment >= 0) {
        cp_async_wait<0>();  // the next cluster has landed
        // After the barrier every thread's copies are visible and the
        // stage of the cluster just left is free for the one after next.
        __syncthreads();
        stage_next();
      }
      ++segment;
      cluster = w.cluster;
    }
    test(ring + (segment % kRingStages) * stage_f4, w);
  }
  cp_async_wait<0>();
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(stats, static_cast<unsigned long long>(u1 - u0));
    atomicAdd(stats + 1, 1ULL);
    atomicAdd(stats + 2, static_cast<unsigned long long>(staged));
  }
}

#define RACC_PAIR_HIT_ARGS                                                    \
  const int* __restrict__ items, const int* __restrict__ ustart,             \
      int* __restrict__ out, unsigned long long* __restrict__ stats,         \
      int n_items, int C, int col_bits

template <bool Guard>
__global__ void __launch_bounds__(kCtaThreads, kPairMinCtas)
pair_hit_kernel(const float* __restrict__ Fp, const float* __restrict__ G3,
                RACC_PAIR_HIT_ARGS) {
  extern __shared__ __align__(128) float4 ring[];
  const int rows = 4 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % kColSplit, slot = lane / kColSplit;
  const int low = (1 << (col_bits + 3)) - 1;
  auto test = [&](const float4* g, const Unit& w) {
    float f[2][10], tmin[2], tmax[2];
    int p[2], rank_bits[2];
    bool on[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p[i] = w.p0 + warp * kWarpRays + slot + kWarpPairs * i;
      on[i] = false;
      if (p[i] < w.p1) {
        const int word = load_ray(Fp, p[i], f[i], tmin[i], tmax[i]);
        on[i] = (word & kClusterMask) == w.cluster;
        rank_bits[i] = static_cast<int>(static_cast<unsigned>(word) >> kRankShift)
                       << col_bits;
      }
      if (!on[i]) {
#pragma unroll
        for (int q = 0; q < 10; ++q) f[i][q] = 0.0f;
        tmin[i] = tmax[i] = 0.0f;
        rank_bits[i] = 0;
      }
    }
    if (!__any_sync(0xffffffffu, on[0] || on[1])) return;
    int m[2] = {kIntMax, kIntMax};
    if (on[0] || on[1]) {
#pragma unroll 2
      for (int c = sub; c < C; c += kColSplit) {
        bool inside[2];
        float ad[2], ts[2];
        decode2(g, c, C, f, inside, ad, ts);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // Only a column that passes every test packs a word (with the
          // IEEE reciprocal): a failed one would pack 3e38, above the miss
          // marker the minimum is clamped to.
          if (inside[i] && ts[i] > ad[i] * tmin[i] &&
              (!Guard || ts[i] < ad[i] * tmax[i])) {
            const float score = ts[i] * __frcp_rn(ad[i]);
            m[i] = min(m[i], (__float_as_int(score) & ~low) | rank_bits[i] | c);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o < kColSplit; o <<= 1)
        m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      if (sub == 0 && on[i]) out[p[i]] = min(m[i], kMissBits);
    }
  };
  walk_units(items, ustart, stats, n_items, rows * kRowF4, ring,
             [&](float4* dst, int cluster) {
               stage_async(
                   dst, G3 + static_cast<size_t>(cluster) * rows * kFeat,
                   rows);
             },
             test);
}

// The bf16 variant: the same units on the scene's bf16 fragment copy, a
// warp's pairs as the A operand of the tensor-core products (common.cuh:
// mma_rays), each lane decoding whole (pair, triangle) pairs.
template <bool Guard>
__global__ void __launch_bounds__(kFragWarps * 32)
pair_hit_bf16_kernel(const float* __restrict__ Fp,
                     const float4* __restrict__ G3b, RACC_PAIR_HIT_ARGS) {
  extern __shared__ __align__(128) float4 ring[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int chunks = frag_chunks(C), groups = (C + 3) / 4;
  const int low = (1 << (col_bits + 3)) - 1;
  auto test = [&](const float4* stage, const Unit& w) {
    const int base = w.p0 + warp * kFragRays;
    // This lane's pairs (common.cuh:frag_ray): the A fragment's features
    // 2t, 2t + 1 and (t = 0) 8, 9, bf16; a row past the unit is zeros (it
    // may lie past the end of Fp) and, as a pair whose lane word names
    // another cluster, is not written.
    unsigned a[kFrags][4];
    float tmin[kLaneRays], tmax[kLaneRays];
    int rank_bits[kLaneRays];
    bool on[kLaneRays], any = false;
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i) {
      const int p = frag_ray(base, i);
      float2 x = make_float2(0.0f, 0.0f), y = x, window = x;
      int word = 0;
      if (p < w.p1) {
        const float2* row = reinterpret_cast<const float2*>(
            Fp + static_cast<size_t>(p) * kFeat);
        x = row[t];
        if (t == 0) y = row[4];
        window = row[5];
        word = __float_as_int(row[6].x);
      }
      a[i >> 1][i & 1] = pack_bf16(x.x, x.y);
      a[i >> 1][2 + (i & 1)] = pack_bf16(y.x, y.y);
      tmin[i] = window.x;
      tmax[i] = window.y;
      on[i] = p < w.p1 && (word & kClusterMask) == w.cluster;
      rank_bits[i] =
          static_cast<int>(static_cast<unsigned>(word) >> kRankShift)
          << col_bits;
      any |= on[i];
    }
    if (!__any_sync(0xffffffffu, any)) return;
    const uint4* g = reinterpret_cast<const uint4*>(stage);
    int m[kLaneRays];
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i) m[i] = kIntMax;
    // kPairGroups groups at a time, the last one repeated past the
    // cluster's end (a repeated column cannot change a minimum); a column
    // past C is dropped. A failed candidate packs the miss marker, which
    // the final clamp makes the same as no candidate. The reciprocal takes
    // __frcp_rn's branch only where its fast path does not hold.
    for (int q0 = 0; q0 < groups; q0 += kPairGroups) {
      constexpr int N = kPairGroups * kLaneRays;
      float p[kPairGroups][kLaneRays][4], ad[N], ts[N], r[N];
      bool inside[N], slow = false;
#pragma unroll
      for (int u = 0; u < kPairGroups; ++u)
        mma_rays(g, min(q0 + u, groups - 1), a, p[u]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        decode_rays(p[k / kLaneRays][k % kLaneRays], inside[k], ad[k], ts[k]);
        r[k] = rcp_newton(ad[k]);
        slow |= inside[k] & !rcp_fast(ad[k]) & (ad[k] != 0.0f);
      }
      if (slow) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (!rcp_fast(ad[k])) r[k] = __frcp_rn(ad[k]);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int i = k % kLaneRays;
        const int c = 4 * min(q0 + k / kLaneRays, groups - 1) + t;
        const bool ok = inside[k] & (ts[k] > ad[k] * tmin[i]) &
                        (!Guard | (ts[k] < ad[k] * tmax[i]));
        const int score = ok ? __float_as_int(ts[k] * r[k]) : kMissBits;
        if (c < C) m[i] = min(m[i], (score & ~low) | rank_bits[i] | c);
      }
    }
    // Lanes 4g .. 4g + 3 hold the same pairs.
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i) {
      m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      if (t == 0 && on[i]) out[frag_ray(base, i)] = min(m[i], kMissBits);
    }
  };
  walk_units(items, ustart, stats, n_items, chunks, ring,
             [&](float4* dst, int cluster) {
               const float4* src = G3b + static_cast<size_t>(cluster) * chunks;
               for (int i = threadIdx.x; i < chunks; i += kFragWarps * 32)
                 cp_async16(dst + i, src + i);
             },
             test);
}

// Launches one form of the kernel on a grid of the CTAs the card holds at
// once (asked once a form, at its own CTA and its ring for clusters of
// kMaxC): G3b non-null launches the bf16 variant on it.
template <bool Guard, bool kBf16>
int launch(const float* Fp, const float* G3, const void* G3b,
           const int* items, int* ustart, int* out,
           unsigned long long* stats, int n_items, int P, int C,
           int col_bits, cudaStream_t stream) {
  static int resident = 0;
  const void* kernel =
      kBf16 ? reinterpret_cast<const void*>(pair_hit_bf16_kernel<Guard>)
            : reinterpret_cast<const void*>(pair_hit_kernel<Guard>);
  constexpr int threads = kBf16 ? kFragWarps * 32 : kCtaThreads;
  constexpr int most_smem = kBf16 ? frag_ring_bytes(kMaxC) : ring_bytes(kMaxC);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, most_smem)) != cudaSuccess)
      return static_cast<int>(e);
    if (sms * per_sm <= 0) return static_cast<int>(cudaErrorInvalidValue);
    resident = sms * per_sm;
  }
  // No launch has more units than this; a CTA without a unit exits.
  const long long most = n_items + static_cast<long long>(P) / kUnitPairs;
  const int grid = static_cast<int>(most < resident ? most : resident);
  if constexpr (kBf16)
    pair_hit_bf16_kernel<Guard><<<grid, threads, frag_ring_bytes(C), stream>>>(
        Fp, static_cast<const float4*>(G3b), items, ustart, out, stats,
        n_items, C, col_bits);
  else
    pair_hit_kernel<Guard><<<grid, threads, ring_bytes(C), stream>>>(
        Fp, G3, items, ustart, out, stats, n_items, C, col_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace racc

// Fp (P, 16) pair feature rows [d, o, d x o, 1, tmin, tmax, lane word,
// 0...]; G3 (n_c, 4C, 16); G3b (nullable) G3's bf16 fragment copy (n_c,
// ceil(C/4), 32, 4 words); items (n_items, 3) int32 [start, end, cluster];
// ustart (n_items + 1,) int32 scratch; out (P,) int32, pre-filled with the
// miss marker by the caller. stats (nullable, 3 counters) gains the work
// units, the CTAs that took any, and the clusters staged. With G3b the
// bf16 tensor-core variant runs on it.
extern "C" int racc_pair_hit(const float* Fp, const float* G3, const void* G3b,
                             const int* items, int* ustart, int n_items,
                             int* out, unsigned long long* stats, int P,
                             int n_c, int C, int col_bits, int guard_tmax,
                             void* stream) {
  using namespace racc;
  if (C < 1 || C > kMaxC || n_items < 0 || P < 0 || n_c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0 || P == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pair_hit_units_kernel<<<1, kScanThreads, 0, st>>>(items, n_items, n_c, P,
                                                   ustart);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool bf16 = G3b != nullptr;
  auto run = guard_tmax
                 ? (bf16 ? &launch<true, true> : &launch<true, false>)
                 : (bf16 ? &launch<false, true> : &launch<false, false>);
  return run(Fp, G3, G3b, items, ustart, out, stats, n_items, P, C, col_bits,
             st);
}

// The work-unit prefix alone: ustart (n_items + 1,) int32 as racc_pair_hit
// writes it. The pair kernel's TMA-staged probe (pair_hit_mb.cu) walks the
// same units.
extern "C" int racc_pair_units(const int* items, int n_items, int n_c, int P,
                               int* ustart, void* stream) {
  using namespace racc;
  if (n_items < 1 || P < 0 || n_c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_hit_units_kernel<<<1, kScanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      items, n_items, n_c, P, ustart);
  return static_cast<int>(cudaGetLastError());
}
