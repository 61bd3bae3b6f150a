// P4: K3's function with several pair blocks a CTA and each run's cluster
// staged by one TMA bulk copy.
//
// Replaces tools/probe_pair_dma.py:_kernel_mb (:63-136, pallas_call :163),
// the TPU probe of a multi-block pair kernel: each grid step owns GB
// consecutive SP-pair blocks and walks their cluster runs in order, the
// runs' bounds read on the device, each run's G block double-buffered by
// explicit async copies. Its output is K3's (csrc/pair_hit.cu), word for
// word on the covered pairs: for every pair of a run whose lane word names
// the run's cluster, min(miss marker, packed (score | rank | column)).
//
// Design. A CTA owns blocks [gb * blockIdx.x, gb * blockIdx.x + gb) and
// their runs, items[starts[b0] .. starts[b1]) (runs are block-major in the
// items). Its shared memory is a two-stage ring of whole G3 cluster blocks
// (4C rows of 64 bytes, 32 KB at C = 128) with one mbarrier a stage. One
// thread arms the next run's barrier and issues one bulk copy of its
// cluster block into the other stage (tma.cuh) while the CTA tests the
// present run; every thread waits on the stage's parity, which flips each
// time the stage comes round. A run is tested 64 pairs at a time with K1's
// thread shape (common.cuh: two pairs a thread, kColSplit threads on every
// kColSplit-th column) and K3's decode (decode2) and packed score (the
// IEEE reciprocal, the same FMA order), so the words equal K3's; only the
// run's own pairs are tested (a run is contiguous in a cluster-sorted
// block). Whole 64-byte rows put two staged rows in the same banks where
// K3's 48-byte rows put none, so the lanes are laid out the other way from
// K3's: the kColSplit threads of a pair are lanes 4 apart, a quarter warp
// reads two neighbouring rows for four pairs each, and no load conflicts.
//
// What bounds it on the H100: K3's work, the fp32 FMA rate (40 FMAs a
// (pair, triangle)). It stages a cluster once a run where K3 stages it once
// for consecutive units of one cluster, and its balance is per block, not
// per 64-pair unit.
#include <cuda_runtime.h>

#include "common.cuh"
#include "tma.cuh"

namespace racc {
namespace {

constexpr int kRankShift = 20;
constexpr int kClusterMask = (1 << kRankShift) - 1;
constexpr int kMissBits = 0x7F000000;
constexpr int kRunPairs = kCtaRays;   // pairs a CTA tests at once
constexpr int kMbMinCtas = 3;         // as K3: 80 registers a thread
constexpr int kStageRowF4 = kFeat / 4;  // a staged row: a whole G3 row

// Bytes of one staged cluster block and of the ring, for clusters of C.
__host__ __device__ constexpr int mb_stage_bytes(int C) {
  return 4 * C * kFeat * static_cast<int>(sizeof(float));
}
__host__ __device__ constexpr int mb_ring_bytes(int C) {
  return kRingStages * mb_stage_bytes(C);
}

template <bool Guard>
__global__ void __launch_bounds__(kCtaThreads, kMbMinCtas)
pair_hit_mb_kernel(const float* __restrict__ Fp, const float* __restrict__ G3,
                   const int* __restrict__ items,
                   const int* __restrict__ starts, int* __restrict__ out,
                   unsigned long long* __restrict__ stats,
                   int* __restrict__ err, int n_blocks, int gb, int n_c,
                   int P, int C, int col_bits) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ __align__(8) unsigned long long bar[kRingStages];
  static_assert(kRingStages == 2, "the parities below assume two stages");
  const unsigned bytes = mb_stage_bytes(C);
  const int stage_f4 = 4 * C * kStageRowF4;
  if (dynamic_smem_bytes() < kRingStages * bytes) {
    if (threadIdx.x == 0) report_error(err, kErrSmem, blockIdx.x);
    return;
  }
  const int b0 = blockIdx.x * gb;
  const int j1 = starts[min(b0 + gb, n_blocks)];
  // The next run from j that names a cluster of the scene and pairs of the
  // array (K3 gives any other item no work unit).
  auto next_run = [&](int j) {
    for (; j < j1; ++j) {
      const int s = items[3 * j], e = items[3 * j + 1], cl = items[3 * j + 2];
      if (s >= 0 && e > s && e <= P && cl >= 0 && cl < n_c) break;
    }
    return j;
  };
  int j = next_run(starts[b0]);
  if (j >= j1) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kWarpPairs, slot = lane % kWarpPairs;
  const int low = (1 << (col_bits + 3)) - 1;
  auto issue = [&](int run, int stage) {
    const int cl = items[3 * run + 2];
    mbar_arrive_expect_tx(&bar[stage], bytes);
    bulk_copy_g2s(ring + stage * stage_f4,
                  G3 + static_cast<size_t>(cl) * 4 * C * kFeat, bytes,
                  &bar[stage]);
  };
  // Pairs [p0, p1) of a run of `cluster` against the staged block g: K3's
  // test (pair_hit.cu:pair_hit_kernel) with this kernel's lanes.
  auto test = [&](const float4* g, int p0, int p1, int cluster) {
    float f[2][10], tmin[2], tmax[2];
    int p[2], rank_bits[2];
    bool on[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p[i] = p0 + warp * kWarpRays + slot + kWarpPairs * i;
      on[i] = false;
      if (p[i] < p1) {
        const int word = load_ray(Fp, p[i], f[i], tmin[i], tmax[i]);
        on[i] = (word & kClusterMask) == cluster;
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
        decode2<kStageRowF4>(g, c, C, f, inside, ad, ts);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
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
      for (int o = kWarpPairs; o < 32; o <<= 1)
        m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      if (sub == 0 && on[i]) out[p[i]] = min(m[i], kMissBits);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
    issue(j, 0);
  }
  __syncthreads();
  int n = 0;  // runs tested; run n sits in stage n & 1
  while (j < j1) {
    const int nxt = next_run(j + 1), stage = n & 1;
    // The other stage was last read by run n - 1, before the barrier that
    // ended it.
    if (threadIdx.x == 0 && nxt < j1) issue(nxt, stage ^ 1);
    if (__syncthreads_or(!mbar_wait(&bar[stage], (n >> 1) & 1))) {
      if (threadIdx.x == 0) report_error(err, kErrWait, j);
      return;
    }
    const int s = items[3 * j], e = items[3 * j + 1], cl = items[3 * j + 2];
    for (int p0 = s; p0 < e; p0 += kRunPairs)
      test(ring + stage * stage_f4, p0, min(p0 + kRunPairs, e), cl);
    __syncthreads();  // every read of this stage before its next copy
    j = nxt;
    ++n;
  }
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(stats, static_cast<unsigned long long>(n));
    atomicAdd(stats + 1, 1ULL);
    atomicAdd(stats + 2, static_cast<unsigned long long>(n) * bytes);
  }
}

}  // namespace
}  // namespace racc

// Fp (P, 16) pair rows and G3 (n_c, 4C, 16) as K3 takes them (G3 16-byte
// aligned); items (n_items, 3) int32 [start, end, cluster], block-major;
// starts (n_blocks + 1,) int32, the first item of each SP-pair block
// (tools/probe_pair_dma.py:block_runs); out (P,) int32, pre-filled with
// the miss marker by the caller; err (2,) int32 zeros (tma.cuh: code,
// step). stats (nullable, 3 counters) gains the runs tested, the CTAs that
// tested any and the bytes staged. gb blocks a CTA. smem 0 gives the
// kernel its ring for clusters of C; another value is used as it is.
extern "C" int racc_pair_hit_mb(const float* Fp, const float* G3,
                                const int* items, const int* starts, int* out,
                                unsigned long long* stats, int* err, int P,
                                int n_c, int C, int col_bits, int guard_tmax,
                                int n_blocks, int gb, int smem, void* stream) {
  using namespace racc;
  if (C < 1 || C > kMaxC || P < 0 || n_c < 1 || n_blocks < 0 || gb < 1 ||
      reinterpret_cast<size_t>(G3) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0 || P == 0) return static_cast<int>(cudaSuccess);
  const int dyn = smem > 0 ? smem : mb_ring_bytes(C);
  const int grid = (n_blocks + gb - 1) / gb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* kernel =
      guard_tmax ? reinterpret_cast<const void*>(pair_hit_mb_kernel<true>)
                 : reinterpret_cast<const void*>(pair_hit_mb_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn > mb_ring_bytes(kMaxC) ? dyn : mb_ring_bytes(kMaxC));
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return static_cast<int>(e);
  }
  if (guard_tmax)
    pair_hit_mb_kernel<true><<<grid, kCtaThreads, dyn, st>>>(
        Fp, G3, items, starts, out, stats, err, n_blocks, gb, n_c, P, C,
        col_bits);
  else
    pair_hit_mb_kernel<false><<<grid, kCtaThreads, dyn, st>>>(
        Fp, G3, items, starts, out, stats, err, n_blocks, gb, n_c, P, C,
        col_bits);
  return static_cast<int>(cudaGetLastError());
}
