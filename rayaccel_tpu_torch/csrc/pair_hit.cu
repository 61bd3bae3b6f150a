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
// What bounds it on the H100: fp32 FMA issue, as in K1: 40 FMAs and ~20
// decode operations per (pair, triangle). Device memory traffic is one
// 64-byte feature row and one output word per pair.
//
// Design: the Pallas grid ran in order and initialised a pair block on its
// first item. Every pair lane belongs to exactly one item, so items are
// independent: the wrapper pre-fills the output with the miss marker and
// hands each item as [start, end) of its run; one CTA per item stages the
// cluster's columns in shared memory and its threads stride over the run.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

constexpr int kRankShift = 20;
constexpr int kClusterMask = (1 << kRankShift) - 1;
constexpr int kMissBits = 0x7F000000;

__global__ void __launch_bounds__(256)
pair_hit_kernel(const float* __restrict__ Fp, const float* __restrict__ G3,
                const int* __restrict__ items, int* __restrict__ out, int C,
                int col_bits, int guard_tmax) {
  __shared__ float4 g[kStageFloat4];
  const int start = items[3 * blockIdx.x];
  const int end = items[3 * blockIdx.x + 1];
  const int cluster = items[3 * blockIdx.x + 2];
  stage_cluster(g, G3, cluster, C);
  __syncthreads();
  const int low = (1 << (col_bits + 3)) - 1;
  for (int p = start + threadIdx.x; p < end; p += blockDim.x) {
    float row[16];
    load_row16(Fp + static_cast<size_t>(p) * kFeat, row);
    const int lane = __float_as_int(row[12]);
    if ((lane & kClusterMask) != cluster) continue;
    const float tmin = row[10], tmax = row[11];
    const int rank_bits = static_cast<int>(static_cast<unsigned>(lane) >> kRankShift)
                          << col_bits;
    int m = kIntMax;
    for (int c = 0; c < C; ++c) {
      const Candidate h = candidate(g, c, row);
      bool valid = h.sign_ok && fabsf(h.u_plus_v) <= h.ad && h.ts > h.ad * tmin;
      if (guard_tmax) valid = valid && h.ts < h.ad * tmax;
      const float score = valid ? h.ts * __frcp_rn(h.ad) : 3e38f;
      m = min(m, (__float_as_int(score) & ~low) | rank_bits | c);
    }
    out[p] = min(m, kMissBits);
  }
}

}  // namespace
}  // namespace racc

// Fp (P, 16) pair feature rows [d, o, d x o, 1, tmin, tmax, lane word,
// 0...]; G3 (n_c, 4C, 16); items (n_items, 3) int32 [start, end, cluster];
// out (P,) int32, pre-filled with the miss marker by the caller.
extern "C" int racc_pair_hit(const float* Fp, const float* G3, const int* items,
                             int n_items, int* out, int C, int col_bits,
                             int guard_tmax, void* stream) {
  if (C < 1 || C > racc::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  racc::pair_hit_kernel<<<n_items, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      Fp, G3, items, out, C, col_bits, guard_tmax);
  return static_cast<int>(cudaGetLastError());
}
