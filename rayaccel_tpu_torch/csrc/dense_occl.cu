// K4: dense any-hit (occlusion) over a per-tile, front-to-back cluster
// queue.
//
// Replaces rayaccel_tpu/ops/trace_pallas.py:_occl_kernel (:265-324),
// launched by _make_occl_call (:327-360) inside trace_occlusion_pallas.
// Same function: a ray is occluded when some triangle of its tile's queued
// clusters has sign-consistent u, v and det, |u + v| <= |det|, and its
// det-signed t numerator inside the window: ts > |det| * tmin and
// ts <= |det| * tmax (inclusive at tmax, as in the TPU kernel; the pair
// kernel's guard is strict). There is no reciprocal, so the predicate is
// exact up to the fp32 dot products. Inactive lanes carry tmax = -1, which
// no candidate satisfies.
//
// What bounds it on the H100: fp32 FMA issue, as in K1 (40 FMAs and a few
// compares per (ray, triangle)), but less of it: a lane stops testing at
// its first blocker, and the tile stops walking its queue once the next
// entry distance passes the largest tmax among its unoccluded lanes.
//
// Design, as in K1 (csrc/dense_hit.cu): one CTA per ray tile, one thread
// per ray, walking the tile's own queue row in order. The Pallas kernel
// carried the tile's bound in scratch from grid step to grid step; here it
// is a register, refreshed after each K-step by a block-wide max of
// (occluded ? 0 : tmax bits). An occluded thread still joins the staging
// barriers and the block max, and skips its column loop.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

__global__ void __launch_bounds__(1024)
dense_occl_kernel(const float* __restrict__ F, const float* __restrict__ G3,
                  const int* __restrict__ q_cluster,
                  const int* __restrict__ q_entry,
                  const int* __restrict__ q_count,
                  unsigned char* __restrict__ out, int cap, int C, int K) {
  __shared__ float4 g[kStageFloat4];
  __shared__ int red[32];
  const int tile = blockIdx.x;
  const int r = tile * blockDim.x + threadIdx.x;

  float row[16];
  load_row16(F + static_cast<size_t>(r) * kFeat, row);
  const float tmin = row[10];
  const float tmax = row[11];
  const int t_bits = max(__float_as_int(tmax), 0);
  bool occ = false;
  int bound = block_max(t_bits, red);

  const int n = q_count[tile];
  const int* clusters = q_cluster + static_cast<size_t>(tile) * cap;
  const int* entries = q_entry + static_cast<size_t>(tile) * cap;
  for (int s = 0; s < n; s += K) {
    // Front-to-back early-out: bound >= 0, and non-negative float bits
    // order like the floats.
    if (entries[s] > bound) break;
    for (int k = 0; k < K; ++k) {
      const int cluster = clusters[s + k];
      __syncthreads();  // every thread is done with the previous cluster
      stage_cluster(g, G3, cluster, C);
      __syncthreads();
      if (occ) continue;
      for (int c = 0; c < C; ++c) {
        const Candidate h = candidate(g, c, row);
        if (h.sign_ok && fabsf(h.u_plus_v) <= h.ad && h.ts > h.ad * tmin &&
            h.ts <= h.ad * tmax) {
          occ = true;
          break;
        }
      }
    }
    bound = block_max(occ ? 0 : t_bits, red);
  }
  out[r] = occ ? 1 : 0;
}

}  // namespace
}  // namespace racc

// F (T*tile, 16) rows [d, o, d x o, 1, tmin, tmax_eff, 0...]; G3 (n_c, 4C,
// 16); q_cluster / q_entry (T, cap) int32; q_count (T,) int32; out (R,)
// one byte per ray, 1 = occluded.
extern "C" int racc_dense_occluded(const float* F, const float* G3,
                                   const int* q_cluster, const int* q_entry,
                                   const int* q_count, unsigned char* out,
                                   int T, int tile, int cap, int C, int K,
                                   void* stream) {
  if (C < 1 || C > racc::kMaxC || tile < 32 || tile > 1024 || tile % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  racc::dense_occl_kernel<<<T, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      F, G3, q_cluster, q_entry, q_count, out, cap, C, K);
  return static_cast<int>(cudaGetLastError());
}
