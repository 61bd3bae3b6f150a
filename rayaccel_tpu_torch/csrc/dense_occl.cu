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
// What bounds it on the H100: fp32 instruction throughput, as in K1 (40
// FMAs, 80 FLOP, and a few compares per (ray, triangle)), but less of it:
// a ray needs the queued clusters up to its first blocker whose entry is
// within its tmax (0.066 ms of fp32 FMAs on chip_smoke.py's shadow wave;
// PERF.md has the share this kernel reaches).
//
// Design, K1's (csrc/dense_hit.cu, common.cuh:walk_queue): a tile's rays
// split across CTAs of 64, two rays a thread and 8 threads a pair of
// rays, clusters staged by cp.async into a two-stage ring. A warp's bound is the largest tmax bits among its
// unoccluded rays (occluded and inactive rays count as negative), so a
// warp whose rays are all occluded skips every later cluster and the CTA
// stops staging once all its warps would skip; the Pallas kernel's bound
// was tile-wide. Inside a cluster, a thread leaves its column loop once
// both its rays are occluded, and the threads of a pair of rays merge
// their flags after it.
//
// The bf16 variant (precision "default") takes the products from the
// tensor cores as K1's does (common.cuh:mma_pairs, csrc/dense_hit.cu): a
// lane tests one (ray, triangle) pair a product, and the warp leaves a
// cluster once a ballot shows each of its 8 rays occluded or inactive.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

__global__ void __launch_bounds__(kCtaThreads)
dense_occl_kernel(const float* __restrict__ F, const float* __restrict__ G3,
                  const int* __restrict__ q_cluster,
                  const int* __restrict__ q_entry,
                  const int* __restrict__ q_count,
                  unsigned char* __restrict__ out,
                  unsigned long long* __restrict__ walked, int tile, int cap,
                  int C) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ int red[2 * kWarps];
  const int sub = dense_sub(), r = dense_ray();
  const int tl = blockIdx.x * kCtaRays / tile;

  float f[2][10], tmin[2], tmax[2];
  load_rays2(F, r, f, tmin, tmax);
  bool occ[2] = {false, false};
  auto warp_bound = [&]() {
    return warp_max(max(occ[0] ? kSignBit : __float_as_int(tmax[0]),
                        occ[1] ? kSignBit : __float_as_int(tmax[1])));
  };

  auto test = [&](const float4* g, int) {
    for (int c = sub; c < C && !(occ[0] && occ[1]); c += kColSplit) {
      bool inside[2];
      float ad[2], ts[2];
      decode2(g, c, C, f, inside, ad, ts);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        occ[i] = occ[i] || (inside[i] && ts[i] > ad[i] * tmin[i] &&
                            ts[i] <= ad[i] * tmax[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int o = 1; o < kColSplit; o <<= 1)
        occ[i] = __shfl_xor_sync(0xffffffffu, occ[i], o) || occ[i];
    return warp_bound();
  };
  const long long tested = walk_queue(
      G3, q_cluster + static_cast<size_t>(tl) * cap,
      q_entry + static_cast<size_t>(tl) * cap, q_count[tl], C, warp_bound(),
      ring, red, test);
  if (walked != nullptr && (threadIdx.x & 31) == 0)
    atomicAdd(walked, static_cast<unsigned long long>(tested));
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) out[r + kWarpPairs * i] = occ[i] ? 1 : 0;
  }
}

// The bf16 variant: K4's walk, each lane testing one (ray, triangle) pair
// of a tensor-core product (common.cuh:mma_pairs).
__global__ void __launch_bounds__(kCtaThreads)
dense_occl_bf16_kernel(const float* __restrict__ F,
                       const float* __restrict__ G3,
                       const int* __restrict__ q_cluster,
                       const int* __restrict__ q_entry,
                       const int* __restrict__ q_count,
                       unsigned char* __restrict__ out,
                       unsigned long long* __restrict__ walked, int tile,
                       int cap, int C) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ int red[2 * kWarps];
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kCtaRays + (threadIdx.x >> 5) * kWarpRays;
  const int r = base + mma_ray();
  const int tl = blockIdx.x * kCtaRays / tile;

  unsigned b[2];
  ray_fragment(F + static_cast<size_t>(base + (lane >> 2)) * kFeat, b);
  const float tmin = F[static_cast<size_t>(r) * kFeat + 10];
  const float tmax = F[static_cast<size_t>(r) * kFeat + 11];
  // Inactive rays (tmax_eff -1) are never occluded and need no test.
  const bool idle = __float_as_int(tmax) < 0;
  bool occ = false;
  auto warp_bound = [&]() {
    return warp_max(occ ? kSignBit : __float_as_int(tmax));
  };
  // Lanes l, l ^ 8, l ^ 16, l ^ 24 share a ray: bit (l & 7) of the fold
  // is set when one of them is done.
  auto all_done = [&]() {
    unsigned v = __ballot_sync(0xffffffffu, occ || idle);
    v |= v >> 16;
    v |= v >> 8;
    return (v & 0xFFu) == 0xFFu;
  };

  auto test = [&](const float4* g, int) {
    for (int c0 = 0; c0 < C && !all_done(); c0 += 4) {
      float det, u, v, tn, ad, ts;
      bool inside;
      mma_pairs(g, c0, C, b, det, u, v, tn);
      decode1(det, u, v, tn, inside, ad, ts);
      occ = occ || (c0 + (lane >> 3) < C && inside && ts > ad * tmin &&
                    ts <= ad * tmax);
    }
    occ = __shfl_xor_sync(0xffffffffu, occ, 8) || occ;
    occ = __shfl_xor_sync(0xffffffffu, occ, 16) || occ;
    return warp_bound();
  };
  const long long tested = walk_queue(
      G3, q_cluster + static_cast<size_t>(tl) * cap,
      q_entry + static_cast<size_t>(tl) * cap, q_count[tl], C, warp_bound(),
      ring, red, test);
  if (walked != nullptr && lane == 0)
    atomicAdd(walked, static_cast<unsigned long long>(tested));
  if (lane < 8) out[r] = occ ? 1 : 0;
}

}  // namespace
}  // namespace racc

// F (T*tile, 16) rows [d, o, d x o, 1, tmin, tmax_eff, 0...]; G3 (n_c, 4C,
// 16); q_cluster / q_entry (T, cap) int32; q_count (T,) int32; out (R,)
// one byte per ray, 1 = occluded; walked (nullable) gains the (ray,
// cluster) pairs tested. The tile is a multiple of kCtaRays. bf16 != 0
// launches the bf16 tensor-core variant.
extern "C" int racc_dense_occluded(const float* F, const float* G3,
                                   const int* q_cluster, const int* q_entry,
                                   const int* q_count, unsigned char* out,
                                   unsigned long long* walked, int T,
                                   int tile, int cap, int C, int bf16,
                                   void* stream) {
  using namespace racc;
  if (!dense_launch_ok(T, tile, C))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const int smem = ring_bytes(C);
  auto kernel = bf16 ? dense_occl_bf16_kernel : dense_occl_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<T * (tile / kCtaRays), kCtaThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      F, G3, q_cluster, q_entry, q_count, out, walked, tile, cap, C);
  return static_cast<int>(cudaGetLastError());
}
