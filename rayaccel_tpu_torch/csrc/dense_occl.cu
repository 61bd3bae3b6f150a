// K4: dense any-hit (occlusion) over a per-tile, front-to-back cluster
// queue.
//
// Replaces rayaccel_tpu/ops/trace_pallas.py:_occl_kernel (:265-324),
// launched by _make_occl_call (:327-360) inside trace_occlusion_pallas.
// Same function, taken per ray over the queued clusters whose box the ray
// enters (as K1's): a ray is occluded when some triangle of those clusters
// has sign-consistent u, v and det, |u + v| <= |det|, and its det-signed t
// numerator inside the window: ts > |det| * tmin and ts <= |det| * tmax
// (inclusive at tmax, as in the TPU kernel; the pair kernel's guard is
// strict). There is no reciprocal, so the predicate is exact up to the
// fp32 dot products. Inactive lanes carry tmax = -1, which no candidate
// satisfies and no box admits.
//
// What bounds it on the H100: fp32 instruction throughput, as in K1 (40
// FMAs, 80 FLOP, and a few compares per (ray, triangle)), but less of it:
// a ray needs the queued clusters up to its first blocker whose entry is
// within its tmax (0.066 ms of fp32 FMAs on chip_smoke.py's shadow wave;
// PERF.md has the share this kernel reaches).
//
// Design, K1's (csrc/dense_hit.cu, common.cuh:walk_queue): a tile's rays
// split across CTAs of 64 (8 x 8 pixel squares), each gated by its own
// rays' boxes, two rays a thread and 8 threads a pair of rays, clusters
// staged by cp.async into a two-stage ring. A warp's bound is the largest
// tmax bits among its unoccluded rays (occluded and inactive rays count as
// negative), so a warp whose rays are all occluded skips every later
// cluster and the CTA stages no more for it; the Pallas kernel's bound was
// tile-wide. Inside a cluster, a thread leaves its column loop once each
// of its rays is occluded or outside the box, and the threads of a pair
// of rays merge their flags after it.
//
// The bf16 variant (precision "default") is K1's bf16 design
// (csrc/dense_hit.cu, common.cuh:mma_rays): the walk's CTA and warp gates
// without the per-ray one, a warp's 16 rays as the A fragment, the scene's
// bf16 fragment copy as B, whole pairs a lane; its column loop takes
// kOcclGroups groups at a time with no branch, and the warp leaves a
// cluster once a ballot, taken between two such steps, shows each of its
// rays occluded or inactive.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

// Groups of 4 triangles the bf16 variant's column loop takes at once (32
// products at kFrags = 1), between two checks of the warp's early exit.
// Chosen on the card (PERF.md).
constexpr int kOcclGroups = 16;

__global__ void __launch_bounds__(kCtaThreads)
dense_occl_kernel(const float* __restrict__ F, const float* __restrict__ G3,
                  const float* __restrict__ bbmin,
                  const float* __restrict__ bbmax,
                  const int* __restrict__ q_cluster,
                  const int* __restrict__ q_entry,
                  const int* __restrict__ q_count,
                  unsigned char* __restrict__ out,
                  unsigned long long* __restrict__ walked, int tile, int cap,
                  int C) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ int red[2 * kWarps];
  const int sub = dense_sub(), own = dense_ray(), r = cta_row(tile, own);
  const int tl = blockIdx.x * kCtaRays / tile;

  float f[2][10], tmin[2], tmax[2];
  load_rays2(F, r, f, tmin, tmax);
  bool occ[2] = {false, false};
  auto warp_bound = [&]() {
    return warp_max(max(occ[0] ? kSignBit : __float_as_int(tmax[0]),
                        occ[1] ? kSignBit : __float_as_int(tmax[1])));
  };

  auto test = [&](const float4* g, int, unsigned long long in) {
    // A ray takes the candidates of a box it enters: one that does not
    // counts as done for this cluster, and keeps its flag.
    bool was[2], in2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      was[i] = occ[i];
      in2[i] = enters(in, own + kWarpPairs * i);
      occ[i] = occ[i] || !in2[i];
    }
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
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o < kColSplit; o <<= 1)
        occ[i] = __shfl_xor_sync(0xffffffffu, occ[i], o) || occ[i];
      occ[i] = in2[i] ? occ[i] : was[i];
    }
    return warp_bound();
  };
  const WalkCount n = walk_queue(
      F, tile, bbmin, bbmax, G3,
      q_cluster + static_cast<size_t>(tl) * cap,
      q_entry + static_cast<size_t>(tl) * cap, q_count[tl], cap, C,
      warp_bound(), ring, red, test);
  count_walk(walked, n);
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) out[r + kWarpPairs * i] = occ[i] ? 1 : 0;
  }
}

// The bf16 variant: K4's walk on the scene's bf16 fragment copy, a warp's
// rays as the A operand (common.cuh:mma_rays, as K1's bf16 variant), each
// lane testing whole (ray, triangle) pairs.
__global__ void __launch_bounds__(kFragWarps * 32)
dense_occl_bf16_kernel(const float* __restrict__ F,
                       const float4* __restrict__ G3b,
                       const float* __restrict__ bbmin,
                       const float* __restrict__ bbmax,
                       const int* __restrict__ q_cluster,
                       const int* __restrict__ q_entry,
                       const int* __restrict__ q_count,
                       unsigned char* __restrict__ out,
                       unsigned long long* __restrict__ walked, int tile,
                       int cap, int C) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ int red[2 * kFragWarps];
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int base = (threadIdx.x >> 5) * kFragRays;  // the warp's first ray
  const int tl = blockIdx.x * kCtaRays / tile;

  unsigned a[kFrags][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
    ray_rows_fragment(F, cta_row(tile, frag_ray(base, 2 * f)),
                      cta_row(tile, frag_ray(base, 2 * f + 1)), a[f]);
  float tmin[kLaneRays], tmax[kLaneRays];
  bool idle[kLaneRays], occ[kLaneRays];
#pragma unroll
  for (int i = 0; i < kLaneRays; ++i) {
    const size_t r = cta_row(tile, frag_ray(base, i));
    tmin[i] = F[r * kFeat + 10];
    tmax[i] = F[r * kFeat + 11];
    // Inactive rays (tmax_eff -1) are never occluded and need no test.
    idle[i] = __float_as_int(tmax[i]) < 0;
    occ[i] = false;
  }
  auto warp_bound = [&]() {
    int b = kSignBit;
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i)
      b = max(b, occ[i] ? kSignBit : __float_as_int(tmax[i]));
    return warp_max(b);
  };
  // Lanes 4g .. 4g + 3 share their rays: bit 4g of a ray slot's fold is
  // set when one of them has the slot's ray done.
  auto all_done = [&]() {
    unsigned v = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i) {
      unsigned b = __ballot_sync(0xffffffffu, occ[i] || idle[i]);
      b |= b >> 1;
      v &= b | (b >> 2);
    }
    return (v & 0x11111111u) == 0x11111111u;
  };
  auto test = [&](const float4* stage, int, unsigned long long) {
    const uint4* g = reinterpret_cast<const uint4*>(stage);
    const int groups = (C + 3) / 4;
    // kOcclGroups groups at a time, the last one repeated past the
    // cluster's end; a column past C is dropped. The warp leaves the
    // cluster once each of its rays is occluded or inactive, checked once
    // a step.
    for (int q0 = 0; q0 < groups && !all_done(); q0 += kOcclGroups) {
      float p[kOcclGroups][kLaneRays][4];
#pragma unroll
      for (int u = 0; u < kOcclGroups; ++u)
        mma_rays(g, min(q0 + u, groups - 1), a, p[u]);
#pragma unroll
      for (int u = 0; u < kOcclGroups; ++u) {
        const bool live = 4 * min(q0 + u, groups - 1) + t < C;
#pragma unroll
        for (int i = 0; i < kLaneRays; ++i) {
          float ad, ts;
          bool inside;
          decode_rays(p[u][i], inside, ad, ts);
          occ[i] |= live & inside & (ts > ad * tmin[i]) & (ts <= ad * tmax[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i) {
      occ[i] = __shfl_xor_sync(0xffffffffu, occ[i], 1) || occ[i];
      occ[i] = __shfl_xor_sync(0xffffffffu, occ[i], 2) || occ[i];
    }
    return warp_bound();
  };
  const WalkCount n = walk_frags(
      F, tile, bbmin, bbmax, G3b,
      q_cluster + static_cast<size_t>(tl) * cap,
      q_entry + static_cast<size_t>(tl) * cap, q_count[tl], cap, C,
      warp_bound(), ring, red, test);
  count_walk(walked, n);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kLaneRays; ++i)
      out[cta_row(tile, frag_ray(base, i))] = occ[i] ? 1 : 0;
  }
}

}  // namespace
}  // namespace racc

// F (T*tile, 16) rows [d, o, d x o, 1, tmin, tmax_eff, 0...]; G3 (n_c, 4C,
// 16); G3b (nullable) G3's bf16 fragment copy; bbmin, bbmax (n_c, 3) the
// clusters' boxes; q_cluster / q_entry (T, cap) int32; q_count (T,) int32;
// out (R,) one byte per ray, 1 = occluded; walked (nullable, 2 int64)
// gains the (ray, cluster) pairs tested and the clusters the CTAs staged.
// The tile is a multiple of kCtaRays. With G3b the bf16 tensor-core
// variant runs on it.
extern "C" int racc_dense_occluded(const float* F, const float* G3,
                                   const void* G3b, const float* bbmin,
                                   const float* bbmax, const int* q_cluster,
                                   const int* q_entry, const int* q_count,
                                   unsigned char* out,
                                   unsigned long long* walked, int T,
                                   int tile, int cap, int C, void* stream) {
  using namespace racc;
  if (!dense_launch_ok(T, tile, cap, C))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = T * (tile / kCtaRays);
  if (G3b != nullptr) {
    const int smem = walk_bytes(frag_chunks(C), cap);
    cudaError_t e = cudaFuncSetAttribute(
        dense_occl_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dense_occl_bf16_kernel<<<blocks, kFragWarps * 32, smem, s>>>(
        F, static_cast<const float4*>(G3b), bbmin, bbmax, q_cluster, q_entry,
        q_count, out, walked, tile, cap, C);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = walk_bytes(4 * C * kRowF4, cap);
  cudaError_t e = cudaFuncSetAttribute(
      dense_occl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_occl_kernel<<<blocks, kCtaThreads, smem, s>>>(
      F, G3, bbmin, bbmax, q_cluster, q_entry, q_count, out, walked, tile,
      cap, C);
  return static_cast<int>(cudaGetLastError());
}
