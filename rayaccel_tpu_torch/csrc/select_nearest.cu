// K2: fused cluster cull and nearest-k selection.
//
// Replaces rayaccel_tpu/ops/trace_sparse.py:_select_kernel (:209-267),
// launched by _select_nearest_pallas (:270-370). Same function, bit for
// bit: for each ray, slab-test every cluster AABB over [tmin, tmax], pack
// (entry distance bits | cluster id) into one int32 word per cluster, drop
// words below the ray's previous spill word (the restart progress
// guarantee), and output the k smallest words in order, then the (k+1)-th
// (the spill word) and the count of overlapped clusters. Lanes of ray
// tiles with no live ray output the masked words the JAX wrapper gives
// them (0x7FFFFFFF, count 0) without being tested.
//
// What bounds it on the H100: fp32/ALU issue, ~25 operations per (ray,
// cluster) pair with no reuse across rays; 896 boxes x 983,040 rays per
// frame-width call. Memory traffic is one 36-byte ray record in and
// (k + 2) words out per ray.
//
// Design: one thread per ray; all cluster boxes (896 x 6 floats = 21 KB at
// the headline scene) are staged in shared memory and read as broadcasts.
// The Pallas kernel extracted the k nearest by k + 1 masked minimum passes
// over an (n_cp, tile) block; here each thread keeps its k + 1 smallest
// words in registers by insertion, one pass over the boxes. There is no
// approximate arithmetic: -0.0 entries are canonicalised to +0.0 (the sign
// of a zero minimum is otherwise unspecified), so the result equals the
// plain version's bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

constexpr int kInfBits = 0x7F800000;

template <int K>
__global__ void __launch_bounds__(256)
select_kernel(const float* __restrict__ F8, const int* __restrict__ prev,
              const unsigned char* __restrict__ live,
              const float* __restrict__ bb, int* __restrict__ out, int R,
              int n_cp, int id_bits) {
  extern __shared__ float sbb[];  // (n_cp, 6): bbmin | bbmax
  for (int i = threadIdx.x; i < n_cp * 6; i += blockDim.x) sbb[i] = bb[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  if (!live[r]) {
    for (int i = 0; i <= K; ++i) out[static_cast<size_t>(i) * R + r] = kIntMax;
    out[static_cast<size_t>(K + 1) * R + r] = 0;
    return;
  }
  const float* fr = F8 + static_cast<size_t>(r) * 8;
  const float o[3] = {fr[0], fr[1], fr[2]};
  const float inv[3] = {fr[3], fr[4], fr[5]};
  const float tmin = fr[6], tmax = fr[7];
  const int pv = prev[r];
  const int low = (1 << id_bits) - 1;

  int top[K + 1];
#pragma unroll
  for (int i = 0; i <= K; ++i) top[i] = kIntMax;
  int cnt = 0;
  for (int c = 0; c < n_cp; ++c) {
    const float* b = sbb + c * 6;
    float t0 = tmin, t1 = tmax;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float tn = (b[a] - o[a]) * inv[a];
      const float tf = (b[3 + a] - o[a]) * inv[a];
      t0 = fmaxf(t0, fminf(tn, tf));
      t1 = fminf(t1, fmaxf(tn, tf));
    }
    const float e = t0 <= t1 ? fmaxf(t0, 0.0f) + 0.0f : __int_as_float(kInfBits);
    int w = (__float_as_int(e) & ~low) | c;
    if (w < pv) w = kIntMax;
    cnt += w < kInfBits;
    if (w < top[K]) {
#pragma unroll
      for (int i = 0; i <= K; ++i) {
        if (w < top[i]) {
          const int tmp = top[i];
          top[i] = w;
          w = tmp;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i <= K; ++i) out[static_cast<size_t>(i) * R + r] = top[i];
  out[static_cast<size_t>(K + 1) * R + r] = cnt;
}

template <int K>
int launch(const float* F8, const int* prev, const unsigned char* live,
           const float* bb, int* out, int R, int n_cp, int id_bits,
           cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(n_cp) * 6 * sizeof(float);
  select_kernel<K><<<blocks, threads, smem, stream>>>(F8, prev, live, bb, out,
                                                      R, n_cp, id_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace racc

// F8 (R, 8) rows [o, inv_d, tmin, tmax_eff]; prev (R,) int32 previous
// spill words; live (R,) uint8 lane-of-a-live-tile flags; bb (n_cp, 6);
// out (k + 2, R) int32: k nearest packed words, the spill word, the count.
extern "C" int racc_select_nearest(const float* F8, const int* prev,
                                   const unsigned char* live, const float* bb,
                                   int* out, int R, int n_cp, int id_bits,
                                   int k, void* stream) {
  const size_t smem = static_cast<size_t>(n_cp) * 6 * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return racc::launch<1>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 2: return racc::launch<2>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 3: return racc::launch<3>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 4: return racc::launch<4>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 5: return racc::launch<5>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 6: return racc::launch<6>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 7: return racc::launch<7>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    case 8: return racc::launch<8>(F8, prev, live, bb, out, R, n_cp, id_bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
