// The threefry draws: the shading layer's random numbers, one launch a call.
//
// Replaces no Pallas kernel: the JAX package draws with jax.random, which
// XLA fuses into its own kernels on the TPU. The port's plain version
// (rng.py: threefry2x32 and the draws built on it) runs the 20-round
// Threefry-2x32 cipher as int64 tensor arithmetic, with a mask after every
// step because CPU torch has no uint32 shifts: some 174 elementwise
// launches a cipher call, each over a whole wave or pool. Same function,
// bit for bit: every word equals the plain version's, and so jax.random's
// (jax_threefry_partitionable=True).
//
// What bounds it on the H100: integer instruction rate. A cipher block
// costs about 72 operations (two key adds; 20 rounds of an add, a rotation
// and an xor; five key injections of two adds) on a counter the thread
// makes itself, and a draw writes 4 bytes. The compiler issues most adds
// as IMAD.IADD on the FMA pipe, so the bound prices the rotations, xors
// and ors at the INT32 pipe's rate, 64 lanes an SM (chip_smoke.py).
//
// Design. One thread an output row (a counter, a lane, a pixel); the words
// stay in registers, the rounds unrolled with the rotations and the key
// schedule's constants known at compile time, each rotation one
// __funnelshift_l. A float is (bits >> 9) | 0x3F800000 minus 1 (exact),
// written straight to the output. The draw shape is a template parameter:
// - kPositional (rng.uniform): counter i of n hashes (0, i), and out[i] is
//   word0 ^ word1 (the flat stream, which the wrapper reshapes);
// - kLane (rng.lane_uniform): lane l hashes the blocks (l, l + 2^31) and
//   (l + 2^30, l + 3 * 2^30), mod 2^32, and its row is (a0, b0, a1);
// - kPair (rng.fold_in_uniform_pair): element e takes the key
//   threefry(k, (0, e mod 2^32)), then draws the counters (0, 0) and
//   (0, 1) under it; its row is each draw's word0 ^ word1.
#include <cuda_runtime.h>

namespace racc {
namespace {

constexpr int kPositional = 0;
constexpr int kLane = 1;
constexpr int kPair = 2;
constexpr int kThreads = 256;

template <int R>
__device__ __forceinline__ void mix(unsigned& x0, unsigned& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(unsigned& x0, unsigned& x1) {
  mix<R0>(x0, x1);
  mix<R1>(x0, x1);
  mix<R2>(x0, x1);
  mix<R3>(x0, x1);
}

// Threefry-2x32, 20 rounds, on the counter (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry(unsigned k0, unsigned k1,
                                         unsigned& x0, unsigned& x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

// 23 random mantissa bits under exponent 0, minus one: a float in [0, 1).
__device__ __forceinline__ float unit(unsigned bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

template <int kShape>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const int* __restrict__ ids, float* __restrict__ out,
                    int n, unsigned k0, unsigned k1) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if constexpr (kShape == kPositional) {
    unsigned x0 = 0u, x1 = static_cast<unsigned>(i);
    threefry(k0, k1, x0, x1);
    out[i] = unit(x0 ^ x1);
  } else if constexpr (kShape == kLane) {
    const unsigned l = static_cast<unsigned>(ids[i]);
    unsigned a0 = l, a1 = l + 0x80000000u;
    unsigned b0 = l + 0x40000000u, b1 = l + 0xC0000000u;
    threefry(k0, k1, a0, a1);
    threefry(k0, k1, b0, b1);
    float* row = out + 3 * static_cast<size_t>(i);
    row[0] = unit(a0);
    row[1] = unit(b0);
    row[2] = unit(a1);
  } else {
    unsigned e0 = 0u, e1 = static_cast<unsigned>(ids[i]);
    threefry(k0, k1, e0, e1);
    unsigned a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
    threefry(e0, e1, a0, a1);
    threefry(e0, e1, b0, b1);
    float* row = out + 2 * static_cast<size_t>(i);
    row[0] = unit(a0 ^ a1);
    row[1] = unit(b0 ^ b1);
  }
}

template <int kShape>
cudaError_t launch(const int* ids, float* out, int n, unsigned k0,
                   unsigned k1, cudaStream_t st) {
  const int blocks = (n + kThreads - 1) / kThreads;
  threefry_kernel<kShape><<<blocks, kThreads, 0, st>>>(ids, out, n, k0, k1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace racc

// shape 0, 1 or 2 (kPositional, kLane, kPair); ids (n,) int32 (null for
// kPositional); out (n,), (n, 3) or (n, 2) float32; (k0, k1) the key's two
// words.
extern "C" int racc_threefry(int shape, const int* ids, float* out, int n,
                             unsigned k0, unsigned k1, void* stream) {
  using namespace racc;
  if (n < 0 || (shape != kPositional && ids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case kPositional:
      return static_cast<int>(launch<kPositional>(ids, out, n, k0, k1, st));
    case kLane:
      return static_cast<int>(launch<kLane>(ids, out, n, k0, k1, st));
    case kPair:
      return static_cast<int>(launch<kPair>(ids, out, n, k0, k1, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
