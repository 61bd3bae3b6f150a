// P1-P3: the manual-DMA probes on Hopper.
//
// Replace tools/probe_dma.py:kern_a (:33), kern_b (:57) and kern_c (:88),
// three escalating steps of an async copy from device memory into scratch
// memory, each waited on through a DMA semaphore:
//
//   P1 (kern_a) a static slice: rows 8:16 of x, then written out;
//   P2 (kern_b) a row block whose index is read on the device (the TPU's
//      scalar prefetch; here the CTA reads it from an int32 tensor);
//   P3 (kern_c) a work list: for each index in turn, copy that row block
//      into one scratch buffer, wait, and add it to an f32 accumulator.
//
// On Hopper the async copy is a TMA bulk copy completing on an mbarrier
// (tma.cuh).
//
// P1 and P2 move a block through shared memory and back, so they are one
// warp whose first lane does everything: it arms the barrier with the
// block's bytes, issues the bulk load, waits on the phase, and issues one
// bulk store of the buffer to the output, whose shared-memory reads it
// waits for before it exits (the global writes complete with the kernel).
// No thread passes a value through its registers. P3 adds each block to
// an accumulator, so it is one CTA of kSumThreads: one thread issues each
// block's copy, every thread waits on the phase's parity and adds its
// elements; the buffer and the barrier are reused, so the parity flips
// each iteration, and a __syncthreads orders every thread's read of the
// buffer before the next copy into it. The accumulator is the output in
// device memory: each thread owns the same elements in every iteration and
// adds in the list's order, from zeros, as the plain version does.
//
// Each kernel's dynamic shared memory limit is raised once per process
// and size (tma.cuh:allow_smem), not before every launch.
//
// What bounds them on the H100: nothing but latency. The probe's block is
// 8 x 128 f32 = 4 KB (8 KB moved by P1 and P2, 20 KB by P3), a few
// nanoseconds at 3.35 TB/s; a launch and the copies' round trips set the
// time.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace racc {
namespace {

constexpr int kSumThreads = 256;

// P1 (Indexed false: the block at row row0) and P2 (Indexed true: the
// block at row idx[0] * rows) of x (R, W) f32 into out, through shared
// memory, by lane 0 of one warp.
template <bool Indexed>
__global__ void __launch_bounds__(32)
probe_bulk_kernel(const float* __restrict__ x, int R, int W, int row0,
                  const int* __restrict__ idx, int rows,
                  float* __restrict__ out, int* __restrict__ err) {
  extern __shared__ __align__(128) float4 buf4[];
  __shared__ __align__(8) unsigned long long bar;
  if (threadIdx.x != 0) return;
  const unsigned bytes = static_cast<unsigned>(rows * W) * sizeof(float);
  if (dynamic_smem_bytes() < bytes) {
    report_error(err, kErrSmem, 0);
    return;
  }
  const long long r = Indexed ? static_cast<long long>(idx[0]) * rows : row0;
  if (r < 0 || r + rows > R) {
    report_error(err, kErrIndex, 0);
    return;
  }
  mbar_init(&bar, 1);
  mbar_fence_init();
  mbar_arrive_expect_tx(&bar, bytes);
  bulk_copy_g2s(buf4, x + r * W, bytes, &bar);
  if (!mbar_wait(&bar, 0)) {
    report_error(err, kErrWait, 0);
    return;
  }
  fence_proxy_async();
  bulk_store_s2g(out, buf4, bytes);
  bulk_store_wait_read();
}

// P3: out = the sum from zeros of the n row blocks of x (R, W) f32 at rows
// idx[j] * rows, j < n, added in the list's order.
__global__ void __launch_bounds__(kSumThreads)
probe_sum_kernel(const float* __restrict__ x, int R, int W,
                 const int* __restrict__ idx, int n, int rows,
                 float* __restrict__ out, int* __restrict__ err) {
  extern __shared__ __align__(128) float4 buf4[];
  __shared__ __align__(8) unsigned long long bar;
  const float* buf = reinterpret_cast<const float*>(buf4);
  const int count = rows * W;
  const unsigned bytes = static_cast<unsigned>(count) * sizeof(float);
  if (dynamic_smem_bytes() < bytes) {
    if (threadIdx.x == 0) report_error(err, kErrSmem, 0);
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    // Every thread reads the index, so all leave together on a bad one.
    const long long r = static_cast<long long>(idx[j]) * rows;
    if (r < 0 || r + rows > R) {
      if (threadIdx.x == 0) report_error(err, kErrIndex, j);
      return;
    }
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&bar, bytes);
      bulk_copy_g2s(buf4, x + r * W, bytes, &bar);
    }
    if (__syncthreads_or(!mbar_wait(&bar, j & 1))) {
      if (threadIdx.x == 0) report_error(err, kErrWait, j);
      return;
    }
    for (int e = threadIdx.x; e < count; e += kSumThreads) {
      const float acc = j ? out[e] : 0.0f;
      out[e] = acc + buf[e];
    }
    __syncthreads();  // every read of buf before the next copy into it
  }
}

// Whether n bulk copies of `rows` rows of x (R, W) f32 can be made: the
// block's bytes a multiple of 16 and x 16-byte aligned.
bool blocks_ok(const float* x, int R, int W, int rows, int n) {
  const long long bytes = static_cast<long long>(rows) * W * sizeof(float);
  return R >= 1 && W >= 1 && rows >= 1 && n >= 1 && bytes % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
}

template <bool Indexed>
int launch_bulk(const float* x, int R, int W, int row0, const int* idx,
                int rows, float* out, int* err, int smem, void* stream) {
  static int allowed = 0;
  if (!blocks_ok(x, R, W, rows, 1) ||
      (!Indexed && (row0 < 0 || row0 + rows > R ||
                    static_cast<long long>(row0) * W * sizeof(float) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dyn = smem > 0 ? smem : rows * W * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(probe_bulk_kernel<Indexed>, dyn, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_bulk_kernel<Indexed><<<1, 32, dyn, static_cast<cudaStream_t>(stream)>>>(
      x, R, W, row0, idx, rows, out, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace racc

// x (R, W) f32, 16-byte aligned; out (rows, W) f32; err (2,) int32 zeros,
// where the kernel reports a failure (tma.cuh: code, step). smem 0 gives
// the kernel the block's bytes of dynamic shared memory; another value is
// used as it is (the card tests force too little and too much).
extern "C" int racc_probe_static(const float* x, int R, int W, int row0,
                                 int rows, float* out, int* err, int smem,
                                 void* stream) {
  return racc::launch_bulk<false>(x, R, W, row0, nullptr, rows, out, err,
                                  smem, stream);
}

// P2: the block at row idx[0] * rows, idx (1,) int32 on the device.
extern "C" int racc_probe_dynamic(const float* x, int R, int W,
                                  const int* idx, int rows, float* out,
                                  int* err, int smem, void* stream) {
  return racc::launch_bulk<true>(x, R, W, 0, idx, rows, out, err, smem,
                                 stream);
}

// P3: the sum of the blocks at rows idx[j] * rows, j < n, from zeros.
extern "C" int racc_probe_worklist(const float* x, int R, int W,
                                   const int* idx, int n, int rows,
                                   float* out, int* err, int smem,
                                   void* stream) {
  using namespace racc;
  static int allowed = 0;
  if (!blocks_ok(x, R, W, rows, n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dyn = smem > 0 ? smem : rows * W * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(probe_sum_kernel, dyn, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_sum_kernel<<<1, kSumThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      x, R, W, idx, n, rows, out, err);
  return static_cast<int>(cudaGetLastError());
}
