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
// (tma.cuh). Each kernel is one CTA: one thread arms the barrier with the
// block's bytes and issues the copy, every thread waits on the phase's
// parity and then reads shared memory. P3 reuses one buffer and one
// barrier, so the parity flips each iteration, and a __syncthreads orders
// every thread's read of the buffer before the next copy into it. The
// accumulator is the output in device memory: each thread owns the same
// elements in every iteration and adds in the list's order, from zeros, as
// the plain version does.
//
// What bounds them on the H100: nothing but latency. The probe's block is
// 8 x 128 f32 = 4 KB (8 KB moved by P1 and P2, 20 KB by P3), a few
// nanoseconds at 3.35 TB/s; a launch and one copy's round trip set the
// time.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace racc {
namespace {

constexpr int kProbeThreads = 256;

// Copies n row blocks of `rows` rows of x (R, W) f32 in turn: block j
// starts at row row0 (Indexed false, n = 1) or at idx[j] * rows. With Sum
// out is the sum of the blocks from zeros, else the last block.
template <bool Indexed, bool Sum>
__global__ void __launch_bounds__(kProbeThreads)
probe_copy_kernel(const float* __restrict__ x, int R, int W, int row0,
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
    const long long r =
        Indexed ? static_cast<long long>(idx[j]) * rows : row0;
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
    for (int e = threadIdx.x; e < count; e += kProbeThreads) {
      if (Sum) {
        const float acc = j ? out[e] : 0.0f;
        out[e] = acc + buf[e];
      } else {
        out[e] = buf[e];
      }
    }
    __syncthreads();  // every read of buf before the next copy into it
  }
}

template <bool Indexed, bool Sum>
int launch_probe(const float* x, int R, int W, int row0, const int* idx,
                 int n, int rows, float* out, int* err, int smem,
                 void* stream) {
  const long long bytes = static_cast<long long>(rows) * W * sizeof(float);
  if (R < 1 || W < 1 || rows < 1 || n < 1 || bytes % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
      (!Indexed && (row0 < 0 || row0 + rows > R ||
                    static_cast<long long>(row0) * W * sizeof(float) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dyn = smem > 0 ? smem : static_cast<int>(bytes);
  cudaError_t e = cudaFuncSetAttribute(
      probe_copy_kernel<Indexed, Sum>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return static_cast<int>(e);
  }
  probe_copy_kernel<Indexed, Sum>
      <<<1, kProbeThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
          x, R, W, row0, idx, n, rows, out, err);
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
  return racc::launch_probe<false, false>(x, R, W, row0, nullptr, 1, rows,
                                          out, err, smem, stream);
}

// P2: the block at row idx[0] * rows, idx (1,) int32 on the device.
extern "C" int racc_probe_dynamic(const float* x, int R, int W,
                                  const int* idx, int rows, float* out,
                                  int* err, int smem, void* stream) {
  return racc::launch_probe<true, false>(x, R, W, 0, idx, 1, rows, out, err,
                                         smem, stream);
}

// P3: the sum of the blocks at rows idx[j] * rows, j < n, from zeros.
extern "C" int racc_probe_worklist(const float* x, int R, int W,
                                   const int* idx, int n, int rows,
                                   float* out, int* err, int smem,
                                   void* stream) {
  return racc::launch_probe<true, true>(x, R, W, 0, idx, n, rows, out, err,
                                        smem, stream);
}
