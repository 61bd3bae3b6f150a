// Hopper's bulk copies (the Tensor Memory Accelerator, TMA) completing on
// an mbarrier in shared memory: the counterpart of the TPU's
// pltpu.make_async_copy with a DMA semaphore. One thread arms the barrier
// with the bytes it expects and issues the copy; the hardware moves the
// bytes and completes the barrier's phase; every thread waits on the
// phase's parity. A copy is a plain bulk copy (a contiguous run of bytes)
// or a tensor copy (a box of a tensor map encoded on the host). A bulk
// store moves shared memory back to global memory and completes on the
// issuing thread's bulk group. Used by the DMA probes (probe_dma.cu) and
// the pair kernel's TMA-staged form (pair_hit_mb.cu). Kept apart from
// common.cuh so that the trace kernels K1-K4 compile as they did.
//
// A wait is bounded: a wrong parity or a copy that never lands would spin
// forever (on the TPU a wrong manual DMA hung the chip for an hour,
// tools/probe_dma.py:3-6), so after kWaitCycles the wait gives up, the
// kernel reports kErrWait with its step in an error word, and the wrapper
// raises.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace racc {

// Error codes a kernel writes to err[0] (the first one wins), with the step
// it failed at (a loop iteration, a run) in err[1].
constexpr int kErrSmem = 1;    // less dynamic shared memory than it needs
constexpr int kErrWait = 2;    // an mbarrier wait timed out
constexpr int kErrIndex = 3;   // a row block read on the device is out of range

// About two seconds of SM clock: a 32 KB bulk copy lands in microseconds.
constexpr long long kWaitCycles = 1LL << 32;

__device__ __forceinline__ void report_error(int* err, int code, int step) {
  if (atomicCAS(err, 0, code) == 0) err[1] = step;
}

__device__ __forceinline__ unsigned shared_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory this launch was given.
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned r;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

// One thread: a barrier that completes a phase on `count` arrivals (and
// the bytes they announce). Call mbar_fence_init and __syncthreads before
// any thread uses it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(shared_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives on the barrier and announces `bytes` more to land in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(shared_u32(bar)), "r"(bytes) : "memory");
}

// Arrives on the barrier (one of the `count` arrivals of its phase).
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(shared_u32(bar)) : "memory");
}

// Starts a bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(shared_u32(dst)), "l"(src), "r"(bytes), "r"(shared_u32(bar))
      : "memory");
}

// Starts a tensor copy of the box at coordinates (x, y, z) of a 3-D tensor
// map (a __grid_constant__ kernel parameter) into dst (128-byte aligned),
// completing on `bar` with the box's bytes.
__device__ __forceinline__ void tensor_copy_g2s_3d(void* dst,
                                                   const CUtensorMap* map,
                                                   int x, int y, int z,
                                                   unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(shared_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
         "r"(x), "r"(y), "r"(z), "r"(shared_u32(bar))
      : "memory");
}

// Orders this thread's view of shared memory (the bytes a bulk copy landed,
// seen through a completed barrier) before its next bulk operation.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Starts a bulk store of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from shared to global memory in this thread's bulk group.
__device__ __forceinline__ void bulk_store_s2g(void* dst, const void* src,
                                               unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(shared_u32(src)), "r"(bytes) : "memory");
}

// Commits this thread's bulk stores and waits until they have read their
// shared memory (the writes land before the kernel is complete).
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Whether the phase of parity `parity` has completed (the hardware may
// suspend the thread for a while before answering no).
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}"
      : "=r"(done) : "r"(shared_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity`; false if it has not completed
// within kWaitCycles.
__device__ __forceinline__ bool mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try_wait(bar, parity)) return true;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) return false;
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory: the attribute is set
// the first time a launch needs more than `allowed` (once per process and
// size, not once per launch). A refusal is cleared and returned.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return e;
  }
  allowed = bytes;
  return cudaSuccess;
}

}  // namespace racc
