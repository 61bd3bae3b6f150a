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
// No thread passes a value through its registers.
//
// P3 keeps its whole work list in flight. The TPU kernel waits on each
// block before it copies the next, so n blocks pay n round trips and the
// adds between them; here the CTA first checks every index (a bad one: the
// first is reported and no copy starts), then a producer warp's first lane
// issues one bulk copy a stage for as many blocks as the stages hold, each
// stage a buffer with a full and an empty barrier, before any thread waits.
// A longer list goes through the stages as a ring (pair_hit_mb.cu's
// pattern): a stage is refilled only once every consumer warp has arrived
// on its empty barrier, and each barrier's parity flips with each use. The
// stages are as many as the dynamic shared memory the kernel is launched
// with holds, at most the list's pieces; the host sizes that memory
// (tools/probe_dma.py:worklist_plan). Eight consumer warps sum in
// registers: each thread owns
// the same float4s of every block, adds them from 0.0f in the list's order
// (so the sum is the plain version's zeros + x[...] + ..., -0.0 included)
// and writes them to `out` once, by coalesced stores; `out` is never read.
// A block over 64 KB goes through in slices of 64 KB (16 float4 a thread),
// the list once a slice.
//
// Every wait is bounded and names its step in the error word; each
// kernel's dynamic shared memory limit is raised once per process and
// size (tma.cuh:allow_smem), not before every launch.
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

constexpr int kSumThreads = 256;                 // P3's consumer threads
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumCta = kSumThreads + 32;        // and a producer warp
constexpr int kSumMaxF4 = 16;                    // float4s a consumer thread
constexpr int kPieceF4 = kSumThreads * kSumMaxF4;  // a stage's most: 64 KB
constexpr int kStageBarBytes = 16;               // a full and an empty barrier

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
// idx[j] * rows, j < n, added in the list's order. Each block is `slices`
// pieces of piece_f4 float4s (the last may be shorter); piece i = slice
// * n + j lands in stage i % stages, a buffer of piece_f4 float4s, with
// the stages' full and then empty barriers after the last buffer. K:
// float4s a consumer thread owns, K * kSumThreads >= piece_f4.
template <int K>
__global__ void __launch_bounds__(kSumCta)
probe_sum_kernel(const float* __restrict__ x, int R, int W,
                 const int* __restrict__ idx, int n, int rows, int piece_f4,
                 int slices, int stages, float* __restrict__ out,
                 int* __restrict__ err) {
  extern __shared__ __align__(128) float4 ring[];
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + stages * piece_f4);
  unsigned long long* empty = full + stages;
  const unsigned stage_bytes = piece_f4 * sizeof(float4) + kStageBarBytes;
  if (dynamic_smem_bytes() < stages * stage_bytes) {
    if (threadIdx.x == 0) report_error(err, kErrSmem, 0);
    return;
  }
  // The whole list is checked before any copy starts: index j by the
  // thread of rank j mod kSumCta, the producer warp's lanes first, so that
  // lane l holds idx[l] when it issues its first copy.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = warp == kSumWarps ? lane : threadIdx.x + 32;
  auto outside = [&](int block) {
    const long long r = static_cast<long long>(block) * rows;
    return r < 0 || r + rows > R;
  };
  const int mine = rank < n ? idx[rank] : 0;
  bool bad = rank < n && outside(mine);
  for (int j = rank + kSumCta; j < n; j += kSumCta) bad |= outside(idx[j]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSumWarps);
    }
    mbar_fence_init();
  }
  if (__syncthreads_or(bad)) {
    if (threadIdx.x == 0) {
      int j = 0;
      while (!outside(idx[j])) ++j;
      report_error(err, kErrIndex, j);
    }
    return;
  }

  const int block_f4 = rows * W / 4;
  const int pieces = n * slices;
  if (warp == kSumWarps) {
    // The producer. Piece i, slice `slice` of block idx[j], goes to stage
    // s = i % stages: the first lane arms the stage's full barrier with the
    // piece's bytes and issues the bulk copy.
    const float4* x4 = reinterpret_cast<const float4*>(x);
    auto issue = [&](int s, int slice, int block) {
      const int f4 = min(piece_f4, block_f4 - slice * piece_f4);
      mbar_arrive_expect_tx(&full[s], f4 * sizeof(float4));
      bulk_copy_g2s(ring + s * piece_f4,
                    x4 + static_cast<long long>(block) * block_f4 +
                        slice * piece_f4,
                    f4 * sizeof(float4), &full[s]);
    };
    int slice = 0, j = 0;
    auto next = [&] {
      if (++j == n) {
        j = 0;
        ++slice;
      }
    };
    // Every stage's first piece, before any thread waits; the block
    // indices below 32 come from the lanes that checked them.
    for (int s = 0; s < stages; ++s, next()) {
      const int block = j < 32 ? __shfl_sync(0xffffffffu, mine, j) : idx[j];
      if (lane == 0) issue(s, slice, block);
    }
    // The ring: piece i goes to stage s once every consumer warp has left
    // piece i - stages (the empty barrier's previous phase there).
    if (lane != 0) return;
    for (int i = stages, s = 0, use = 1; i < pieces; ++i, next()) {
      if (!mbar_wait(&empty[s], (use - 1) & 1)) {
        report_error(err, kErrWait, -1 - i);
        return;
      }
      issue(s, slice, idx[j]);
      if (++s == stages) {
        s = 0;
        ++use;
      }
    }
    return;
  }

  // The consumers: float4 k * kSumThreads + threadIdx.x of every piece.
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int slice = 0, i = 0, s = 0, use = 0; slice < slices; ++slice) {
    const int f4 = min(piece_f4, block_f4 - slice * piece_f4);
    float4 acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < n; ++j, ++i) {
      const bool ok = mbar_wait(&full[s], use & 1);
      if (__any_sync(0xffffffffu, !ok)) {
        if (lane == 0) report_error(err, kErrWait, i);
        return;
      }
      const float4* buf = ring + s * piece_f4;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = k * kSumThreads + threadIdx.x;
        if (e < f4) {
          const float4 v = buf[e];
          acc[k].x += v.x;
          acc[k].y += v.y;
          acc[k].z += v.z;
          acc[k].w += v.w;
        }
      }
      if (i + stages < pieces) {
        __syncwarp();  // every lane's reads of the stage are done
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (++s == stages) {
        s = 0;
        ++use;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = k * kSumThreads + threadIdx.x;
      if (e < f4) out4[slice * piece_f4 + e] = acc[k];
    }
  }
}

// Whether n bulk copies of `rows` rows of x (R, W) f32 can be made: the
// block's bytes a multiple of 16 and x 16-byte aligned.
bool blocks_ok(const float* x, int R, int W, int rows, int n) {
  const long long bytes = static_cast<long long>(rows) * W * sizeof(float);
  return R >= 1 && W >= 1 && rows >= 1 && n >= 1 && bytes % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
}

// P3's pieces for blocks of `bytes` (a multiple of 16): at most kPieceF4
// float4s (slices a block), a stage's bytes (a piece's buffer and its two
// barriers) and the float4s a consumer thread owns (a power of two).
struct SumPlan {
  int piece_f4, slices, stage, k;
};

bool sum_plan(int n, long long bytes, SumPlan& p) {
  const long long f4 = bytes / static_cast<long long>(sizeof(float4));
  p.piece_f4 = static_cast<int>(f4 < kPieceF4 ? f4 : kPieceF4);
  const long long slices = (f4 + p.piece_f4 - 1) / p.piece_f4;
  if (slices * n > 0x7fffffff) return false;
  p.slices = static_cast<int>(slices);
  p.stage = p.piece_f4 * static_cast<int>(sizeof(float4)) + kStageBarBytes;
  for (p.k = 1; p.k * kSumThreads < p.piece_f4;) p.k *= 2;
  return true;
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

template <int K>
int launch_sum(const float* x, int R, int W, const int* idx, int n, int rows,
               float* out, int* err, const SumPlan& p, int dyn, int stages,
               void* stream) {
  static int allowed = 0;
  const cudaError_t e = allow_smem(probe_sum_kernel<K>, dyn, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_sum_kernel<K><<<1, kSumCta, dyn, static_cast<cudaStream_t>(stream)>>>(
      x, R, W, idx, n, rows, p.piece_f4, p.slices, stages, out, err);
  return static_cast<int>(cudaGetLastError());
}

// P3 in `smem` bytes of dynamic shared memory (0: one stage's): as many
// stages as fit, at most the list's pieces; where not one fits, the kernel
// is launched with one and reports too little shared memory.
int launch_worklist(const float* x, int R, int W, const int* idx, int n,
                    int rows, float* out, int* err, int smem, void* stream) {
  SumPlan p;
  if (!blocks_ok(x, R, W, rows, n) ||
      !sum_plan(n, static_cast<long long>(rows) * W * sizeof(float), p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dyn = smem > 0 ? smem : p.stage;
  const long long pieces = static_cast<long long>(n) * p.slices;
  const int stages =
      static_cast<int>(pieces < dyn / p.stage ? pieces : dyn / p.stage);
  const int s = stages > 0 ? stages : 1;
  switch (p.k) {
    case 1: return launch_sum<1>(x, R, W, idx, n, rows, out, err, p, dyn, s,
                                 stream);
    case 2: return launch_sum<2>(x, R, W, idx, n, rows, out, err, p, dyn, s,
                                 stream);
    case 4: return launch_sum<4>(x, R, W, idx, n, rows, out, err, p, dyn, s,
                                 stream);
    case 8: return launch_sum<8>(x, R, W, idx, n, rows, out, err, p, dyn, s,
                                 stream);
    default:
      return launch_sum<16>(x, R, W, idx, n, rows, out, err, p, dyn, s,
                            stream);
  }
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

// P3: the sum of the blocks at rows idx[j] * rows, j < n, from zeros, in
// as many stages as smem holds (0: one stage).
extern "C" int racc_probe_worklist(const float* x, int R, int W,
                                   const int* idx, int n, int rows,
                                   float* out, int* err, int smem,
                                   void* stream) {
  return racc::launch_worklist(x, R, W, idx, n, rows, out, err, smem, stream);
}
