// P4: K3's function on K3's balanced work units, each cluster staged by a
// TMA tensor copy into a ring that a producer warp keeps ahead of the
// consumer warps.
//
// Replaces tools/probe_pair_dma.py:_kernel_mb (:63-136, pallas_call :163),
// the TPU probe of a multi-block pair kernel: each grid step owns GB
// consecutive SP-pair blocks and walks their cluster runs in order, the
// runs' bounds read on the device, each run's G block double-buffered by
// explicit async copies. Its output is K3's (csrc/pair_hit.cu), word for
// word on the covered pairs: for every pair of a run whose lane word names
// the run's cluster, min(miss marker, packed (score | rank | column)).
//
// Design. The work is K3's: the runs cut into 64-pair work units
// (pair_hit.cu:pair_hit_units_kernel writes the prefix), a grid of the
// CTAs the card holds at once, and CTA b the b-th contiguous share of the
// units, so the probe's "several blocks a grid step" is what a share
// spans, not a knob. Only the staging differs from K3's:
//
// - A tensor copy a cluster. The host encodes a 3-D tensor map over G3
//   (16 floats, C rows, 4 n_c kinds; strides 64 and 64C bytes) whose box
//   is 12 floats x C rows x 4 kinds: one copy lands the 48 live bytes of
//   each of the cluster's 4C rows densely, which is K3's staged layout
//   (row k C + c at 48 (k C + c) bytes, conflict-free for decode2), 24 KB
//   at C = 128.
// - Warp specialisation. Warps 0-7 are K3's CTA (kColSplit threads on two
//   pairs, decode2, the packed score), warp 8 the producer: its first lane
//   walks the share's units ahead of the consumers and, at each change of
//   cluster, waits for the ring stage to be empty, arms its full barrier
//   with the stage's bytes and issues the copy. Consecutive units of one
//   cluster are staged once, as in K3. A consumer warp waits on a stage's
//   full barrier when its walk reaches the next cluster and arrives on the
//   empty barrier of the stage it leaves. A ring of `stages` stages (2 to
//   4) keeps up to that many clusters in flight.
//
// Every wait is bounded (tma.cuh) and names its step in the error word; a
// CTA checks the dynamic shared memory it was given.
//
// What bounds it on the H100: K3's work, the fp32 FMA rate (40 FMAs a
// (pair, triangle)).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "tma.cuh"

extern "C" int racc_pair_units(const int* items, int n_items, int n_c, int P,
                               int* ustart, void* stream);

namespace racc {
namespace {

constexpr int kRankShift = 20;
constexpr int kClusterMask = (1 << kRankShift) - 1;
constexpr int kMissBits = 0x7F000000;
constexpr int kUnitPairs = kCtaRays;          // K3's work unit
constexpr int kMbThreads = kCtaThreads + 32;  // K3's CTA and a producer warp
// CTAs an SM should hold: K3's 3, so that the grid and the shares are
// K3's. With the producer warp's 32 threads this caps every thread at 72
// registers (K3: 80) and the consumers spill; at 2 an SM P4 is faster,
// on other shares (PERF.md; tools/probe_pair_dma.py --min-ctas).
constexpr int kMbMinCtas = 3;
constexpr int kMbMaxStages = 4;
constexpr int kSmemAlign = 128;               // a tensor copy's destination

// Bytes of one staged cluster of C (the 48 live bytes of each of its 4C
// rows), the stride of a ring stage, and the dynamic shared memory of a
// ring of S stages (with room to align its start).
__host__ __device__ constexpr int mb_stage_bytes(int C) {
  return 4 * C * kRowF4 * static_cast<int>(sizeof(float4));
}
__host__ __device__ constexpr int mb_stage_stride(int C) {
  return (mb_stage_bytes(C) + kSmemAlign - 1) / kSmemAlign * kSmemAlign;
}
__host__ __device__ constexpr int mb_ring_bytes(int C, int S) {
  return S * mb_stage_stride(C) + kSmemAlign;
}

template <bool Guard>
__global__ void __launch_bounds__(kMbThreads, kMbMinCtas)
pair_hit_mb_kernel(const __grid_constant__ CUtensorMap g3,
                   const float* __restrict__ Fp,
                   const int* __restrict__ items,
                   const int* __restrict__ ustart, int* __restrict__ out,
                   unsigned long long* __restrict__ stats,
                   int* __restrict__ err, int n_items, int C, int col_bits,
                   int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kMbMaxStages];
  __shared__ __align__(8) unsigned long long empty[kMbMaxStages];
  const unsigned stride = mb_stage_stride(C);
  const unsigned pad =
      (kSmemAlign - shared_u32(smem) % kSmemAlign) % kSmemAlign;
  if (dynamic_smem_bytes() < pad + stages * stride) {
    if (threadIdx.x == 0) report_error(err, kErrSmem, blockIdx.x);
    return;
  }
  float4* ring = reinterpret_cast<float4*>(smem + pad);
  const int stage_f4 = stride / sizeof(float4);

  // This CTA's share of the units, as K3's walk_units cuts it.
  const long long total = ustart[n_items];
  const int u0 = static_cast<int>(total * blockIdx.x / gridDim.x);
  const int u1 = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;
  // The item of unit u0: the last whose prefix is at most u0.
  int first = 0;
  for (int hi = n_items; hi - first > 1;) {
    const int mid = (first + hi) >> 1;
    if (ustart[mid] <= u0) first = mid; else hi = mid;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // The producer: one lane walks the share's items (an item's units share
    // its cluster; an item with no unit is passed over, as the consumers'
    // walk passes it) and stages each change of cluster. Staging n goes to
    // stage n % stages once the consumers have left staging n - stages.
    if (lane != 0) return;
    const unsigned bytes = mb_stage_bytes(C);
    int cluster = -1;
    unsigned staged = 0;
    for (int item = first; item < n_items && ustart[item] < u1; ++item) {
      const int cl = items[3 * item + 2];
      if (ustart[item + 1] == ustart[item] || cl == cluster) continue;
      const int s = staged % stages;
      if (staged >= static_cast<unsigned>(stages) &&
          !mbar_wait(&empty[s], (staged / stages - 1) & 1)) {
        report_error(err, kErrWait, -1 - static_cast<int>(staged));
        return;
      }
      mbar_arrive_expect_tx(&full[s], bytes);
      tensor_copy_g2s_3d(ring + s * stage_f4, &g3, 0, 0, 4 * cl, &full[s]);
      cluster = cl;
      ++staged;
    }
    if (stats != nullptr) {
      atomicAdd(stats, static_cast<unsigned long long>(u1 - u0));
      atomicAdd(stats + 1, 1ULL);
      atomicAdd(stats + 2, static_cast<unsigned long long>(staged) * bytes);
    }
    return;
  }

  // The consumers: K3's test of a unit (pair_hit.cu:pair_hit_kernel).
  const int sub = lane % kColSplit, slot = lane / kColSplit;
  const int low = (1 << (col_bits + 3)) - 1;
  auto test = [&](const float4* g, int p0, int p1, int cluster) {
    float f[2][10], tmin[2], tmax[2];
    int p[2], rank_bits[2];
    bool on[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p[i] = p0 + warp * kWarpRays + slot + kWarpPairs * i;
      on[i] = false;
      if (p[i] < p1) {
        const int word = load_ray(Fp, p[i], f[i], tmin[i], tmax[i]);
        on[i] = (word & kClusterMask) == cluster;
        rank_bits[i] = static_cast<int>(static_cast<unsigned>(word) >> kRankShift)
                       << col_bits;
      }
      if (!on[i]) {
#pragma unroll
        for (int q = 0; q < 10; ++q) f[i][q] = 0.0f;
        tmin[i] = tmax[i] = 0.0f;
        rank_bits[i] = 0;
      }
    }
    if (!__any_sync(0xffffffffu, on[0] || on[1])) return;
    int m[2] = {kIntMax, kIntMax};
    if (on[0] || on[1]) {
#pragma unroll 2
      for (int c = sub; c < C; c += kColSplit) {
        bool inside[2];
        float ad[2], ts[2];
        decode2(g, c, C, f, inside, ad, ts);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (inside[i] && ts[i] > ad[i] * tmin[i] &&
              (!Guard || ts[i] < ad[i] * tmax[i])) {
            const float score = ts[i] * __frcp_rn(ad[i]);
            m[i] = min(m[i], (__float_as_int(score) & ~low) | rank_bits[i] | c);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o < kColSplit; o <<= 1)
        m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      if (sub == 0 && on[i]) out[p[i]] = min(m[i], kMissBits);
    }
  };

  // Each warp walks the share's units; segment j (the j-th change of
  // cluster) sits in stage j % stages, its full barrier's phase j / stages.
  int item = first, segment = -1, cluster = -1, stage = 0;
  for (int u = u0; u < u1; ++u) {
    while (ustart[item + 1] <= u) ++item;
    const int p0 = items[3 * item] + (u - ustart[item]) * kUnitPairs;
    const int p1 = min(p0 + kUnitPairs, items[3 * item + 1]);
    const int cl = items[3 * item + 2];
    if (cl != cluster) {
      if (segment >= 0) {
        __syncwarp();  // every lane's reads of the stage it leaves are done
        if (lane == 0) mbar_arrive(&empty[stage]);
      }
      ++segment;
      cluster = cl;
      stage = segment % stages;
      const bool ok = mbar_wait(&full[stage], (segment / stages) & 1);
      if (__any_sync(0xffffffffu, !ok)) {
        if (lane == 0) report_error(err, kErrWait, segment);
        return;
      }
    }
    test(ring + stage * stage_f4, p0, p1, cl);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library links nothing beyond the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The codes racc_pair_hit_mb returns when the tensor map over G3 cannot be
// encoded (the wrapper names the argument): kEncodeArg + the refused
// argument (1 globalAddress, 2 globalDim, 3 globalStrides, 4 boxDim),
// kEncodeEntry (the driver has no cuTensorMapEncodeTiled), kEncodeDriver +
// the driver's CUresult (an argument it refused that the checks passed).
constexpr int kEncodeArg = 10000;
constexpr int kEncodeEntry = 10100;
constexpr int kEncodeDriver = 20000;

int encode_g3(CUtensorMap* map, const float* G3, int n_c, int C) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr) {
      cudaGetLastError();
      return kEncodeEntry;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  // G3 (n_c, 4C, 16) f32 seen as (4 n_c kinds, C rows, 16 floats).
  const cuuint64_t dim[3] = {static_cast<cuuint64_t>(kFeat),
                             static_cast<cuuint64_t>(C),
                             4 * static_cast<cuuint64_t>(n_c)};
  const cuuint64_t strides[2] = {kFeat * sizeof(float),
                                 static_cast<cuuint64_t>(C) * kFeat *
                                     sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(4 * kRowF4),
                             static_cast<cuuint32_t>(C), 4};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (reinterpret_cast<std::uintptr_t>(G3) % 16 != 0) return kEncodeArg + 1;
  for (cuuint64_t d : dim)
    if (d < 1 || d > (1ULL << 32)) return kEncodeArg + 2;
  for (cuuint64_t s : strides)
    if (s % 16 != 0 || s >= (1ULL << 40)) return kEncodeArg + 3;
  for (int i = 0; i < 3; ++i)
    if (box[i] < 1 || box[i] > 256 || box[i] > dim[i]) return kEncodeArg + 4;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(G3), dim,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeDriver + static_cast<int>(r);
}

template <bool Guard>
const void* mb_kernel() {
  return reinterpret_cast<const void*>(pair_hit_mb_kernel<Guard>);
}

// The dynamic shared memory each form of the kernel may take so far.
int allowed[2] = {0, 0};

}  // namespace
}  // namespace racc

// The CTAs of P4 the card holds at once with a ring of `stages` stages for
// clusters of 128 (what the launcher sizes the grid by), or minus a CUDA
// error code.
extern "C" int racc_pair_hit_mb_resident(int guard_tmax, int stages) {
  using namespace racc;
  static int resident[2][kMbMaxStages + 1] = {};
  if (stages < 2 || stages > kMbMaxStages)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int g = guard_tmax ? 1 : 0;
  if (resident[g][stages] > 0) return resident[g][stages];
  const void* kernel = g ? mb_kernel<true>() : mb_kernel<false>();
  const int smem = mb_ring_bytes(kMaxC, stages);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = allow_smem(kernel, smem, allowed[g])) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kMbThreads, smem)) != cudaSuccess)
    return -static_cast<int>(e);
  if (sms * per_sm <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  resident[g][stages] = sms * per_sm;
  return resident[g][stages];
}

// Fp (P, 16) pair rows and G3 (n_c, 4C, 16) as K3 takes them; items
// (n_items, 3) int32 [start, end, cluster]; ustart (n_items + 1,) int32
// scratch (the unit prefix, written here by K3's unit pass); out (P,)
// int32, pre-filled with the miss marker by the caller; err (2,) int32
// zeros (tma.cuh: code, step). stats (nullable, 3 counters) gains the
// units tested, the CTAs that tested any and the bytes staged. `grid`
// CTAs (racc_pair_hit_mb_resident, capped by the units there can be),
// `stages` ring stages (2 to 4). smem 0 gives the kernel its ring for
// clusters of C; another value is used as it is. A tensor map the host
// cannot encode returns a code above 10000 (encode_g3).
extern "C" int racc_pair_hit_mb(const float* Fp, const float* G3,
                                const int* items, int* ustart, int n_items,
                                int* out, unsigned long long* stats, int* err,
                                int P, int n_c, int C, int col_bits,
                                int guard_tmax, int stages, int grid,
                                int smem, void* stream) {
  using namespace racc;
  if (C < 1 || C > kMaxC || P < 0 || n_c < 1 || n_items < 0 || grid < 1 ||
      stages < 2 || stages > kMbMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items == 0 || P == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap map;
  const int code = encode_g3(&map, G3, n_c, C);
  if (code != 0) return code;
  int e = racc_pair_units(items, n_items, n_c, P, ustart, stream);
  if (e != 0) return e;
  const int g = guard_tmax ? 1 : 0;
  const int dyn = smem > 0 ? smem : mb_ring_bytes(C, stages);
  e = allow_smem(g ? mb_kernel<true>() : mb_kernel<false>(), dyn, allowed[g]);
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g)
    pair_hit_mb_kernel<true><<<grid, kMbThreads, dyn, st>>>(
        map, Fp, items, ustart, out, stats, err, n_items, C, col_bits, stages);
  else
    pair_hit_mb_kernel<false><<<grid, kMbThreads, dyn, st>>>(
        map, Fp, items, ustart, out, stats, err, n_items, C, col_bits, stages);
  return static_cast<int>(cudaGetLastError());
}
