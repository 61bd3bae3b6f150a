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
// What bounds it on the H100: instruction rate, and within it the pipe
// that takes compares, minima and maxima, which runs at half the rate of
// the FMA pipe. A (ray, box) pair costs 12 subtractions and products of
// the slab test (none of them an FMA), 12 minima and maxima as the Pallas
// kernel wrote it, and ~12 operations of packing, filtering and counting,
// with no reuse across rays; memory traffic is one 32-byte ray record in
// and (k + 2) words out per ray. The bound prices 24 operations a pair at
// the FMA peak, so the same arithmetic cannot pass about half of it
// (PERF.md).
//
// Design. The Pallas kernel extracted the k nearest by k + 1 masked minimum
// passes over an (n_cp, tile) block; here a thread keeps its k + 1 smallest
// words in registers by insertion, one pass over its boxes. There is no
// approximate arithmetic: -0.0 entries are canonicalised to +0.0 (the sign
// of a zero minimum is otherwise unspecified), so the result equals the
// plain version's bit for bit.
//
// - Boxes lie in shared memory as six float arrays (min x, y, z; max x, y,
//   z), staged by 4-byte cp.async copies (a box is 24 bytes in memory, so
//   no wider copy lands aligned) that run while the CTA classifies its
//   lanes, then put in order (min <= max on each axis: the slab test is
//   symmetric in the two planes of an axis, so this changes no answer).
// - Near and far planes by address, not by arithmetic. With min <= max a
//   ray's near plane on an axis is the min plane when its inverse
//   direction is positive and the max plane otherwise, so
//   min(tn, tf) = (near - o) * inv and max(tn, tf) = (far - o) * inv bit
//   for bit (rounding is monotone; the sign of a zero is canonicalised
//   later). Each ray keeps the six array offsets of its near and far
//   planes and reads them with 4-byte loads: 6 of the 12 minima and
//   maxima of a pair become loads, which run on a pipe that is otherwise
//   idle. The max arrays start 16 banks from the min arrays, so the two
//   addresses a warp may read at once never share a bank.
// - Only overlapped boxes go through the list. A box the ray misses packs
//   0x7F800000 | id, which sorts after every overlapped box; the loop
//   leaves those out, and a lane that overlapped fewer than k + 1 boxes
//   fills its list afterwards with the first boxes it missed (a short
//   second walk from box 0). The previous-spill filter, the count and the
//   list test are one subtraction and two unsigned compares:
//   prev <= w < x  <=>  unsigned(w - prev) < unsigned(x - prev).
// - A CTA first sorts its lanes into three kinds. A lane of a dead tile
//   gets the masked words. A dead lane of a live tile (tmax_eff < tmin) is
//   answered in closed form, see dead_lane_word. Every other lane goes
//   into a compacted list in shared memory, and only the list is tested:
//   threads past its end exit, so dead lanes scattered among live ones
//   cost no loop, and a CTA whose lanes are all dead costs its staging.
// - The boxes of a lane are split across S threads of one warp (thread s
//   takes boxes s, s + S, ...). Each keeps its own sorted k + 1 words and
//   count; the S lists are merged by k + 1 rounds of a warp-segment minimum
//   (redux.sync) in which the thread that holds the minimum pops it. Words
//   are distinct (each carries its box id; 0x7FFFFFFF only fills the
//   tail), so the merged words and the summed count are the ones one
//   thread would find. The launcher picks S from the launch width alone so
//   that a narrow launch still fills the card; at S = 1 (frame width) no
//   merge runs. One ray a thread: with the planes read by address a box
//   read no longer serves two rays, and two rays a thread measured slower
//   (PERF.md).
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

constexpr int kInfBits = 0x7F800000;
constexpr int kSelThreads = 256;
// Boxes whose six planes fit the 227 KB a CTA can have beside the list.
constexpr int kMaxBoxes = 9216;

// One ray of the box loop: its record, the offsets of its near and far
// plane arrays in the staged boxes, its sorted list and its count.
template <int KM>
struct Lane {
  float o[3], inv[3], tmin, tmax;
  int near[3], far[3];   // float offsets of the plane arrays, by axis
  int pv;                // previous spill word
  unsigned lim_cnt;      // unsigned(0x7F800000 - pv): words that count
  unsigned lim_top;      // unsigned(min(top[KM], 0x7F800000) - pv)
  int top[KM + 1], cnt;
};

// The slab test of box c: whether the ray's window overlaps it, and its
// entry distance t0.
template <int KM>
__device__ __forceinline__ bool slab(const float* sb, const Lane<KM>& l, int c,
                                     float& t0) {
  float t1 = l.tmax;
  t0 = l.tmin;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    t0 = fmaxf(t0, (sb[l.near[a] + c] - l.o[a]) * l.inv[a]);
    t1 = fminf(t1, (sb[l.far[a] + c] - l.o[a]) * l.inv[a]);
  }
  return t0 <= t1;
}

// The packed word of an overlapped box: entry bits (a -0.0 or negative
// entry as +0.0) over the box id.
__device__ __forceinline__ int entry_word(float t0, int low, int c) {
  return (__float_as_int(fmaxf(t0, 0.0f) + 0.0f) & ~low) | c;
}

template <int KM>
__device__ __forceinline__ void insert(Lane<KM>& l, int w) {
#pragma unroll
  for (int j = 0; j <= KM; ++j) {
    if (w < l.top[j]) {
      const int tmp = l.top[j];
      l.top[j] = w;
      w = tmp;
    }
  }
}

// Word i of a dead lane's answer. A lane with tmax_eff < tmin (both
// ordered, so neither is a NaN: a NaN window fails the test and goes to the
// loop) overlaps no box, whatever the boxes: the slab test starts from
// t0 = tmin, t1 = tmax and only raises t0 (fmaxf, which never returns a NaN
// when one operand is a number) and lowers t1, so t0 >= tmin > tmax >= t1
// and "t0 <= t1" is false for every box. Box c's word is therefore
// 0x7F800000 | c (the id bits lie below the exponent), replaced by
// 0x7FFFFFFF when below prev, and nothing counts as overlapped. Those words
// rise with c, so the k + 1 smallest are the first k + 1 boxes from
// c0 = max(0, prev - 0x7F800000) on, and 0x7FFFFFFF past the last box.
__device__ __forceinline__ int dead_lane_word(int pv, int n_cp, int i) {
  const int c = (pv <= kInfBits ? 0 : pv - kInfBits) + i;
  return c < n_cp ? (kInfBits | c) : kIntMax;
}

// Float offset of plane array j (0-2 min x, y, z; 3-5 max) for n_pad boxes.
__host__ __device__ constexpr int plane_at(int j, int n_pad) {
  return j * n_pad + (j >= 3 ? 16 : 0);
}

__host__ __device__ constexpr int pad32(int n) { return (n + 31) & ~31; }

// KM: the sorted list holds KM + 1 words (k <= KM); S threads share a
// lane's boxes. A CTA takes kSelThreads / S lanes.
template <int KM, int S>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ F8, const int* __restrict__ prev,
              const unsigned char* __restrict__ live,
              const float* __restrict__ bb, int* __restrict__ out,
              unsigned long long* __restrict__ tested, int R, int n_cp,
              int id_bits, int k) {
  constexpr int kLanes = kSelThreads / S;
  extern __shared__ __align__(16) float sb[];  // six plane arrays
  __shared__ int list[kLanes];
  __shared__ int n_list;
  const int n_pad = pad32(n_cp);
  for (int i = threadIdx.x; i < n_cp * 6; i += kSelThreads) {
    const int c = i / 6;
    cp_async4(sb + plane_at(i - c * 6, n_pad) + c, bb + i);
  }
  cp_async_commit();
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();

  // Classify the CTA's lanes while the boxes land.
  const int lane_id = threadIdx.x & 31;
  const int base = blockIdx.x * kLanes;
  {
    const int r = base + threadIdx.x;
    bool loop = false;
    if (threadIdx.x < kLanes && r < R) {
      if (!live[r]) {
        for (int i = 0; i <= k; ++i)
          out[static_cast<size_t>(i) * R + r] = kIntMax;
        out[static_cast<size_t>(k + 1) * R + r] = 0;
      } else {
        const float2 win =
            *reinterpret_cast<const float2*>(F8 + static_cast<size_t>(r) * 8 + 6);
        if (win.y < win.x) {
          const int pv = prev[r];
          for (int i = 0; i <= k; ++i)
            out[static_cast<size_t>(i) * R + r] = dead_lane_word(pv, n_cp, i);
          out[static_cast<size_t>(k + 1) * R + r] = 0;
        } else {
          loop = true;
        }
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, loop);
    int at = 0;
    if (lane_id == 0 && m != 0) at = atomicAdd(&n_list, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (loop) list[at + __popc(m & ((1u << lane_id) - 1))] = r;
  }
  cp_async_wait<0>();
  __syncthreads();  // the list and every thread's box copies are visible
  const int n = n_list;
  if (n == 0) return;
  for (int i = threadIdx.x; i < n_cp * 3; i += kSelThreads) {
    const int a = i / n_cp, c = i - a * n_cp;
    float& lo = sb[plane_at(a, n_pad) + c];
    float& hi = sb[plane_at(a + 3, n_pad) + c];
    if (lo > hi) {
      const float t = lo;
      lo = hi;
      hi = t;
    }
  }
  __syncthreads();
  if (tested != nullptr && threadIdx.x == 0)
    atomicAdd(tested, static_cast<unsigned long long>(n));

  // Group g (S threads of one warp) takes list entry g.
  const int g = threadIdx.x / S, s = threadIdx.x % S;
  if (g >= n) return;
  const int r = list[g];
  Lane<KM> l;
  {
    const float4* fr =
        reinterpret_cast<const float4*>(F8 + static_cast<size_t>(r) * 8);
    const float4 a = fr[0], b = fr[1];
    l.o[0] = a.x, l.o[1] = a.y, l.o[2] = a.z;
    l.inv[0] = a.w, l.inv[1] = b.x, l.inv[2] = b.y;
    l.tmin = b.z, l.tmax = b.w;
    l.pv = prev[r];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool neg = __float_as_int(l.inv[a]) < 0;
    l.near[a] = plane_at(neg ? a + 3 : a, n_pad);
    l.far[a] = plane_at(neg ? a : a + 3, n_pad);
  }
  l.lim_cnt = l.pv < kInfBits
                  ? static_cast<unsigned>(kInfBits) - static_cast<unsigned>(l.pv)
                  : 0u;
  l.lim_top = l.lim_cnt;
  l.cnt = 0;
#pragma unroll
  for (int j = 0; j <= KM; ++j) l.top[j] = kIntMax;
  const int low = (1 << id_bits) - 1;
#pragma unroll 4
  for (int c = s; c < n_cp; c += S) {
    float t0;
    if (slab(sb, l, c, t0)) {
      const int w = entry_word(t0, low, c);
      const unsigned d = static_cast<unsigned>(w) - static_cast<unsigned>(l.pv);
      l.cnt += d < l.lim_cnt;
      if (d < l.lim_top) {
        insert(l, w);
        l.lim_top = static_cast<unsigned>(min(l.top[KM], kInfBits)) -
                    static_cast<unsigned>(l.pv);
      }
    }
  }
  // A thread that kept fewer than k + 1 overlapped boxes fills its list
  // with the first of its boxes that the ray missed (or entered at
  // infinity) and whose word is not below prev: those words rise with the
  // id and follow every kept word.
  int have = min(l.cnt, KM + 1);
  if (have <= k) {
    int c = l.pv <= kInfBits ? 0 : l.pv - kInfBits;  // first id not below prev
    c += (s - c % S + S) % S;                       // this thread's next box
    for (; c < n_cp && have <= k; c += S) {
      float t0;
      if (slab(sb, l, c, t0) && entry_word(t0, low, c) < kInfBits) continue;
#pragma unroll
      for (int j = 0; j <= KM; ++j)
        if (j == have) l.top[j] = kInfBits | c;
      ++have;
    }
  }
  if (S > 1) {
    // Merge the S sorted lists of the group: each round takes the least
    // head of the group, and the thread that held it pops it.
    const unsigned mask =
        S == 32 ? 0xffffffffu : ((1u << (S & 31)) - 1u) << (lane_id & ~(S - 1));
    int res[KM + 1];
#pragma unroll
    for (int j = 0; j <= KM; ++j) {
      res[j] = __reduce_min_sync(mask, l.top[0]);
      if (l.top[0] == res[j]) {
#pragma unroll
        for (int q = 0; q < KM; ++q) l.top[q] = l.top[q + 1];
        l.top[KM] = kIntMax;
      }
    }
#pragma unroll
    for (int j = 0; j <= KM; ++j) l.top[j] = res[j];
    l.cnt = __reduce_add_sync(mask, l.cnt);
    if (s != 0) return;
  }
#pragma unroll
  for (int j = 0; j <= KM; ++j)
    if (j <= k) out[static_cast<size_t>(j) * R + r] = l.top[j];
  out[static_cast<size_t>(k + 1) * R + r] = l.cnt;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// The threads that share a lane's boxes, from the launch width alone: the
// least power of two that gives the launch about half of the threads the
// card can hold (1024 an SM), 32 at most.
int pick_split(int R) {
  const long long want = 1024LL * sm_count();
  int S = 1;
  while (S < 32 && static_cast<long long>(R) * S < want) S *= 2;
  return S;
}

template <int KM, int S>
int launch(const float* F8, const int* prev, const unsigned char* live,
           const float* bb, int* out, unsigned long long* tested, int R,
           int n_cp, int id_bits, int k, cudaStream_t stream) {
  constexpr int kLanes = kSelThreads / S;
  const int smem = (6 * pad32(n_cp) + 16) * static_cast<int>(sizeof(float));
  auto kernel = select_kernel<KM, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(R + kLanes - 1) / kLanes, kSelThreads, smem, stream>>>(
      F8, prev, live, bb, out, tested, R, n_cp, id_bits, k);
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int launch_split(int S, const float* F8, const int* prev,
                 const unsigned char* live, const float* bb, int* out,
                 unsigned long long* tested, int R, int n_cp, int id_bits,
                 int k, cudaStream_t st) {
  switch (S) {
    case 1: return launch<KM, 1>(F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
    case 2: return launch<KM, 2>(F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
    case 4: return launch<KM, 4>(F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
    case 8: return launch<KM, 8>(F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
    case 16: return launch<KM, 16>(F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
    case 32: return launch<KM, 32>(F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace racc

// The most boxes racc_select_nearest takes (their shared-memory limit).
extern "C" int racc_select_max_boxes() { return racc::kMaxBoxes; }

// The split S the launcher picks for a launch of R lanes.
extern "C" int racc_select_split(int R) { return racc::pick_split(R); }

// F8 (R, 8) rows [o, inv_d, tmin, tmax_eff]; prev (R,) int32 previous
// spill words; live (R,) uint8 lane-of-a-live-tile flags; bb (n_cp, 6);
// out (k + 2, R) int32: k nearest packed words, the spill word, the count.
// tested (nullable) gains the lanes that ran the box loop. split 0 takes
// the launcher's choice; a power of two up to 32 forces it (the card tests
// hold every split against the plain version).
extern "C" int racc_select_nearest(const float* F8, const int* prev,
                                   const unsigned char* live, const float* bb,
                                   int* out, unsigned long long* tested, int R,
                                   int n_cp, int id_bits, int k, int split,
                                   void* stream) {
  using namespace racc;
  if (R < 0 || n_cp < 1 || n_cp > kMaxBoxes || k < 1 || k > 8 ||
      id_bits < 1 || id_bits > 22)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = split == 0 ? pick_split(R) : split;
  // The list length is a compile-time size: the least of 1, 4 and 8 that
  // holds k (a longer sorted list starts with the shorter one).
  if (k == 1)
    return launch_split<1>(S, F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
  if (k <= 4)
    return launch_split<4>(S, F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
  return launch_split<8>(S, F8, prev, live, bb, out, tested, R, n_cp, id_bits, k, st);
}
