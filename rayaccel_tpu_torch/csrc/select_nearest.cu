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
//
// Past one CTA's shared memory (more than kMaxBoxes boxes) a second kernel,
// select_chunks_kernel, streams the boxes through it in chunks of kChunk
// boxes (the scene's ClusterScene.bb_chunks gives each chunk's union box),
// keeping each lane's sorted list and count across chunks. Scenes of
// kMaxBoxes boxes or fewer take select_kernel, the single-chunk path. A
// chunk is 2,048 boxes, 48 KB of planes, so that two to four CTAs share an
// SM. A lane skips a chunk when no box of it can change its answer,
// decided from the union box alone:
//
// - Every box of the chunk lies inside the union box, so for each box the
//   slab test's entry is at least the union's and its exit at most the
//   union's: rounding is monotone, and with o and inv finite and inv
//   nonzero no term is a NaN that one box drops and the union keeps. So a
//   ray that misses the union misses every box, and a box it enters packs
//   a word between (union entry bits & ~low) and (union exit bits | low).
// - The chunk is skipped when the ray misses the union, or when every word
//   it could pack lies below prev (such boxes are neither counted nor
//   kept), or, where the caller does not ask for the count, when the least
//   word it could pack lies above the lane's current (k+1)-th word (such
//   boxes cannot enter the k + 1 words that are output). The first two
//   leave the count exact; the third does not, so the count is then not
//   written. The missed boxes that fill a short list are read from global
//   memory in id order, so a skipped chunk takes none of them away.
// - The decision is one per lane (an OR over its S threads), and a CTA
//   stages a chunk only when some lane of it needs the chunk. The answer is
//   the single-chunk path's bit for bit whatever is skipped.
#include <cuda_runtime.h>

#include "common.cuh"

namespace racc {
namespace {

constexpr int kInfBits = 0x7F800000;
constexpr int kSelThreads = 256;
// Boxes whose six planes fit the 227 KB a CTA can have beside the list: the
// single-chunk path's limit.
constexpr int kMaxBoxes = 9216;
// The most boxes either path takes: the sparse engine's lane word carries
// the cluster in 20 bits (ops/trace_sparse.py: _RANK_SHIFT).
constexpr int kMaxAllBoxes = 1 << 20;
// Boxes a chunk of the multi-chunk path; scene/clusters.py: SELECT_CHUNK
// computes the union boxes for it, and the launch checks their number.
constexpr int kChunk = 2048;
static_assert(kChunk % 32 == 0 && kChunk <= kMaxBoxes, "a chunk's planes");
constexpr float kFloatMax = 3.40282347e38f;

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

// One axis of the slab test on the box planes lo <= hi, by slab's
// arithmetic: the near plane by the sign of inv.
__device__ __forceinline__ void axis_window(float lo, float hi, float o,
                                            float inv, float& t0, float& t1) {
  const bool neg = __float_as_int(inv) < 0;
  t0 = fmaxf(t0, ((neg ? hi : lo) - o) * inv);
  t1 = fminf(t1, ((neg ? lo : hi) - o) * inv);
}

// The slab test's window of box `box` (six floats [min | max], planes in
// order) read from global memory.
template <int KM>
__device__ __forceinline__ void box_window(const float* __restrict__ box,
                                           const Lane<KM>& l, float& t0,
                                           float& t1) {
  t0 = l.tmin;
  t1 = l.tmax;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    axis_window(__ldg(box + a), __ldg(box + 3 + a), l.o[a], l.inv[a], t0, t1);
}

// The slab test of box c read from global memory, its planes put in order
// as the staging puts them: slab's answer bit for bit.
template <int KM>
__device__ __forceinline__ bool slab_global(const float* __restrict__ bb,
                                            const Lane<KM>& l, int c,
                                            float& t0) {
  float t1 = l.tmax;
  t0 = l.tmin;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = __ldg(bb + static_cast<size_t>(c) * 6 + a);
    float hi = __ldg(bb + static_cast<size_t>(c) * 6 + 3 + a);
    if (lo > hi) {
      const float t = lo;
      lo = hi;
      hi = t;
    }
    axis_window(lo, hi, l.o[a], l.inv[a], t0, t1);
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

// Every thread of the CTA: answers the lanes of dead tiles (the masked
// words) and the dead lanes of live tiles (dead_lane_word) of the CTA's
// kLanes lanes from `base` on, and appends every other lane to `list`.
template <int kLanes>
__device__ __forceinline__ void classify(
    const float* __restrict__ F8, const int* __restrict__ prev,
    const unsigned char* __restrict__ live, int* __restrict__ out, int R,
    int n_cp, int k, int base, int* list, int* n_list) {
  const int lane_id = threadIdx.x & 31;
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
  if (lane_id == 0 && m != 0) at = atomicAdd(n_list, __popc(m));
  at = __shfl_sync(0xffffffffu, at, 0);
  if (loop) list[at + __popc(m & ((1u << lane_id) - 1))] = r;
}

// Lane r's record, its plane offsets for n_pad staged boxes, an empty list.
template <int KM>
__device__ __forceinline__ void load_lane(Lane<KM>& l,
                                          const float* __restrict__ F8,
                                          const int* __restrict__ prev, int r,
                                          int n_pad) {
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
}

// The box loop over the staged boxes c0, c0 + S, ... below n (staged box c
// is box id_base + c).
template <int KM, int S>
__device__ __forceinline__ void test_boxes(Lane<KM>& l, const float* sb,
                                           int c0, int n, int id_base,
                                           int low) {
#pragma unroll 4
  for (int c = c0; c < n; c += S) {
    float t0;
    if (slab(sb, l, c, t0)) {
      const int w = entry_word(t0, low, id_base + c);
      const unsigned d = static_cast<unsigned>(w) - static_cast<unsigned>(l.pv);
      l.cnt += d < l.lim_cnt;
      if (d < l.lim_top) {
        insert(l, w);
        l.lim_top = static_cast<unsigned>(min(l.top[KM], kInfBits)) -
                    static_cast<unsigned>(l.pv);
      }
    }
  }
}

// A thread that kept fewer than k + 1 overlapped boxes fills its list
// with the first of its boxes (ids s, s + S, ...) that the ray missed (or
// entered at infinity) and whose word is not below prev: those words rise
// with the id and follow every kept word. The boxes are the staged ones
// (all of them), or with kGlobal those of bb in global memory.
template <int KM, int S, bool kGlobal>
__device__ __forceinline__ void fill_missed(Lane<KM>& l, int k, int n_cp,
                                            int s, int low,
                                            const float* boxes) {
  int have = min(l.cnt, KM + 1);
  if (have <= k) {
    int c = l.pv <= kInfBits ? 0 : l.pv - kInfBits;  // first id not below prev
    c += (s - c % S + S) % S;                       // this thread's next box
    for (; c < n_cp && have <= k; c += S) {
      float t0;
      bool hit;
      if constexpr (kGlobal)
        hit = slab_global(boxes, l, c, t0);
      else
        hit = slab(boxes, l, c, t0);
      if (hit && entry_word(t0, low, c) < kInfBits) continue;
#pragma unroll
      for (int j = 0; j <= KM; ++j)
        if (j == have) l.top[j] = kInfBits | c;
      ++have;
    }
  }
}

// Merges the S sorted lists of a lane's group (each round takes the least
// head of the group, and the thread that held it pops it) and stores the
// k + 1 words, and the count where `count`.
template <int KM, int S>
__device__ __forceinline__ void store_lane(Lane<KM>& l, int* __restrict__ out,
                                           int R, int r, int k, int s,
                                           bool count) {
  if (S > 1) {
    const int lane_id = threadIdx.x & 31;
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
  if (count) out[static_cast<size_t>(k + 1) * R + r] = l.cnt;
}

// KM: the sorted list holds KM + 1 words (k <= KM); S threads share a
// lane's boxes. A CTA takes kSelThreads / S lanes. The single-chunk path:
// every box staged once.
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
  classify<kLanes>(F8, prev, live, out, R, n_cp, k, blockIdx.x * kLanes, list,
                   &n_list);
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
  load_lane(l, F8, prev, r, n_pad);
  const int low = (1 << id_bits) - 1;
  test_boxes<KM, S>(l, sb, s, n_cp, 0, low);
  fill_missed<KM, S, false>(l, k, n_cp, s, low, sb);
  store_lane<KM, S>(l, out, R, r, k, s, true);
}

// The multi-chunk path (more than kMaxBoxes boxes): the boxes pass through
// shared memory kChunk at a time, ub (n_chunks, 6) holding each chunk's
// union box (planes in order). tested gains one for each (lane, chunk) the
// lane tested; `count` 0 lets a lane skip a chunk past its (k+1)-th word
// and leaves the count row unwritten.
template <int KM, int S>
__global__ void __launch_bounds__(kSelThreads)
select_chunks_kernel(const float* __restrict__ F8,
                     const int* __restrict__ prev,
                     const unsigned char* __restrict__ live,
                     const float* __restrict__ bb,
                     const float* __restrict__ ub, int* __restrict__ out,
                     unsigned long long* __restrict__ tested, int R, int n_cp,
                     int id_bits, int k, int count) {
  constexpr int kLanes = kSelThreads / S;
  extern __shared__ __align__(16) float sb[];  // six plane arrays, a chunk
  __shared__ int list[kLanes];
  __shared__ int n_list;
  constexpr int n_pad = pad32(kChunk);
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();
  classify<kLanes>(F8, prev, live, out, R, n_cp, k, blockIdx.x * kLanes, list,
                   &n_list);
  __syncthreads();
  const int n = n_list;
  if (n == 0) return;

  // Every thread stays to the end of the chunk loop, which has barriers;
  // a thread past the list holds a copy of the first lane and tests
  // nothing.
  const int g = threadIdx.x / S, s = threadIdx.x % S;
  const bool mine = g < n;
  const int r = list[mine ? g : 0];
  Lane<KM> l;
  load_lane(l, F8, prev, r, n_pad);
  const int low = (1 << id_bits) - 1;
  bool sure = true;  // no slab term can be a NaN that one box drops
#pragma unroll
  for (int a = 0; a < 3; ++a)
    sure = sure && fabsf(l.o[a]) <= kFloatMax && fabsf(l.inv[a]) <= kFloatMax &&
           l.inv[a] != 0.0f;
  const int lane_id = threadIdx.x & 31;
  const unsigned seg =
      S == 32 ? 0xffffffffu : ((1u << (S & 31)) - 1u) << (lane_id & ~(S - 1));
  unsigned long long lane_chunks = 0;
  const int n_chunks = (n_cp + kChunk - 1) / kChunk;
  for (int q = 0; q < n_chunks; ++q) {
    bool need = mine;
    if (mine && sure) {
      float t0, t1;
      box_window(ub + 6 * q, l, t0, t1);
      if (t0 == t0 && t1 == t1) {
        const int first = __float_as_int(fmaxf(t0, 0.0f) + 0.0f) & ~low;
        const int last = (__float_as_int(fmaxf(t1, 0.0f) + 0.0f) & ~low) | low;
        int kth = l.top[0];
#pragma unroll
        for (int j = 1; j <= KM; ++j)
          if (j == k) kth = l.top[j];
        need = !(t0 > t1 || last < l.pv || (!count && first > kth));
      }
    }
    if (S > 1) need = __reduce_or_sync(seg, need ? 1u : 0u) != 0u;
    const int lanes = __syncthreads_count(need && s == 0);
    if (lanes == 0) continue;
    lane_chunks += lanes;
    const int c_lo = q * kChunk, nb = min(kChunk, n_cp - c_lo);
    const float* src = bb + static_cast<size_t>(c_lo) * 6;
    for (int i = threadIdx.x; i < nb * 6; i += kSelThreads) {
      const int c = i / 6;
      cp_async4(sb + plane_at(i - c * 6, n_pad) + c, src + i);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < nb * 3; i += kSelThreads) {
      const int a = i / nb, c = i - a * nb;
      float& lo = sb[plane_at(a, n_pad) + c];
      float& hi = sb[plane_at(a + 3, n_pad) + c];
      if (lo > hi) {
        const float t = lo;
        lo = hi;
        hi = t;
      }
    }
    __syncthreads();
    if (need) test_boxes<KM, S>(l, sb, s, nb, c_lo, low);
  }
  if (tested != nullptr && threadIdx.x == 0 && lane_chunks != 0)
    atomicAdd(tested, lane_chunks);
  if (!mine) return;  // whole groups: g is the same on a group's threads
  fill_missed<KM, S, true>(l, k, n_cp, s, low, bb);
  store_lane<KM, S>(l, out, R, r, k, s, count != 0);
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

// A launch's arguments (racc_select_nearest's).
struct Args {
  const float* F8;
  const int* prev;
  const unsigned char* live;
  const float* bb;
  const float* ub;
  int* out;
  unsigned long long* tested;
  int R, n_cp, id_bits, k, count;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int KM, int S>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kLanes = kSelThreads / S;
  const bool one = a.n_cp <= kMaxBoxes;
  const int smem =
      (6 * pad32(one ? a.n_cp : kChunk) + 16) * static_cast<int>(sizeof(float));
  const int grid = (a.R + kLanes - 1) / kLanes;
  cudaError_t e;
  if (one) {
    auto kernel = select_kernel<KM, S>;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kSelThreads, smem, stream>>>(
        a.F8, a.prev, a.live, a.bb, a.out, a.tested, a.R, a.n_cp, a.id_bits,
        a.k);
  } else {
    auto kernel = select_chunks_kernel<KM, S>;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kSelThreads, smem, stream>>>(
        a.F8, a.prev, a.live, a.bb, a.ub, a.out, a.tested, a.R, a.n_cp,
        a.id_bits, a.k, a.count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KM>
int launch_split(int S, const Args& a, cudaStream_t st) {
  switch (S) {
    case 1: return launch<KM, 1>(a, st);
    case 2: return launch<KM, 2>(a, st);
    case 4: return launch<KM, 4>(a, st);
    case 8: return launch<KM, 8>(a, st);
    case 16: return launch<KM, 16>(a, st);
    case 32: return launch<KM, 32>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace racc

// The most boxes racc_select_nearest takes.
extern "C" int racc_select_max_boxes() { return racc::kMaxAllBoxes; }

// The union boxes (ub) a launch on n_cp boxes reads: none on the
// single-chunk path (kMaxBoxes boxes or fewer), else one a chunk of kChunk.
extern "C" int racc_select_chunks(int n_cp) {
  return n_cp <= racc::kMaxBoxes ? 0 : (n_cp + racc::kChunk - 1) / racc::kChunk;
}

// The split S the launcher picks for a launch of R lanes.
extern "C" int racc_select_split(int R) { return racc::pick_split(R); }

// F8 (R, 8) rows [o, inv_d, tmin, tmax_eff]; prev (R,) int32 previous
// spill words; live (R,) uint8 lane-of-a-live-tile flags; bb (n_cp, 6);
// out (k + 2, R) int32: k nearest packed words, the spill word, the count.
// Past kMaxBoxes boxes, ub (racc_select_chunks(n_cp), 6) holds the union
// box of each run of kChunk boxes, planes in order, and `count` 0 leaves
// the count row unwritten (so that a lane may skip boxes past its (k+1)-th
// word); fewer boxes take neither. tested (nullable) gains, for each lane
// that ran the box loop, the chunks it tested (one on the single-chunk
// path). split 0 takes the launcher's choice; a power of two up to 32
// forces it (the card tests hold every split against the plain version).
extern "C" int racc_select_nearest(const float* F8, const int* prev,
                                   const unsigned char* live, const float* bb,
                                   const float* ub, int* out,
                                   unsigned long long* tested, int R,
                                   int n_cp, int id_bits, int k, int split,
                                   int count, void* stream) {
  using namespace racc;
  if (R < 0 || n_cp < 1 || n_cp > kMaxAllBoxes || k < 1 || k > 8 ||
      id_bits < 1 || id_bits > 22 || n_cp > (1 << id_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cp > kMaxBoxes && ub == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = split == 0 ? pick_split(R) : split;
  const Args a{F8, prev, live, bb, ub, out, tested, R, n_cp, id_bits, k,
               count};
  // The list length is a compile-time size: the least of 1, 4 and 8 that
  // holds k (a longer sorted list starts with the shorter one).
  if (k == 1) return launch_split<1>(S, a, st);
  if (k <= 4) return launch_split<4>(S, a, st);
  return launch_split<8>(S, a, st);
}
