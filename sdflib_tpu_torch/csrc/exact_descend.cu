// K8 (exact_descend), the leaf sort (leaf_sort) and K9
// (exact_sorted_gather): the exact query's key, its stable sort by leaf
// and its gathers of the sorted order.
//
// None replaces a TPU kernel: no pl.pallas_call lies behind them. The
// JAX package compiles its whole exact query as one XLA program
// (sdflib_tpu/sdf/exact_octree.py _exact_query_fused), in which XLA fuses
// these steps; eager torch ran them as ~10 and ~7 launches a query.
//
// K8 replaces _exact_descent_grid (sdflib_tpu/sdf/exact_octree.py:567-581):
// a point's finest cell on the dense leaf grid, (rel * g) truncated to
// int32 and clamped to [0, g - 1] as ops/exact_query.py
// exact_descend_plain computes it (rel = (p - box_min) / box_size3, an
// IEEE division; the float-to-int conversion saturates and takes NaN to
// 0, as torch's does), and the leaf id the grid holds there, as an int32
// sort key. leaf_key below is that arithmetic; K8 and the leaf sort both
// call it, so both compute the same key.
//
// The leaf sort replaces K8 followed by a stable torch.sort of its keys
// (the JAX package's multi-operand lax.sort, :934-941): the sorted keys
// lid_s (int32) and the order (int64), equal to torch.sort(keys,
// stable=True). The keys are leaf ids below L, so it is a stable LSD radix
// sort over only their bits = max(1, bit_length(L - 1)), in the fewest
// digits of at most 8 bits, as even as can be (three passes of 6 bits at
// depth 6, of 7 at depth 7, two of 6 for K11's 12 bits), so that with 256
// threads a block each thread owns one digit's bin: the tile's count, its
// scan, its status word and its look-back are one word a thread. One call
// is a memset of the look-back state and:
//  * the key launch (K8 fused with the upsweep): a block stages 2,048
//    points with 16-byte loads through shared memory, computes and writes
//    each key, and counts every pass's digits in shared memory, then with
//    atomics into one table in L2 (integer counts: the same every run).
//    The last block to finish turns each pass's counts into its digits'
//    first places. With keys given (the node walk's) it only counts them.
//  * one launch a digit pass ("onesweep", with CUB's early counts): a
//    block takes its tile of 4,096 keys from an atomic counter, never from
//    blockIdx, so a tile that spins on an earlier one never waits on a
//    block not yet scheduled. It copies the tile into shared memory with
//    16-byte loads, counts its digits (a shared atomic a key) and
//    publishes the counts at once (one status word a tile and digit: a
//    2-bit flag, aggregate or inclusive prefix, over a 30-bit count), so
//    the look-back of a later tile moves at the speed of counting, not of
//    ranking. Then each warp ranks its 512 keys in index order (the lanes
//    of a step that share a digit found by one __ballot_sync a bit, and
//    popcounts over a per-warp count of each digit), and the tile finds
//    the counts of all earlier tiles by decoupled look-back (CUB's order),
//    its first read issued before the ranking. A prefix over the warps in
//    order gives the rank in the tile: the sort is stable. The tile goes
//    out from shared memory in sorted order, so a digit's run leaves as
//    consecutive stores. The first pass's value is the index (int32); the
//    last pass writes lid_s and the order as int64, the types K9 and K7
//    read. Three blocks an SM.
// Measured on an H100 (PERF.md; tools/leaf_sort_ab.py): the digits
// matched with __match_any_sync, the early counts by one atomic a warp's
// digit, two blocks an SM, the look-back before the ranking and tiles of
// 2,048, 3,072 and 5,120 keys were each slower.
// Nothing is read back to the host. Bound: bytes; the design moves 64 B a
// point in three passes (12 B of point and a 4 B key; 4 B in and 8 B out
// twice; 8 B in, 4 + 8 B out).
//
// K9 replaces the gathers of the sorted order (the multi-operand lax.sort
// carries the coordinates, :934-941) and of each sorted point's bucket
// bounds (:982-983): pts_s[i] = points[order[i]] and, for the window scan
// and the id-only tier, (b0[i], nc[i]) = bounds[lid_s[i]], the leaf's
// first bucket row and row count from the structure's packed (L, 2)
// table, zero from P up to the padded size.
//
// Bound: bytes. K8 reads 12 B of point and a 4 B grid word and writes a
// 4 B key (20 B a point: 0.0125 ms at 2^21 points on an H100); K9 reads
// 8 B of order, a point's 12 B at a random place, 4 B of key and 8 B of
// the touched leaves' bounds, and writes 12 + 8 B. The grid (2 MiB at
// depth 6, 8 MiB at depth 7) and the leaves' bounds stay in the 50 MB L2.
// Both are one thread a point. K9's cost is its random gathers: the points
// a sorted warp reads lie anywhere in the batch, and memory serves each
// 12-byte point as a whole sector. More points a thread (2, 4 or 8, every
// gather issued before the first store) measured slower on an H100
// (PERF.md): the gathers are not waiting on latency. What helped: the
// order and keys, read once, loaded evict-first and not kept in L1
// (cache_hints.cuh), which leaves L2 to the points: 5-6% at d6 2^21,
// nothing at d7. A leaf's bounds are one 8-byte load from the packed
// table (~22 sorted points share a leaf at d6 2^21, so a warp's read is
// mostly a broadcast); alone, that measured within 2% of the two 4-byte
// reads.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "cache_hints.cuh"

namespace {

constexpr int kThreads = 256;

// The box as values: its low corner and its size on each axis.
struct Box {
  float lo[3];
  float size[3];
};

// The leaf id the dense grid (2^depth cells an axis, z-major) holds at a
// point's cell: exact_descend_plain's arithmetic.
__device__ __forceinline__ int leaf_key(float x, float y, float z, const int* __restrict__ grid,
                                        int depth, const Box& box) {
  const int g = 1 << depth;
  const float gf = static_cast<float>(g);
  const float p[3] = {x, y, z};
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rel = (p[a] - box.lo[a]) / box.size[a];
    const int t = __float2int_rz(rel * gf);
    c[a] = min(max(t, 0), g - 1);
  }
  return grid[(c[2] * g + c[1]) * g + c[0]];
}

__global__ void exact_descend_kernel(const float* __restrict__ points, int P,
                                     const int* __restrict__ grid, int depth,
                                     const float* __restrict__ box_min,
                                     const float* __restrict__ box_size3,
                                     int* __restrict__ key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const Box box = {{box_min[0], box_min[1], box_min[2]},
                   {box_size3[0], box_size3[1], box_size3[2]}};
  key[i] = leaf_key(points[3 * i], points[3 * i + 1], points[3 * i + 2], grid, depth, box);
}

__global__ void __launch_bounds__(kThreads)
    exact_sorted_gather_kernel(const float* __restrict__ points,
                               const long long* __restrict__ order, int P,
                               const int* __restrict__ lid_s, const int2* __restrict__ bounds,
                               int size, float* __restrict__ pts_s, int* __restrict__ b0,
                               int* __restrict__ nc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  int2 bd = make_int2(0, 0);
  if (i < P) {
    const unsigned long long once = hint::evict_first();
    const long long j = hint::load(order + i, once);
    if (bounds != nullptr) bd = __ldg(bounds + hint::load(lid_s + i, once));
    x = __ldg(points + 3 * j);
    y = __ldg(points + 3 * j + 1);
    z = __ldg(points + 3 * j + 2);
  }
  pts_s[3 * i] = x;
  pts_s[3 * i + 1] = y;
  pts_s[3 * i + 2] = z;
  if (bounds != nullptr) {
    b0[i] = bd.x;
    nc[i] = bd.y;
  }
}

// -- the leaf sort ------------------------------------------------------------

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;                          // keys a thread in a pass
constexpr int kSortTile = kSortThreads * kSortItems;    // keys a tile: 4,096
constexpr int kWarpKeys = 32 * kSortItems;              // keys a warp ranks
constexpr int kKeyPoints = 2048;                        // points a step of the key launch
constexpr int kMaxDigit = 8;
constexpr int kRadix = 1 << kMaxDigit;                  // a bin a thread
constexpr int kMaxPasses = 4;                           // 31 bits: 8 + 8 + 8 + 7
// every pass's bins side by side
constexpr int kHistBins = kMaxPasses * kRadix;
// the state's words before the look-back status: the bins, the key
// launch's ticket, a tile counter a pass (a multiple of 4: the buffers
// after the state stay 16-byte aligned)
constexpr int kStateHead = kHistBins + 1 + kMaxPasses + 3;
constexpr unsigned kCountMask = (1u << 30) - 1;
constexpr unsigned kFlagAggregate = 1u << 30;           // the tile's own count
constexpr unsigned kFlagPrefix = 2u << 30;              // the count of it and every earlier tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRadix == kSortThreads, "a digit's bin a thread");
static_assert(kStateHead % 4 == 0 && kSortTile % 4 == 0, "16-byte aligned buffers and tiles");

// tools/leaf_sort_ab.py's "phases" variant defines these to record the
// global timer at each step of a tile; they are empty otherwise.
#ifndef SORT_STAMP
#define SORT_STAMP(step)
#define SORT_STAMPS_OUT()
#endif

// The digits of a sort over ``bits`` bits, least significant first: the
// fewest passes of at most kMaxDigit bits, as even as can be (the first
// ones one bit wider); ops/exact_query.py _digit_plan is the same rule.
struct Plan {
  int passes;
  int shift[kMaxPasses];
  int width[kMaxPasses];
  int off[kMaxPasses];      // the pass's first bin in the table
  int bins;                 // every pass's bins
};

Plan digit_plan(int bits) {
  Plan plan = {};
  plan.passes = (bits + kMaxDigit - 1) / kMaxDigit;
  const int base = bits / plan.passes, extra = bits % plan.passes;
  for (int p = 0, shift = 0; p < plan.passes; ++p) {
    plan.width[p] = base + (p < extra ? 1 : 0);
    plan.shift[p] = shift;
    plan.off[p] = plan.bins;
    shift += plan.width[p];
    plan.bins += 1 << plan.width[p];
  }
  return plan;
}

__device__ __forceinline__ int digit_of(int key, int shift, int width) {
  return static_cast<int>((static_cast<unsigned>(key) >> shift) & ((1u << width) - 1));
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* a) {
  return *reinterpret_cast<const volatile unsigned*>(a);
}

__device__ __forceinline__ void store_volatile(unsigned* a, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(a) = v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The lanes of the warp whose d equals this lane's, d in [0, 2^(width + 1)):
// one ballot a bit. __match_any_sync's time grows with the distinct values
// in the warp (up to 32 of a step's keys here) and measured slower.
__device__ __forceinline__ unsigned lanes_alike(int d, int width) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b <= kMaxDigit; ++b) {
    if (b > width) break;
    const bool bit = (d >> b) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    m &= bit ? set : ~set;
  }
  return m;
}

// A look-back that has waited this long on an earlier tile (which holds a
// running block: it took its index first) traps instead of hanging.
constexpr unsigned long long kSpinLimitNs = 2000000000ull;

// The exclusive prefix sum over the block's threads of v, in thread order
// (every thread of the block calls it; warp_sum is kSortWarps words of
// shared memory, free again when it returns).
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned pre = incl - v;
  for (int w = 0; w < warp; ++w) pre += warp_sum[w];
  __syncthreads();
  return pre;
}

// The key launch: keys (from the points, or given) and every pass's digit
// counts; the last block turns the counts into each digit's first place.
template <bool kPoints, bool kVector>
__global__ void __launch_bounds__(kSortThreads)
    leaf_sort_keys_kernel(const float* __restrict__ points, const int* __restrict__ keys_in,
                          int P, const int* __restrict__ grid, int depth, Box box, Plan plan,
                          int* __restrict__ keys_out, unsigned* __restrict__ state) {
  __shared__ float4 staged4[kKeyPoints * 3 / 4];
  __shared__ unsigned count[kHistBins];
  __shared__ unsigned warp_sum[kSortWarps];
  __shared__ bool last;
  float* staged = reinterpret_cast<float*>(staged4);
  for (int i = threadIdx.x; i < plan.bins; i += kSortThreads) count[i] = 0;
  __syncthreads();
  const int steps = (P + kKeyPoints - 1) / kKeyPoints;
  for (int step = blockIdx.x; step < steps; step += gridDim.x) {
    const int base = step * kKeyPoints;
    const int n = min(kKeyPoints, P - base);
    if (kPoints) {
      const float* src = points + 3ll * base;
      const int nf = 3 * n, n4 = kVector ? nf / 4 : 0;
      for (int i = threadIdx.x; i < n4; i += kSortThreads)
        staged4[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
      for (int i = 4 * n4 + threadIdx.x; i < nf; i += kSortThreads) staged[i] = __ldg(src + i);
      __syncthreads();
    }
    for (int j = threadIdx.x; j < n; j += kSortThreads) {
      int key;
      if (kPoints) {
        key = leaf_key(staged[3 * j], staged[3 * j + 1], staged[3 * j + 2], grid, depth, box);
        keys_out[base + j] = key;
      } else {
        key = __ldg(keys_in + base + j);
      }
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p)
        if (p < plan.passes)
          atomicAdd(&count[plan.off[p] + digit_of(key, plan.shift[p], plan.width[p])], 1u);
    }
    if (kPoints) __syncthreads();       // before the next step's points overwrite these
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plan.bins; i += kSortThreads)
    if (count[i] != 0) atomicAdd(state + i, count[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(state + kHistBins, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // every block's counts are in: each pass's exclusive sums over its digits,
  // a digit a thread
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p >= plan.passes) break;
    const int d = threadIdx.x, R = 1 << plan.width[p];
    const unsigned c = d < R ? __ldcg(state + plan.off[p] + d) : 0u;
    const unsigned first = block_exclusive_scan(c, warp_sum);
    if (d < R) state[plan.off[p] + d] = first;
  }
}

// A digit pass's shared memory: the tile's keys and values in index order
// as loaded, then in sorted order.
struct __align__(16) PassTile {
  int key[kSortTile];
  int val[kSortTile];
};

// Copy n ints from global src (16-byte aligned when vec) to shared dst,
// read once: 16-byte loads, all issued before the first store.
__device__ __forceinline__ void load_tile(const int* __restrict__ src, int n, bool vec,
                                          int* dst) {
  if (vec && n == kSortTile) {
    constexpr int kVecs = kSortTile / 4 / kSortThreads;
    int4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      v[j] = __ldcs(reinterpret_cast<const int4*>(src) + threadIdx.x + j * kSortThreads);
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      reinterpret_cast<int4*>(dst)[threadIdx.x + j * kSortThreads] = v[j];
  } else {
    for (int i = threadIdx.x; i < n; i += kSortThreads) dst[i] = __ldcs(src + i);
  }
}

// One digit pass over the keys (and values; none: the index) into the
// outputs (values as int32, or as int64 into order on the last pass).
// Three blocks an SM: a 2^21-key pass's 512 tiles in one wave.
__global__ void __launch_bounds__(kSortThreads, 3)
    leaf_sort_pass_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in, int P,
                          int shift, int width, const unsigned* __restrict__ first,
                          unsigned* tile_counter, unsigned* status, int* __restrict__ keys_out,
                          int* __restrict__ vals_out, long long* __restrict__ order_out) {
  __shared__ PassTile sm;
  __shared__ unsigned hist[kRadix];                       // the tile's count of each digit
  __shared__ __align__(16) unsigned short warp_count[kSortWarps][kRadix];
  __shared__ unsigned place[kRadix];
  __shared__ unsigned warp_sum[kSortWarps];
  __shared__ int tile_index;
  SORT_STAMP(0);
  const int R = 1 << width;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_index = static_cast<int>(atomicAdd(tile_counter, 1u));
  hist[t] = 0;
  reinterpret_cast<uint4*>(&warp_count[0][0])[t] = make_uint4(0, 0, 0, 0);
  static_assert(sizeof(warp_count) == kSortThreads * sizeof(uint4), "a uint4 a thread");
  __syncthreads();
  const int tile = tile_index;
  SORT_STAMP(1);
  const int base = tile * kSortTile;
  const int n = min(kSortTile, P - base);
  // the tile in index order: keys_in, vals_in and every buffer the call
  // made start 16-byte aligned, given keys may not
  const bool vec = (reinterpret_cast<uintptr_t>(keys_in) & 15) == 0;
  load_tile(keys_in + base, n, vec, sm.key);
  if (vals_in != nullptr) load_tile(vals_in + base, n, true, sm.val);
  __syncthreads();
  // warp w ranks the tile's keys [kWarpKeys w, kWarpKeys (w + 1)): item k
  // of lane l is key kWarpKeys w + 32 k + l, so (k, lane) is index order
  const int first_i = warp * kWarpKeys + lane;
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = first_i + 32 * k;
    key[k] = i < n ? sm.key[i] : 0;
    val[k] = vals_in == nullptr ? base + i : (i < n ? sm.val[i] : 0);
  }
  // the early counts: one shared atomic a key (a warp's lanes of one digit
  // matched first and counted once measured slower, PERF.md)
#pragma unroll
  for (int k = 0; k < kSortItems; ++k)
    if (first_i + 32 * k < n) atomicAdd(&hist[digit_of(key[k], shift, width)], 1u);
  __syncthreads();
  // publish the tile's counts before ranking: a later tile's look-back
  // reads them while this one ranks
  const unsigned mine = t < R ? hist[t] : 0u;
  unsigned* own = status + static_cast<size_t>(tile) * R + t;
  unsigned word = 0;
  if (t < R) {
    store_volatile(own, (tile == 0 ? kFlagPrefix : kFlagAggregate) | mine);
    if (tile > 0) word = load_volatile(own - R);      // the first look-back read, in flight
  }
  SORT_STAMP(2);
  // decoupled look-back over the earlier tiles' counts of digit t
  unsigned before = 0;
  auto look_back = [&]() {
    if (tile == 0 || t >= R) return;
    const unsigned* at = own - R;
    unsigned long long spin_start = 0;
    for (;;) {
      const unsigned flag = word & ~kCountMask;
      if (flag == 0) {                                  // not published yet: again
        const unsigned long long now = global_ns();
        if (spin_start == 0) spin_start = now;
        else if (now - spin_start > kSpinLimitNs) __trap();
        word = load_volatile(at);
        continue;
      }
      before += word & kCountMask;
      if (flag == kFlagPrefix) break;
      at -= R;
      word = load_volatile(at);
    }
    store_volatile(own, kFlagPrefix | (before + mine));
  };
  // rank: each warp in index order (the lanes of a step that share a digit
  // found by ballots), a per-warp running count of each digit
  const unsigned below = (1u << lane) - 1;
  auto rank_keys = [&]() {
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const bool live = first_i + 32 * k < n;
      const int d = live ? digit_of(key[k], shift, width) : R;      // R: no key
      const unsigned mask = lanes_alike(d, width);
      const int leader = __ffs(mask) - 1;
      unsigned seen = 0;
      if (live && lane == leader) {
        seen = warp_count[warp][d];
        warp_count[warp][d] = static_cast<unsigned short>(seen + __popc(mask));
      }
      rank[k] = static_cast<int>(__shfl_sync(kFull, seen, leader) + __popc(mask & below));
      __syncwarp();
    }
  };
  rank_keys();
  SORT_STAMP(3);
  look_back();
  SORT_STAMP(4);
  // each digit's first place in the tile, then each warp's among its keys
  const unsigned tile_first = block_exclusive_scan(mine, warp_sum);
  if (t < R) {
    unsigned sum = tile_first;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const unsigned c = warp_count[w][t];
      warp_count[w][t] = static_cast<unsigned short>(sum);
      sum += c;
    }
    // the output place of the tile's sorted position 0 for digit t
    place[t] = first[t] + before - tile_first;
  }
  __syncthreads();
  // the tile in sorted order, over the keys as loaded (every thread has
  // read its own: the barriers above)
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (first_i + 32 * k < n) {
      const int at = rank[k] + warp_count[warp][digit_of(key[k], shift, width)];
      sm.key[at] = key[k];
      sm.val[at] = val[k];
    }
  }
  __syncthreads();
  for (int i = t; i < n; i += kSortThreads) {
    const int k = sm.key[i];
    const unsigned at = place[digit_of(k, shift, width)] + i;
    keys_out[at] = k;
    if (order_out != nullptr) order_out[at] = sm.val[i];
    else vals_out[at] = sm.val[i];
  }
  SORT_STAMP(5);
  SORT_STAMPS_OUT();
}

}  // namespace

// points (P, 3); grid (8^depth,) int32 leaf ids, z-major, depth 0..10;
// key (P,) int32. A depth out of range returns cudaErrorInvalidValue.
extern "C" int sdf_exact_descend(const float* points, int P, const int* grid, int depth,
                                 const float* box_min, const float* box_size3, int* key,
                                 void* stream) {
  if (depth < 0 || depth > 10) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    exact_descend_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(points, P, grid, depth,
                                                                box_min, box_size3, key);
  }
  return static_cast<int>(cudaGetLastError());
}

// points (P, 3); order (P,) int64; lid_s (P,) int32 and bounds (L, 2)
// int32 {first row, row count} a leaf, with b0 and nc, all null (the
// grouped scan) or all given; pts_s (size, 3), b0 and nc (size,). size <
// P or P < 0 returns cudaErrorInvalidValue.
extern "C" int sdf_exact_sorted_gather(const float* points, const long long* order, int P,
                                       const int* lid_s, const int* bounds, int size,
                                       float* pts_s, int* b0, int* nc, void* stream) {
  if (size < P || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (size > 0) {
    exact_sorted_gather_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        points, order, P, lid_s, reinterpret_cast<const int2*>(bounds), size, pts_s, b0, nc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The leaf sort: lid_s (P,) int32 and order (P,) int64 equal to
// torch.sort(keys, stable=True), the keys computed from points (P, 3) on
// the grid (8^depth,) int32 as K8 computes them (depth 0..10, the box by
// value), or given as keys (P,) int32 (points null). Every key must lie
// in [0, 2^bits), bits 1..31. sms: the card's SMs (the key launch's
// grid). work: int32 scratch of work_words, 16-byte aligned, at least
// ops/exact_query.py _sort_words: the look-back state (zeroed here), the
// keys when computed, and a key and a value buffer for each of the first
// two passes but the last, each buffer P rounded up to a multiple of 4.
// Anything out of range returns cudaErrorInvalidValue.
extern "C" int sdf_leaf_sort(const float* points, const int* keys, int P, const int* grid,
                             int depth, float lx, float ly, float lz, float sx, float sy,
                             float sz, int bits, int sms, int* work, long long work_words,
                             int* lid_s, long long* order, void* stream) {
  const bool given = points == nullptr;
  if (P < 0 || P > static_cast<int>(kCountMask) || bits < 1 || bits > 31 || sms < 1 ||
      (reinterpret_cast<uintptr_t>(work) & 15) != 0 ||
      (given ? keys == nullptr : (depth < 0 || depth > 10 || grid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const Plan plan = digit_plan(bits);
  const long long tiles = (P + kSortTile - 1) / kSortTile;
  const long long state_words = (kStateHead + tiles * plan.bins + 3) / 4 * 4;
  const long long Pp = (P + 3ll) / 4 * 4;
  const long long need = state_words + Pp * ((given ? 0 : 1) + 2 * std::min(plan.passes - 1, 2));
  if (work_words < need) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* state = reinterpret_cast<unsigned*>(work);
  int* buf = work + state_words;
  int* key0 = given ? const_cast<int*>(keys) : buf;
  if (!given) buf += Pp;
  cudaError_t err = cudaMemsetAsync(state, 0, state_words * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Box box = {{lx, ly, lz}, {sx, sy, sz}};
  const int steps = (P + kKeyPoints - 1) / kKeyPoints;
  const int blocks = std::min(steps, 4 * sms);
  if (given)
    leaf_sort_keys_kernel<false, false><<<blocks, kSortThreads, 0, s>>>(
        nullptr, keys, P, nullptr, 0, box, plan, nullptr, state);
  else if ((reinterpret_cast<uintptr_t>(points) & 15) == 0)
    leaf_sort_keys_kernel<true, true><<<blocks, kSortThreads, 0, s>>>(
        points, nullptr, P, grid, depth, box, plan, key0, state);
  else
    leaf_sort_keys_kernel<true, false><<<blocks, kSortThreads, 0, s>>>(
        points, nullptr, P, grid, depth, box, plan, key0, state);
  unsigned* status = state + kStateHead;
  const int* kin = key0;
  const int* vin = nullptr;
  for (int p = 0; p < plan.passes; ++p) {
    const bool final = p == plan.passes - 1;
    int* kout = final ? lid_s : buf + 2 * (p % 2) * Pp;
    int* vout = final ? nullptr : kout + Pp;
    leaf_sort_pass_kernel<<<static_cast<int>(tiles), kSortThreads, 0, s>>>(
        kin, vin, P, plan.shift[p], plan.width[p], state + plan.off[p],
        state + kHistBins + 1 + p, status, kout, vout, final ? order : nullptr);
    status += tiles << plan.width[p];
    kin = kout;
    vin = vout;
  }
  return static_cast<int>(cudaGetLastError());
}
