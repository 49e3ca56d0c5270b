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
// digits of at most 11 bits (two passes at depths 6 and 7, three up to 31
// bits), where torch's general sort takes four 8-bit passes of int32 keys
// with int64 values. One call is a memset of the look-back state and:
//  * the key launch (K8 fused with the upsweep): a block stages 2,048
//    points with 16-byte loads through shared memory, computes and writes
//    each key, and counts every pass's digits in shared memory, then with
//    atomics into one 4,096-bin table in L2 (integer counts: the same
//    every run). The last block to finish turns each pass's counts into
//    its digits' first places. With keys given (the node walk's) it only
//    counts them.
//  * one launch a digit pass ("onesweep"): a block takes its tile of 4,096
//    keys from an atomic counter, never from blockIdx, so a tile that
//    spins on an earlier one never waits on a block not yet scheduled.
//    Each warp ranks its 512 keys in index order (__match_any_sync and
//    popcounts over a per-warp count of each digit), a prefix over the
//    warps in order gives the rank in the tile: the sort is stable. The
//    tile publishes its digit counts, then finds the counts of all earlier
//    tiles by decoupled look-back (one status word a tile and digit: a
//    2-bit flag, aggregate or inclusive prefix, over a 30-bit count), and
//    writes its keys and values from shared memory in sorted order, so a
//    digit's run goes out as consecutive stores. The first pass's value
//    is the index (int32); the last pass writes lid_s and the order as
//    int64, the types K9 and K7 read.
// Nothing is read back to the host. Bound: bytes; the design moves 48 B a
// point in two passes (12 B of point and a 4 B key; 4 B in and 8 B out;
// 8 B in, 4 + 8 B out).
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
constexpr int kKeyPoints = 2048;                        // points a step of the key launch
constexpr int kMaxDigit = 11;
constexpr int kMaxRadix = 1 << kMaxDigit;
constexpr int kDigitsPerThread = kMaxRadix / kSortThreads;
constexpr int kMaxPasses = 3;
// every pass's bins side by side: at most 2 x 2^11 (11 + 11 bits) or
// 2^11 + 2 x 2^10 (11 + 10 + 10 bits, the widest three-pass plan)
constexpr int kHistBins = 2 * kMaxRadix;
// the state's words before the look-back status: the bins, the key
// launch's ticket, a tile counter a pass
constexpr int kStateHead = kHistBins + 1 + kMaxPasses;
constexpr unsigned kCountMask = (1u << 30) - 1;
constexpr unsigned kFlagAggregate = 1u << 30;           // the tile's own count
constexpr unsigned kFlagPrefix = 2u << 30;              // the count of it and every earlier tile
constexpr unsigned kFull = 0xffffffffu;

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

// A look-back that has waited this long on an earlier tile (which holds a
// running block: it took its index first) traps instead of hanging.
constexpr unsigned long long kSpinLimitNs = 2000000000ull;

// Exclusive prefix sums of s[0..n) in shared memory, in place (n <=
// kMaxRadix); every thread of the block calls it after s is complete, and
// s is complete again when it returns.
__device__ void block_exclusive_scan(unsigned* s, int n) {
  __shared__ unsigned warp_sum[kSortWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kSortThreads - 1) / kSortThreads;
  const int lo = threadIdx.x * per;
  unsigned before[kDigitsPerThread];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < kDigitsPerThread; ++i) {
    before[i] = sum;
    if (i < per && lo + i < n) sum += s[lo + i];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned pre = incl - sum;
  for (int w = 0; w < warp; ++w) pre += warp_sum[w];
#pragma unroll
  for (int i = 0; i < kDigitsPerThread; ++i)
    if (i < per && lo + i < n) s[lo + i] = pre + before[i];
  __syncthreads();
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
  // every block's counts are in: each pass's exclusive sums over its digits
  for (int i = threadIdx.x; i < plan.bins; i += kSortThreads) count[i] = __ldcg(state + i);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p)
    if (p < plan.passes) block_exclusive_scan(count + plan.off[p], 1 << plan.width[p]);
  for (int i = threadIdx.x; i < plan.bins; i += kSortThreads) state[i] = count[i];
}

// A digit pass's shared memory: the per-warp digit counts while it ranks
// (16 bits a digit: a warp counts at most 512 keys), then the tile in
// sorted order.
union __align__(16) PassShared {
  unsigned short warp_count[kSortWarps][kMaxRadix];
  struct {
    int key[kSortTile];
    int val[kSortTile];
  } tile;
};

// One digit pass over the keys (and values; none: the index) into the
// outputs (values as int32, or as int64 into order on the last pass).
__global__ void __launch_bounds__(kSortThreads)
    leaf_sort_pass_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in, int P,
                          int shift, int width, const unsigned* __restrict__ first,
                          unsigned* tile_counter, unsigned* status, int* __restrict__ keys_out,
                          int* __restrict__ vals_out, long long* __restrict__ order_out) {
  __shared__ PassShared sm;
  __shared__ unsigned place[kMaxRadix];
  __shared__ int tile_index;
  const int R = 1 << width;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_index = static_cast<int>(atomicAdd(tile_counter, 1u));
  uint4* zero = reinterpret_cast<uint4*>(&sm.warp_count[0][0]);
  for (int i = threadIdx.x; i < kSortWarps * kMaxRadix / 8; i += kSortThreads)
    zero[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int tile = tile_index;
  // warp w holds the tile's keys [512 w, 512 w + 512): item k of lane l is
  // key 512 w + 32 k + l, so (k, lane) is index order within the warp
  const int base = tile * kSortTile + warp * (kSortItems * 32) + lane;
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int i = base + 32 * k;
    key[k] = i < P ? __ldcs(keys_in + i) : 0;
    val[k] = vals_in == nullptr ? i : (i < P ? __ldcs(vals_in + i) : 0);
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const bool live = base + 32 * k < P;
    const int d = live ? digit_of(key[k], shift, width) : R;     // R: no key
    const unsigned peers = __match_any_sync(kFull, d);
    const int leader = __ffs(peers) - 1;
    unsigned seen = 0;
    if (live && lane == leader) {
      seen = sm.warp_count[warp][d];
      sm.warp_count[warp][d] = static_cast<unsigned short>(seen + __popc(peers));
    }
    rank[k] = static_cast<int>(__shfl_sync(kFull, seen, leader) + __popc(peers & below));
    __syncwarp();
  }
  __syncthreads();
  // each digit's count in the tile (published at once) and each warp's
  // first place among the digit's keys
  unsigned mine[kDigitsPerThread];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x + j * kSortThreads;
    mine[j] = 0;
    if (d >= R) continue;
    unsigned sum = 0;
    for (int w = 0; w < kSortWarps; ++w) {
      const unsigned c = sm.warp_count[w][d];
      sm.warp_count[w][d] = static_cast<unsigned short>(sum);
      sum += c;
    }
    mine[j] = sum;
    place[d] = sum;
    store_volatile(status + static_cast<size_t>(tile) * R + d,
                   (tile == 0 ? kFlagPrefix : kFlagAggregate) | sum);
  }
  // decoupled look-back: the digits' counts over every earlier tile, all
  // of a thread's digits in flight at once
  unsigned before[kDigitsPerThread];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) before[j] = 0;
  if (tile > 0) {
    int at[kDigitsPerThread];
    unsigned pending = 0;
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      at[j] = tile - 1;
      if (threadIdx.x + j * kSortThreads < R) pending |= 1u << j;
    }
    unsigned long long spin_start = 0;
    while (pending != 0) {
      unsigned word[kDigitsPerThread];
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j)
        word[j] = (pending >> j & 1) ? load_volatile(status + static_cast<size_t>(at[j]) * R +
                                                     threadIdx.x + j * kSortThreads)
                                     : 0;
      bool waiting = false;
#pragma unroll
      for (int j = 0; j < kDigitsPerThread; ++j) {
        if (!(pending >> j & 1)) continue;
        const unsigned flag = word[j] & ~kCountMask;
        if (flag == 0) {                                // not published yet: again
          waiting = true;
          continue;
        }
        before[j] += word[j] & kCountMask;
        if (flag == kFlagPrefix) pending &= ~(1u << j);
        else --at[j];
      }
      if (waiting) {
        const unsigned long long now = global_ns();
        if (spin_start == 0) spin_start = now;
        else if (now - spin_start > kSpinLimitNs) __trap();
      }
    }
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x + j * kSortThreads;
      if (d < R)
        store_volatile(status + static_cast<size_t>(tile) * R + d,
                       kFlagPrefix | (before[j] + mine[j]));
    }
  }
  __syncthreads();
  block_exclusive_scan(place, R);                       // the digit's first place in the tile
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (base + 32 * k < P) {
      const int d = digit_of(key[k], shift, width);
      rank[k] += static_cast<int>(place[d] + sm.warp_count[warp][d]);
    }
  }
  __syncthreads();                                      // the counts are read: stage over them
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x + j * kSortThreads;
    // the output place of the tile's sorted position 0 for digit d
    if (d < R) place[d] = first[d] + before[j] - place[d];
  }
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (base + 32 * k < P) {
      sm.tile.key[rank[k]] = key[k];
      sm.tile.val[rank[k]] = val[k];
    }
  }
  __syncthreads();
  const int n = min(kSortTile, P - tile * kSortTile);
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    const int k = sm.tile.key[i];
    const unsigned at = place[digit_of(k, shift, width)] + i;
    keys_out[at] = k;
    if (order_out != nullptr) order_out[at] = sm.tile.val[i];
    else vals_out[at] = sm.tile.val[i];
  }
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
// grid). work: int32 scratch of work_words, at least
// ops/exact_query.py _sort_words: the look-back state (zeroed here), the
// keys when computed, and two buffers a pass past the first. Anything out
// of range returns cudaErrorInvalidValue.
extern "C" int sdf_leaf_sort(const float* points, const int* keys, int P, const int* grid,
                             int depth, float lx, float ly, float lz, float sx, float sy,
                             float sz, int bits, int sms, int* work, long long work_words,
                             int* lid_s, long long* order, void* stream) {
  const bool given = points == nullptr;
  if (P < 0 || P > static_cast<int>(kCountMask) || bits < 1 || bits > 31 || sms < 1 ||
      (given ? keys == nullptr : (depth < 0 || depth > 10 || grid == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const Plan plan = digit_plan(bits);
  const long long tiles = (P + kSortTile - 1) / kSortTile;
  const long long state_words = kStateHead + tiles * plan.bins;
  const long long need = state_words + static_cast<long long>(P) *
                                           ((given ? 0 : 1) + 2 * (plan.passes - 1));
  if (work_words < need) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* state = reinterpret_cast<unsigned*>(work);
  int* buf = work + state_words;
  int* key0 = given ? const_cast<int*>(keys) : buf;
  if (!given) buf += P;
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
    int* kout = final ? lid_s : buf + static_cast<size_t>(2 * (p % 2)) * P;
    int* vout = final ? nullptr : kout + P;
    leaf_sort_pass_kernel<<<static_cast<int>(tiles), kSortThreads, 0, s>>>(
        kin, vin, P, plan.shift[p], plan.width[p], state + plan.off[p],
        state + kHistBins + 1 + p, status, kout, vout, final ? order : nullptr);
    status += tiles << plan.width[p];
    kin = kout;
    vin = vout;
  }
  return static_cast<int>(cudaGetLastError());
}
