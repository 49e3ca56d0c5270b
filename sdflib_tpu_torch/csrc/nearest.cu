// K2: brute-force nearest triangle, (P points) x (T triangles).
//
// Replaces the TPU kernel sdflib_tpu/ops/pallas_kernels.py:_nearest_kernel
// (launched by nearest_triangle_pallas), the RealSdf oracle's sweep. For
// each point: the minimum region-classified squared distance over the
// 19-field packed triangle rows and the lowest index that reaches it (a
// strict < over ascending ids; a NaN distance never wins).
//
// Design: the grid is (point tiles) x (S triangle slices). A CTA of 256
// threads owns a tile of 1,024 points, four per thread in registers, and
// walks one slice: a run of whole 64-triangle tiles, staged in shared
// memory as 20-float rows (19 fields and a pad) that every thread reads as
// five float4 broadcasts, each feeding four point-triangle pairs. The
// slices split the tile count evenly (slice s holds tiles
// [s * n / S, (s + 1) * n / S)), so none is empty when S <= n. S comes from
// ops/nearest.py:_split: enough CTAs to fill the 132 SMs at the oracle's
// 10k points (480 CTAs where one thread per point gave 40), and S = 1
// once the point tiles alone fill the card (2^20 points), where the CTA
// writes the result itself. With S > 1 each CTA writes its slice's
// (best, idx) into an (S, P) scratch that the wrapper allocates, and
// merge_kernel reduces it over s in ascending order with a strict <: the
// same as one running minimum over all ids, so ties still go to the
// lowest index and the result does not depend on the schedule.
//
// The region ladder's branches diverge when the points of a warp fall in
// different regions of a triangle, as uniform points in the caller's
// order do. For large work (ops/nearest.py: MORTON_PAIRS) the wrapper
// first puts the points in Morton order (K2's point order, below); the
// kernel reads point order[k] as its k-th point, writes each result at the
// point's own index, and runs the branching ladder, which coherent warps
// mostly skip through (region.cuh). Below that size the order's fixed cost
// outweighs its gain, and the kernel takes the points as given with the
// select form of the ladder, which does not diverge. chip_smoke.py times
// both at each of its shapes; on an H100 each is the faster one on its
// side of MORTON_PAIRS.
//
// Bound: operations. About 34 flops a pair (as PERF.md counts them) and
// 76 bytes a triangle, read once per point tile; the kernels build with
// --fmad=false, so a multiply and an add issue separately, and with the
// ladder's compares and selects a pair takes some 60-80 instructions: the
// issue-rate floor is about twice the table's operations bound or more.
#include <cuda_runtime.h>
#include <math.h>

#include "region.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                     // points a thread
constexpr int kPointTile = kThreads * kPerThread; // points a CTA
constexpr int kTile = 64;                         // triangles a staged tile
constexpr int kFields = 19;                       // packed floats a triangle
constexpr int kRow = 20;                          // staged floats a triangle

// ---- K2's point order ------------------------------------------------------
//
// The order is a stable sort of each point's 30-bit Morton code on a
// 1024^3 grid over the points' own box (ops/nearest.py morton_order_plain:
// torch.aminmax, then the codes, then torch.sort(stable=True)). aminmax
// keeps a NaN, so a NaN coordinate makes its axis's box NaN and sends
// every point of that axis to cell 0; a flat axis (hi == lo) does the same
// through 0 / 0.
//
// Up to sdf_morton_order_max() points (~24k on an H100: the oracle's 10k,
// the gradient batch's 4k) one CTA of 1,024 threads does the whole order
// in one launch: the box by a block reduction (coalesced reads), the codes
// into shared memory, then a stable LSD radix sort of the point ids by
// code, six passes of 5 bits. A pass is a counting sort in which sorter t
// (the first 512 threads) owns the t-th run of positions: it counts its
// digits into its own column of a (16, 512) table of words, two 16-bit
// counts a word (no atomics, no bank conflicts: word k * 512 + t); the
// block scans the 16 words of every sorter at once (packed: no count
// passes P < 2^16), digit-major and sorter-minor, and each sorter
// scatters its run in order. Runs in position order keep the sort stable,
// so the order is the plain version's bit for bit. Shared memory: the
// table (32 KiB), the codes (4 B a point) and two 16-bit id buffers (4 B
// a point); the largest batch is what the card's opt-in shared memory per
// block leaves. One SM does it all: every phase is a short latency chain
// between barriers, and the random reads of the codes and writes of the
// ids take most of a pass (PERF.md section 6 lists the forms measured).
//
// Larger batches (262,144 to 2^22 points, where one SM would be slow): the
// box by a block reduction and one atomic max a CTA on the order-preserving
// integer image of each float (the minimum as the max of the complement;
// a NaN sets its axis's flag), zeroed by a memset; then the codes, one
// thread a point, from that box in device memory; the wrapper sorts them
// (torch.sort, stable).
//
// Bound: bytes, 12 B in and 8 B out a point (the order). The one-CTA
// order is far from it, bound by one SM's latency and shared-memory
// traffic; what it saves is the launches, allocations and host calls of
// the three-step order (aminmax, codes, sort) it replaces.

constexpr int kOrderThreads = 1024;
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kSortThreads = 512;                       // the threads that own runs
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigitBits = 5;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = 6;                              // 30-bit codes
constexpr int kPairs = kBins / 2;                       // 16-bit counts, two a word
constexpr int kCountBytes = kPairs * kSortThreads * 4;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPairs <= kOrderWarps && kBins <= 32 && kSortWarps <= 32 &&
              kSortThreads <= kOrderThreads, "a warp a word of the scan, a lane a digit");

// torch's min and max keep a NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// 10 bits spread to every third bit of a 30-bit Morton code.
__device__ __forceinline__ unsigned spread_bits(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

// morton_codes_plain at one point: each axis scaled to [0, 1023] over the
// box [lo, hi] (a NaN to 0), clamped and truncated, x in the lowest bit.
__device__ __forceinline__ unsigned morton_code(const float* __restrict__ p,
                                                const float (&lo)[3], const float (&hi)[3]) {
  unsigned code = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t = (p[k] - lo[k]) / (hi[k] - lo[k]) * 1023.0f;
    code |= spread_bits(static_cast<unsigned>(fminf(fmaxf(t, 0.0f), 1023.0f))) << k;
  }
  return code;
}

// The order-preserving unsigned image of a float that is not NaN, and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// An inclusive scan of v over the warp's lanes.
__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// The order of P points in one CTA; dynamic shared memory: kCountBytes +
// 8 P bytes.
__global__ void __launch_bounds__(kOrderThreads, 1)
morton_order_kernel(const float* __restrict__ points, int P, long long* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* count = reinterpret_cast<unsigned*>(smem);               // [pair][sorter]
  unsigned* codes = reinterpret_cast<unsigned*>(smem + kCountBytes);
  unsigned short* ids[2] = {reinterpret_cast<unsigned short*>(codes + P),
                            reinterpret_cast<unsigned short*>(codes + P) + P};
  __shared__ float red[6][kOrderWarps];
  __shared__ unsigned wtot[kSortWarps][kPairs];    // each warp's column sums
  __shared__ unsigned wpre[kSortWarps][kPairs];    // ... summed over the warps before it
  __shared__ unsigned tot[kPairs];
  __shared__ unsigned base[kBins];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the box: per thread (coalesced: thread t reads floats t + 1024 j, of
  // axis (t + j) % 3, into slot j % 3), per warp by shuffles, then over
  // the warps
  float mn[3] = {INFINITY, INFINITY, INFINITY}, mx[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll 2
  for (int f = tid; f < 3 * P; f += 3 * kOrderThreads) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (f + r * kOrderThreads < 3 * P) {
        const float x = points[f + r * kOrderThreads];
        mn[r] = nan_min(mn[r], x);
        mx[r] = nan_max(mx[r], x);
      }
    }
  }
  float v[6];
  const int a0 = tid % 3;       // slot r holds axis (a0 + r) % 3
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int r = (k - a0 + 3) % 3;
    v[k] = r == 0 ? mn[0] : (r == 1 ? mn[1] : mn[2]);
    v[3 + k] = r == 0 ? mx[0] : (r == 1 ? mx[1] : mx[2]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = nan_min(v[k], __shfl_xor_sync(kFull, v[k], o));
      v[3 + k] = nan_max(v[3 + k], __shfl_xor_sync(kFull, v[3 + k], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = red[k][lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = nan_min(v[k], __shfl_xor_sync(kFull, v[k], o));
      v[3 + k] = nan_max(v[3 + k], __shfl_xor_sync(kFull, v[3 + k], o));
    }
  }
  const float lo[3] = {v[0], v[1], v[2]}, hi[3] = {v[3], v[4], v[5]};
#pragma unroll 4
  for (int p = tid; p < P; p += kOrderThreads) {
    codes[p] = morton_code(points + 3 * p, lo, hi);
    ids[0][p] = static_cast<unsigned short>(p);
  }

  // sorter t's run of positions (the other threads only meet the barriers)
  const bool sorter = tid < kSortThreads;
  const int per = (P + kSortThreads - 1) / kSortThreads;
  const int t0 = sorter ? min(tid * per, P) : P, t1 = min(t0 + per, P);
  unsigned* col = count + (sorter ? tid : 0);
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = kDigitBits * pass;
    const unsigned short* src = ids[pass & 1];
    unsigned short* dst = ids[(pass + 1) & 1];
    if (sorter) {
#pragma unroll
      for (int k = 0; k < kPairs; ++k) col[k * kSortThreads] = 0u;
    }
    __syncthreads();    // the codes and ids (the last pass's dst) are written
    for (int i = t0; i < t1; ++i) {
      const unsigned d = (codes[src[i]] >> shift) & (kBins - 1);
      col[(d >> 1) * kSortThreads] += 1u << ((d & 1) << 4);
    }
    // exclusive offsets, digit-major and sorter-minor: a scan over the
    // sorters (the lanes, then the warps) of the 16 packed words at once
    unsigned own[kPairs], incl[kPairs];
    if (sorter) {
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        own[k] = col[k * kSortThreads];
        incl[k] = warp_scan(own[k], lane);
        if (lane == 31) wtot[warp][k] = incl[k];
      }
    }
    __syncthreads();
    if (warp < kPairs) {    // warp k scans word k over the sorters' warps
      const unsigned w = lane < kSortWarps ? wtot[lane][warp] : 0u;
      const unsigned s = warp_scan(w, lane);
      if (lane < kSortWarps) wpre[lane][warp] = s - w;
      if (lane == 31) tot[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {        // lane d: the start of digit d
      const unsigned c = (tot[lane >> 1] >> ((lane & 1) << 4)) & 0xFFFFu;
      base[lane] = warp_scan(c, lane) - c;
    }
    __syncthreads();
    if (sorter) {
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const unsigned off = incl[k] - own[k] + wpre[warp][k];
        col[k * kSortThreads] = ((off & 0xFFFFu) + base[2 * k]) |
                                (((off >> 16) + base[2 * k + 1]) << 16);
      }
    }
    for (int i = t0; i < t1; ++i) {
      const unsigned short id = src[i];
      const unsigned d = (codes[id] >> shift) & (kBins - 1);
      const int h = (d & 1) << 4;
      const unsigned w = col[(d >> 1) * kSortThreads];
      dst[(w >> h) & 0xFFFFu] = id;
      col[(d >> 1) * kSortThreads] = w + (1u << h);
    }
    __syncthreads();    // dst is complete before the next pass reads it
  }
  const unsigned short* out = ids[kPasses & 1];
  for (int p = tid; p < P; p += kOrderThreads) order[p] = out[p];
}

// The box of P points: box[k] the max of ~ordered(min), box[3 + k] of
// ordered(max), box[6] bit k set where axis k holds a NaN. Zeroed first.
__global__ void __launch_bounds__(256)
morton_box_kernel(const float* __restrict__ points, int P, unsigned* __restrict__ box) {
  __shared__ float red[6][8];
  __shared__ unsigned flags;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) flags = 0u;
  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  unsigned nan = 0u;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += gridDim.x * blockDim.x) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = points[3 * p + k];
      nan |= (x != x ? 1u : 0u) << k;
      v[k] = fminf(v[k], x);      // fminf and fmaxf skip a NaN
      v[3 + k] = fmaxf(v[3 + k], x);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = fminf(v[k], __shfl_xor_sync(kFull, v[k], o));
      v[3 + k] = fmaxf(v[3 + k], __shfl_xor_sync(kFull, v[3 + k], o));
    }
  }
  nan = __reduce_or_sync(kFull, nan);
  __syncthreads();    // flags is zeroed
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[k][warp] = v[k];
    if (nan) atomicOr(&flags, nan);
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    float m = red[k][0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      m = k < 3 ? fminf(m, red[k][w]) : fmaxf(m, red[k][w]);
    }
    atomicMax(box + k, k < 3 ? ~ordered(m) : ordered(m));
  } else if (threadIdx.x == 6 && flags) {
    atomicOr(box + 6, flags);
  }
}

// Each point's Morton code over the box morton_box_kernel left in box.
__global__ void __launch_bounds__(256)
morton_codes_kernel(const float* __restrict__ points, int P, const unsigned* __restrict__ box,
                    int* __restrict__ codes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const unsigned nan = box[6];
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool n = (nan >> k) & 1u;
    lo[k] = n ? NAN : unordered(~box[k]);
    hi[k] = n ? NAN : unordered(box[3 + k]);
  }
  codes[p] = static_cast<int>(morton_code(points + 3 * static_cast<size_t>(p), lo, hi));
}

// kMorton: the kernel's k-th point is point order[k], and the ladder
// branches; else the k-th point is point k, and the ladder selects.
// Results are written at the point's own index.
template <bool kMorton>
__global__ void __launch_bounds__(kThreads, 4)
nearest_kernel(const float* __restrict__ points, const long long* __restrict__ order,
               int P, const float* __restrict__ fields, int T, int S,
               float* __restrict__ best_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile * kRow / 4];
  float* staged = reinterpret_cast<float*>(tile);
  const int ntiles = (T + kTile - 1) / kTile;
  const int s = blockIdx.y;
  const int tile0 = static_cast<int>(static_cast<long long>(s) * ntiles / S);
  const int tile1 = static_cast<int>(static_cast<long long>(s + 1) * ntiles / S);
  const int p0 = blockIdx.x * kPointTile + threadIdx.x;

  float px[kPerThread], py[kPerThread], pz[kPerThread], best[kPerThread];
  int best_idx[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = p0 + k * kThreads;
    px[k] = py[k] = pz[k] = 0.0f;
    if (q < P) {
      const int p = kMorton ? static_cast<int>(order[q]) : q;
      px[k] = points[3 * p + 0];
      py[k] = points[3 * p + 1];
      pz[k] = points[3 * p + 2];
    }
    best[k] = INFINITY;
    best_idx[k] = 0;
  }

  for (int j = tile0; j < tile1; ++j) {
    const int base = j * kTile;
    const int n = min(kTile, T - base);
    const float* src = fields + static_cast<size_t>(base) * kFields;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n * kFields; i += kThreads) {
      const int t = i / kFields;
      staged[t * kRow + (i - t * kFields)] = src[i];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float4 f0 = tile[t * 5 + 0];   // origin xyz, row x.x
      const float4 f1 = tile[t * 5 + 1];   // row x.yz, row y.xy
      const float4 f2 = tile[t * 5 + 2];   // row y.z, row z.xyz
      const float4 f3 = tile[t * 5 + 3];   // b0 b1 c0 c1
      const float4 f4 = tile[t * 5 + 4];   // v2x v3x v3y, pad
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float dx = px[k] - f0.x;
        const float dy = py[k] - f0.y;
        const float dz = pz[k] - f0.z;
        const float ppx = f0.w * dx + f1.x * dy + f1.y * dz;
        const float ppy = f1.z * dx + f1.w * dy + f2.x * dz;
        const float ppz = f2.y * dx + f2.z * dy + f2.w * dz;
        const float d =
            kMorton ? region_sq_dist(ppx, ppy, ppz, f4.x, f4.y, f4.z, f3.x,
                                     f3.y, f3.z, f3.w)
                    : region_sq_dist_sel(ppx, ppy, ppz, f4.x, f4.y, f4.z, f3.x,
                                         f3.y, f3.z, f3.w);
        if (d < best[k]) {
          best[k] = d;
          best_idx[k] = base + t;
        }
      }
    }
  }

  float* b_out = best_out + static_cast<size_t>(s) * P;
  int* i_out = idx_out + static_cast<size_t>(s) * P;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = p0 + k * kThreads;
    if (q < P) {
      const int p = kMorton ? static_cast<int>(order[q]) : q;
      b_out[p] = best[k];
      i_out[p] = best_idx[k];
    }
  }
}

// Reduce the (S, P) slice results over s in ascending order, strict <.
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_best,
             const int* __restrict__ part_idx, int P, int S,
             float* __restrict__ best_out, int* __restrict__ idx_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float best = INFINITY;
  int best_idx = 0;
  for (int s = 0; s < S; ++s) {
    const float b = part_best[static_cast<size_t>(s) * P + p];
    if (b < best) {
      best = b;
      best_idx = part_idx[static_cast<size_t>(s) * P + p];
    }
  }
  best_out[p] = best;
  idx_out[p] = best_idx;
}

}  // namespace

// The most points morton_order_kernel takes on the current device: what
// its opt-in shared memory per block leaves beside the count table (16-bit
// ids: at most 65,535). 0 on an error.
extern "C" int sdf_morton_order_max(void) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, morton_order_kernel) != cudaSuccess) {
    return 0;
  }
  const long long room = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes) - kCountBytes;
  return static_cast<int>(room < 0 ? 0 : (room / 8 < 65535 ? room / 8 : 65535));
}

// The order of 1 <= P <= sdf_morton_order_max() points in one launch.
extern "C" int sdf_morton_order(const float* points, int P, long long* order, void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = kCountBytes + 8 * static_cast<size_t>(P);
  const cudaError_t set = cudaFuncSetAttribute(
      morton_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  morton_order_kernel<<<1, kOrderThreads, smem, static_cast<cudaStream_t>(stream)>>>(points, P,
                                                                                     order);
  return static_cast<int>(cudaGetLastError());
}

// The codes of P points over their own box: box (7 words of scratch) is
// zeroed, reduced (morton_box_kernel), then read by morton_codes_kernel.
extern "C" int sdf_morton_codes(const float* points, int P, unsigned* box, int* codes,
                                void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t set = cudaMemsetAsync(box, 0, 7 * sizeof(unsigned), st);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = (P + 1023) / 1024;               // four points a thread or more
  const int blocks = tiles < 1024 ? tiles : 1024;
  morton_box_kernel<<<blocks, 256, 0, st>>>(points, P, box);
  morton_codes_kernel<<<(P + 255) / 256, 256, 0, st>>>(points, P, box, codes);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 2 * S * P floats when S > 1 (slice minima, then slice ids as
// int32), unused when S == 1.
extern "C" int sdf_nearest_triangle(const float* points, const long long* order,
                                    int P, const float* fields, int T, int S,
                                    float* scratch, float* best, int* idx,
                                    void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  if (S < 1 || (T > 0 && S > (T + kTile - 1) / kTile) || (T == 0 && S != 1) ||
      (S > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + kPointTile - 1) / kPointTile, S);
  float* part_best = S > 1 ? scratch : best;
  int* part_idx =
      S > 1 ? reinterpret_cast<int*>(scratch + static_cast<size_t>(S) * P) : idx;
  if (order != nullptr) {
    nearest_kernel<true><<<grid, kThreads, 0, st>>>(points, order, P, fields, T,
                                                    S, part_best, part_idx);
  } else {
    nearest_kernel<false><<<grid, kThreads, 0, st>>>(points, order, P, fields, T,
                                                     S, part_best, part_idx);
  }
  if (S > 1) {
    merge_kernel<<<(P + 255) / 256, 256, 0, st>>>(part_best, part_idx, P, S,
                                                  best, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
