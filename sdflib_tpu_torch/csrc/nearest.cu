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
// first puts the points in Morton order (morton_kernel, then a sort); the
// kernel reads point order[k] as its k-th point, writes each result at the
// point's own index, and runs the branching ladder, which coherent warps
// mostly skip through (region.cuh). Below that size the sort's fixed cost
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

// 10 bits spread to every third bit of a 30-bit Morton code.
__device__ __forceinline__ unsigned spread_bits(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

// Each point's Morton code on a 1024^3 grid over the points' box [lo, hi]
// (a NaN coordinate or a flat axis clamps into the grid).
__global__ void __launch_bounds__(256)
morton_kernel(const float* __restrict__ points, int P, const float* __restrict__ lo,
              const float* __restrict__ hi, int* __restrict__ codes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  unsigned code = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t = (points[3 * p + k] - lo[k]) / (hi[k] - lo[k]) * 1023.0f;
    code |= spread_bits(static_cast<unsigned>(fminf(fmaxf(t, 0.0f), 1023.0f))) << k;
  }
  codes[p] = static_cast<int>(code);
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

// scratch: 2 * S * P floats when S > 1 (slice minima, then slice ids as
// int32), unused when S == 1.
extern "C" int sdf_nearest_morton(const float* points, int P, const float* lo,
                                  const float* hi, int* codes, void* stream) {
  if (P > 0) {
    morton_kernel<<<(P + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        points, P, lo, hi, codes);
  }
  return static_cast<int>(cudaGetLastError());
}

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
