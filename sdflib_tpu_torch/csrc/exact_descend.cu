// K8 (exact_descend) and K9 (exact_sorted_gather): the exact query's key
// and its gathers around the stable sort.
//
// Neither replaces a TPU kernel: no pl.pallas_call lies behind them. The
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
// sort key.
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

#include "cache_hints.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void exact_descend_kernel(const float* __restrict__ points, int P,
                                     const int* __restrict__ grid, int depth,
                                     const float* __restrict__ box_min,
                                     const float* __restrict__ box_size3,
                                     int* __restrict__ key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  const int g = 1 << depth;
  const float gf = static_cast<float>(g);
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rel = (points[3 * i + a] - box_min[a]) / box_size3[a];
    const int t = __float2int_rz(rel * gf);
    c[a] = min(max(t, 0), g - 1);
  }
  key[i] = grid[(c[2] * g + c[1]) * g + c[0]];
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
