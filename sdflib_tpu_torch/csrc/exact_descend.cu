// K8 (exact_descend) and K9 (exact_sorted_gather): the exact query's key
// and its gathers around the stable sort, one thread a point.
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
// and the id-only tier, b0[i] = leaf_row0[lid_s[i]] and
// nc[i] = leaf_nchunks[lid_s[i]], zero from P up to the padded size.
//
// Bound: bytes. K8 reads 12 B of point and a 4 B grid word and writes a
// 4 B key (20 B a point: 0.0125 ms at 2^21 points on an H100); K9 reads
// 8 B of order, a point's 12 B at a random place, 4 B of key and 8 B of
// the touched leaves' bounds, and writes 12 + 8 B. The grid (2 MiB at
// depth 6, 8 MiB at depth 7) and the leaves' bounds stay in the 50 MB L2;
// the points a sorted warp reads lie anywhere in the batch, so K9's reads
// cost a 32 B sector each. One thread a point with plain loads and stores
// is what this design does about it: nothing else is worth a launch's
// cost at these sizes.
#include <cuda_runtime.h>

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

__global__ void exact_sorted_gather_kernel(const float* __restrict__ points,
                                           const long long* __restrict__ order, int P,
                                           const int* __restrict__ lid_s,
                                           const int* __restrict__ leaf_row0,
                                           const int* __restrict__ leaf_nchunks, int size,
                                           float* __restrict__ pts_s, int* __restrict__ b0,
                                           int* __restrict__ nc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  int r0 = 0, n0 = 0;
  if (i < P) {
    const long long j = order[i];
    x = points[3 * j];
    y = points[3 * j + 1];
    z = points[3 * j + 2];
    if (b0 != nullptr) {
      const int l = lid_s[i];
      r0 = leaf_row0[l];
      n0 = leaf_nchunks[l];
    }
  }
  pts_s[3 * i] = x;
  pts_s[3 * i + 1] = y;
  pts_s[3 * i + 2] = z;
  if (b0 != nullptr) {
    b0[i] = r0;
    nc[i] = n0;
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

// points (P, 3); order (P,) int64; lid_s, leaf_row0, leaf_nchunks, b0, nc
// all null (the grouped scan) or all given; pts_s (size, 3), b0 and nc
// (size,), size >= P (else cudaErrorInvalidValue).
extern "C" int sdf_exact_sorted_gather(const float* points, const long long* order, int P,
                                       const int* lid_s, const int* leaf_row0,
                                       const int* leaf_nchunks, int size, float* pts_s,
                                       int* b0, int* nc, void* stream) {
  if (size < P || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (size > 0) {
    exact_sorted_gather_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        points, order, P, lid_s, leaf_row0, leaf_nchunks, size, pts_s, b0, nc);
  }
  return static_cast<int>(cudaGetLastError());
}
