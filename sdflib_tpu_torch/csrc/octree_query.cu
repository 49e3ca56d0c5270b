// K4: the approximate octree's dense-grid query, one thread a point.
//
// Replaces the XLA-fused query of the JAX package, sdflib_tpu/sdf/octree.py
// _octree_query_grid (:183; the thin grid, or its fused rows) and
// _octree_query_fat (:325), whose torch copies in sdflib_tpu_torch ran as
// ~55 eager kernels a call. Each thread reads its point, finds its finest
// cell, reads the cell's leaf row (thin grid: the [leaf word, depth | flags]
// row and the 64 or 8 coefficients the word names; fused rows: one row),
// evaluates the leaf polynomial (and its normalized gradient) in registers
// and writes d (and g). Out-of-box points read no row: the box distance
// plus min_border_value, and the reference's box gradient (leaf_eval.cuh).
//
// Bound: bytes. A point moves 12 B in, its grid row (8 B) and coefficient
// row (256 B tricubic) and 4 B out (16 B with the gradient); the rows
// repeat across points, so the least traffic is each touched row once,
// and at bench.py's d6 the whole structure (~3 MB) sits in L2. The design
// keeps every intermediate in registers (the torch version wrote ~55
// (P, 64)-sized temporaries to device memory); the coefficient loads are
// one thread's scattered 4-byte reads through the read-only cache.
#include <cuda_runtime.h>

#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

template <bool Grad>
__global__ void __launch_bounds__(kThreads)
octree_query_kernel(leaf::Grid G, const float* __restrict__ points, int n,
                    float* __restrict__ d_out, float* __restrict__ g_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const leaf::Box b = leaf::load_box(G);
  const size_t o = 3 * static_cast<size_t>(i);
  const float p[3] = {points[o], points[o + 1], points[o + 2]};
  float g[3];
  d_out[i] = leaf::query<Grad>(G, b, p, g);
  if (Grad) {
    g_out[o] = g[0];
    g_out[o + 1] = g[1];
    g_out[o + 2] = g[2];
  }
}

}  // namespace

// rows (g^3, width) int32; coeffs: the float view of the octree words for
// the thin grid (width 2), null for fused rows; g_out null: no gradient.
extern "C" int sdf_octree_query(const int* rows, int width, const float* coeffs,
                                int num_words, int depth, int tricubic,
                                const float* box_min, const float* box_size3,
                                float min_border, const float* points, int n,
                                float* d_out, float* g_out, void* stream) {
  if (n > 0) {
    const leaf::Grid G{rows, width, coeffs, num_words, depth, tricubic,
                       box_min, box_size3, min_border};
    const int blocks = (n + kThreads - 1) / kThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (g_out != nullptr) {
      octree_query_kernel<true><<<blocks, kThreads, 0, st>>>(G, points, n, d_out, g_out);
    } else {
      octree_query_kernel<false><<<blocks, kThreads, 0, st>>>(G, points, n, d_out, g_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
