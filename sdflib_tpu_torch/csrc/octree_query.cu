// K4: the approximate octree's dense-grid query, one lane a point, its
// coefficient row read by a group of lanes.
//
// Replaces the XLA-fused query of the JAX package, sdflib_tpu/sdf/octree.py
// _octree_query_grid (:183; the thin grid, or its fused rows) and
// _octree_query_fat (:325), whose torch copies in sdflib_tpu_torch ran as
// ~55 eager kernels a call. A block stages its points into shared memory
// with coalesced loads. Each lane finds its point's finest cell and reads
// the cell's leaf row (thin grid: the [leaf word, depth | flags] row and
// the 64 or 8 coefficients the word names; fused rows: one row); the warp
// reads its 32 points' coefficient rows kGroup lanes a point, as
// contiguous float4 runs, and sums each leaf polynomial (and its
// gradient) with shuffles (leaf_eval.cuh, tricubic_warp); each lane
// normalizes its own, and the block writes d (and g) back through shared
// memory, coalesced. Out-of-box points read no row: the box distance plus
// min_border_value, and the reference's box gradient.
//
// Bound: bytes. A point moves 12 B in, its grid row (8 B) and coefficient
// row (256 B tricubic) and 4 B out (16 B with the gradient); the rows
// repeat across points, so the least traffic is each touched row once,
// and at bench.py's d6 the whole structure (~3 MB) sits in L2. What holds
// the kernel back is the L1's wavefronts, not bytes: where each lane reads
// its own row (kGroup 1, the earlier form), a warp's load touches a line
// for every lane. A group of kGroup lanes reads a row's 256 B as one run,
// so a load instruction touches each of its points' lines once, while the
// work done once a point stays one lane's.
#include <cuda_runtime.h>

#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

template <bool Grad, int kGroup>
__global__ void __launch_bounds__(kThreads)
octree_query_kernel(leaf::Grid G, const float* __restrict__ points, int n,
                    float* __restrict__ d_out, float* __restrict__ g_out) {
  __shared__ float sp[3 * kThreads];
  __shared__ float sd[kThreads];
  __shared__ float sg[Grad ? 3 * kThreads : 1];
  const int first = blockIdx.x * kThreads;  // < n
  const int here = min(kThreads, n - first);
  const float* __restrict__ in = points + 3 * static_cast<size_t>(first);
  for (int k = threadIdx.x; k < 3 * here; k += kThreads) sp[k] = in[k];
  __syncthreads();
  // every lane runs the query: the group read's shuffles span the warp
  const int pt = threadIdx.x;
  const bool valid = pt < here;
  const leaf::Box b = leaf::load_box(G);
  const float p[3] = {valid ? sp[3 * pt] : 0.0f, valid ? sp[3 * pt + 1] : 0.0f,
                      valid ? sp[3 * pt + 2] : 0.0f};
  float g[3];
  const float d = leaf::query<Grad, kGroup>(G, b, p, g);
  if (valid) {
    sd[pt] = d;
    if (Grad) {
      sg[3 * pt] = g[0];
      sg[3 * pt + 1] = g[1];
      sg[3 * pt + 2] = g[2];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < here; k += kThreads) d_out[first + k] = sd[k];
  if (Grad) {
    float* __restrict__ out = g_out + 3 * static_cast<size_t>(first);
    for (int k = threadIdx.x; k < 3 * here; k += kThreads) out[k] = sg[k];
  }
}

template <int kGroup>
void launch(const leaf::Grid& G, const float* points, int n, float* d_out, float* g_out,
            cudaStream_t st) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (g_out != nullptr) {
    octree_query_kernel<true, kGroup><<<blocks, kThreads, 0, st>>>(G, points, n, d_out, g_out);
  } else {
    octree_query_kernel<false, kGroup><<<blocks, kThreads, 0, st>>>(G, points, n, d_out, g_out);
  }
}

}  // namespace

// rows (g^3, width) int32; coeffs: the float view of the octree words for
// the thin grid (width 2), null for fused rows; g_out null: no gradient;
// group: the lanes that read a point's coefficient row, 1, 4 or 8.
extern "C" int sdf_octree_query(const int* rows, int width, const float* coeffs,
                                int num_words, int depth, int tricubic,
                                const float* box_min, const float* box_size3,
                                float min_border, const float* points, int n,
                                float* d_out, float* g_out, int group, void* stream) {
  if (n > 0) {
    const leaf::Grid G{rows, width, coeffs, num_words, depth, tricubic,
                       box_min, box_size3, min_border};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (group) {
      case 1: launch<1>(G, points, n, d_out, g_out, st); break;
      case 4: launch<4>(G, points, n, d_out, g_out, st); break;
      case 8: launch<8>(G, points, n, d_out, g_out, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
