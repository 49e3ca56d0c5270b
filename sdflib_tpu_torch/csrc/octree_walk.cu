// K10-K12: the approximate octree's walk over a given coefficient pointer,
// its backward, and the generic march over it; one thread a point or a ray.
//
// K10, walk_query_kernel, replaces the JAX package's XLA-fused walk,
// sdflib_tpu/sdf/octree.py _octree_query (:56), and the forward of
// sdflib_tpu/diff/query.py octree_query_diff (:43); the torch copy
// (ops/walk.py walk_query_plain: _octree_walk, then _finish) ran ~10 eager
// kernels a level and kept its autograd graph. A thread walks its point
// (walk.cuh) and evaluates the leaf polynomial with leaf_eval.cuh's
// one-thread sums: the distance; with the normalised gradient (the box
// gradient outside) as OctreeSdf queries return it; or with the diff
// query's world gradient, the polynomial's gradient times 2^steps / cell
// (0 outside the box).
//
// K11, walk_backward_kernel, replaces XLA's transpose of the coefficient
// row gather (sdflib_tpu/diff/query.py:108) and the polynomial's VJP. It
// walks the point again rather than reading a descent saved by K10: the
// walk re-reads ~5 node words that sit in L2 (the d6 words are ~1 MB),
// where a saved (start, position, steps) would cost K10 20 B a point
// written and K11 20 B read, and every forward (the render's march, the
// queries that are never differentiated) would pay the writes. For an
// in-box point it adds w_j = gd m_j(f) + sum_a (gg_a / leaf) d_a m_j(f)
// into the coefficient gradient at the leaf's row; an out-of-box point
// adds 0 times its weights at the leaf it reaches from the nearest start
// cell, as JAX's transpose does, which is NaN where a weight is not
// finite (a NaN or infinite point) and 0 elsewhere. Fp32 atomics, four
// coefficients at once as sm_90's float4 atomicAdd on the aligned layout,
// one at a time at start + j on the other. With the point gradient it
// also reads the row: gd times the world gradient inside the box, gd times
// autograd's gradient of box_distance outside.
//
// K12, walk_march_kernel, replaces sdflib_tpu/render/sphere_trace.py
// sphere_trace (:251) as sdflib_tpu/diff/render.py (:65-68) calls it over
// octree_query_diff: a ray's march state stays in registers for all
// max_iters trips of ops/march.py _trip with the step max(d, 0) and K10's
// distance at each; a done ray leaves at once (as K5 does), so one launch
// carries the whole march. No free-cell steps: the flags are proven from
// coefficients that a fit changes.
//
// Bound: K10 and K11 by bytes moved once: the points in and the outputs
// out (16 B a point, 12 more for each gradient, in or out), and the node
// words and coefficient rows the points touch, which on path F's 2^22
// points are 2,941 rows that stay in L2 (K11 writes the whole gradient
// array once); their operations (~316 flops a K10 point) bound them about
// as closely. What holds a thread is the chain of ~5 dependent node loads
// and then its 256-B row from L2, so both run far above that bound. K11's
// atomics meet in L2 wherever points share a leaf (~1,400 points a row on
// path F), so they hold it further (a leaf-sorted reduction a row is the
// redesign). K12 by operations: ~310 flops a useful trip, every trip of a
// ray waiting on its own walk.
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

constexpr int kThreads = 256;

template <int kMode, int N>
__global__ void __launch_bounds__(kThreads)
walk_query_kernel(walk::Tree T, const float* __restrict__ points, int n,
                  float* __restrict__ d_out, float* __restrict__ g_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const walk::Box w = walk::load_box(T);
  const size_t o = 3 * static_cast<size_t>(i);
  const float p[3] = {points[o], points[o + 1], points[o + 2]};
  float g[3];
  d_out[i] = walk::query<kMode, N>(T, w, p, g);
  if (kMode != walk::kDistance) {
    g_out[o] = g[0];
    g_out[o + 1] = g[1];
    g_out[o + 2] = g[2];
  }
}

// torch's autograd of ops/box.py box_distance at p, times gd: the square
// root's backward gd / (2 outside), the square's 2 o, clamp_min's q >= 0;
// the maximum's gradient split over its ties, clamp_max's m <= 0; abs's
// sign (0 at 0 and at NaN).
__device__ __forceinline__ void box_vjp(const leaf::Box& b, const float p[3], float gd,
                                        float out[3]) {
  float x[3], q[3], o[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x[a] = p[a] - b.ctr[a];
    q[a] = fabsf(x[a]) - b.half[a];
    o[a] = leaf::nan_max(q[a], 0.0f);
  }
  const float outside = sqrtf((o[0] * o[0] + o[2] * o[2]) + o[1] * o[1]);
  const float go = gd / (2.0f * outside);
  const float m = leaf::nan_max(leaf::nan_max(q[0], q[1]), q[2]);
  const float gin = m <= 0.0f ? gd : 0.0f;
  const float ties = static_cast<float>((q[0] == m) + (q[1] == m) + (q[2] == m));
  const float share = gin / ties;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g_out = q[a] >= 0.0f ? go * (2.0f * o[a]) : 0.0f;
    const float g_in = q[a] == m ? share : 0.0f * share;
    const float sgn = x[a] > 0.0f ? 1.0f : (x[a] < 0.0f ? -1.0f : 0.0f);
    out[a] = (g_out + g_in) * sgn;
  }
}

// The coefficient weights of one point into its row (aligned: float4
// atomics; else scalar ones): gd m_j + ((gl_x dx m_j + gl_y dy m_j) +
// gl_z dz m_j), m_j the monomial (x_i y_j) z_k of index i + 4j + 16k
// (tricubic) or the corner weight of index i + 2j + 4k (trilinear).
template <int N, bool Grad>
__device__ __forceinline__ void add_weights(const walk::Tree& T, const walk::Reach& r,
                                            float gd, const float gl[3],
                                            float* __restrict__ grad) {
  constexpr int kN = N == 64 ? 4 : 2;  // terms an axis
  const float fx = r.f[0], fy = r.f[1], fz = r.f[2];
  float xv[kN], yv[kN], zv[kN], dxv[kN], dyv[kN], dzv[kN];
  if constexpr (N == 64) {
    const float px[4] = {1.0f, fx, fx * fx, fx * fx * fx};
    const float py[4] = {1.0f, fy, fy * fy, fy * fy * fy};
    const float pz[4] = {1.0f, fz, fz * fz, fz * fz * fz};
    const float qx[4] = {0.0f, 1.0f, 2.0f * fx, 3.0f * fx * fx};
    const float qy[4] = {0.0f, 1.0f, 2.0f * fy, 3.0f * fy * fy};
    const float qz[4] = {0.0f, 1.0f, 2.0f * fz, 3.0f * fz * fz};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xv[e] = px[e]; yv[e] = py[e]; zv[e] = pz[e];
      dxv[e] = qx[e]; dyv[e] = qy[e]; dzv[e] = qz[e];
    }
  } else {
    xv[0] = 1.0f - fx; xv[1] = fx;
    yv[0] = 1.0f - fy; yv[1] = fy;
    zv[0] = 1.0f - fz; zv[1] = fz;
    dxv[0] = dyv[0] = dzv[0] = -1.0f;
    dxv[1] = dyv[1] = dzv[1] = 1.0f;
  }
  float* row = grad + r.start;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    float wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 4 * q + e;
      const int i = m % kN, j = (m / kN) % kN, k = m / (kN * kN);
      const float xy = xv[i] * yv[j];
      float wt = gd * (xy * zv[k]);
      if (Grad) {
        wt = wt + ((gl[0] * ((dxv[i] * yv[j]) * zv[k]) + gl[1] * ((xv[i] * dyv[j]) * zv[k])) +
                   gl[2] * (xy * dzv[k]));
      }
      wv[e] = wt;
    }
    if (T.fast) {
      atomicAdd(reinterpret_cast<float4*>(row) + q, make_float4(wv[0], wv[1], wv[2], wv[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) atomicAdd(row + 4 * q + e, wv[e]);
    }
  }
}

// Whether a point lies within 2^31 start cells of the box's corner on
// every axis: then its position in the leaf stays in [0, 1), its weights
// are finite, and 0 times them (an out-of-box point's share) adds nothing.
__device__ __forceinline__ bool within_cells(const walk::Box& w, const float p[3]) {
  bool near = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    near = near && fabsf((p[a] - w.b.mn[a]) / w.cell[a]) < 2147483648.0f;
  }
  return near;
}

template <int N, bool Grad>
__global__ void __launch_bounds__(kThreads)
walk_backward_kernel(walk::Tree T, const float* __restrict__ points, int n,
                     const float* __restrict__ gd, const float* __restrict__ gg,
                     float* __restrict__ grad_c, float* __restrict__ grad_p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const walk::Box w = walk::load_box(T);
  const size_t o = 3 * static_cast<size_t>(i);
  const float p[3] = {points[o], points[o + 1], points[o + 2]};
  const float dv = gd[i];
  walk::Reach r;
  if (!walk::descend(T, w, p, r)) {
    if (grad_p != nullptr) {
      float g[3];
      box_vjp(w.b, p, dv, g);
      grad_p[o] = g[0];
      grad_p[o + 1] = g[1];
      grad_p[o + 2] = g[2];
    }
    if (grad_c != nullptr && !within_cells(w, p)) {
      // 0 times the weights at the leaf reached from the nearest start
      // cell: NaN where a weight is not finite (a NaN, infinite or far
      // point), as JAX's transpose adds it; nothing to add elsewhere
      walk::descend<true>(T, w, p, r);
      const float zero[3] = {0.0f, 0.0f, 0.0f};
      if (r.start >= 0) add_weights<N, Grad>(T, r, 0.0f, zero, grad_c);
    }
    return;
  }
  if (r.start < 0) {
    if (grad_p != nullptr) grad_p[o] = grad_p[o + 1] = grad_p[o + 2] = NAN;
    return;
  }
  const float e = walk::leaf_size(w, r);
  if (grad_c != nullptr) {
    float gl[3] = {0.0f, 0.0f, 0.0f};
    if (Grad) {
      gl[0] = gg[o] / e;
      gl[1] = gg[o + 1] / e;
      gl[2] = gg[o + 2] / e;
    }
    add_weights<N, Grad>(T, r, dv, gl, grad_c);
  }
  if (grad_p != nullptr) {
    const float4 v = walk::poly<true, N>(T, r);
    grad_p[o] = dv * (v.y / e);
    grad_p[o + 1] = dv * (v.z / e);
    grad_p[o + 2] = dv * (v.w / e);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
walk_march_kernel(walk::Tree T, const float* __restrict__ origins,
                  const float* __restrict__ dirs, int n, float eps, float far, int max_iters,
                  unsigned char* __restrict__ hit, float* __restrict__ pos,
                  float* __restrict__ depth, int* __restrict__ its) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const walk::Box w = walk::load_box(T);
  const size_t o = 3 * static_cast<size_t>(r);
  float p[3] = {origins[o], origins[o + 1], origins[o + 2]};
  const float u[3] = {dirs[o], dirs[o + 1], dirs[o + 2]};
  float ac = 0.0f, ld = INFINITY, a = 1.0f;
  int it = 0;
  for (int t = 0; t < max_iters && a > 0.0f; ++t) {
    float g[3];
    const float d = walk::query<walk::kDistance, N>(T, w, p, g);
    const float moved = leaf::nan_max(d, 0.0f) * a;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p[k] + u[k] * moved;
    ac = ac + moved;
    ld = d;
    it += 1;
    a = a * ((ld > eps && ac < far) ? 1.0f : 0.0f);
  }
  hit[r] = ld <= eps ? 1 : 0;
  pos[o] = p[0];
  pos[o + 1] = p[1];
  pos[o + 2] = p[2];
  depth[r] = ac;
  its[r] = it;
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <int N>
void launch_query(const walk::Tree& T, const float* points, int n, int mode, float* d,
                  float* g, cudaStream_t st) {
  switch (mode) {
    case walk::kDistance:
      walk_query_kernel<walk::kDistance, N><<<blocks(n), kThreads, 0, st>>>(T, points, n, d, g);
      break;
    case walk::kNormal:
      walk_query_kernel<walk::kNormal, N><<<blocks(n), kThreads, 0, st>>>(T, points, n, d, g);
      break;
    default:
      walk_query_kernel<walk::kWorld, N><<<blocks(n), kThreads, 0, st>>>(T, points, n, d, g);
  }
}

template <int N>
void launch_backward(const walk::Tree& T, const float* points, int n, const float* gd,
                     const float* gg, float* grad_c, float* grad_p, cudaStream_t st) {
  if (gg != nullptr) {
    walk_backward_kernel<N, true><<<blocks(n), kThreads, 0, st>>>(T, points, n, gd, gg,
                                                                  grad_c, grad_p);
  } else {
    walk_backward_kernel<N, false><<<blocks(n), kThreads, 0, st>>>(T, points, n, gd, gg,
                                                                   grad_c, grad_p);
  }
}

}  // namespace

// The walk's leading arguments (ops/walk.py walk_args): words, coeffs,
// num_words, start grid size, levels, tricubic, fast, box_min, box_size3,
// min_border.
#define SDF_WALK_PARAMS                                                                \
  const int *words, const float *coeffs, int num_words, int sgs, int levels, int tricubic, \
      int fast, const float *box_min, const float *box_size3, float min_border
#define SDF_WALK_TREE                                                                     \
  walk::Tree {                                                                            \
    words, coeffs, num_words, sgs, levels, tricubic, fast, box_min, box_size3, min_border \
  }

// mode: 0 distance, 1 normalised gradient, 2 world gradient (g_out (n, 3)).
extern "C" int sdf_walk_query(SDF_WALK_PARAMS, const float* points, int n, int mode,
                              float* d_out, float* g_out, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const walk::Tree T = SDF_WALK_TREE;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tricubic) {
      launch_query<64>(T, points, n, mode, d_out, g_out, st);
    } else {
      launch_query<8>(T, points, n, mode, d_out, g_out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// gd (n,); gg (n, 3) or null; grad_c (num_words,) zeroed, or null: no
// coefficient gradient; grad_p (n, 3) or null: no point gradient (gg null).
extern "C" int sdf_walk_backward(SDF_WALK_PARAMS, const float* points, int n, const float* gd,
                                 const float* gg, float* grad_c, float* grad_p, void* stream) {
  if (n > 0) {
    const walk::Tree T = SDF_WALK_TREE;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tricubic) {
      launch_backward<64>(T, points, n, gd, gg, grad_c, grad_p, st);
    } else {
      launch_backward<8>(T, points, n, gd, gg, grad_c, grad_p, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// hit (n,) bool, pos (n, 3), depth (n,), its (n,) int32.
extern "C" int sdf_walk_march(SDF_WALK_PARAMS, const float* origins, const float* dirs, int n,
                              float eps, float far, int max_iters, unsigned char* hit,
                              float* pos, float* depth, int* its, void* stream) {
  if (n > 0) {
    const walk::Tree T = SDF_WALK_TREE;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tricubic) {
      walk_march_kernel<64><<<blocks(n), kThreads, 0, st>>>(T, origins, dirs, n, eps, far,
                                                            max_iters, hit, pos, depth, its);
    } else {
      walk_march_kernel<8><<<blocks(n), kThreads, 0, st>>>(T, origins, dirs, n, eps, far,
                                                           max_iters, hit, pos, depth, its);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
