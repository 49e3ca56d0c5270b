// K10-K15: the approximate octree's walk over a given coefficient pointer,
// its backward, the generic march over it, and the sphere tracer's march
// and beam segments over it.
//
// K10, walk_query_kernel, replaces the JAX package's XLA-fused walk,
// sdflib_tpu/sdf/octree.py _octree_query (:56), and the forward of
// sdflib_tpu/diff/query.py octree_query_diff (:43); the torch copy
// (ops/walk.py walk_query_plain: _octree_walk, then _finish) ran ~10 eager
// kernels a level and kept its autograd graph. As K4 (octree_query.cu): a
// block stages its points in shared memory with coalesced loads, each lane
// walks its own point (walk.cuh descend), then the warp reads its 32
// points' coefficient rows kGroup lanes a row as contiguous float4 runs
// and sums each polynomial by shuffles in the one-thread order
// (leaf_eval.cuh tricubic_warp), so d is bit-equal to one thread's sum
// (K12's); d and g go back out through shared memory. Out-of-box points
// and points whose words name no row lend their lane and read nothing;
// the warp's rounds take only the lanes with a row, so a warp of sparse
// points (a render's ray ends, mostly outside the box) takes few rounds.
// The aligned tricubic layout takes the group read (8 lanes a row for the
// distance, 4 with a gradient, as K4); trilinear rows (32 B) and the
// word-by-word layout (rows at any word) keep the one-thread form, each
// thread reading its own row (group 1), unstaged.
// The mode finishes as the walk does: the distance; with the normalised
// gradient (the box gradient outside) as OctreeSdf queries return it; or
// with the diff query's world gradient, the polynomial's gradient times
// 2^steps / cell (0 outside the box).
//
// K11 replaces XLA's transpose of the coefficient row gather
// (sdflib_tpu/diff/query.py:108) and the polynomial's VJP. On the aligned
// layout it is a deterministic, leaf-sorted reduction with no atomics:
//  1. walk_key_kernel walks each point again (the ~5 node words sit in L2;
//     a descent saved by K10 would cost every forward its writes) and
//     writes the row it adds into, start / N, and its share: its position
//     in the leaf and gd (0 outside the box), and gg over the leaf's edge
//     (0 outside). An in-box point whose words name no row, and an
//     out-of-box point within 2^31 start cells of the box (its weights are
//     finite, times 0 they add nothing), take the key `rows`, one past the
//     last row. Any other out-of-box point (NaN, infinite, far) is keyed
//     with the row it reaches from the nearest start cell, where JAX's
//     transpose adds its 0 times NaN. With the point gradient it reads the
//     row too (tricubic: the group read, 4 lanes a row): gd times the world
//     gradient inside the box, gd times autograd's gradient of box_distance
//     outside.
//  2. ops/exact_query.py launch_leaf_sort sorts the keys, stable, in its
//     given-keys mode: sorted keys and the order.
//  3. walk_reduce_kernel takes 1,024 sorted points a block (kTile), staged
//     in shared memory with each point's share gathered through the order,
//     and sums each point's N weights w_j = gd m_j(f) + sum_a gl_a d_a
//     m_j(f) per row in sorted order: a run of 4 lanes (2 for trilinear
//     rows), each 4 float4s of the row (1), adds its 16 points (8) one
//     after the other, so a lane computes a point's powers once for 16
//     weights; a row that lies within a run is stored at once; the runs'
//     first and last pieces are added in run order, a float4 of the row a
//     thread; a row within the tile is stored, the first and last rows that
//     cross the tile's edges go to the tile's two partials;
//     walk_reduce_span_kernel adds a crossing
//     row's partials in tile order (its last tile found by a binary search
//     of the sorted keys) and stores it. Every sum's order is fixed by the
//     sorted order and by boundaries that depend on P alone, so the
//     gradient is the same bits from run to run, and a row is written once,
//     with plain stores, into the zeroed gradient. A hot row (a render's
//     10^5-10^6 hits on one leaf) spreads over P / 1,024 blocks and leaves
//     one thread of each of its lanes a P / 1,024-term sum of partials.
//     The reduction reads the key launch's shares through the order: on
//     path F's 2^22 points that took 0.2832 ms on an H100 against 0.3640-
//     0.3823 ms for walking each sorted point again (PERF.md).
// The word-by-word layout (a leaf at any word: rows may partly overlap)
// keeps walk_backward_kernel: one thread a point, scalar fp32 atomics at
// start + j, in an order that changes from run to run.
//
// K12 replaces sdflib_tpu/render/sphere_trace.py sphere_trace (:251) as
// sdflib_tpu/diff/render.py (:65-68) calls it over octree_query_diff: the
// trips of ops/march.py _trip with the step max(d, 0), every trip of every
// ray in one launch. No free-cell steps: the flags are proven from
// coefficients that a fit changes. walk_march_warps_kernel is persistent:
// as many blocks as the SMs hold at once, each lane a slot that holds one
// ray's march state in registers. A warp takes kMarchChunk rays at a time
// from a global counter (one atomicAdd a chunk; in 8 x 4 pixel tiles where
// the caller names the image's width, neighbouring rays marching alike)
// and, after every trip, hands the chunk's next rays to the lanes whose
// ray has left (a ballot; a lane's rank among them picks its ray). So its
// lanes stay busy until the rays run out, where a warp of one thread a ray
// lives as long as its longest ray (lane use 0.65 on path F's render).
// Each lane reads its own row and folds it a quad at a time in
// Tree<0, 32>'s order (leaf_eval.cuh tricubic_quads): the 64 coefficients
// are never live at once, so the kernel fits 64 registers and 4 blocks an
// SM (one thread a ray took 102, 2 blocks), which hides the trip's chain
// behind twice the warps. A group read (K10's) lost here: its shuffles
// cost more than the lines it saves. Each ray's arithmetic is
// walk_march_kernel's, operation for operation, and a ray's results go to
// its own index, so hit, pos, depth and its are bit-equal to the
// one-thread form whichever lane took the ray. walk_march_kernel, one
// thread a ray for all its trips, stays as the reference the tests and
// chip_smoke.py hold the persistent form against. Trilinear rows and the
// word-by-word layout march in the same warps with walk::query's read.
//
// K14 and K15 are the sphere tracer's walk route (a container with no
// query grid, or eps above the free cells' margin): K14, walk_segment_kernel,
// replaces _march_pyramid_jit's trips (sdflib_tpu/render/sphere_trace.py
// :411) over the walk's dist_fn (:304-311), and K15, walk_beam_kernel, the
// walk branch of _beam_prepass_jit (:541, :588-594). As K5 and K6 do on
// the grid (march.cu), a thread runs up to `trips` trips of its ray on the
// frame's state in place (position, distance so far, last distance, active
// flag, trips), a done ray leaving at once, so a launch carries a round's
// budget with no host check and a frame of such launches is one CUDA graph.
// The distance is K12's march_distance (the same bits as K10, whose eager
// trips they replace: ~10 launches and a host sync every 16 trips). K12's
// persistent warps were tried for K14 and lost to one thread a ray in the
// walk frame (PERF.md, K14).
//
// Bound: K10 by bytes moved once: the points in and the outputs out (16 B
// a point, 12 more with a gradient), and the node words and coefficient
// rows the points touch, which on path F's 2^22 points are 2,941 rows that
// stay in L2; its operations (~316 flops a point) bound it about as
// closely. What held the one-lane form was the L1's wavefronts: each lane's
// float4 loads of its own row touch a line for every lane of the warp; the
// group read touches each row's lines once a load. K11's key launch is
// bounded by the point, gd (and gg) in and the key and share out; the
// reduction by the sorted keys, the order and the shares in and the
// gradient out. K12 by operations: ~310 flops a useful trip (counted at
// the fused multiply-add rate, 67 TFLOP/s; built with --fmad=false every
// multiply and add issues alone, about twice the time); every trip of a
// ray waits on its own walk (three divisions, a dependent node word a
// level, then the row), so the card hides that chain only across many
// rays in flight: the persistent warps keep every lane's slot on a live
// ray, and the quad fold's registers let twice the warps in. K14 and K15
// likewise: ~310 flops a useful trip against the state read and written
// once (68 B a ray, 60 a beam) and the touched words and rows.
//
// Launches a backward on the aligned layout: the key launch, the
// gradient's zero fill, the leaf sort (a memset and 1 + passes launches: 2
// passes for path F's 3,800 rows) and the reduction's two launches; one
// launch and the fill on the word-by-word layout.
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // sorted points a block of the reduction (REDUCE_TILE)

// The staged points of a block: 3 * kThreads floats, coalesced.
__device__ __forceinline__ int stage_points(const float* __restrict__ points, int n,
                                            float* sp) {
  const int first = blockIdx.x * kThreads;  // < n
  const int here = min(kThreads, n - first);
  const float* __restrict__ in = points + 3 * static_cast<size_t>(first);
  for (int k = threadIdx.x; k < 3 * here; k += kThreads) sp[k] = in[k];
  __syncthreads();
  return here;
}

// Each lane's point's polynomial (value and unit-cube gradient) where it
// lies in the box and reaches a row (`row`), else zeros. kGroup > 1: the
// warp reads its points' aligned tricubic rows kGroup lanes a row; every
// lane of the warp calls it.
template <bool Grad, int N, int kGroup>
__device__ __forceinline__ float4 leaf_poly(const walk::Tree& T, const walk::Reach& r,
                                            bool row) {
  if constexpr (kGroup > 1) {
    const float4* base = row ? reinterpret_cast<const float4*>(T.coeffs + r.start) : nullptr;
    return leaf::tricubic_warp<Grad, kGroup, 0>(base, r.f);
  } else {
    return row ? walk::poly<Grad, N>(T, r) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <int kMode, int N, int kGroup>
__global__ void __launch_bounds__(kThreads)
walk_query_kernel(walk::Tree T, const float* __restrict__ points, int n,
                  float* __restrict__ d_out, float* __restrict__ g_out) {
  constexpr bool kGrad = kMode != walk::kDistance;
  if constexpr (kGroup == 1) {
    // one lane reads its own row, unstaged: staging made the block wait on
    // its slowest walk before any lane wrote, which only cost time
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const walk::Box w = walk::load_box(T);
    const size_t o = 3 * static_cast<size_t>(i);
    const float p[3] = {points[o], points[o + 1], points[o + 2]};
    float g[3];
    d_out[i] = walk::query<kMode, N>(T, w, p, g);
    if (kGrad) {
      g_out[o] = g[0];
      g_out[o + 1] = g[1];
      g_out[o + 2] = g[2];
    }
    return;
  }
  __shared__ float sp[3 * kThreads];
  __shared__ float sd[kThreads];
  __shared__ float sg[kGrad ? 3 * kThreads : 1];
  const int here = stage_points(points, n, sp);
  // every lane walks and reads: the group read's shuffles span the warp
  const int pt = threadIdx.x;
  const bool valid = pt < here;
  const walk::Box w = walk::load_box(T);
  const float p[3] = {valid ? sp[3 * pt] : 0.0f, valid ? sp[3 * pt + 1] : 0.0f,
                      valid ? sp[3 * pt + 2] : 0.0f};
  walk::Reach r;
  const bool in_box = walk::descend(T, w, p, r);
  const float4 v = leaf_poly<kGrad, N, kGroup>(T, r, valid && in_box && r.start >= 0);
  float g[3];
  const float d = walk::answer<kMode>(T, w, p, in_box, r, v, g);
  if (valid) {
    sd[pt] = d;
    if (kGrad) {
      sg[3 * pt] = g[0];
      sg[3 * pt + 1] = g[1];
      sg[3 * pt + 2] = g[2];
    }
  }
  __syncthreads();
  const int first = blockIdx.x * kThreads;
  for (int k = threadIdx.x; k < here; k += kThreads) d_out[first + k] = sd[k];
  if (kGrad) {
    float* __restrict__ out = g_out + 3 * static_cast<size_t>(first);
    for (int k = threadIdx.x; k < 3 * here; k += kThreads) out[k] = sg[k];
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

// The point gradient of one point from its descent and polynomial v: gd
// times the world gradient in the box, autograd's of box_distance outside,
// NaN where the words name no row.
__device__ __forceinline__ void point_grad(const walk::Box& w, const float p[3], bool in_box,
                                           const walk::Reach& r, float4 v, float dv,
                                           float g[3]) {
  if (!in_box) {
    box_vjp(w.b, p, dv, g);
  } else if (r.start < 0) {
    g[0] = g[1] = g[2] = NAN;
  } else {
    const float e = walk::leaf_size(w, r);
    g[0] = dv * (v.y / e);
    g[1] = dv * (v.z / e);
    g[2] = dv * (v.w / e);
  }
}

// K11's key of one point (the row it adds into, or `rows`: nothing) and
// its share: a = (position in the leaf, gd there), b = gg / the leaf's
// edge (0 outside the box); zeros for a keyless point. r and in_box are
// the point's descent; an out-of-box point that is keyed walks again from
// the nearest start cell.
template <int N, bool Grad>
__device__ __forceinline__ int key_share(const walk::Tree& T, const walk::Box& w,
                                         const float p[3], bool in_box, walk::Reach& r,
                                         float gd, const float gg[3], float4& a, float4& b) {
  const int rows = T.num_words / N;
  a = b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // a keyless point's share
  if (in_box) {
    if (r.start < 0) return rows;
    a = make_float4(r.f[0], r.f[1], r.f[2], gd);
    if (Grad) {
      const float e = walk::leaf_size(w, r);
      b = make_float4(gg[0] / e, gg[1] / e, gg[2] / e, 0.0f);
    }
    return r.start / N;
  }
  if (within_cells(w, p)) return rows;
  walk::descend<true>(T, w, p, r);
  if (r.start < 0) return rows;
  a = make_float4(r.f[0], r.f[1], r.f[2], 0.0f);
  return r.start / N;
}

// K11's key launch (the aligned layout): keys (n,) and shares (n, 1 or 2
// float4), or neither (keys null); with grad_p the point gradient.
template <int N, bool Grad, bool PointGrad>
__global__ void __launch_bounds__(kThreads)
walk_key_kernel(walk::Tree T, const float* __restrict__ points, int n,
                const float* __restrict__ gd, const float* __restrict__ gg,
                int* __restrict__ keys, float4* __restrict__ share,
                float* __restrict__ grad_p) {
  __shared__ float sp[3 * kThreads];
  __shared__ float sgg[Grad ? 3 * kThreads : 1];
  const int first = blockIdx.x * kThreads;
  if (Grad) {
    const int here = min(kThreads, n - first);
    const float* __restrict__ in = gg + 3 * static_cast<size_t>(first);
    for (int k = threadIdx.x; k < 3 * here; k += kThreads) sgg[k] = in[k];
  }
  const int here = stage_points(points, n, sp);
  const int pt = threadIdx.x;
  const bool valid = pt < here;
  const int i = first + pt;
  const walk::Box w = walk::load_box(T);
  const float p[3] = {valid ? sp[3 * pt] : 0.0f, valid ? sp[3 * pt + 1] : 0.0f,
                      valid ? sp[3 * pt + 2] : 0.0f};
  const float dv = valid ? gd[i] : 0.0f;
  walk::Reach r;
  const bool in_box = walk::descend(T, w, p, r);
  if constexpr (PointGrad) {
    const float4 v = leaf_poly<true, N, N == 64 ? 4 : 1>(T, r, valid && in_box && r.start >= 0);
    if (valid) {
      float g[3];
      point_grad(w, p, in_box, r, v, dv, g);
      const size_t o = 3 * static_cast<size_t>(i);
      grad_p[o] = g[0];
      grad_p[o + 1] = g[1];
      grad_p[o + 2] = g[2];
    }
  }
  if (keys == nullptr || !valid) return;
  const float g3[3] = {Grad ? sgg[3 * pt] : 0.0f, Grad ? sgg[3 * pt + 1] : 0.0f,
                       Grad ? sgg[3 * pt + 2] : 0.0f};
  float4 a, b;
  keys[i] = key_share<N, Grad>(T, w, p, in_box, r, dv, g3, a, b);
  share[(Grad ? 2 : 1) * static_cast<size_t>(i)] = a;
  if (Grad) share[2 * static_cast<size_t>(i) + 1] = b;
}

// The four weights of quad q (coefficients 4q..4q+3) of a point of share
// (a, b): gd m_j + ((gl_x dx m_j + gl_y dy m_j) + gl_z dz m_j), m_j the
// monomial (x_i y_j) z_k of index i + 4j + 16k (tricubic) or the corner
// weight of index i + 2j + 4k (trilinear), in ops/walk.py _weights' order.
template <int N, bool Grad>
__device__ __forceinline__ float4 quad_weights(int q, float4 a, float4 b) {
  const float fx = a.x, fy = a.y, fz = a.z, gd = a.w;
  float wv[4];
  if constexpr (N == 64) {
    const float xv[4] = {1.0f, fx, fx * fx, fx * fx * fx};
    const float yv[4] = {1.0f, fy, fy * fy, fy * fy * fy};
    const float zv[4] = {1.0f, fz, fz * fz, fz * fz * fz};
    const float dxv[4] = {0.0f, 1.0f, 2.0f * fx, 3.0f * fx * fx};
    const float dyv[4] = {0.0f, 1.0f, 2.0f * fy, 3.0f * fy * fy};
    const float dzv[4] = {0.0f, 1.0f, 2.0f * fz, 3.0f * fz * fz};
    const float y = leaf::pick4(yv, q & 3), dy = leaf::pick4(dyv, q & 3);
    const float z = leaf::pick4(zv, q >> 2), dz = leaf::pick4(dzv, q >> 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xy = xv[e] * y;
      float wt = gd * (xy * z);
      if (Grad) {
        wt = wt + ((b.x * ((dxv[e] * y) * z) + b.y * ((xv[e] * dy) * z)) + b.z * (xy * dz));
      }
      wv[e] = wt;
    }
  } else {
    const float xv[2] = {1.0f - fx, fx};
    const float yv[2] = {1.0f - fy, fy};
    const float dv[2] = {-1.0f, 1.0f};
    const float z = q ? fz : 1.0f - fz, dz = q ? 1.0f : -1.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e & 1, j = e >> 1;
      const float xy = xv[i] * yv[j];
      float wt = gd * (xy * z);
      if (Grad) {
        wt = wt + ((b.x * ((dv[i] * yv[j]) * z) + b.y * ((xv[i] * dv[j]) * z)) + b.z * (xy * dz));
      }
      wv[e] = wt;
    }
  }
  return make_float4(wv[0], wv[1], wv[2], wv[3]);
}

__device__ __forceinline__ void store_quad(float* __restrict__ out, int row, int N, int q,
                                           float4 v) {
  reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N)[q] = v;
}

// K11's reduction over kTile sorted points a block (see the header).
template <int N, bool Grad>
__global__ void __launch_bounds__(kThreads)
walk_reduce_kernel(walk::Tree T, const int* __restrict__ lid_s,
                   const long long* __restrict__ order, int P,
                   const float4* __restrict__ share, float* __restrict__ grad,
                   float* __restrict__ partial) {
  constexpr int kQ = N / 4;               // float4s of a row
  constexpr int kLanes = N == 64 ? 4 : 2; // lanes a run
  constexpr int kQL = kQ / kLanes;        // float4s of the row a lane: 4 or 1
  constexpr int kRuns = kThreads / kLanes;
  constexpr int kRun = kTile / kRuns;     // points a run: 16 or 8
  constexpr int kS = Grad ? 2 : 1;        // float4s of a share
  constexpr int kPer = kTile / kThreads;  // points a thread stages
  constexpr int kShare = kTile * kS, kPieces = 2 * kRuns * kQ;
  __shared__ int skey[kTile];
  __shared__ int srow[2][kRuns];          // each run's first and last rows, -1: none
  // the staged shares, then each run's first and last pieces
  __shared__ float4 sbuf[kShare > kPieces ? kShare : kPieces];
  const int rows = T.num_words / N;
  const int t = blockIdx.x;
  const int first = t * kTile;
  const int here = min(kTile, P - first);
  // stage: the keys, then the order, then the shares, each a batch of loads
  int key[kPer];
  long long at[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    key[j] = k < here ? lid_s[first + k] : rows;
    if (k < here) skey[k] = key[j];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    at[j] = key[j] < rows ? order[first + threadIdx.x + j * kThreads] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (key[j] >= rows) continue;
    const int k = threadIdx.x + j * kThreads;
    const long long i = at[j];
    sbuf[kS * k] = share[kS * i];
    if (Grad) sbuf[kS * k + 1] = share[kS * i + 1];
  }
  __syncthreads();
  // run `run`: its kLanes lanes add its points' weights in sorted order,
  // lane l the row's float4s kQL l .. kQL l + kQL - 1
  const int lane = threadIdx.x % kLanes, run = threadIdx.x / kLanes;
  const int lo = run * kRun, hi = min(lo + kRun, here);
  int cur = -1, head = -1;
  float4 acc[kQL], piece[kQL];
  for (int k = lo; k < hi; ++k) {
    const int kk = skey[k];
    if (kk >= rows) break;  // the keyless points sort last
    const float4 a = sbuf[kS * k];
    const float4 b = Grad ? sbuf[kS * k + 1] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 wv[kQL];
#pragma unroll
    for (int j = 0; j < kQL; ++j) wv[j] = quad_weights<N, Grad>(kQL * lane + j, a, b);
    if (kk == cur) {
#pragma unroll
      for (int j = 0; j < kQL; ++j) acc[j] = leaf::add4(acc[j], wv[j]);
      continue;
    }
    if (cur >= 0) {
      if (head < 0) {
        head = cur;
#pragma unroll
        for (int j = 0; j < kQL; ++j) piece[j] = acc[j];
      } else {
#pragma unroll
        for (int j = 0; j < kQL; ++j) store_quad(grad, cur, N, kQL * lane + j, acc[j]);
      }
    }
    cur = kk;
#pragma unroll
    for (int j = 0; j < kQL; ++j) acc[j] = wv[j];
  }
  __syncthreads();  // every share is read: their room takes the pieces
  float4(*spart)[kRuns][kQ] = reinterpret_cast<float4(*)[kRuns][kQ]>(sbuf);
#pragma unroll
  for (int j = 0; j < kQL; ++j) {
    if (head >= 0) {
      spart[0][run][kQL * lane + j] = piece[j];
      spart[1][run][kQL * lane + j] = acc[j];
    } else if (cur >= 0) {
      spart[0][run][kQL * lane + j] = acc[j];
    }
  }
  if (lane == 0) {
    srow[0][run] = head >= 0 ? head : cur;
    srow[1][run] = head >= 0 ? cur : -1;
  }
  __syncthreads();
  if (threadIdx.x >= kQ) return;
  // the runs' pieces in run order, a float4 of the row a thread; a row
  // within the tile is stored, the rows that cross its edges go to its
  // partials: [2t] the row that began before it, [2t + 1] the row that
  // goes on past it
  const int q = threadIdx.x;
  const int prev = first > 0 ? lid_s[first - 1] : -1;
  const int next = first + here < P ? lid_s[first + here] : -1;
  int row = -1;
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto flush = [&]() {
    if (row == prev) {
      store_quad(partial, 2 * t, N, q, sum);
    } else if (row == next) {
      store_quad(partial, 2 * t + 1, N, q, sum);
    } else {
      store_quad(grad, row, N, q, sum);
    }
  };
  for (int u = 0; u < kRuns; ++u) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int rr = srow[s][u];
      if (rr < 0) continue;
      const float4 v = spart[s][u][q];
      if (rr == row) {
        sum = leaf::add4(sum, v);
      } else {
        if (row >= 0) flush();
        row = rr;
        sum = v;
      }
    }
  }
  if (row >= 0) flush();
}

// The rows that cross tile edges: the tile where such a row begins adds
// its partial [2t + 1] and the next tiles' [2u] in tile order, and stores
// the row. kThreads / (N / 4) tiles a block.
template <int N>
__global__ void __launch_bounds__(kThreads)
walk_reduce_span_kernel(const int* __restrict__ lid_s, int P, int rows,
                        const float* __restrict__ partial, float* __restrict__ grad) {
  constexpr int kQ = N / 4;
  const int t = blockIdx.x * (kThreads / kQ) + threadIdx.x / kQ;
  const int q = threadIdx.x % kQ;
  if (static_cast<long long>(t + 1) * kTile >= P) return;  // the last tile's rows go on nowhere
  const int end = (t + 1) * kTile;  // the next tile's first point
  const int row = lid_s[end - 1];
  if (row >= rows || lid_s[end] != row) return;
  if (t > 0 && lid_s[t * kTile - 1] == row) return;  // it began in an earlier tile
  // the row's end: the first sorted key past it, by binary search
  int a = end, b = P;
  while (a < b) {
    const int m = a + (b - a) / 2;
    if (lid_s[m] <= row) a = m + 1; else b = m;
  }
  const int last = (a - 1) / kTile;
  const float4* pt = reinterpret_cast<const float4*>(partial);
  float4 sum = pt[(2 * t + 1) * kQ + q];
  for (int u = t + 1; u <= last; ++u) sum = leaf::add4(sum, pt[(2 * u) * kQ + q]);
  store_quad(grad, row, N, q, sum);
}

// The coefficient weights of one point into its row by scalar atomics at
// start + j (the word-by-word layout): gd m_j + ((gl_x dx m_j + gl_y dy
// m_j) + gl_z dz m_j).
template <int N, bool Grad>
__device__ __forceinline__ void add_weights(const walk::Reach& r, float gd, const float gl[3],
                                            float* __restrict__ grad) {
  const float4 a = make_float4(r.f[0], r.f[1], r.f[2], gd);
  const float4 b = make_float4(gl[0], gl[1], gl[2], 0.0f);
  float* row = grad + r.start;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 wv = quad_weights<N, Grad>(q, a, b);
    atomicAdd(row + 4 * q, wv.x);
    atomicAdd(row + 4 * q + 1, wv.y);
    atomicAdd(row + 4 * q + 2, wv.z);
    atomicAdd(row + 4 * q + 3, wv.w);
  }
}

// K11 on the word-by-word layout, one thread a point.
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
  const bool in_box = walk::descend(T, w, p, r);
  if (grad_p != nullptr) {
    const float4 v = in_box && r.start >= 0 ? walk::poly<true, N>(T, r)
                                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float g[3];
    point_grad(w, p, in_box, r, v, dv, g);
    grad_p[o] = g[0];
    grad_p[o + 1] = g[1];
    grad_p[o + 2] = g[2];
  }
  if (grad_c == nullptr) return;
  // the key is unused: a row may start at any word; what the point adds,
  // where key_share leaves a row to add into (start >= 0)
  const float g3[3] = {Grad ? gg[o] : 0.0f, Grad ? gg[o + 1] : 0.0f, Grad ? gg[o + 2] : 0.0f};
  float4 a, b;
  key_share<N, Grad>(T, w, p, in_box, r, dv, g3, a, b);
  if (r.start >= 0) {
    const float gl[3] = {b.x, b.y, b.z};
    add_weights<N, Grad>(r, a.w, gl, grad_c);
  }
}

// K12's state of one ray: its position, direction, depth so far, last
// distance, 1 while it marches (0 once done), trips taken.
struct Ray {
  float p[3], u[3];
  float ac, ld, a;
  int it;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origins,
                                        const float* __restrict__ dirs, int r) {
  const size_t o = 3 * static_cast<size_t>(r);
  Ray s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.p[k] = origins[o + k];
    s.u[k] = dirs[o + k];
  }
  s.ac = 0.0f;
  s.ld = INFINITY;
  s.a = 1.0f;
  s.it = 0;
  return s;
}

// One trip's step from the walk's distance d at the ray's position.
__device__ __forceinline__ void march_step(Ray& s, float d, float eps, float far) {
  const float moved = leaf::nan_max(d, 0.0f) * s.a;
#pragma unroll
  for (int k = 0; k < 3; ++k) s.p[k] = s.p[k] + s.u[k] * moved;
  s.ac = s.ac + moved;
  s.ld = d;
  s.it += 1;
  s.a = s.a * ((s.ld > eps && s.ac < far) ? 1.0f : 0.0f);
}

// Whether the ray takes another trip.
__device__ __forceinline__ bool marching(const Ray& s, int max_iters) {
  return s.it < max_iters && s.a > 0.0f;
}

__device__ __forceinline__ void march_out(const Ray& s, int r, float eps,
                                          unsigned char* __restrict__ hit,
                                          float* __restrict__ pos, float* __restrict__ depth,
                                          int* __restrict__ its) {
  const size_t o = 3 * static_cast<size_t>(r);
  hit[r] = s.ld <= eps ? 1 : 0;
  pos[o] = s.p[0];
  pos[o + 1] = s.p[1];
  pos[o + 2] = s.p[2];
  depth[r] = s.ac;
  its[r] = s.it;
}

// K12 one thread a ray, for all its trips: the reference form.
template <int N>
__global__ void __launch_bounds__(kThreads)
walk_march_kernel(walk::Tree T, const float* __restrict__ origins,
                  const float* __restrict__ dirs, int n, float eps, float far, int max_iters,
                  unsigned char* __restrict__ hit, float* __restrict__ pos,
                  float* __restrict__ depth, int* __restrict__ its) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const walk::Box w = walk::load_box(T);
  Ray s = load_ray(origins, dirs, r);
  while (marching(s, max_iters)) {
    float g[3];
    march_step(s, walk::query<walk::kDistance, N>(T, w, s.p, g), eps, far);
  }
  march_out(s, r, eps, hit, pos, depth, its);
}

constexpr int kMarchChunk = 32;     // rays a warp takes from the counter at once
constexpr int kMarchMinBlocks = 4;  // blocks an SM holds at once (64 registers)

// The walk's distance at a ray's position. kQuads: one lane folds its
// aligned tricubic row a quad at a time; else walk::query's c[N].
template <int N, bool kQuads>
__device__ __forceinline__ float march_distance(const walk::Tree& T, const walk::Box& w,
                                                const float p[3]) {
  float g[3];
  if constexpr (kQuads) {
    walk::Reach r;
    const bool in_box = walk::descend(T, w, p, r);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in_box && r.start >= 0) {
      v = leaf::tricubic_quads<false>(reinterpret_cast<const float4*>(T.coeffs + r.start), r.f);
    }
    return walk::answer<walk::kDistance>(T, w, p, in_box, r, v, g);
  } else {
    return walk::query<walk::kDistance, N>(T, w, p, g);
  }
}

// The ray of the counter's k-th fetch: k itself, or with width > 0 (the
// rays a width x height image, width % 8 == 0, height % 4 == 0) the rays
// of its 8 x 4 pixel tiles in turn, so a chunk of 32 is one tile.
__device__ __forceinline__ int ray_at(unsigned k, int width) {
  if (width <= 0) return static_cast<int>(k);
  const unsigned tile = k >> 5, e = k & 31u, across = static_cast<unsigned>(width) / 8u;
  return static_cast<int>(((tile / across) * 4u + (e >> 3)) * static_cast<unsigned>(width) +
                          (tile % across) * 8u + (e & 7u));
}

// K12, persistent warps (see the header): every lane of every warp runs the
// loop to its end (the ballots span the warp). counter: the rays handed
// out so far, zeroed before the launch; stats, or null: adds the warps'
// trips (each a trip of all 32 slots).
template <int N, bool kQuads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
walk_march_warps_kernel(walk::Tree T, const float* __restrict__ origins,
                        const float* __restrict__ dirs, int n, int width, float eps, float far,
                        int max_iters, unsigned char* __restrict__ hit, float* __restrict__ pos,
                        float* __restrict__ depth, int* __restrict__ its,
                        unsigned* __restrict__ counter, unsigned long long* __restrict__ stats) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const walk::Box w = walk::load_box(T);
  int ray = -1;  // the lane's ray; -1: none
  Ray s{};
  unsigned next = 0, end = 0;  // the warp's fetches not yet handed out
  bool more = true;            // whether the counter may hold rays still
  unsigned long long trips = 0;
  while (true) {
    // the lanes without a ray take the chunk's next rays, in lane order
    unsigned idle = __ballot_sync(leaf::kFullMask, ray < 0);
    while (idle != 0u && more) {
      if (next == end) {
        unsigned first = 0;
        if (lane == 0) first = atomicAdd(counter, static_cast<unsigned>(kMarchChunk));
        first = __shfl_sync(leaf::kFullMask, first, 0);
        if (first >= static_cast<unsigned>(n)) {
          more = false;
          break;
        }
        next = first;
        end = min(first + kMarchChunk, static_cast<unsigned>(n));
      }
      const unsigned take = min(static_cast<unsigned>(__popc(idle)), end - next);
      const unsigned rank = __popc(idle & below);
      if (ray < 0 && rank < take) {
        ray = ray_at(next + rank, width);
        s = load_ray(origins, dirs, ray);
        if (!marching(s, max_iters)) {  // max_iters <= 0: no trip
          march_out(s, ray, eps, hit, pos, depth, its);
          ray = -1;
        }
      }
      next += take;
      idle = __ballot_sync(leaf::kFullMask, ray < 0);
    }
    if (__ballot_sync(leaf::kFullMask, ray >= 0) == 0u) break;  // no ray left
    ++trips;
    if (ray >= 0) {
      march_step(s, march_distance<N, kQuads>(T, w, s.p), eps, far);
      if (!marching(s, max_iters)) {
        march_out(s, ray, eps, hit, pos, depth, its);
        ray = -1;
      }
    }
  }
  if (stats != nullptr && lane == 0) atomicAdd(stats, trips);
}

// K14's and K15's ray state, read from and written back to the frame's
// arrays at index r.
__device__ __forceinline__ Ray load_state(const float* __restrict__ pos,
                                          const float* __restrict__ acc,
                                          const float* __restrict__ last_d, float a,
                                          const int* __restrict__ its,
                                          const float* __restrict__ dirs, int r) {
  const size_t o = 3 * static_cast<size_t>(r);
  Ray s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.p[k] = pos[o + k];
    s.u[k] = dirs[o + k];
  }
  s.ac = acc[r];
  s.ld = last_d[r];
  s.a = a;
  s.it = its[r];
  return s;
}

__device__ __forceinline__ void store_state(const Ray& s, int r, float* __restrict__ pos,
                                            float* __restrict__ acc,
                                            float* __restrict__ last_d,
                                            float* __restrict__ active, int* __restrict__ its) {
  const size_t o = 3 * static_cast<size_t>(r);
  pos[o] = s.p[0];
  pos[o + 1] = s.p[1];
  pos[o + 2] = s.p[2];
  acc[r] = s.ac;
  last_d[r] = s.ld;
  active[r] = s.a;
  its[r] = s.it;
}

// K14, one thread a ray: up to `trips` march trips of its ray in place. A
// ray inactive at a trip leaves: the torch trip moves it by step * 0 and
// keeps its state.
template <int N, bool kQuads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
walk_segment_kernel(walk::Tree T, float* __restrict__ pos, float* __restrict__ acc,
                    float* __restrict__ last_d, float* __restrict__ active,
                    int* __restrict__ its, const float* __restrict__ dirs, int n, float eps,
                    float far, int trips) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float a = active[r];
  if (!(a > 0.0f)) return;
  const walk::Box w = walk::load_box(T);
  Ray s = load_state(pos, acc, last_d, a, its, dirs, r);
  for (int t = 0; t < trips && s.a > 0.0f; ++t) {
    march_step(s, march_distance<N, kQuads>(T, w, s.p), eps, far);
  }
  store_state(s, r, pos, acc, last_d, active, its);
}

// K15, one thread a beam: up to `trips` beam trips in place, K6's
// beam_kernel (march.cu) over the walk's distance. The walk proves no cell
// free, so the tube-safe exit step is -inf and the step, max(dstep, -inf),
// is dstep itself (a NaN kept, as torch.maximum keeps it).
template <int N, bool kQuads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
walk_beam_kernel(walk::Tree T, float* __restrict__ pos, float* __restrict__ acc,
                 float* __restrict__ active, const float* __restrict__ dirs,
                 const float* __restrict__ r0, const float* __restrict__ rd, int n, float margin,
                 float half_margin, float far, int trips) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  float a = active[r];
  if (!(a > 0.0f)) return;
  const walk::Box w = walk::load_box(T);
  const size_t o = 3 * static_cast<size_t>(r);
  float p[3] = {pos[o], pos[o + 1], pos[o + 2]};
  const float u[3] = {dirs[o], dirs[o + 1], dirs[o + 2]};
  const float rr0 = r0[r], grow = rd[r];
  float ac = acc[r];
  for (int t = 0; t < trips && a > 0.0f; ++t) {
    const float radius = rr0 + ac * grow;
    const float d = march_distance<N, kQuads>(T, w, p);
    const float step = leaf::nan_max(((d - radius) - margin) / (1.0f + grow), 0.0f);
    const float moved = step * a;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p[k] + u[k] * moved;
    ac = ac + moved;
    a = a * ((step > half_margin && ac < far) ? 1.0f : 0.0f);
  }
  pos[o] = p[0];
  pos[o + 1] = p[1];
  pos[o + 2] = p[2];
  acc[r] = ac;
  active[r] = a;
}

inline int blocks(long long n, int per) { return static_cast<int>((n + per - 1) / per); }

// The persistent march: the counter's fill, then as many blocks as the
// card holds at once (at most one lane a ray).
template <int N, bool kQuads, int kMinBlocks>
cudaError_t launch_march_warps(const walk::Tree& T, const float* origins, const float* dirs,
                               int n, int width, float eps, float far, int max_iters,
                               unsigned char* hit, float* pos, float* depth, int* its,
                               unsigned* counter, unsigned long long* stats, cudaStream_t st) {
  constexpr int kCards = 64;
  static int slots[kCards];  // blocks the card holds at once, by card
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int resident = dev < kCards ? slots[dev] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, walk_march_warps_kernel<N, kQuads, kMinBlocks>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
    if (dev < kCards) slots[dev] = resident;
  }
  const int nb = blocks(n, kThreads) < resident ? blocks(n, kThreads) : resident;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  walk_march_warps_kernel<N, kQuads, kMinBlocks><<<nb, kThreads, 0, st>>>(
      T, origins, dirs, n, width, eps, far, max_iters, hit, pos, depth, its, counter, stats);
  return cudaGetLastError();
}

template <int N, bool kQuads, int kMinBlocks>
cudaError_t launch_segment(const walk::Tree& T, float* pos, float* acc, float* last_d,
                           float* active, int* its, const float* dirs, int n, float eps,
                           float far, int trips, cudaStream_t st) {
  walk_segment_kernel<N, kQuads, kMinBlocks><<<blocks(n, kThreads), kThreads, 0, st>>>(
      T, pos, acc, last_d, active, its, dirs, n, eps, far, trips);
  return cudaGetLastError();
}

template <int N, bool kQuads, int kMinBlocks>
cudaError_t launch_beam(const walk::Tree& T, float* pos, float* acc, float* active,
                        const float* dirs, const float* r0, const float* rd, int n, float margin,
                        float half_margin, float far, int trips, cudaStream_t st) {
  walk_beam_kernel<N, kQuads, kMinBlocks><<<blocks(n, kThreads), kThreads, 0, st>>>(
      T, pos, acc, active, dirs, r0, rd, n, margin, half_margin, far, trips);
  return cudaGetLastError();
}

template <int kMode, int N>
void launch_query_mode(const walk::Tree& T, const float* points, int n, int group, float* d,
                       float* g, cudaStream_t st) {
  const int nb = blocks(n, kThreads);
  if constexpr (N == 64) {
    if (T.fast && group == 8) {
      walk_query_kernel<kMode, N, 8><<<nb, kThreads, 0, st>>>(T, points, n, d, g);
      return;
    }
    if (T.fast && group == 4) {
      walk_query_kernel<kMode, N, 4><<<nb, kThreads, 0, st>>>(T, points, n, d, g);
      return;
    }
  }
  walk_query_kernel<kMode, N, 1><<<nb, kThreads, 0, st>>>(T, points, n, d, g);
}

template <int N>
void launch_query(const walk::Tree& T, const float* points, int n, int mode, int group,
                  float* d, float* g, cudaStream_t st) {
  switch (mode) {
    case walk::kDistance:
      launch_query_mode<walk::kDistance, N>(T, points, n, group, d, g, st);
      break;
    case walk::kNormal:
      launch_query_mode<walk::kNormal, N>(T, points, n, group, d, g, st);
      break;
    default:
      launch_query_mode<walk::kWorld, N>(T, points, n, group, d, g, st);
  }
}

template <int N, bool Grad>
void launch_keys_gg(const walk::Tree& T, const float* points, int n, const float* gd,
                    const float* gg, int* keys, float* share, float* grad_p, cudaStream_t st) {
  float4* sh = reinterpret_cast<float4*>(share);
  if (grad_p != nullptr) {
    walk_key_kernel<N, Grad, true><<<blocks(n, kThreads), kThreads, 0, st>>>(
        T, points, n, gd, gg, keys, sh, grad_p);
  } else {
    walk_key_kernel<N, Grad, false><<<blocks(n, kThreads), kThreads, 0, st>>>(
        T, points, n, gd, gg, keys, sh, grad_p);
  }
}

template <int N>
void launch_keys(const walk::Tree& T, const float* points, int n, const float* gd,
                 const float* gg, int* keys, float* share, float* grad_p, cudaStream_t st) {
  if (gg != nullptr) {
    launch_keys_gg<N, true>(T, points, n, gd, gg, keys, share, grad_p, st);
  } else {
    launch_keys_gg<N, false>(T, points, n, gd, gg, keys, share, grad_p, st);
  }
}

template <int N, bool Grad>
void launch_reduce_gg(const walk::Tree& T, const int* lid_s, const long long* order, int P,
                      const float* share, float* grad, float* partial, cudaStream_t st) {
  const int tiles = blocks(P, kTile);
  walk_reduce_kernel<N, Grad><<<tiles, kThreads, 0, st>>>(
      T, lid_s, order, P, reinterpret_cast<const float4*>(share), grad, partial);
  walk_reduce_span_kernel<N><<<blocks(tiles, kThreads / (N / 4)), kThreads, 0, st>>>(
      lid_s, P, T.num_words / N, partial, grad);
}

template <int N>
void launch_reduce(const walk::Tree& T, const int* lid_s, const long long* order, int P,
                   const float* share, int with_gg, float* grad, float* partial,
                   cudaStream_t st) {
  if (with_gg) {
    launch_reduce_gg<N, true>(T, lid_s, order, P, share, grad, partial, st);
  } else {
    launch_reduce_gg<N, false>(T, lid_s, order, P, share, grad, partial, st);
  }
}

template <int N>
void launch_backward(const walk::Tree& T, const float* points, int n, const float* gd,
                     const float* gg, float* grad_c, float* grad_p, cudaStream_t st) {
  if (gg != nullptr) {
    walk_backward_kernel<N, true><<<blocks(n, kThreads), kThreads, 0, st>>>(
        T, points, n, gd, gg, grad_c, grad_p);
  } else {
    walk_backward_kernel<N, false><<<blocks(n, kThreads), kThreads, 0, st>>>(
        T, points, n, gd, gg, grad_c, grad_p);
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

// mode: 0 distance, 1 normalised gradient, 2 world gradient (g_out (n, 3));
// group: the lanes that read an aligned tricubic row, 1, 4 or 8 (other
// rows: 1).
extern "C" int sdf_walk_query(SDF_WALK_PARAMS, const float* points, int n, int mode,
                              int group, float* d_out, float* g_out, void* stream) {
  if (mode < 0 || mode > 2 || (group != 1 && group != 4 && group != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const walk::Tree T = SDF_WALK_TREE;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tricubic) {
      launch_query<64>(T, points, n, mode, group, d_out, g_out, st);
    } else {
      launch_query<8>(T, points, n, mode, group, d_out, g_out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K11's key launch, the aligned layout only: gd (n,); gg (n, 3) or null;
// keys (n,) int32 and share (n, 4, or 8 with gg), or both null (no
// coefficient gradient); grad_p (n, 3) or null (gg null).
extern "C" int sdf_walk_keys(SDF_WALK_PARAMS, const float* points, int n, const float* gd,
                             const float* gg, int* keys, float* share, float* grad_p,
                             void* stream) {
  if (!fast || (keys == nullptr) != (share == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const walk::Tree T = SDF_WALK_TREE;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tricubic) {
      launch_keys<64>(T, points, n, gd, gg, keys, share, grad_p, st);
    } else {
      launch_keys<8>(T, points, n, gd, gg, keys, share, grad_p, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K11's reduction, the aligned layout only: lid_s (P,) int32 sorted keys,
// order (P,) int64; share as the key launch wrote it, with_gg whether it
// holds gg. grad_c (num_words,) zeroed; partial 2 * tiles * N floats.
extern "C" int sdf_walk_reduce(SDF_WALK_PARAMS, const int* lid_s, const long long* order,
                               int P, const float* share, int with_gg, float* grad_c,
                               float* partial, void* stream) {
  if (!fast || share == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    const walk::Tree T = SDF_WALK_TREE;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tricubic) {
      launch_reduce<64>(T, lid_s, order, P, share, with_gg, grad_c, partial, st);
    } else {
      launch_reduce<8>(T, lid_s, order, P, share, with_gg, grad_c, partial, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K11 on the word-by-word layout: gd (n,); gg (n, 3) or null; grad_c
// (num_words,) zeroed, or null: no coefficient gradient; grad_p (n, 3) or
// null: no point gradient (gg null).
extern "C" int sdf_walk_backward(SDF_WALK_PARAMS, const float* points, int n, const float* gd,
                                 const float* gg, float* grad_c, float* grad_p, void* stream) {
  if (fast) return static_cast<int>(cudaErrorInvalidValue);
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

// hit (n,) bool, pos (n, 3), depth (n,), its (n,) int32. width: 0, or the
// rays are an image width rays a row (width % 8 == 0, rows % 4 == 0),
// handed out in 8 x 4 tiles. form 0: the persistent warps (counter: one
// uint32 of scratch, zeroed here; stats: one uint64 the warps' trips are
// added to, or null); 1: one thread a ray, the reference (width, counter
// and stats unused).
extern "C" int sdf_walk_march(SDF_WALK_PARAMS, const float* origins, const float* dirs, int n,
                              int width, float eps, float far, int max_iters, int form,
                              unsigned char* hit, float* pos, float* depth, int* its,
                              unsigned* counter, unsigned long long* stats, void* stream) {
  const bool tiles_ok = width == 0 || (width > 0 && width % 8 == 0 && n % width == 0 &&
                                       (n / width) % 4 == 0);
  if ((form != 0 && form != 1) || (form == 0 && counter == nullptr) || !tiles_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const walk::Tree T = SDF_WALK_TREE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (tricubic) {
      walk_march_kernel<64><<<blocks(n, kThreads), kThreads, 0, st>>>(
          T, origins, dirs, n, eps, far, max_iters, hit, pos, depth, its);
    } else {
      walk_march_kernel<8><<<blocks(n, kThreads), kThreads, 0, st>>>(
          T, origins, dirs, n, eps, far, max_iters, hit, pos, depth, its);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // the aligned tricubic rows fold a quad at a time; the other layouts
  // (trilinear rows, 48 registers; rows at any word) read c[N]
  const cudaError_t err =
      !tricubic ? launch_march_warps<8, false, 1>(T, origins, dirs, n, width, eps, far, max_iters,
                                                  hit, pos, depth, its, counter, stats, st)
      : fast    ? launch_march_warps<64, true, kMarchMinBlocks>(T, origins, dirs, n, width, eps,
                                                                far, max_iters, hit, pos, depth,
                                                                its, counter, stats, st)
                : launch_march_warps<64, false, 1>(T, origins, dirs, n, width, eps, far,
                                                   max_iters, hit, pos, depth, its, counter,
                                                   stats, st);
  return static_cast<int>(err);
}

// K14: up to `trips` march trips of each of the n rays, in place, one
// thread a ray: pos (n, 3), acc, last_d, active (float 0/1) (n,), its (n,)
// int32 trips taken, dirs (n, 3).
extern "C" int sdf_walk_segment(SDF_WALK_PARAMS, float* pos, float* acc, float* last_d,
                                float* active, int* its, const float* dirs, int n, float eps,
                                float far, int trips, void* stream) {
  if (n <= 0 || trips <= 0) return static_cast<int>(cudaGetLastError());
  const walk::Tree T = SDF_WALK_TREE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // K12's instances: the aligned tricubic rows fold a quad at a time in 64
  // registers; trilinear rows and rows at any word read c[N]
  const cudaError_t err =
      !tricubic ? launch_segment<8, false, 1>(T, pos, acc, last_d, active, its, dirs, n, eps,
                                              far, trips, st)
      : fast    ? launch_segment<64, true, kMarchMinBlocks>(T, pos, acc, last_d, active, its,
                                                            dirs, n, eps, far, trips, st)
                : launch_segment<64, false, 1>(T, pos, acc, last_d, active, its, dirs, n, eps,
                                               far, trips, st);
  return static_cast<int>(err);
}

// K15: up to `trips` beam trips of each of the n beams, in place: pos (n,
// 3), acc, active (float 0/1) (n,), dirs (n, 3), the radius at the origin
// r0 and its growth rd (n,).
extern "C" int sdf_walk_beam(SDF_WALK_PARAMS, float* pos, float* acc, float* active,
                             const float* dirs, const float* r0, const float* rd, int n,
                             float margin, float half_margin, float far, int trips,
                             void* stream) {
  if (n <= 0 || trips <= 0) return static_cast<int>(cudaGetLastError());
  const walk::Tree T = SDF_WALK_TREE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !tricubic ? launch_beam<8, false, 1>(T, pos, acc, active, dirs, r0, rd, n, margin,
                                           half_margin, far, trips, st)
      : fast    ? launch_beam<64, true, kMarchMinBlocks>(T, pos, acc, active, dirs, r0, rd, n,
                                                         margin, half_margin, far, trips, st)
                : launch_beam<64, false, 1>(T, pos, acc, active, dirs, r0, rd, n, margin,
                                            half_margin, far, trips, st);
  return static_cast<int>(err);
}
