// The approximate octree's walk (OctreeSdf.cpp:93-152) over a given
// coefficient pointer, one thread a point, shared by K10-K12
// (octree_walk.cu): the start-grid cell, up to `levels` descents, the
// reached leaf's coefficients and the polynomial there. K10 reads the rows
// of its points a group of lanes a row (leaf_eval.cuh tricubic_warp) and
// finishes with `answer`; K12 reads its own row (`query`), with the same
// sums, so the two agree bit for bit.
//
// The torch version is ops/walk.py _descend and _octree_walk. Every
// expression keeps its operand order and the library builds with
// --fmad=false, so the descent (cells, children, positions, steps) agrees
// bit for bit; the leaf polynomial is leaf_eval.cuh's one-thread sum, whose
// order differs from torch's CPU reduction by a few ulps.
//
// The point's in-box test comes from float comparisons of the floored
// position: CUDA's float-to-int conversion gives 0 for NaN where torch's
// CPU one gives INT_MIN, so a NaN point would otherwise walk cell 0 and
// read a finite distance where the plain version reads NaN. Outside the
// box (K11's walk of a non-finite point) the start cell's offset is
// converted as XLA converts it, saturating at +-2^31 and NaN to 0, in
// float arithmetic, so the walk reaches the JAX package's leaf on any
// device.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "leaf_eval.cuh"

namespace walk {

// What the walk reads.
struct Tree {
  const int* words;        // (W,) int32 octree words (leaf bit = sign)
  const float* coeffs;     // (W,) float32 coefficients: the words' float view
                           // or a trainable tensor of the same length
  int num_words;           // W
  int sgs;                 // start grid size s (s^3 words first, z-major)
  int levels;              // descents at most below the start grid
  int tricubic;            // 1: 64 coefficients; 0: trilinear, 8
  int fast;                // aligned layout: node rows of 8 words,
                           // coefficient rows of num_coeff words
  const float* box_min;    // (3,) on the device
  const float* box_size3;  // (3,) on the device
  float min_border;        // min_border_value, added to the box fallback
};

// The box's constants, read once a thread: leaf_eval's box (for the box
// fallback) and the start grid's cell, box_size3 / s.
struct Box {
  leaf::Box b;
  float cell[3];
};

__device__ __forceinline__ Box load_box(const Tree& T) {
  Box w;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w.b.mn[a] = T.box_min[a];
    w.b.sz[a] = T.box_size3[a];
    w.b.half[a] = 0.5f * w.b.sz[a];
    w.b.ctr[a] = w.b.mn[a] + w.b.half[a];
    w.cell[a] = w.b.sz[a] / static_cast<float>(T.sgs);
  }
  w.b.cell = w.cell[0];
  return w;
}

// Where a point's descent ended.
struct Reach {
  int start;   // the leaf's first coefficient word; -1: the words name a
               // node or a row past the octree's end (the answer is NaN)
  int steps;   // descents below the start grid
  float f[3];  // the position in the leaf, in [0, 1)
};

// The descent of one point (_descend): whether it lies in the box. Outside
// it r holds nothing, unless kOutside walks it from the start cell nearest
// to it (what K11 needs of a point whose weights may be NaN). A node word
// reads as its child (>= 0.5 an axis) until a leaf word (sign bit) or
// `levels` descents; the position doubles and keeps its fraction at each.
// The aligned layout reads the child within its 8-word row (one 32-byte
// sector, as the row read of the torch version touches), the other layout
// at base + child.
template <bool kOutside = false>
__device__ __forceinline__ bool descend(const Tree& T, const Box& w, const float p[3],
                                        Reach& r) {
  int ic[3];
  bool in_box = true;
  const float top = static_cast<float>(T.sgs - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t = (p[a] - w.b.mn[a]) / w.cell[a];
    const float fl = floorf(t);
    in_box = in_box && fl >= 0.0f && fl < static_cast<float>(T.sgs);
    if (kOutside) {
      const float ip = fl != fl ? 0.0f : fminf(fmaxf(fl, -2147483648.0f), 2147483648.0f);
      r.f[a] = t - ip;
      ic[a] = static_cast<int>(fminf(fmaxf(ip, 0.0f), top));
    } else {
      r.f[a] = t - fl;
      ic[a] = in_box ? static_cast<int>(fl) : 0;
    }
  }
  r.start = -1;
  r.steps = 0;
  if (!in_box && !kOutside) return false;
  const int s = T.sgs;
  int word = __ldg(T.words + (ic[2] * s + ic[1]) * s + ic[0]);
  for (int l = 0; l < T.levels && word >= 0; ++l) {
    const int child = ((r.f[2] >= 0.5f ? 1 : 0) << 2) + ((r.f[1] >= 0.5f ? 1 : 0) << 1) +
                      (r.f[0] >= 0.5f ? 1 : 0);
    const int base = word & leaf::kIndexMask;
    const int at = T.fast ? ((base >> 3) << 3) + child : base + child;
    if (at >= T.num_words) return in_box;
    word = __ldg(T.words + at);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = 2.0f * r.f[a];
      r.f[a] = t - floorf(t);
    }
    ++r.steps;
  }
  const int nc = T.tricubic ? 64 : 8;
  const int base = word & leaf::kIndexMask;
  const int start = T.fast ? (base / nc) * nc : base;
  if (start + nc <= T.num_words) r.start = start;
  return in_box;
}

// The reached leaf's N coefficients: float4 loads from the aligned row
// (the wrapper checks the pointer's 16-byte alignment), scalar loads at
// start + j otherwise.
template <int N>
__device__ __forceinline__ void coefficients(const Tree& T, const Reach& r, float (&c)[N]) {
  if (T.fast) {
    leaf::load_coeffs<0, N>(reinterpret_cast<const float4*>(T.coeffs + r.start), c);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = __ldg(T.coeffs + r.start + j);
  }
}

// The polynomial at the reached position: (value, and with Grad the
// unit-cube gradient).
template <bool Grad, int N>
__device__ __forceinline__ float4 poly(const Tree& T, const Reach& r) {
  float c[N];
  coefficients<N>(T, r, c);
  if constexpr (N == 64) {
    return leaf::tricubic<Grad>(c, r.f[0], r.f[1], r.f[2]);
  } else {
    return leaf::trilinear<Grad>(c, r.f[0], r.f[1], r.f[2]);
  }
}

// The reached leaf's edge, cell / 2^steps (steps < 31).
__device__ __forceinline__ float leaf_size(const Box& w, const Reach& r) {
  return w.cell[0] / static_cast<float>(1u << r.steps);
}

// What a query returns besides the distance.
enum Mode : int {
  kDistance = 0,  // the distance only
  kNormal = 1,    // _finish's normalised gradient (the box's outside)
  kWorld = 2,     // the polynomial's gradient / the leaf's edge, 0 outside
};

// The walk's answer at one point from its descent (in_box, r) and its
// leaf polynomial v (value and unit-cube gradient, read only where the
// point lies in the box and reaches a row): d, and the gradient of the mode
// in g.
template <int kMode>
__device__ __forceinline__ float answer(const Tree& T, const Box& w, const float p[3],
                                        bool in_box, const Reach& r, float4 v, float g[3]) {
  if (!in_box) {
    if (kMode == kNormal) leaf::box_gradient(w.b, p, g);
    if (kMode == kWorld) g[0] = g[1] = g[2] = 0.0f;
    return leaf::box_value(w.b, p, T.min_border);
  }
  if (r.start < 0) {
    if (kMode != kDistance) g[0] = g[1] = g[2] = NAN;
    return NAN;
  }
  if (kMode == kNormal) {
    const float norm = leaf::nan_max(sqrtf((v.y * v.y + v.w * v.w) + v.z * v.z), 1e-30f);
    g[0] = v.y / norm;
    g[1] = v.z / norm;
    g[2] = v.w / norm;
  } else if (kMode == kWorld) {
    const float e = leaf_size(w, r);
    g[0] = v.y / e;
    g[1] = v.z / e;
    g[2] = v.w / e;
  }
  return v.x;
}

// The walk's answer at one point, one thread reading its own row.
template <int kMode, int N>
__device__ __forceinline__ float query(const Tree& T, const Box& w, const float p[3],
                                       float g[3]) {
  Reach r;
  const bool in_box = descend(T, w, p, r);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (in_box && r.start >= 0) v = poly<kMode != kDistance, N>(T, r);
  return answer<kMode>(T, w, p, in_box, r, v, g);
}

}  // namespace walk
