// The approximate octree's leaf evaluation on its dense leaf grid, shared by
// K4 (octree_query.cu) and K5/K6 (march.cu): a point's finest cell, the
// cell's leaf row (the thin grid's [leaf word, depth | flags] and the
// coefficient row the word names, or one fused row holding both words and
// the coefficients), the position in the leaf, the tricubic or trilinear
// polynomial and its gradient, and the box fallback outside the box.
//
// Every expression keeps the operand order of the torch version
// (sdf/octree.py _grid_cells, _leaf_frac, _finish; ops/interpolation.py;
// ops/box.py), and the library builds with --fmad=false, so both round
// alike. A sum over the last axis takes the order of torch's CUDA
// reduction of a contiguous axis: 64 terms as 32 lanes, lane t adding
// terms t and t + 32, then a pairwise tree over the lanes; 3 terms as
// (x0 + x2) + x1. Where torch's order differs on some build, the two
// still agree to a few ulps of the largest term.
//
// Two ways to read a row: one thread reads the whole row of its own point
// (the march, and K4 with a group of 1), or a group of lanes shares one
// point and reads its row together (K4's group read, below), with the
// same sum, so both give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace leaf {

constexpr int kIndexMask = 0x3FFFFFFF;  // CHILDREN_INDEX_MASK

// What a query or a march step reads.
struct Grid {
  const int* rows;         // (g^3, width) int32 rows, z-major cells
  int width;               // words a row: 2 (thin grid) or the fused width
  const float* coeffs;     // thin grid: the float view of the octree words;
                           // null: fused rows, coefficients from word 2
  int num_words;           // thin grid: words of the octree
  int depth;               // grid depth d: g = 2^d cells an axis
  int tricubic;            // 1: 64 coefficients; 0: trilinear, 8
  const float* box_min;    // (3,) on the device
  const float* box_size3;  // (3,) on the device
  float min_border;        // min_border_value, added to the box fallback
};

// The box's constants, read once a thread.
struct Box {
  float mn[3], sz[3], ctr[3], half[3];
  float cell;  // box_size3[0] / g, a finest cell's edge
};

// torch.maximum, torch.minimum, clamp_min and amin keep a NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

__device__ __forceinline__ Box load_box(const Grid& G) {
  Box b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.mn[a] = G.box_min[a];
    b.sz[a] = G.box_size3[a];
    b.half[a] = 0.5f * b.sz[a];
    b.ctr[a] = b.mn[a] + b.half[a];
  }
  b.cell = b.sz[0] / static_cast<float>(1 << G.depth);
  return b;
}

// _grid_cells: the point's position in box units and whether it lies in
// the box; inside, its finest cell. The cast runs on in-box values only,
// rel * g in [0, g), where C's float-to-int cast is defined.
__device__ __forceinline__ bool grid_cell(const Grid& G, const Box& b,
                                          const float p[3], float rel[3],
                                          int c[3]) {
  bool in_box = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    rel[a] = (p[a] - b.mn[a]) / b.sz[a];
    in_box = in_box && rel[a] >= 0.0f && rel[a] < 1.0f;
  }
  if (in_box) {
    const int g = 1 << G.depth;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      c[a] = min(max(static_cast<int>(rel[a] * static_cast<float>(g)), 0), g - 1);
    }
  }
  return in_box;
}

// The cell's leaf row: its depth word, and the 16-byte aligned start of
// the words that hold its coefficients: the coefficient row (thin grid;
// the coefficients from word 0) or the fused row itself (from word 2).
// Null when a thin grid's word names a row past the octree's end.
__device__ __forceinline__ const float4* leaf_row(const Grid& G, const int c[3],
                                                  int* dw) {
  const int g = 1 << G.depth;
  const size_t lin = (static_cast<size_t>(c[2]) * g + c[1]) * g + c[0];
  const int* row = G.rows + lin * G.width;
  if (G.coeffs == nullptr) {
    *dw = __ldg(row + 1);
    return reinterpret_cast<const float4*>(row);
  }
  const int2 wd = __ldg(reinterpret_cast<const int2*>(row));
  *dw = wd.y;
  const int nc = G.tricubic ? 64 : 8;
  const int r = (wd.x & kIndexMask) / nc;
  if (static_cast<long long>(r + 1) * nc > G.num_words) return nullptr;
  return reinterpret_cast<const float4*>(G.coeffs + static_cast<size_t>(r) * nc);
}

// N coefficients from S words into the 16-byte aligned base, as float4
// loads by one thread. Where each lane of a warp reads its own row, one
// load instruction touches as many lines as the warp has distinct rows.
template <int S, int N>
__device__ __forceinline__ void load_coeffs(const float4* __restrict__ base, float (&c)[N]) {
#pragma unroll
  for (int q = 0; q < (S + N + 3) / 4; ++q) {
    const float4 v = __ldg(base + q);
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 4 * q + e - S;
      if (m >= 0 && m < N) c[m] = w[e];
    }
  }
}

// A pairwise tree over lanes [Lo, Lo + N) of (value, gx, gy, gz) sums.
template <int Lo, int N>
struct Tree {
  template <class Lane>
  __device__ __forceinline__ static float4 sum(const Lane& lane) {
    const float4 a = Tree<Lo, N / 2>::sum(lane);
    const float4 b = Tree<Lo + N / 2, N / 2>::sum(lane);
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

template <int Lo>
struct Tree<Lo, 1> {
  template <class Lane>
  __device__ __forceinline__ static float4 sum(const Lane& lane) {
    return lane(Lo);
  }
};

// tricubic_interpolate and, with Grad, tricubic_gradient (unit-cube
// coordinates): sums of c[m] * monomial m, m = i + 4j + 16k for
// x^i y^j z^k, each monomial (x_i * y_j) * z_k.
template <bool Grad>
__device__ __forceinline__ float4 tricubic(const float (&c)[64], float fx, float fy,
                                           float fz) {
  const float xv[4] = {1.0f, fx, fx * fx, fx * fx * fx};
  const float yv[4] = {1.0f, fy, fy * fy, fy * fy * fy};
  const float zv[4] = {1.0f, fz, fz * fz, fz * fz * fz};
  const float dxv[4] = {0.0f, 1.0f, 2.0f * fx, 3.0f * fx * fx};
  const float dyv[4] = {0.0f, 1.0f, 2.0f * fy, 3.0f * fy * fy};
  const float dzv[4] = {0.0f, 1.0f, 2.0f * fz, 3.0f * fz * fz};
  // lane t: terms t and t + 32 (the same i and j, k and k + 2)
  auto lane = [&](int t) -> float4 {
    const int i = t & 3, j = (t >> 2) & 3, k = t >> 4;
    const float c0 = c[t], c1 = c[t + 32];
    const float xy = xv[i] * yv[j];
    float4 s;
    s.x = c0 * (xy * zv[k]) + c1 * (xy * zv[k + 2]);
    if (Grad) {
      const float dxy = dxv[i] * yv[j];
      const float xdy = xv[i] * dyv[j];
      s.y = c0 * (dxy * zv[k]) + c1 * (dxy * zv[k + 2]);
      s.z = c0 * (xdy * zv[k]) + c1 * (xdy * zv[k + 2]);
      s.w = c0 * (xy * dzv[k]) + c1 * (xy * dzv[k + 2]);
    } else {
      s.y = s.z = s.w = 0.0f;
    }
    return s;
  };
  return Tree<0, 32>::sum(lane);
}

// trilinear_interpolate and, with Grad, trilinear_gradient.
template <bool Grad>
__device__ __forceinline__ float4 trilinear(const float (&v)[8], float fx, float fy,
                                            float fz) {
  const float ux = 1.0f - fx, uy = 1.0f - fy, uz = 1.0f - fz;
  float4 s;
  {
    const float d00 = v[0] * ux + v[1] * fx;
    const float d01 = v[2] * ux + v[3] * fx;
    const float d10 = v[4] * ux + v[5] * fx;
    const float d11 = v[6] * ux + v[7] * fx;
    const float d0 = d00 * uy + d01 * fy;
    const float d1 = d10 * uy + d11 * fy;
    s.x = d0 * uz + d1 * fz;
    if (Grad) {
      s.z = (d01 * uz + d11 * fz) - (d00 * uz + d10 * fz);
      s.w = (d10 * uy + d11 * fy) - (d00 * uy + d01 * fy);
    } else {
      s.z = s.w = 0.0f;
    }
  }
  if (Grad) {
    const float d00 = v[0] * uy + v[2] * fy;
    const float d01 = v[1] * uy + v[3] * fy;
    const float d10 = v[4] * uy + v[6] * fy;
    const float d11 = v[5] * uy + v[7] * fy;
    s.y = (d01 * uz + d11 * fz) - (d00 * uz + d10 * fz);
  } else {
    s.y = 0.0f;
  }
  return s;
}

// The polynomial of N coefficients from S words into base, at f.
template <bool Grad, int S, int N>
__device__ __forceinline__ float4 poly(const float4* base, const float f[3]) {
  float c[N];
  load_coeffs<S, N>(base, c);
  if constexpr (N == 64) {
    return tricubic<Grad>(c, f[0], f[1], f[2]);
  } else {
    return trilinear<Grad>(c, f[0], f[1], f[2]);
  }
}

// ---- K4's group read ------------------------------------------------------
//
// Each lane of a warp finds its own point's cell, row and position in the
// leaf; then the warp reads the 32 points' coefficient rows in kGroup
// rounds, kGroup lanes (4 or 8, an aligned run of the warp) a point: in
// round r, group g takes point r * 32 / kGroup + g (its row pointer and
// position come by shuffles), and its lane s loads float4s s, s + kGroup,
// s + 2 kGroup, ... of the 16-byte aligned words that hold the
// coefficients (a thin grid's coefficient row: 16 float4; a fused row:
// words 0-67, 17 float4). So one load instruction reads each point's row
// as a contiguous run and touches each of its lines once, and the work
// done once a point (the cell, the divisions, the normalization) stays
// one lane's. Coefficient m lies in float4 (m + S) / 4.
//
// The sum is tricubic's, term for term: quad q (0..7) is the pairwise sum
// of its lanes 4q..4q+3, which need terms 4q..4q+3 ("lo") and
// 4q+32..4q+35 ("hi"), and the eight quads add as a pairwise tree. A lane
// owns quads s + kGroup j, takes their lo and hi coefficients from its own
// loads or, where another lane loaded them, by a shuffle of the raw
// coefficients, sums its quads, and the group adds its quads by
// __shfl_xor_sync (a + b == b + a
// in IEEE arithmetic, so both lanes of an exchange hold the same bits).
// Every lane of the group ends with the total, bit-equal to one thread's
// tricubic, and the point's own lane takes it by a shuffle.

constexpr unsigned kFullMask = 0xffffffffu;

template <int kGroup, int S>
struct GroupRow {
  static constexpr int kFloat4s = S == 0 ? 16 : 17;  // the float4s of live words
  static constexpr int kSlots = (kFloat4s + kGroup - 1) / kGroup;  // loads a lane
  static constexpr int kQuads = 8 / kGroup;                        // quads a lane
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src, int width) {
  return make_float4(__shfl_sync(kFullMask, v.x, src, width),
                     __shfl_sync(kFullMask, v.y, src, width),
                     __shfl_sync(kFullMask, v.z, src, width),
                     __shfl_sync(kFullMask, v.w, src, width));
}

// Words 2-3 of a and 0-1 of b: four coefficients that straddle two float4
// of a fused row.
__device__ __forceinline__ float4 zw_xy(float4 a, float4 b) {
  return make_float4(a.z, a.w, b.x, b.y);
}

__device__ __forceinline__ float pick4(const float (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// The lo and hi coefficients of each quad lane s owns, from its loads v.
template <int kGroup, int S>
__device__ __forceinline__ void quad_coeffs(const float4 (&v)[GroupRow<kGroup, S>::kSlots],
                                            int s, float4 (&lo)[GroupRow<kGroup, S>::kQuads],
                                            float4 (&hi)[GroupRow<kGroup, S>::kQuads]) {
  constexpr int Q = GroupRow<kGroup, S>::kQuads;
  if constexpr (S == 0) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      lo[j] = v[j];
      hi[j] = v[j + 8 / kGroup];
    }
  } else {
    // slot q of lane s + 1 holds float4 s + 1 + kGroup q; lane s = kGroup - 1
    // reads lane 0, whose next slot holds it
    constexpr int K = GroupRow<kGroup, S>::kSlots;
    float4 next[K - 1];
#pragma unroll
    for (int q = 0; q + 1 < K; ++q) {
      next[q] = shfl4(s == 0 ? v[q + 1] : v[q], (s + 1) & (kGroup - 1), kGroup);
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      lo[j] = zw_xy(v[j], next[j]);
      hi[j] = zw_xy(v[j + 8 / kGroup], next[j + 8 / kGroup]);
    }
  }
}

// Quad q's pairwise sum of tricubic's lanes 4q..4q+3 (unit-cube powers xv,
// yv, zv and their derivatives).
template <bool Grad>
__device__ __forceinline__ float4 quad_sum(float4 lo4, float4 hi4, int q, const float (&xv)[4],
                                           const float (&yv)[4], const float (&zv)[4],
                                           const float (&dxv)[4], const float (&dyv)[4],
                                           const float (&dzv)[4]) {
  const int j = q & 3, k = q >> 2;
  const float y = pick4(yv, j), dy = pick4(dyv, j);
  const float z0 = k ? zv[1] : zv[0], z1 = k ? zv[3] : zv[2];
  const float dz0 = k ? dzv[1] : dzv[0], dz1 = k ? dzv[3] : dzv[2];
  const float lo[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
  const float hi[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
  auto lane = [&](int i) -> float4 {
    const float c0 = lo[i], c1 = hi[i];
    const float xy = xv[i] * y;
    float4 s;
    s.x = c0 * (xy * z0) + c1 * (xy * z1);
    if (Grad) {
      const float dxy = dxv[i] * y;
      const float xdy = xv[i] * dy;
      s.y = c0 * (dxy * z0) + c1 * (dxy * z1);
      s.z = c0 * (xdy * z0) + c1 * (xdy * z1);
      s.w = c0 * (xy * dz0) + c1 * (xy * dz1);
    } else {
      s.y = s.z = s.w = 0.0f;
    }
    return s;
  };
  return Tree<0, 4>::sum(lane);
}

template <bool Grad>
__device__ __forceinline__ float4 shfl_xor4(float4 v, int mask, int width) {
  v.x = __shfl_xor_sync(kFullMask, v.x, mask, width);
  if (Grad) {
    v.y = __shfl_xor_sync(kFullMask, v.y, mask, width);
    v.z = __shfl_xor_sync(kFullMask, v.z, mask, width);
    v.w = __shfl_xor_sync(kFullMask, v.w, mask, width);
  }
  return v;
}

// Lane s's loads of one point's row for the group: float4s s, s + kGroup,
// ...; base null reads nothing (zeros).
template <int kGroup, int S>
__device__ __forceinline__ void group_load(const float4* base, int s,
                                           float4 (&v)[GroupRow<kGroup, S>::kSlots]) {
  using R = GroupRow<kGroup, S>;
#pragma unroll
  for (int q = 0; q < R::kSlots; ++q) {
    const int i = s + kGroup * q;
    v[q] = (base != nullptr && i < R::kFloat4s) ? __ldg(base + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// tricubic<Grad> of one point's row from the group's loads v (group_load):
// lane s of the group calls it (every lane of the warp does: the shuffles
// span the warp).
template <bool Grad, int kGroup, int S>
__device__ __forceinline__ float4 group_sum(const float4 (&v)[GroupRow<kGroup, S>::kSlots],
                                            int s, const float f[3]) {
  using R = GroupRow<kGroup, S>;
  float4 lo[R::kQuads], hi[R::kQuads];
  quad_coeffs<kGroup, S>(v, s, lo, hi);
  const float fx = f[0], fy = f[1], fz = f[2];
  const float xv[4] = {1.0f, fx, fx * fx, fx * fx * fx};
  const float yv[4] = {1.0f, fy, fy * fy, fy * fy * fy};
  const float zv[4] = {1.0f, fz, fz * fz, fz * fz * fz};
  const float dxv[4] = {0.0f, 1.0f, 2.0f * fx, 3.0f * fx * fx};
  const float dyv[4] = {0.0f, 1.0f, 2.0f * fy, 3.0f * fy * fy};
  const float dzv[4] = {0.0f, 1.0f, 2.0f * fz, 3.0f * fz * fz};
  float4 part[R::kQuads];
#pragma unroll
  for (int j = 0; j < R::kQuads; ++j) {
    part[j] = quad_sum<Grad>(lo[j], hi[j], s + kGroup * j, xv, yv, zv, dxv, dyv, dzv);
  }
  // the pairwise tree over the quads: lanes 1, 2, 4 apart hold quads 1,
  // 2, 4 apart; with four lanes, quads 0-3 and 4-7 meet last
#pragma unroll
  for (int m = 1; m < kGroup; m <<= 1) {
#pragma unroll
    for (int j = 0; j < R::kQuads; ++j) part[j] = add4(part[j], shfl_xor4<Grad>(part[j], m, kGroup));
  }
  float4 total = part[0];
#pragma unroll
  for (int j = 1; j < R::kQuads; ++j) total = add4(total, part[j]);
  return total;
}

// tricubic<Grad> of one point's row read by the group: lane s of the group
// calls it (every lane of the warp does: the shuffles span the warp);
// base null reads nothing.
template <bool Grad, int kGroup, int S>
__device__ __forceinline__ float4 tricubic_group(const float4* base, int s, const float f[3]) {
  float4 v[GroupRow<kGroup, S>::kSlots];
  group_load<kGroup, S>(base, s, v);
  return group_sum<Grad, kGroup, S>(v, s, f);
}

// tricubic<Grad> of one thread's aligned row (16 float4 from base), read
// a quad at a time: quad q's two float4 (coefficients 4q..4q+3 and
// 4q+32..4q+35) go straight into quad_sum, and the eight quads add as
// Tree<0, 32>'s pairwise tree does, so the sum is tricubic's bit for bit
// while the 64 coefficients are never all live (K12's march).
template <bool Grad>
__device__ __forceinline__ float4 tricubic_quads(const float4* __restrict__ base,
                                                 const float f[3]) {
  const float fx = f[0], fy = f[1], fz = f[2];
  const float xv[4] = {1.0f, fx, fx * fx, fx * fx * fx};
  const float yv[4] = {1.0f, fy, fy * fy, fy * fy * fy};
  const float zv[4] = {1.0f, fz, fz * fz, fz * fz * fz};
  const float dxv[4] = {0.0f, 1.0f, 2.0f * fx, 3.0f * fx * fx};
  const float dyv[4] = {0.0f, 1.0f, 2.0f * fy, 3.0f * fy * fy};
  const float dzv[4] = {0.0f, 1.0f, 2.0f * fz, 3.0f * fz * fz};
  auto quad = [&](int q) {
    return quad_sum<Grad>(__ldg(base + q), __ldg(base + q + 8), q, xv, yv, zv, dxv, dyv, dzv);
  };
  const float4 lo = add4(add4(quad(0), quad(1)), add4(quad(2), quad(3)));
  const float4 hi = add4(add4(quad(4), quad(5)), add4(quad(6), quad(7)));
  return add4(lo, hi);
}

// The lane of the k-th (from 0) set bit of mask (k below its count).
__device__ __forceinline__ int nth_lane(unsigned mask, int k) {
  int at = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int low = __popc(mask & ((1u << w) - 1u));
    if (k >= low) {
      k -= low;
      mask >>= w;
      at += w;
    }
  }
  return at;
}

// tricubic<Grad> of each lane's own point (its row's 16-byte aligned base,
// null: none; its position f in the leaf), the rows read kGroup lanes a
// point in rounds over the warp. Every lane of the warp calls it. Where
// some lanes have no row, the lanes with one move down to lanes 0.. in
// lane order first and their sums move back after, so a warp whose lanes
// hold few rows (points outside the box) takes few rounds; a lane without
// a row returns zeros. A point's sum is the same bits whichever group
// takes it.
template <bool Grad, int kGroup, int S>
__device__ __forceinline__ float4 tricubic_warp(const float4* base, const float f[3]) {
  constexpr int kPer = 32 / kGroup;     // points a round
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup, s = lane % kGroup;
  const unsigned live = __ballot_sync(kFullMask, base != nullptr);
  const int count = __popc(live);
  unsigned long long mine = reinterpret_cast<unsigned long long>(base);
  float pf[3] = {f[0], f[1], f[2]};
  if (live != kFullMask) {
    const int src = nth_lane(live, lane < count ? lane : 0);
    mine = __shfl_sync(kFullMask, mine, src);
    if (lane >= count) mine = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) pf[a] = __shfl_sync(kFullMask, f[a], src);
  }
  float4 own = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int r = 0; r * kPer < count; ++r) {
    const int q = r * kPer + g;          // the point the group takes
    const float4* qb = reinterpret_cast<const float4*>(__shfl_sync(kFullMask, mine, q));
    const float qf[3] = {__shfl_sync(kFullMask, pf[0], q), __shfl_sync(kFullMask, pf[1], q),
                         __shfl_sync(kFullMask, pf[2], q)};
    const float4 tot = tricubic_group<Grad, kGroup, S>(qb, s, qf);
    // lane L's point went to group L - r * kPer in this round
    const int at = lane - r * kPer;
    float4 back;
    back.x = __shfl_sync(kFullMask, tot.x, (at & (kPer - 1)) * kGroup);
    if (Grad) {
      back.y = __shfl_sync(kFullMask, tot.y, (at & (kPer - 1)) * kGroup);
      back.z = __shfl_sync(kFullMask, tot.z, (at & (kPer - 1)) * kGroup);
      back.w = __shfl_sync(kFullMask, tot.w, (at & (kPer - 1)) * kGroup);
    } else {
      back.y = back.z = back.w = 0.0f;
    }
    if (at >= 0 && at < kPer) own = back;
  }
  if (live != kFullMask) {
    // the lane's sum sits at its rank among the lanes with a row
    const int rank = __popc(live & ((1u << lane) - 1u));
    own.x = __shfl_sync(kFullMask, own.x, rank);
    if (Grad) {
      own.y = __shfl_sync(kFullMask, own.y, rank);
      own.z = __shfl_sync(kFullMask, own.z, rank);
      own.w = __shfl_sync(kFullMask, own.w, rank);
    }
    if (((live >> lane) & 1u) == 0) own = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return own;
}

// The leaf polynomial at an in-box point of the cell with depth word dw,
// its coefficients from leaf_row: (d, and with Grad the normalized
// gradient). NaN where the row is missing. kGroup > 1: the warp reads its
// points' rows kGroup lanes a point (tricubic); every lane of the warp
// calls it.
template <bool Grad, int kGroup = 1>
__device__ __forceinline__ float4 leaf_value(const Grid& G, const float4* base,
                                             const float rel[3], int dw) {
  if (kGroup == 1 && base == nullptr) return make_float4(NAN, NAN, NAN, NAN);
  const float scale = static_cast<float>(1 << (dw & 0xFFFF));
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t = rel[a] * scale;
    f[a] = t - floorf(t);
  }
  const bool fused = G.coeffs == nullptr;
  float4 v;
  if (!G.tricubic) {
    // 8 coefficients: each lane reads them all (the group's lanes read
    // the same words)
    v = base == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                        : (fused ? poly<Grad, 2, 8>(base, f) : poly<Grad, 0, 8>(base, f));
  } else if constexpr (kGroup == 1) {
    v = fused ? poly<Grad, 2, 64>(base, f) : poly<Grad, 0, 64>(base, f);
  } else {
    v = fused ? tricubic_warp<Grad, kGroup, 2>(base, f) : tricubic_warp<Grad, kGroup, 0>(base, f);
  }
  if (Grad) {
    const float norm = nan_max(sqrtf((v.y * v.y + v.w * v.w) + v.z * v.z), 1e-30f);
    v.y = v.y / norm;
    v.z = v.z / norm;
    v.w = v.w / norm;
  }
  return base == nullptr ? make_float4(NAN, NAN, NAN, NAN) : v;
}

// box_distance about the box's centre, plus min_border_value.
__device__ __forceinline__ float box_value(const Box& b, const float p[3],
                                           float min_border) {
  float q[3], o[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q[a] = fabsf(p[a] - b.ctr[a]) - b.half[a];
    o[a] = nan_max(q[a], 0.0f);
  }
  const float outside = sqrtf((o[0] * o[0] + o[2] * o[2]) + o[1] * o[1]);
  const float inside = nan_min(nan_max(nan_max(q[0], q[1]), q[2]), 0.0f);
  return (outside + inside) + min_border;
}

// box_distance_gradient's gradient: the reference's formula over the raw
// point and the full size (utils/Mesh.h:50).
__device__ __forceinline__ void box_gradient(const Box& b, const float p[3],
                                             float g[3]) {
  float a[3], bb[3], sg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = fabsf(p[k]) - b.sz[k];
    bb[k] = nan_max(a[k], 0.0f);
    sg[k] = p[k] >= 0.0f ? 1.0f : -1.0f;
  }
  const int k = a[0] > a[1] ? 0 : 1;
  const int l = a[2] > a[k] ? 2 : k;
  const float c = nan_max(sqrtf((bb[0] * bb[0] + bb[2] * bb[2]) + bb[1] * bb[1]), 1e-30f);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    g[m] = a[l] < 0.0f ? (l == m ? 1.0f : 0.0f) * sg[m]
                       : (a[m] > 0.0f ? bb[m] / c * sg[m] : 0.0f);
  }
}

// _octree_query_grid / _octree_query_fat at one point: d, and with Grad
// the gradient in g. Out-of-box points read no row. kGroup > 1: the warp
// reads its points' rows together; every lane of the warp calls it.
template <bool Grad, int kGroup = 1>
__device__ __forceinline__ float query(const Grid& G, const Box& b, const float p[3],
                                       float g[3]) {
  float rel[3];
  int c[3];
  const bool in_box = grid_cell(G, b, p, rel, c);
  int dw = 0;
  const float4* base = nullptr;
  if (in_box) {
    base = leaf_row(G, c, &dw);
  } else if (kGroup == 1) {
    if (Grad) box_gradient(b, p, g);
    return box_value(b, p, G.min_border);
  }
  const float4 v = leaf_value<Grad, kGroup>(G, base, rel, dw);
  if (!in_box) {
    if (Grad) box_gradient(b, p, g);
    return box_value(b, p, G.min_border);
  }
  if (Grad) {
    g[0] = v.y;
    g[1] = v.z;
    g[2] = v.w;
  }
  return v.x;
}

}  // namespace leaf
