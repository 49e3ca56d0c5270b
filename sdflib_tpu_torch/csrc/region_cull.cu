// K13 (region_cull): the exact build's per-node-region influence cull of a
// whole node group in one launch.
//
// It replaces no TPU kernel: no pl.pallas_call lies behind it. It does the
// work of _region_cull_chunk (sdflib_tpu/sdf/exact_octree.py:160-250),
// which the JAX package compiles into one XLA program with a fori_loop over
// the 27 anchors and maps over a group's chunks (_cull_group, :446-483);
// eager torch ran it as a few dozen launches an anchor and chunk.
//
// For node n with centre p and half size h, the 27 anchors l = p + (i, j,
// k) h (i, j, k in {-1, 0, 1}; anchor 13 is p) and the sub-cube corner
// offsets q_c = (+-h/2)^3, candidate slot s (triangle t = cand[n, s]) is
// kept iff valid[n, s] and, at some anchor,
//
//     min_c [d_t(l) + g_t(l) . q_c - d_b(l + q_c)] <= eps   or   d_t(l) <= near
//
// where b is the anchor's nearest candidate (torch.argmin over the row of
// squared distances, inf at invalid slots: the first index of the minimum,
// a NaN before any number) and g_t the analytic gradient of the unsigned
// distance. Outputs: keep (N, K) bool, the kept counts (N,) int64 and
// sqd_center (N, K), the squared distance at anchor 13, inf where invalid.
//
// Bits: every expression keeps the operand order of the plain version
// (ops/cull.py region_cull_plain over ops/point_triangle.py
// sq_dist_and_grad_from_field_fn): the ladder of region.cuh's select form,
// the gradient's branch-by-branch select and (t0 hx + t3 hy) + t6 hz,
// inv = (1 / max(d, 1e-20)) * 0.5 (torch's 0.5 / x is reciprocal times
// 0.5; a NaN passes the clamp as in torch), phi = (((d + gx qx) + gy qy) +
// gz qz) - d_b, the corner minimum NaN when any term is NaN (amin), and
// the thresholds as the wrapper rounds them to float32. The library builds
// with --fmad=false, so keep, the counts and sqd_center are bit-equal to
// the plain version's on the card.
//
// Design (one node a group of G threads, a warp or a block):
// * rows: the field table padded to 20 floats a row (ops/cull.py
//   cull_rows, built once a build), read as five 16-byte loads; the 20th
//   float is n, a bound on the norm of the row's gradient (below).
// * pass 1: each thread takes slots s = lane, lane + G, ...; a valid
//   slot's frame products for the 3 x, y and z anchor coordinates serve
//   all 27 anchors, whose running (squared distance, slot) minima stay in
//   registers; anchor 13's value is sqd_center. The minima reduce across
//   the warp (shuffles; with a block a node, then the warps' minima in
//   shared memory) into the 27 winners. The 54 minima take the kernels to
//   the 128-register cap with a 72-byte spill; pass 1 in three slabs of 9
//   anchors (each slot read thrice) had no spill and was slower on an
//   H100, as was a warp-form block of 255 registers (PERF.md).
// * corners: the group evaluates the 27 winners at their sub-cube's 8
//   corners, 216 distances a node, into shared memory, and the largest of
//   each anchor's 8 (NaN if any is).
// * pass 2: each thread evaluates its valid slots again, anchor by anchor:
//   the distance d, the near test, then (in the block form) the skip
//   test, then the gradient and the 8 corner terms; the first anchor that
//   keeps a slot ends its loop (keep is an OR). No (K, 8) phi or other
//   (N, K) transient is written.
// * the skip test: the gradient's norm is |M^T h| / d, M the row's frame
//   and h its halves; |h| = d but on an edge, where it is |de| |b| (or
//   |c|) against d >= |de|. So |g| <= n = max(1, |b|, |c|) ||M||_2 (the
//   norm bounded by Gershgorin's circles of M M^T: 1 to rounding for a
//   true frame, whatever a degenerate row holds), and every corner term
//   is at least lb = d - sqrt(3) qh n - max_c d_b. An anchor whose lb
//   exceeds eps by kSkipRel of the terms' magnitudes (far above float32's
//   rounding of every term) keeps nothing: its gradient and corners are
//   skipped. keep is an OR over the anchors, so no bit changes. A NaN or
//   an infinity in d, n or d_b makes the comparison false: the anchor is
//   evaluated in full. It holds at 66-93% of the wide groups' anchor
//   evaluations and at none of the deepest level's, where the warp form
//   runs: there it only cost time, so the warp form leaves it out. The
//   launcher picks it by form (``launch``; ops/cull.py SKIP_LANES mirrors
//   the pick, chip_smoke.py ``cull_ab`` times the other picks).
// Forms (the wrapper picks G from K, ops/cull.py lanes_for): a warp a
// node in 256-thread blocks, or a 512-thread block a node for wide rows of
// few nodes (the top levels, up to 131,072 slots a node).
//
// Bound: operations. Pass 1's 27 evaluations a valid pair (~34 flops each,
// the frame products shared), pass 2's up to 27 (~102 each with the
// gradient and the corner terms), 216 corner evaluations a node (~46
// each); bytes: a pair's id, valid, keep and sqd_center (10 B) and each
// touched field row once. --fmad=false keeps every multiply and add a
// separate instruction, so the floor is ~2x the bound taken at the FMA
// rate. The skip test takes ~60 of an anchor's 102 flops out where it
// holds; chip_smoke.py's bound counts the anchors it skipped at the ~43
// of the distance and the tests (cull_bound, from the run's tallies).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "region.cuh"

namespace {

constexpr int kWarpThreads = 256;    // block of the warp-a-node form
constexpr int kNodeThreads = 512;    // block of the block-a-node form
constexpr int kAnchors = 27;
constexpr int kCorners = 8;
constexpr int kRowFloats = 20;       // ops/cull.py ROW_FLOATS: 19 fields and n
constexpr int kCenter = 13;          // the anchor at the node centre
constexpr float kSkipRel = 1.0f / 16384.0f;   // the skip test's margin, relative
constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  float h;      // float32(half): the anchors' offset
  float qh;     // float32(0.5 * h): the corners' offset
  float eps;    // float32(2e-3) * h
  float near;   // s + eps, s = float32(sqrt(3)) * qh
  float reach;  // sqrt(3) qh, rounded up: the corners' distance from the anchor
};

// Pass 2's tallies (the stats launch): anchor evaluations, kept by the
// near test, skipped, evaluated in full.
struct Tally {
  unsigned long long evals, near, skipped, full;
};

// torch.argmin's order: a NaN before any number, then the smaller value,
// then the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

// The triangle-space coordinates of (px, py, pz) for field row f, as
// _frame_coords computes them.
__device__ __forceinline__ void frame_coords(const float* f, float px, float py, float pz,
                                             float& ppx, float& ppy, float& ppz) {
  const float dx = px - f[0], dy = py - f[1], dz = pz - f[2];
  ppx = f[3] * dx + f[4] * dy + f[5] * dz;
  ppy = f[6] * dx + f[7] * dy + f[8] * dz;
  ppz = f[9] * dx + f[10] * dy + f[11] * dz;
}

// sq_dist_and_grad_from_field_fn's triangle-space gradient halves (hx, hy
// before the factor 2): region_sq_dist_sel's region tests, the gradient
// selected branch by branch.
__device__ __forceinline__ void grad_halves(float ppx, float ppy, const float* f, float& hx,
                                            float& hy) {
  const float v2x = f[16], v3x = f[17], v3y = f[18];
  const float b0 = f[12], b1 = f[13], c0 = f[14], c1 = f[15];
  const float de1 = -ppy;
  const float de2 = (ppx - v2x) * b1 - ppy * b0;
  const float de3 = ppx * c1 - ppy * c0;
  const float rx2 = ppx - v2x;
  const float rx3 = ppx - v3x;
  const float ry3 = ppy - v3y;
  const bool a1 = ppx <= 0.0f, e1 = ppx >= v2x;
  const bool a2 = rx2 * b0 + ppy * b1 <= 0.0f, e2 = rx3 * b0 + ry3 * b1 >= 0.0f;
  const bool a3 = ppx * c0 + ppy * c1 >= 0.0f, e3 = rx3 * c0 + ry3 * c1 <= 0.0f;
  const bool r1 = de1 >= 0.0f, r2 = de2 >= 0.0f, r3 = de3 >= 0.0f;
  // vertices as the distance, edge1 (0, -de1), edge2 (de2 b1, -de2 b0),
  // edge3 (de3 c1, -de3 c0), the face (0, 0)
  const float gx1 = a1 ? ppx : (e1 ? rx2 : 0.0f), gy1 = (a1 || e1) ? ppy : -de1;
  const float gx2 = a2 ? rx2 : (e2 ? rx3 : de2 * b1), gy2 = a2 ? ppy : (e2 ? ry3 : -de2 * b0);
  const float gx3 = a3 ? ppx : (e3 ? rx3 : de3 * c1), gy3 = a3 ? ppy : (e3 ? ry3 : -de3 * c0);
  hx = r1 ? gx1 : (r2 ? gx2 : (r3 ? gx3 : 0.0f));
  hy = r1 ? gy1 : (r2 ? gy2 : (r3 ? gy3 : 0.0f));
}

// region_sq_dist_sel's squared distance and grad_halves's halves in one
// pass over the ladder (pass 2 without the skip test).
__device__ __forceinline__ float sq_dist_grad(float ppx, float ppy, float ppz, const float* f,
                                              float& hx, float& hy) {
  const float v2x = f[16], v3x = f[17], v3y = f[18];
  const float b0 = f[12], b1 = f[13], c0 = f[14], c1 = f[15];
  const float de1 = -ppy;
  const float de2 = (ppx - v2x) * b1 - ppy * b0;
  const float de3 = ppx * c1 - ppy * c0;
  const float z2 = ppz * ppz;
  const float rx2 = ppx - v2x;
  const float rx3 = ppx - v3x;
  const float ry3 = ppy - v3y;
  const bool a1 = ppx <= 0.0f, e1 = ppx >= v2x;
  const bool a2 = rx2 * b0 + ppy * b1 <= 0.0f, e2 = rx3 * b0 + ry3 * b1 >= 0.0f;
  const bool a3 = ppx * c0 + ppy * c1 >= 0.0f, e3 = rx3 * c0 + ry3 * c1 <= 0.0f;
  const float x1 = a1 ? ppx : (e1 ? rx2 : de1), y1 = (a1 || e1) ? ppy : 0.0f;
  const float x2 = a2 ? rx2 : (e2 ? rx3 : de2), y2 = a2 ? ppy : (e2 ? ry3 : 0.0f);
  const float x3 = a3 ? ppx : (e3 ? rx3 : de3), y3 = a3 ? ppy : (e3 ? ry3 : 0.0f);
  const bool r1 = de1 >= 0.0f, r2 = de2 >= 0.0f, r3 = de3 >= 0.0f;
  const float x = r1 ? x1 : (r2 ? x2 : (r3 ? x3 : 0.0f));
  const float y = r1 ? y1 : (r2 ? y2 : (r3 ? y3 : 0.0f));
  // the gradient: vertices as the distance, edge1 (0, -de1), edge2
  // (de2 b1, -de2 b0), edge3 (de3 c1, -de3 c0), the face (0, 0)
  const float gx1 = a1 ? ppx : (e1 ? rx2 : 0.0f), gy1 = (a1 || e1) ? ppy : -de1;
  const float gx2 = a2 ? rx2 : (e2 ? rx3 : de2 * b1), gy2 = a2 ? ppy : (e2 ? ry3 : -de2 * b0);
  const float gx3 = a3 ? ppx : (e3 ? rx3 : de3 * c1), gy3 = a3 ? ppy : (e3 ? ry3 : -de3 * c0);
  hx = r1 ? gx1 : (r2 ? gx2 : (r3 ? gx3 : 0.0f));
  hy = r1 ? gy1 : (r2 ? gy2 : (r3 ? gy3 : 0.0f));
  return x * x + y * y + z2;
}

__device__ __forceinline__ float row_sq_dist(float ppx, float ppy, float ppz, const float* f) {
  return region_sq_dist_sel(ppx, ppy, ppz, f[16], f[17], f[18], f[12], f[13], f[14], f[15]);
}

// Row t of the padded table (an id below 0 reads row t + T, as torch's
// indexing does): five 16-byte loads.
__device__ __forceinline__ void load_row(const float* __restrict__ rows, int T, int t, float* f) {
  const float4* r =
      reinterpret_cast<const float4*>(rows + static_cast<size_t>(t < 0 ? t + T : t) * kRowFloats);
#pragma unroll
  for (int q = 0; q < kRowFloats / 4; ++q) {
    const float4 v = __ldg(r + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// The node's work area in shared memory.
struct NodeSmem {
  int win[kAnchors];                 // each anchor's winning triangle
  float db[kAnchors * kCorners];     // its distance at the sub-cube's corners
  float dbmax[kAnchors];             // the largest of an anchor's 8 (NaN if any is)
};

// Reduce a (value, slot) pair over the lanes of a warp.
__device__ __forceinline__ void warp_min(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  return c;
}

// Pass 1 of one thread: its slots' 27 squared distances, anchor 13's
// written to sqd_center, the running minima in bv / bi.
__device__ __forceinline__ void pass1(const float* __restrict__ rows, int T,
                                      const int* __restrict__ cand,
                                      const uint8_t* __restrict__ valid, int K, int lane,
                                      int G, const float (&ax)[3], const float (&ay)[3],
                                      const float (&az)[3], float* __restrict__ sqd_row,
                                      float (&bv)[kAnchors], int (&bi)[kAnchors]) {
  for (int s = lane; s < K; s += G) {
    if (!valid[s]) {
      sqd_row[s] = INFINITY;
#pragma unroll
      for (int l = 0; l < kAnchors; ++l) {
        if (better(INFINITY, s, bv[l], bi[l])) {
          bv[l] = INFINITY;
          bi[l] = s;
        }
      }
      continue;
    }
    float f[kRowFloats];
    load_row(rows, T, cand[s], f);
    // ppx = (f3 dx + f4 dy) + f5 dz: the products of each anchor coordinate
    float mx[3][3], my[3][3], mz[3][3];   // [output axis][anchor index]
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dx = ax[a] - f[0], dy = ay[a] - f[1], dz = az[a] - f[2];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        mx[o][a] = f[3 + 3 * o] * dx;
        my[o][a] = f[4 + 3 * o] * dy;
        mz[o][a] = f[5 + 3 * o] * dz;
      }
    }
#pragma unroll
    for (int l = 0; l < kAnchors; ++l) {
      const int i = l % 3, j = (l / 3) % 3, k = l / 9;
      const float ppx = mx[0][i] + my[0][j] + mz[0][k];
      const float ppy = mx[1][i] + my[1][j] + mz[1][k];
      const float ppz = mx[2][i] + my[2][j] + mz[2][k];
      const float sq = row_sq_dist(ppx, ppy, ppz, f);
      if (l == kCenter) sqd_row[s] = sq;
      if (better(sq, s, bv[l], bi[l])) {
        bv[l] = sq;
        bi[l] = s;
      }
    }
  }
}

// An anchor's offset on one axis, index a of (-h, 0, h).
__device__ __forceinline__ float anchor_off(int a, float h) {
  return a == 0 ? -h : (a == 1 ? 0.0f : h);
}

// The corners: task e = 8 l + c evaluates anchor l's winner at corner c;
// (px, py, pz) is the node centre.
__device__ __forceinline__ void corners(const float* __restrict__ rows, int T, int lane, int G,
                                        float px, float py, float pz, const Consts& k,
                                        NodeSmem& sm) {
  for (int e = lane; e < kAnchors * kCorners; e += G) {
    const int l = e >> 3, c = e & 7;
    float f[kRowFloats];
    load_row(rows, T, sm.win[l], f);
    const float qx = (c & 1) ? k.qh : -k.qh;
    const float qy = (c & 2) ? k.qh : -k.qh;
    const float qz = (c & 4) ? k.qh : -k.qh;
    const float lx = px + anchor_off(l % 3, k.h), ly = py + anchor_off((l / 3) % 3, k.h);
    const float lz = pz + anchor_off(l / 9, k.h);
    float ppx, ppy, ppz;
    frame_coords(f, lx + qx, ly + qy, lz + qz, ppx, ppy, ppz);
    sm.db[e] = sqrtf(row_sq_dist(ppx, ppy, ppz, f));
  }
}

// Each anchor's largest corner distance, NaN where any is (after corners,
// once every corner is in shared memory).
__device__ __forceinline__ void corner_max(int lane, NodeSmem& sm) {
  if (lane < kAnchors) {
    float m = sm.db[lane * kCorners];
#pragma unroll
    for (int c = 1; c < kCorners; ++c) {
      const float v = sm.db[lane * kCorners + c];
      m = (v > m || v != v) ? v : m;
      if (m != m) break;
    }
    sm.dbmax[lane] = m;
  }
}

// Pass 2 of one thread: keep for each of its slots; returns its kept count.
template <bool kStats, bool kSkip>
__device__ __forceinline__ int pass2(const float* __restrict__ rows, int T,
                                     const int* __restrict__ cand,
                                     const uint8_t* __restrict__ valid, int K, int lane, int G,
                                     const float (&ax)[3], const float (&ay)[3],
                                     const float (&az)[3], const Consts& k,
                                     const NodeSmem& sm, uint8_t* __restrict__ keep_row,
                                     Tally& tally) {
  int kept = 0;
  for (int s = lane; s < K; s += G) {
    bool keep = false;
    if (valid[s]) {
      float f[kRowFloats];
      load_row(rows, T, cand[s], f);
      const float reach = k.reach * f[19];
      float mx[3][3], my[3][3], mz[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float dx = ax[a] - f[0], dy = ay[a] - f[1], dz = az[a] - f[2];
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          mx[o][a] = f[3 + 3 * o] * dx;
          my[o][a] = f[4 + 3 * o] * dy;
          mz[o][a] = f[5 + 3 * o] * dz;
        }
      }
#pragma unroll
      for (int l = 0; l < kAnchors; ++l) {   // unrolled: the products stay in registers
        const int i = l % 3, j = (l / 3) % 3, kk = l / 9;
        const float ppx = mx[0][i] + my[0][j] + mz[0][kk];
        const float ppy = mx[1][i] + my[1][j] + mz[1][kk];
        const float ppz = mx[2][i] + my[2][j] + mz[2][kk];
        // without the skip test the gradient halves come with the distance
        float hx, hy;
        const float d = sqrtf(kSkip ? row_sq_dist(ppx, ppy, ppz, f)
                                    : sq_dist_grad(ppx, ppy, ppz, f, hx, hy));
        if (kStats) ++tally.evals;
        if (d <= k.near) {
          if (kStats) ++tally.near;
          keep = true;
          break;
        }
        // the skip test: every corner term is at least lb (false on a NaN)
        const float dbm = sm.dbmax[l];
        const float lb = (d - reach) - dbm;
        if (kSkip && lb > k.eps + kSkipRel * ((d + reach) + dbm)) {
          if (kStats) ++tally.skipped;
          continue;
        }
        if (kStats) ++tally.full;
        if (kSkip) grad_halves(ppx, ppy, f, hx, hy);
        hx = 2.0f * hx;
        hy = 2.0f * hy;
        const float hz = 2.0f * ppz;
        const float c = (d >= 1e-20f || d != d) ? d : 1e-20f;   // clamp_min, NaN kept
        const float inv = (1.0f / c) * 0.5f;
        const float gx = (f[3] * hx + f[6] * hy + f[9] * hz) * inv;
        const float gy = (f[4] * hx + f[7] * hy + f[10] * hz) * inv;
        const float gz = (f[5] * hx + f[8] * hy + f[11] * hz) * inv;
        const float gxq = gx * k.qh, gyq = gy * k.qh, gzq = gz * k.qh;
        float m = INFINITY;
        bool nan = false;
#pragma unroll
        for (int c8 = 0; c8 < kCorners; ++c8) {
          const float phi = d + ((c8 & 1) ? gxq : -gxq) + ((c8 & 2) ? gyq : -gyq) +
                            ((c8 & 4) ? gzq : -gzq) - sm.db[l * kCorners + c8];
          nan |= phi != phi;
          m = fminf(m, phi);
        }
        if (!nan && m <= k.eps) {
          keep = true;
          break;
        }
      }
    }
    keep_row[s] = keep;
    kept += keep;
  }
  return kept;
}

// The node's anchor coordinates: p + (-h, 0, h) on each axis, as p + o.
__device__ __forceinline__ void anchor_coords(const float* __restrict__ centers, int n,
                                              float h, float (&ax)[3], float (&ay)[3],
                                              float (&az)[3]) {
  const float px = centers[3 * n], py = centers[3 * n + 1], pz = centers[3 * n + 2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ax[a] = px + anchor_off(a, h);
    ay[a] = py + anchor_off(a, h);
    az[a] = pz + anchor_off(a, h);
  }
}

// Add a warp's tallies to the launch's (lane 0, one atomic a field).
__device__ __forceinline__ void flush_tally(Tally t, unsigned long long* out) {
  t.evals = warp_sum(t.evals);
  t.near = warp_sum(t.near);
  t.skipped = warp_sum(t.skipped);
  t.full = warp_sum(t.full);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(out, t.evals);
    atomicAdd(out + 1, t.near);
    atomicAdd(out + 2, t.skipped);
    atomicAdd(out + 3, t.full);
  }
}

// A warp a node, 8 nodes a block.
template <bool kStats, bool kSkip>
__global__ void __launch_bounds__(kWarpThreads, 2)
region_cull_warp_kernel(const float* __restrict__ rows, int T,
                         const float* __restrict__ centers, int N,
                         const int* __restrict__ cand, long long cand_stride,
                         const uint8_t* __restrict__ valid, long long valid_stride, int K,
                         Consts k, uint8_t* __restrict__ keep, long long* __restrict__ counts,
                         float* __restrict__ sqd, unsigned long long* __restrict__ stats) {
  constexpr int G = 32;
  __shared__ NodeSmem smem[kWarpThreads / G];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const int n = blockIdx.x * (kWarpThreads / G) + g;
  const bool live = n < N;               // a dead warp still joins the shuffles
  const int Kn = live ? K : 0;
  const int nc = live ? n : 0;
  NodeSmem& sm = smem[g];
  float ax[3], ay[3], az[3];
  anchor_coords(centers, nc, k.h, ax, ay, az);
  const int* crow = cand + nc * cand_stride;
  const uint8_t* vrow = valid + nc * valid_stride;

  float bv[kAnchors];
  int bi[kAnchors];
#pragma unroll
  for (int l = 0; l < kAnchors; ++l) {
    bv[l] = INFINITY;
    bi[l] = 0x7fffffff;
  }
  pass1(rows, T, crow, vrow, Kn, lane, G, ax, ay, az, sqd + static_cast<size_t>(nc) * K, bv,
        bi);
#pragma unroll
  for (int l = 0; l < kAnchors; ++l) {
    warp_min(bv[l], bi[l]);
    if (lane == 0 && live) sm.win[l] = crow[bi[l]];
  }
  __syncwarp();
  if (live) {
    corners(rows, T, lane, G, centers[3 * n], centers[3 * n + 1], centers[3 * n + 2], k, sm);
    __syncwarp();
    corner_max(lane, sm);
  }
  __syncwarp();
  Tally tally = {};
  const int kept = warp_sum(
      pass2<kStats, kSkip>(rows, T, crow, vrow, Kn, lane, G, ax, ay, az, k, sm,
                    keep + static_cast<size_t>(nc) * K, tally));
  if (lane == 0 && live) counts[n] = kept;
  if (kStats) flush_tally(tally, stats);
}

// A 512-thread block a node.
template <bool kStats, bool kSkip>
__global__ void __launch_bounds__(kNodeThreads, 1)
region_cull_block_kernel(const float* __restrict__ rows, int T,
                         const float* __restrict__ centers, int N,
                         const int* __restrict__ cand, long long cand_stride,
                         const uint8_t* __restrict__ valid, long long valid_stride, int K,
                         Consts k, uint8_t* __restrict__ keep, long long* __restrict__ counts,
                         float* __restrict__ sqd, unsigned long long* __restrict__ stats) {
  constexpr int kWarps = kNodeThreads / 32;
  __shared__ NodeSmem sm;
  __shared__ float wv[kWarps][kAnchors];
  __shared__ int wi[kWarps][kAnchors];
  __shared__ int wsum[kWarps];
  const int n = blockIdx.x, t = threadIdx.x, warp = t / 32, lane = t % 32;
  float ax[3], ay[3], az[3];
  anchor_coords(centers, n, k.h, ax, ay, az);
  const int* crow = cand + n * cand_stride;
  const uint8_t* vrow = valid + n * valid_stride;

  float bv[kAnchors];
  int bi[kAnchors];
#pragma unroll
  for (int l = 0; l < kAnchors; ++l) {
    bv[l] = INFINITY;
    bi[l] = 0x7fffffff;
  }
  pass1(rows, T, crow, vrow, K, t, kNodeThreads, ax, ay, az, sqd + static_cast<size_t>(n) * K,
        bv, bi);
#pragma unroll
  for (int l = 0; l < kAnchors; ++l) {
    warp_min(bv[l], bi[l]);
    if (lane == 0) {
      wv[warp][l] = bv[l];
      wi[warp][l] = bi[l];
    }
  }
  __syncthreads();
  if (t < kAnchors) {
    float v = wv[0][t];
    int i = wi[0][t];
    for (int w = 1; w < kWarps; ++w) {
      if (better(wv[w][t], wi[w][t], v, i)) {
        v = wv[w][t];
        i = wi[w][t];
      }
    }
    sm.win[t] = crow[i];
  }
  __syncthreads();
  corners(rows, T, t, kNodeThreads, centers[3 * n], centers[3 * n + 1], centers[3 * n + 2], k,
          sm);
  __syncthreads();
  corner_max(t, sm);
  __syncthreads();
  Tally tally = {};
  const int kept = warp_sum(pass2<kStats, kSkip>(rows, T, crow, vrow, K, t, kNodeThreads,
                                                      ax, ay, az, k, sm,
                                                      keep + static_cast<size_t>(n) * K, tally));
  if (lane == 0) wsum[warp] = kept;
  if (kStats) flush_tally(tally, stats);
  __syncthreads();
  if (t == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += wsum[w];
    counts[n] = total;
  }
}

template <bool kStats>
void launch(const float* rows, int T, const float* centers, int N, const int* cand,
            long long cand_stride, const uint8_t* valid, long long valid_stride, int K,
            const Consts& k, int lanes, uint8_t* keep, long long* counts, float* sqd,
            unsigned long long* stats, cudaStream_t st) {
  // the skip test in the block form only (ops/cull.py SKIP_LANES)
  if (lanes == 32)
    region_cull_warp_kernel<kStats, false><<<(N + 7) / 8, kWarpThreads, 0, st>>>(
        rows, T, centers, N, cand, cand_stride, valid, valid_stride, K, k, keep, counts, sqd,
        stats);
  else
    region_cull_block_kernel<kStats, true><<<N, kNodeThreads, 0, st>>>(
        rows, T, centers, N, cand, cand_stride, valid, valid_stride, K, k, keep, counts, sqd,
        stats);
}

}  // namespace

// rows (T, 20) float32 row-major, 16-byte aligned (ops/cull.py cull_rows:
// the 19 packed fields and the gradient bound n); centers (N, 3) float32;
// cand (N, K) int32 and valid (N, K) bool, each with unit stride along K
// and the given row stride (0 for an expanded row); h, qh, eps, near as
// float32, reach = sqrt(3) qh rounded up; lanes 32 (a warp a node) or 512
// (a block a node); keep (N, K) bool, counts (N,) int64, sqd (N, K)
// float32, contiguous; stats null, or 4 uint64 that pass 2's tallies are
// added to (evaluations, near keeps, skips, full evaluations). An id below
// 0 reads row id + T, as torch's indexing does.
extern "C" int sdf_region_cull(const float* rows, int T, const float* centers, int N,
                               const int* cand, long long cand_stride, const uint8_t* valid,
                               long long valid_stride, int K, float h, float qh, float eps,
                               float near, float reach, int lanes, uint8_t* keep,
                               long long* counts, float* sqd, unsigned long long* stats,
                               void* stream) {
  if (N < 0 || K <= 0 || T <= 0 || (lanes != 32 && lanes != kNodeThreads) ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const Consts k{h, qh, eps, near, reach};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    launch<true>(rows, T, centers, N, cand, cand_stride, valid, valid_stride, K, k, lanes, keep,
                 counts, sqd, stats, st);
  else
    launch<false>(rows, T, centers, N, cand, cand_stride, valid, valid_stride, K, k, lanes, keep,
                  counts, sqd, nullptr, st);
  return static_cast<int>(cudaGetLastError());
}
