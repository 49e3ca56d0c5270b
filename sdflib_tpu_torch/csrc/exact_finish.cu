// K7 (exact_finish): the exact query's signed finish and its unsort, one
// thread a point.
//
// It replaces no TPU kernel: no pl.pallas_call lies behind it. It does the
// work of _exact_finish (sdflib_tpu/sdf/exact_octree.py:1144-1181) and of
// the unsort that follows it (:1041-1048), which XLA fuses inside the JAX
// package's one compiled query; eager torch ran them as ~120 launches
// (37 column gathers, the region ladder, the box, the scatter).
//
// Point i of the leaf-sorted points reads its winner's row of the finish
// table (ops/exact_query.py finish_table: the 37 fields of
// pack_triangle_full_fields, then the 9 world-vertex floats, 48 floats a
// row, row-major) and writes d[order[i]] (and g[order[i]]): inside the
// box [box_min, box_min + box_size3), the signed distance to the winner (a
// winner of -1 reads triangle 0); outside it box_distance + fallback
// (leaf_eval.cuh's box_value, whose 3-term sums take torch's CUDA order),
// and box_distance_gradient's gradient. Out-of-box points read no row.
//
// Every expression keeps the operand order of the torch version the
// wrapper falls back to on the CPU (exact_finish_plain):
// signed_dist_from_rows for the distance, signed_dist_grad_pair and
// _safe_normalize for the gradient (ops/point_triangle.py), torch.sign's
// 0 at 0 and NaN, the ladder's >= / <= tests, sqrtf and rsqrtf as torch's
// CUDA sqrt and rsqrt call them, and torch's CUDA sum of 3 terms as
// (x0 + x2) + x1. The library builds with --fmad=false, so the distances
// round as the eager ops do, bit for bit.
//
// Bound: bytes. Each point reads 12 B of point, 4 B of winner and 8 B of
// order and writes 4 B (16 more with the gradient); each touched triangle's
// 148 B row (184 B with the world vertices) is read once. At 2^21 points
// that is ~0.018 ms on an H100, against ~70 flops a point (~100 with the
// gradient). What the card spends instead (PERF.md): the unsort's
// scattered writes, the sorted points' row loads, the streams.
//
// * The rows. The sorted lanes of a warp share few winners, so a load
//   instruction costs one L1 wavefront per distinct row it touches. The
//   row stride is the compile-time 48 floats (192 B, 16-byte aligned), so
//   the frame (fields 0-19) is five 16-byte loads; the region's normal
//   triple (and with the gradient its world vertex) is three scalar loads
//   at an offset computed from the region code. The region's arithmetic is
//   selects, not a switch, so lanes of different regions do not serialise.
//   The box and the fallback come by value.
// * The unsort, one scattered write a point at order[i], costs more than
//   the rows (PERF.md times K7 at its order and at the identity). The streams read
//   once are loaded evict-first, the outputs stored evict-last
//   (cache_hints.cuh), and a gradient is two stores, its 8-byte-aligned
//   pair as one.
// * Two points a thread, every load issued before the first arithmetic,
//   measured no faster on an H100, so a thread takes one.
#include <cuda_runtime.h>
#include <math.h>

#include "cache_hints.cuh"
#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 48;  // floats a row of the finish table (192 B)
// finish-table fields (ops/point_triangle.py _F_*, ops/exact_query.py)
constexpr int kEdgeN = 19, kVertN = 28, kVWorld = 37;

// the box [mn, mn + sz) and the fallback's constant, by value
struct FinishBox {
  float mn[3], sz[3], fallback;
};

// torch.sign on the card: (0 < v) - (v < 0), so 0 at 0 and at NaN
__device__ __forceinline__ float torch_sign(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

// _safe_normalize(vec, tn): torch's sum of 3 terms, (x0 + x2) + x1; rsqrt
// of the sum clamped to 1e-38 where it is positive, else the fallback tn
__device__ __forceinline__ void safe_normalize(const float v[3], const float tn[3],
                                               float out[3]) {
  const float n2 = (v[0] * v[0] + v[2] * v[2]) + v[1] * v[1];
  const float inv = rsqrtf(fmaxf(n2, 1e-38f));
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = n2 > 0.0f ? v[j] * inv : tn[j];
}

// The winner's frame (fields 0-19 of its row: origin, transform, b, c,
// v2x, v3xy and one spare) as five 16-byte loads.
struct Frame {
  float4 q[5];
  __device__ __forceinline__ float operator[](int k) const {
    const float4 v = q[k >> 2];
    return (k & 3) == 0 ? v.x : (k & 3) == 1 ? v.y : (k & 3) == 2 ? v.z : v.w;
  }
};

// A point in its winner's frame and the region code of _code: 0-2
// vertices, 3-5 edges, 6 the face. (a, b) is the point's in-plane offset
// from the code's feature as the pseudonormal dot takes it, e its
// distance from the edge line (edge codes).
struct Local {
  float t[9], ppx, ppy, ppz, z2, a, b, e, b0, b1, c0, c1;
  int code;
};

__device__ __forceinline__ Local classify(const Frame& f, float px, float py, float pz) {
  Local L;
#pragma unroll
  for (int k = 0; k < 9; ++k) L.t[k] = f[3 + k];
  const float dx = px - f[0];
  const float dy = py - f[1];
  const float dz = pz - f[2];
  const float* t = L.t;
  const float ppx = t[0] * dx + t[1] * dy + t[2] * dz;
  const float ppy = t[3] * dx + t[4] * dy + t[5] * dz;
  const float ppz = t[6] * dx + t[7] * dy + t[8] * dz;
  const float b0 = f[12], b1 = f[13], c0 = f[14], c1 = f[15];
  const float v2x = f[16], v3x = f[17], v3y = f[18];

  const float de1 = -ppy;
  const float de2 = (ppx - v2x) * b1 - ppy * b0;
  const float de3 = ppx * c1 - ppy * c0;
  const float rx2 = ppx - v2x;
  const float rx3 = ppx - v3x, ry3 = ppy - v3y;
  const float dot_b_v2 = rx2 * b0 + ppy * b1;
  const float dot_b_v3 = rx3 * b0 + ry3 * b1;
  const float dot_c_v1 = ppx * c0 + ppy * c1;
  const float dot_c_v3 = rx3 * c0 + ry3 * c1;

  int code;
  if (de1 >= 0.0f) {
    code = ppx <= 0.0f ? 0 : (ppx >= v2x ? 1 : 3);
  } else if (de2 >= 0.0f) {
    code = dot_b_v2 <= 0.0f ? 1 : (dot_b_v3 >= 0.0f ? 2 : 4);
  } else if (de3 >= 0.0f) {
    code = dot_c_v1 >= 0.0f ? 0 : (dot_c_v3 <= 0.0f ? 2 : 5);
  } else {
    code = 6;
  }
  L.code = code;
  L.ppx = ppx;
  L.ppy = ppy;
  L.ppz = ppz;
  L.z2 = ppz * ppz;
  // vertices: v1 (ppx, ppy), v2 (rx2, ppy), v3 (rx3, ry3); edges e1 and
  // e3 dot (ppx, ppy), e2 (rx2, ppy)
  L.a = (code == 1 || code == 4) ? rx2 : (code == 2 ? rx3 : ppx);
  L.b = code == 2 ? ry3 : ppy;
  L.e = code == 3 ? de1 : (code == 4 ? de2 : de3);
  L.b0 = b0;
  L.b1 = b1;
  L.c0 = c0;
  L.c1 = c1;
  return L;
}

// the first field of the code's pseudonormal triple (the face reads none)
__device__ __forceinline__ int normal_field(int code) {
  return code <= 2 ? kVertN + 3 * code : kEdgeN + 3 * (code - 3);
}

// The signed distance (and with Grad the gradient) of a classified point
// from its feature's normal n and, for the vertex codes, its world vertex vw.
template <bool Grad>
__device__ __forceinline__ float signed_finish(const Local& L, const float n[3],
                                               const float vw[3], float px, float py,
                                               float pz, float g[3]) {
  const int code = L.code;
  // the squared distance and the pseudonormal dot of the code's feature
  const float sq = code <= 2 ? L.a * L.a + L.b * L.b + L.z2 : L.e * L.e + L.z2;
  const float s = n[0] * L.a + n[1] * L.b + n[2] * L.ppz;
  const float sign = code == 6 ? 0.0f : torch_sign(s);
  const float d = code == 6 ? L.ppz : sign * sqrtf(sq);
  if (!Grad) return d;

  // signed_dist_grad_pair: the normal of the code's feature, each built as
  // the torch version builds all seven
  const float* t = L.t;
  const float tn[3] = {t[6], t[7], t[8]};
  const bool flat = code == 6 || (sign == 0.0f && sq == 0.0f);
  // edges: e1 (0, y, z); e2 and e3 the point less its component along b
  // or c, (x - dot u0, y - dot u1, z)
  const bool e2 = code == 4;
  const float u0 = e2 ? L.b0 : L.c0, u1 = e2 ? L.b1 : L.c1;
  const float dot = L.a * u0 + L.ppy * u1;
  const float x = code == 3 ? 0.0f : L.a - dot * u0;
  const float y = code == 3 ? L.ppy : L.ppy - dot * u1;
  float w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // _to_world(tri, x, y, z), component j: (t[0][j] x + t[1][j] y) + t[2][j] z
    const float edge = t[j] * x + t[3 + j] * y + t[6 + j] * L.ppz;
    const float p = j == 0 ? px : (j == 1 ? py : pz);
    w[j] = code <= 2 ? p - vw[j] : edge;
  }
  float nn[3];
  safe_normalize(w, tn, nn);
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = flat ? tn[j] : sign * nn[j];
  return d;
}

template <bool Grad>
__global__ void __launch_bounds__(kThreads)
    exact_finish_kernel(const float* __restrict__ pts_s, const int* __restrict__ win,
                        const long long* __restrict__ order, int P,
                        const float* __restrict__ table, FinishBox fb,
                        float* __restrict__ d_out, float* __restrict__ g_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  leaf::Box b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.mn[a] = fb.mn[a];
    b.sz[a] = fb.sz[a];
    b.half[a] = 0.5f * b.sz[a];
    b.ctr[a] = b.mn[a] + b.half[a];
  }
  const unsigned long long once = hint::evict_first();
  const float p[3] = {hint::load(pts_s + 3 * i, once), hint::load(pts_s + 3 * i + 1, once),
                      hint::load(pts_s + 3 * i + 2, once)};
  const int w = max(hint::load(win + i, once), 0);
  const long long o = hint::load(order + i, once);
  bool in_box = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rel = (p[a] - b.mn[a]) / b.sz[a];
    in_box = in_box && rel >= 0.0f && rel < 1.0f;
  }
  float d, g[3];
  if (in_box) {
    const float* row = table + static_cast<long long>(w) * kRow;
    Frame f;
#pragma unroll
    for (int m = 0; m < 5; ++m) f.q[m] = __ldg(reinterpret_cast<const float4*>(row) + m);
    const Local L = classify(f, p[0], p[1], p[2]);
    float n[3] = {0.0f, 0.0f, 0.0f}, vw[3] = {0.0f, 0.0f, 0.0f};
    if (L.code != 6) {
#pragma unroll
      for (int j = 0; j < 3; ++j) n[j] = __ldg(row + normal_field(L.code) + j);
    }
    if (Grad && L.code <= 2) {
#pragma unroll
      for (int j = 0; j < 3; ++j) vw[j] = __ldg(row + kVWorld + 3 * L.code + j);
    }
    d = signed_finish<Grad>(L, n, vw, p[0], p[1], p[2], g);
  } else {
    d = leaf::box_value(b, p, fb.fallback);
    if (Grad) leaf::box_gradient(b, p, g);
  }
  const unsigned long long keep = hint::evict_last();
  hint::store(d_out + o, d, keep);
  if (Grad) {
    float* gp = g_out + 3 * o;       // 8-byte aligned at even o, gp + 1 at odd o
    if ((o & 1) == 0) {
      hint::store2(gp, g[0], g[1], keep);
      hint::store(gp + 2, g[2], keep);
    } else {
      hint::store(gp, g[0], keep);
      hint::store2(gp + 1, g[1], g[2], keep);
    }
  }
}

}  // namespace

// pts_s (P, 3) leaf-sorted; win (P,) int32; order (P,) int64; table
// (T, 48) float32, row-major and 16-byte aligned; the box [bmin, bmin +
// bsize) and the fallback by value; d (P,); g (P, 3), 8-byte aligned, or
// null (no gradient). P < 0 returns cudaErrorInvalidValue.
extern "C" int sdf_exact_finish(const float* pts_s, const int* win, const long long* order,
                                int P, const float* table, float bx, float by, float bz,
                                float sx, float sy, float sz, float fallback, float* d, float* g,
                                void* stream) {
  if (P < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    const FinishBox fb{{bx, by, bz}, {sx, sy, sz}, fallback};
    const int blocks = (P + kThreads - 1) / kThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (g == nullptr) {
      exact_finish_kernel<false><<<blocks, kThreads, 0, st>>>(pts_s, win, order, P, table, fb,
                                                               d, g);
    } else {
      exact_finish_kernel<true><<<blocks, kThreads, 0, st>>>(pts_s, win, order, P, table, fb,
                                                              d, g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
