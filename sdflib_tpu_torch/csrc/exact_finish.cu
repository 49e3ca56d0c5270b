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
// pack_triangle_full_fields, then the 9 world-vertex floats) and writes
// d[order[i]] (and g[order[i]]): inside the box [box_min, box_min +
// box_size3), the signed distance to the winner (a winner of -1 reads
// triangle 0); outside it box_distance + fallback (leaf_eval.cuh's
// box_value, whose 3-term sums take torch's CUDA order), and
// box_distance_gradient's gradient. Out-of-box points read no row.
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
// that is ~0.018 ms on an H100, against ~70 flops a point (~150 with the
// gradient). The sorted points of a warp share few winners, so the rows
// come from L1 after the first lane's miss; the scatter of the outputs
// to order[i] is the random access, one 32 B sector a point. The table's
// strides are arguments, so one kernel reads either layout: row-major,
// where a row is five consecutive sectors, or field-major, where a field
// of neighbouring triangles shares a sector (PERF.md compares the two).
#include <cuda_runtime.h>
#include <math.h>

#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;
// finish-table fields (ops/point_triangle.py _F_*, ops/exact_query.py)
constexpr int kOrigin = 0, kTransform = 3, kB = 12, kC = 14, kV2x = 16, kV3 = 17;
constexpr int kEdgeN = 19, kVertN = 28, kVWorld = 37;

struct Row {
  const float* base;
  long long stride;
  __device__ __forceinline__ float operator()(int r) const { return __ldg(base + r * stride); }
};

// torch.sign on the card: (0 < v) - (v < 0), so 0 at 0 and at NaN
__device__ __forceinline__ float torch_sign(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

// _safe_normalize(vec, tn): torch's sum of 3 terms, (x0 + x2) + x1; rsqrt
// of the sum clamped to 1e-38 where it is positive, else the fallback tn
__device__ __forceinline__ void safe_normalize(float v0, float v1, float v2,
                                               const float tn[3], float out[3]) {
  const float n2 = (v0 * v0 + v2 * v2) + v1 * v1;
  if (n2 > 0.0f) {
    const float inv = rsqrtf(fmaxf(n2, 1e-38f));
    out[0] = v0 * inv;
    out[1] = v1 * inv;
    out[2] = v2 * inv;
  } else {
    out[0] = tn[0];
    out[1] = tn[1];
    out[2] = tn[2];
  }
}

// _to_world(tri, x, y, z), component j: (t[0][j] x + t[1][j] y) + t[2][j] z
__device__ __forceinline__ void to_world(const float t[9], float x, float y, float z,
                                         float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = t[j] * x + t[3 + j] * y + t[6 + j] * z;
}

template <bool Grad>
__device__ __forceinline__ float signed_finish(const Row& f, float px, float py, float pz,
                                               float g[3]) {
  float t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = f(kTransform + k);
  const float dx = px - f(kOrigin);
  const float dy = py - f(kOrigin + 1);
  const float dz = pz - f(kOrigin + 2);
  const float ppx = t[0] * dx + t[1] * dy + t[2] * dz;
  const float ppy = t[3] * dx + t[4] * dy + t[5] * dz;
  const float ppz = t[6] * dx + t[7] * dy + t[8] * dz;
  const float b0 = f(kB), b1 = f(kB + 1), c0 = f(kC), c1 = f(kC + 1);
  const float v2x = f(kV2x), v3x = f(kV3), v3y = f(kV3 + 1);

  const float de1 = -ppy;
  const float de2 = (ppx - v2x) * b1 - ppy * b0;
  const float de3 = ppx * c1 - ppy * c0;
  const float z2 = ppz * ppz;
  const float rx2 = ppx - v2x;
  const float rx3 = ppx - v3x, ry3 = ppy - v3y;
  const float dot_b_v2 = rx2 * b0 + ppy * b1;
  const float dot_b_v3 = rx3 * b0 + ry3 * b1;
  const float dot_c_v1 = ppx * c0 + ppy * c1;
  const float dot_c_v3 = rx3 * c0 + ry3 * c1;

  // the region code of _code: 0-2 vertices, 3-5 edges, 6 the face
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
  // the squared distance and the pseudonormal dot of the code's feature
  float sq, s;
  switch (code) {
    case 0:
      sq = ppx * ppx + ppy * ppy + z2;
      s = f(kVertN) * ppx + f(kVertN + 1) * ppy + f(kVertN + 2) * ppz;
      break;
    case 1:
      sq = rx2 * rx2 + ppy * ppy + z2;
      s = f(kVertN + 3) * rx2 + f(kVertN + 4) * ppy + f(kVertN + 5) * ppz;
      break;
    case 2:
      sq = rx3 * rx3 + ry3 * ry3 + z2;
      s = f(kVertN + 6) * rx3 + f(kVertN + 7) * ry3 + f(kVertN + 8) * ppz;
      break;
    case 3:
      sq = de1 * de1 + z2;
      s = f(kEdgeN) * ppx + f(kEdgeN + 1) * ppy + f(kEdgeN + 2) * ppz;
      break;
    case 4:
      sq = de2 * de2 + z2;
      s = f(kEdgeN + 3) * rx2 + f(kEdgeN + 4) * ppy + f(kEdgeN + 5) * ppz;
      break;
    case 5:
      sq = de3 * de3 + z2;
      s = f(kEdgeN + 6) * ppx + f(kEdgeN + 7) * ppy + f(kEdgeN + 8) * ppz;
      break;
    default:
      sq = z2;
      s = ppz;
  }
  const float sign = torch_sign(s);
  const float d = code == 6 ? ppz : sign * sqrtf(sq);
  if (!Grad) return d;

  // signed_dist_grad_pair: the normal of the code's feature, each built as
  // the torch version builds all seven
  const float tn[3] = {t[6], t[7], t[8]};
  const bool on_rim = code != 6 && sign == 0.0f && sq == 0.0f;
  if (code == 6 || on_rim) {
    g[0] = tn[0];
    g[1] = tn[1];
    g[2] = tn[2];
    return d;
  }
  float n[3], w[3];
  if (code <= 2) {
    const int v = kVWorld + 3 * code;
    safe_normalize(px - f(v), py - f(v + 1), pz - f(v + 2), tn, n);
  } else if (code == 3) {
    to_world(t, 0.0f, ppy, ppz, w);
    safe_normalize(w[0], w[1], w[2], tn, n);
  } else if (code == 4) {
    const float dot_b = (ppx - v2x) * b0 + ppy * b1;
    to_world(t, (ppx - v2x) - dot_b * b0, ppy - dot_b * b1, ppz, w);
    safe_normalize(w[0], w[1], w[2], tn, n);
  } else {
    const float dot_c = ppx * c0 + ppy * c1;
    to_world(t, ppx - dot_c * c0, ppy - dot_c * c1, ppz, w);
    safe_normalize(w[0], w[1], w[2], tn, n);
  }
  g[0] = sign * n[0];
  g[1] = sign * n[1];
  g[2] = sign * n[2];
  return d;
}

template <bool Grad>
__global__ void exact_finish_kernel(const float* __restrict__ pts_s, const int* __restrict__ win,
                                    const long long* __restrict__ order, int P,
                                    const float* __restrict__ table, long long ts,
                                    long long rs, const float* __restrict__ box_min,
                                    const float* __restrict__ box_size3, float fallback,
                                    float* __restrict__ d_out, float* __restrict__ g_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  leaf::Box b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.mn[a] = box_min[a];
    b.sz[a] = box_size3[a];
    b.half[a] = 0.5f * b.sz[a];
    b.ctr[a] = b.mn[a] + b.half[a];
  }
  const float p[3] = {pts_s[3 * i], pts_s[3 * i + 1], pts_s[3 * i + 2]};
  bool in_box = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rel = (p[a] - b.mn[a]) / b.sz[a];
    in_box = in_box && rel >= 0.0f && rel < 1.0f;
  }
  float d, g[3];
  if (in_box) {
    const int w = max(win[i], 0);
    const Row f{table + w * ts, rs};
    d = signed_finish<Grad>(f, p[0], p[1], p[2], g);
  } else {
    d = leaf::box_value(b, p, fallback);
    if (Grad) leaf::box_gradient(b, p, g);
  }
  const long long o = order[i];
  d_out[o] = d;
  if (Grad) {
    g_out[3 * o] = g[0];
    g_out[3 * o + 1] = g[1];
    g_out[3 * o + 2] = g[2];
  }
}

}  // namespace

// pts_s (P, 3) leaf-sorted; win (P,) int32; order (P,) int64; table
// (T, 48) float32, element (t, r) at table[t * ts + r * rs]; d (P,); g
// (P, 3) or null (no gradient). Strides below 1 return
// cudaErrorInvalidValue.
extern "C" int sdf_exact_finish(const float* pts_s, const int* win, const long long* order,
                                int P, const float* table, long long ts, long long rs,
                                const float* box_min, const float* box_size3, float fallback,
                                float* d, float* g, void* stream) {
  if (ts <= 0 || rs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    const int blocks = (P + kThreads - 1) / kThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (g == nullptr) {
      exact_finish_kernel<false><<<blocks, kThreads, 0, st>>>(
          pts_s, win, order, P, table, ts, rs, box_min, box_size3, fallback, d, g);
    } else {
      exact_finish_kernel<true><<<blocks, kThreads, 0, st>>>(
          pts_s, win, order, P, table, ts, rs, box_min, box_size3, fallback, d, g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
