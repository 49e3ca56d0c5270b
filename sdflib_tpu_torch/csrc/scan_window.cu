// K1 (window mode): the exact octree's candidate scan.
//
// Replaces the TPU kernel sdflib_tpu/ops/pallas_scan.py:_scan_kernel as
// launched by exact_scan_window_pallas, with the semantics of the XLA
// window scan it is held against (sdflib_tpu/sdf/exact_octree.py:
// _exact_scan_window_xla). Points arrive sorted by leaf and cut into fixed
// windows of 32; each point carries its leaf's first bucket row b0 and row
// count nc. A bucket row holds 64 triangle ids (-1 padded) and their world
// vertices, field-major (9 x 64 floats). Output: per point, the id of the
// winning triangle: within a row the first minimal slot, across rows a
// strict < (a row whose minimum is NaN, from a zero-area triangle, never
// wins, as with the NaN-propagating row minimum of the JAX scan); a point
// with no rows gets id 0.
//
// Design: one warp per window, one point per lane. The warp reduces its
// lanes' spans to the window's union [lo, hi) and walks it; after a row it
// jumps to the smallest row some lane still needs, so rows of leaves that
// lie between a sparse window's leaves are never fetched. That row sequence
// depends on b0 and nc only, so while the warp evaluates one row its lanes
// already hold the next row's vertices in registers (lane l loads slots l
// and l + 32, each field a coalesced 128-byte load per warp). At the top of
// a row lane l derives the frames of its two slots (frame.cuh), once for
// the whole warp. The warp then runs over the row's active points (those
// whose span covers it) one by one, parallel over the slots as the grouped
// kernel does: every lane evaluates its two slots for the point, and a warp
// min, a ballot for the first minimal slot and an any-vote for NaN give the
// row's winner, the lexicographic (distance, slot) minimum. Each lane reads
// only the frames it derived, so they stay in registers. At the bench's
// dense batch (~14 points a leaf) about 43% of a window's points need each
// visited row, at a sparse one 5%; slot-parallel, the lanes of points that
// do not need the row work too. The lanes evaluate different triangles, so
// the region ladder is the select form (frame_sq_dist<true>; region.cuh),
// with no divergent branches.
//
// Bound: by PERF.md's rule (bytes or operations over the card's peaks),
// bytes: one read of each visited row's 2.5 KB and of the points (0.0895
// ms at the bench's 2^21 points over the depth-6 torus, on an H100), above
// the operations (~34 flops a point-slot pair of a point's own rows, ~78 a
// slot frame). What sets the pace is instruction issue: the row fetch takes
// a sixth of the kernel's time. With --fmad=false a multiply and an add
// issue separately, the select ladder computes every region's terms, and
// each active point of each row costs every lane two point-slot pairs and
// the warp's shuffles and votes.
#include <cuda_runtime.h>
#include <math.h>

#include "frame.cuh"

namespace {

constexpr int kWindow = 32;          // points per window = warp width
constexpr int kWarps = 8;            // windows per CTA
constexpr int kCH = 64;              // slots per bucket row
constexpr int kNF = 9;               // floats per slot (3 world vertices)
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_minf(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The vertices of slots lane and lane + 32 of one bucket row, in registers.
struct SlotVerts {
  float a[kNF], b[kNF];
  int ta, tb;
};

__device__ __forceinline__ void load_slots(SlotVerts& v, const int* __restrict__ ids,
                                           const float* __restrict__ fields,
                                           int num_rows, int row, int lane) {
  const int r = min(max(row, 0), num_rows - 1);
  const int* src_ids = ids + static_cast<size_t>(r) * kCH;
  const float* f = fields + static_cast<size_t>(r) * (kNF * kCH);
  v.ta = src_ids[lane];
  v.tb = src_ids[lane + 32];
#pragma unroll
  for (int k = 0; k < kNF; ++k) {
    v.a[k] = f[k * kCH + lane];
    v.b[k] = f[k * kCH + lane + 32];
  }
}

__device__ __forceinline__ Frame verts_frame(const float* v) {
  return triangle_frame(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]);
}

__global__ void __launch_bounds__(kWarps * kWindow)
scan_window_kernel(const int* __restrict__ bucket_ids,
                   const float* __restrict__ bucket_fields, int num_rows,
                   const float* __restrict__ points,
                   const int* __restrict__ b0, const int* __restrict__ nc,
                   int num_windows, int* __restrict__ win) {
  const int lane = threadIdx.x % kWindow;
  const int w = blockIdx.x * kWarps + threadIdx.x / kWindow;
  if (w >= num_windows) return;  // uniform across the warp

  const int p = w * kWindow + lane;
  const float px = points[3 * p + 0];
  const float py = points[3 * p + 1];
  const float pz = points[3 * p + 2];
  const int pb0 = b0[p];
  const bool live = nc[p] > 0;
  const int pend = live ? pb0 + nc[p] : 0;
  const int hi = warp_max(pend);
  int row = warp_min(live ? pb0 : kBig);

  float best = INFINITY;
  int best_id = 0;
  SlotVerts v;
  if (row < hi) load_slots(v, bucket_ids, bucket_fields, num_rows, row, lane);
  while (row < hi) {
    const Frame f0 = verts_frame(v.a), f1 = verts_frame(v.b);
    const int t0 = v.ta, t1 = v.tb;
    const int next =
        warp_min((live && pb0 > row) ? pb0 : (row + 1 < pend ? row + 1 : kBig));
    if (next < hi) load_slots(v, bucket_ids, bucket_fields, num_rows, next, lane);

    // the warp runs over the active points, parallel over the slots
    const unsigned active = __ballot_sync(kFull, row >= pb0 && row < pend);
    for (unsigned m = active; m != 0; m &= m - 1) {
      const int src = __ffs(m) - 1;  // uniform across the warp
      const float qx = __shfl_sync(kFull, px, src);
      const float qy = __shfl_sync(kFull, py, src);
      const float qz = __shfl_sync(kFull, pz, src);
      const float d0 = t0 >= 0 ? frame_sq_dist<true>(qx, qy, qz, f0) : INFINITY;
      const float d1 = t1 >= 0 ? frame_sq_dist<true>(qx, qy, qz, f1) : INFINITY;
      if (__any_sync(kFull, d0 != d0 || d1 != d1)) continue;  // NaN row
      const float mn = warp_minf(fminf(d0, d1));
      const float cur = __shfl_sync(kFull, best, src);
      if (!(mn < cur)) continue;
      // first minimal slot: slots 0-31 (d0 of lanes 0-31) before 32-63
      const unsigned lo = __ballot_sync(kFull, d0 == mn);
      const int slot = lo ? __ffs(lo) - 1 : 31 + __ffs(__ballot_sync(kFull, d1 == mn));
      const int tid = __shfl_sync(kFull, slot < 32 ? t0 : t1, slot & 31);
      if (lane == src) {
        best = mn;
        best_id = tid;
      }
    }
    row = next;
  }
  win[p] = best_id;
}

}  // namespace

extern "C" int sdf_scan_window(const int* bucket_ids, const float* bucket_fields,
                               int num_rows, const float* points, const int* b0,
                               const int* nc, int num_windows, int* win,
                               void* stream) {
  if (num_windows > 0) {
    const int blocks = (num_windows + kWarps - 1) / kWarps;
    scan_window_kernel<<<blocks, kWarps * kWindow, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        bucket_ids, bucket_fields, num_rows, points, b0, nc, num_windows, win);
  }
  return static_cast<int>(cudaGetLastError());
}
