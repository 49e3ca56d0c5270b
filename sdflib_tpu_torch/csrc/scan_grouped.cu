// K1 (grouped mode): the exact octree's candidate scan for sparse batches.
//
// Replaces the TPU kernel sdflib_tpu/ops/pallas_scan.py:_scan_kernel as
// launched by exact_scan_grouped_pallas. Points arrive sorted by leaf and
// cut into groups: runs of at most G consecutive points that share one
// leaf, given as CSR offsets into the points (int32 throughout; the TPU
// path's float id carrier is not needed). Every point of a group scans its
// leaf's bucket rows [row0, row0 + nrows); a row holds 64 triangle ids (-1
// padded) and their world vertices, field-major (9 x 64 floats). Output:
// per sorted point, the winning triangle id, with the rules of the window
// kernel: within a row the first minimal slot, across rows a strict <, a
// row whose minimum is NaN never wins, a point with no rows gets id 0.
//
// Design: one warp per group, parallel over slots rather than points. Lane
// l owns slots l and l + 32 of each row: it loads their vertices straight
// from device memory (each field a coalesced 128-byte load per warp),
// derives their triangle frames once per row, and evaluates both slots for
// each point of the group in turn. A warp min over the 64 distances, a
// ballot for the first slot that reaches it and an any-vote for NaN give
// the row's winner for that point; the lane that owns the point keeps its
// running best. Groups of more than 64 points run in passes of 64.
//
// Why it fits sparse batches: with ~0.5 points per leaf most groups hold
// one point, and a point-per-lane kernel would leave 31 lanes idle while
// one lane derives 64 frames; here all 32 lanes work and each frame is
// derived once per row, not once per point.
//
// Bound: operations. A row's 2.5 KB is read once per group; each
// (point, slot) pair costs ~34 flops after the frame (~78 flops per slot
// and row) plus the warp's shuffles and votes per point and row, which at
// one or two points a group dominate the evaluation itself.
#include <cuda_runtime.h>
#include <math.h>

#include "frame.cuh"

namespace {

constexpr int kWarps = 8;            // groups per CTA
constexpr int kCH = 64;              // slots per bucket row
constexpr int kNF = 9;               // floats per slot (3 world vertices)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
scan_grouped_kernel(const int* __restrict__ bucket_ids,
                    const float* __restrict__ bucket_fields, int num_rows,
                    const float* __restrict__ points,
                    const int* __restrict__ point_leaf,
                    const int* __restrict__ group_start, int num_groups,
                    const int* __restrict__ leaf_row0,
                    const int* __restrict__ leaf_nrows, int* __restrict__ win) {
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= num_groups) return;  // uniform across the warp
  const int start = group_start[g];
  const int end = group_start[g + 1];
  if (start >= end) return;
  const int leaf = point_leaf[start];
  const int row0 = leaf_row0[leaf];
  const int nrows = leaf_nrows[leaf];

  for (int base = start; base < end; base += 64) {
    const int n = min(64, end - base);
    // lane l holds points base + l (set a) and base + 32 + l (set b)
    float ax = 0.0f, ay = 0.0f, az = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    if (lane < n) {
      ax = points[3 * (base + lane) + 0];
      ay = points[3 * (base + lane) + 1];
      az = points[3 * (base + lane) + 2];
    }
    if (lane + 32 < n) {
      bx = points[3 * (base + 32 + lane) + 0];
      by = points[3 * (base + 32 + lane) + 1];
      bz = points[3 * (base + 32 + lane) + 2];
    }
    float best_a = INFINITY, best_b = INFINITY;
    int id_a = 0, id_b = 0;
    for (int i = 0; i < nrows; ++i) {
      const int r = min(max(row0 + i, 0), num_rows - 1);
      const int* ids = bucket_ids + static_cast<size_t>(r) * kCH;
      const float* f = bucket_fields + static_cast<size_t>(r) * (kNF * kCH);
      const int t0 = ids[lane];
      const int t1 = ids[lane + 32];
      const Frame f0 = slot_frame(f, lane, kCH);
      const Frame f1 = slot_frame(f, lane + 32, kCH);
      for (int j = 0; j < n; ++j) {  // j is uniform across the warp
        const bool in_a = j < 32;
        const int src = j & 31;
        const float px = __shfl_sync(kFull, in_a ? ax : bx, src);
        const float py = __shfl_sync(kFull, in_a ? ay : by, src);
        const float pz = __shfl_sync(kFull, in_a ? az : bz, src);
        const float d0 = t0 >= 0 ? frame_sq_dist(px, py, pz, f0) : INFINITY;
        const float d1 = t1 >= 0 ? frame_sq_dist(px, py, pz, f1) : INFINITY;
        if (__any_sync(kFull, d0 != d0 || d1 != d1)) continue;  // NaN row
        const float m = warp_min(fminf(d0, d1));
        const float cur = __shfl_sync(kFull, in_a ? best_a : best_b, src);
        if (!(m < cur)) continue;
        // first minimal slot: slots 0-31 (d0 of lanes 0-31) before 32-63
        const unsigned lo = __ballot_sync(kFull, d0 == m);
        const int slot = lo ? __ffs(lo) - 1 : 31 + __ffs(__ballot_sync(kFull, d1 == m));
        const int tid = __shfl_sync(kFull, slot < 32 ? t0 : t1, slot & 31);
        if (lane == src) {
          if (in_a) {
            best_a = m;
            id_a = tid;
          } else {
            best_b = m;
            id_b = tid;
          }
        }
      }
    }
    if (lane < n) win[base + lane] = id_a;
    if (lane + 32 < n) win[base + 32 + lane] = id_b;
  }
}

}  // namespace

extern "C" int sdf_scan_grouped(const int* bucket_ids, const float* bucket_fields,
                                int num_rows, const float* points,
                                const int* point_leaf, const int* group_start,
                                int num_groups, const int* leaf_row0,
                                const int* leaf_nrows, int* win, void* stream) {
  if (num_groups > 0) {
    const int blocks = (num_groups + kWarps - 1) / kWarps;
    scan_grouped_kernel<<<blocks, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        bucket_ids, bucket_fields, num_rows, points, point_leaf, group_start,
        num_groups, leaf_row0, leaf_nrows, win);
  }
  return static_cast<int>(cudaGetLastError());
}
