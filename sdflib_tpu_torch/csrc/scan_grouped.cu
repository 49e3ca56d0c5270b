// K1 (grouped mode): the exact octree's candidate scan for sparse batches.
//
// Replaces the TPU kernel sdflib_tpu/ops/pallas_scan.py:_scan_kernel as
// launched by exact_scan_grouped_pallas. Points arrive sorted by leaf and
// cut into groups: runs of consecutive points that share one leaf, given
// as CSR offsets into the points (int32 throughout; the TPU path's float
// id carrier is not needed). Every point of a group scans its leaf's
// bucket rows [row0, row0 + nrows); a row holds 64 triangle ids (-1
// padded, anywhere) and their world vertices, field-major (9 x 64
// floats). Output: per sorted point, the winning triangle id: within a
// row the first minimal slot, across rows a strict <, a row whose minimum
// is NaN never wins, a point with no rows gets id 0.
//
// Design: each warp walks a run of kRun consecutive groups. Its first
// lanes load their group's offsets, leaf and row span at once, and a
// prefix scan numbers the run's items: each group's rows, once per pass of
// 32 of its points (one point a lane), from the offsets alone, never from
// distances. The items stream through a two-stage ring in shared memory
// with cp.async: while the warp evaluates one row, the next row's ids and
// fields, and on a pass's first row its points, are in flight. On each row
// lane l derives the frames of slots l and l + 32 (frame.cuh) from the
// staged fields, once for the warp, and the warp evaluates them for each
// point of the pass in turn: an any-vote for NaN, one redux.sync min over
// the 64 distances' bits (non-negative floats order as their bits) and a
// ballot for the first slot that reaches it give the row's winner; the
// lane that owns the point keeps its running best. The lanes evaluate
// different triangles for one point, so the region ladder is the select
// form (region.cuh). Groups past the last point cost one load of their
// offsets. 4-warp CTAs, 6 an SM (24 warps, at most 80 registers).
//
// Bound: bytes, one read of each fetched row's 2.5 KB and of the points
// (0.6717 ms for the 870,848 rows of the depth-7 cell's 2^20 points on an
// H100). What sets the pace (PERF.md): the compute of each row (frames and
// ladders with --fmad=false, the warp's votes) at 24 warps an SM, over a
// fetch that alone runs near the K3 probes' rate over the same rows.
// Measured and not kept: longer runs (a warp's long walk was slower, from
// 4 groups on), fetching only the halves of a row that hold an id (it
// needs the ids a step ahead of the fields) and skipping the frames of
// such halves.
#include <cuda_runtime.h>
#include <math.h>

#include "frame.cuh"

namespace {

constexpr int kWarps = 4;            // warps per CTA
constexpr int kMinBlocks = 6;        // CTAs an SM holds: 24 warps, <= 80 registers
constexpr int kRun = 2;              // groups a warp walks
constexpr int kStages = 2;           // rows in the ring: the one evaluated, the next
constexpr int kCH = 64;              // slots per bucket row
constexpr int kNF = 9;               // floats per slot (3 world vertices)
constexpr int kPass = 32;            // points a warp holds at once, one a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFirst = 1, kLast = 2; // an item's place in its pass's rows

// One stage of a warp's ring: an item (one bucket row of one pass of a
// group) as the warp decoded it, (row, base, n, flags), with the pass's
// points [base, base + n) on its first row, and the row's ids and fields.
struct Stage {
  int4 item;
  int ids[kCH];
  float fields[kNF * kCH];
  float pts[3 * kPass];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The run's groups, one a lane: group j's points [s, e), its rows
// [row0, row0 + nr), and its items [off, end) of the run's.
struct Run {
  int s, e, row0, nr, off, end;
};

__device__ __forceinline__ int4 decode(const Run& run, int k) {
  const int j = __popc(__ballot_sync(kFull, run.end <= k));   // uniform
  const int nr = __shfl_sync(kFull, run.nr, j);
  int local = k - __shfl_sync(kFull, run.off, j), q = 0;
  if (local >= nr) {
    q = local / nr;
    local -= q * nr;
  }
  const int base = __shfl_sync(kFull, run.s, j) + q * kPass;
  const int n = min(kPass, __shfl_sync(kFull, run.e, j) - base);
  return make_int4(__shfl_sync(kFull, run.row0, j) + local, base, n,
                   (local == 0 ? kFirst : 0) | (local == nr - 1 ? kLast : 0));
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
scan_grouped_kernel(const int* __restrict__ bucket_ids,
                    const float* __restrict__ bucket_fields, int num_rows,
                    const float* __restrict__ points,
                    const int* __restrict__ point_leaf,
                    const int* __restrict__ group_start, int num_groups,
                    const int* __restrict__ leaf_row0,
                    const int* __restrict__ leaf_nrows, int* __restrict__ win) {
  __shared__ Stage stages[kWarps][kStages];
  Stage* ring = stages[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int g = (blockIdx.x * kWarps + threadIdx.x / 32) * kRun + lane;

  Run run{0, 0, 0, 0, 0, 0};
  if (lane < kRun && g < num_groups) {
    run.s = group_start[g];
    run.e = group_start[g + 1];
    if (run.s < run.e) {
      const int leaf = point_leaf[run.s];
      run.row0 = leaf_row0[leaf];
      run.nr = leaf_nrows[leaf];
    }
  }
  // points of groups without rows get id 0
  for (unsigned m = __ballot_sync(kFull, run.s < run.e && run.nr <= 0); m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const int e = __shfl_sync(kFull, run.e, j);
    for (int p = __shfl_sync(kFull, run.s, j) + lane; p < e; p += 32) win[p] = 0;
  }
  const int items = run.nr > 0 ? (run.e - run.s + kPass - 1) / kPass * run.nr : 0;
  run.end = items;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, run.end, o);
    if (lane >= o) run.end += v;
  }
  run.off = run.end - items;
  const int total = __shfl_sync(kFull, run.end, 31);

  // item k into stage k % kStages: its row's ids and fields and, on its
  // pass's first row, the pass's points; one commit group an item
  auto fetch = [&](int k) {
    const int4 it = decode(run, k);
    Stage& st = ring[k % kStages];
    if (lane == 0) st.item = it;
    const int r = min(max(it.x, 0), num_rows - 1);
    const int* ids = bucket_ids + static_cast<size_t>(r) * kCH;
    const float* f = bucket_fields + static_cast<size_t>(r) * (kNF * kCH);
    if (lane < kCH / 4) cp_async16(&st.ids[4 * lane], ids + 4 * lane);
    for (int c = lane; c < kNF * kCH / 4; c += 32) cp_async16(&st.fields[4 * c], f + 4 * c);
    if (it.w & kFirst) {
      const float* p = points + 3 * static_cast<size_t>(it.y);
      for (int i = lane; i < 3 * it.z; i += 32) cp_async4(&st.pts[i], p + i);
    }
    cp_async_commit();
  };

  float px = 0.0f, py = 0.0f, pz = 0.0f, best = INFINITY;
  int best_id = 0;
  if (total > 0) fetch(0);  // total is uniform across the warp
  for (int m = 0; m < total; ++m) {
    if (m + 1 < total) {
      fetch(m + 1);              // in flight while item m is evaluated
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();                // item m has landed for every lane
    const Stage& st = ring[m % kStages];
    const int4 it = st.item;
    const int t0 = st.ids[lane];
    const int t1 = st.ids[lane + 32];
    if (it.w & kFirst) {  // lane l holds point base + l
      px = py = pz = 0.0f;
      if (lane < it.z) {
        px = st.pts[3 * lane + 0];
        py = st.pts[3 * lane + 1];
        pz = st.pts[3 * lane + 2];
      }
      best = INFINITY;
      best_id = 0;
    }
    const Frame f0 = slot_frame(st.fields, lane, kCH);
    const Frame f1 = slot_frame(st.fields, lane + 32, kCH);
    for (int j = 0; j < it.z; ++j) {  // j is uniform across the warp
      const float qx = __shfl_sync(kFull, px, j);
      const float qy = __shfl_sync(kFull, py, j);
      const float qz = __shfl_sync(kFull, pz, j);
      const float d0 = t0 >= 0 ? frame_sq_dist<true>(qx, qy, qz, f0) : INFINITY;
      const float d1 = t1 >= 0 ? frame_sq_dist<true>(qx, qy, qz, f1) : INFINITY;
      if (__any_sync(kFull, d0 != d0 || d1 != d1)) continue;  // NaN row
      // distances are >= +0 or +inf, so their bits order as they do
      const float mn = __uint_as_float(
          __reduce_min_sync(kFull, __float_as_uint(fminf(d0, d1))));
      if (!(mn < __shfl_sync(kFull, best, j))) continue;
      // first minimal slot: slots 0-31 (d0 of lanes 0-31) before 32-63
      const unsigned lo = __ballot_sync(kFull, d0 == mn);
      const int slot = lo ? __ffs(lo) - 1 : 31 + __ffs(__ballot_sync(kFull, d1 == mn));
      const int tid = __shfl_sync(kFull, slot < 32 ? t0 : t1, slot & 31);
      if (lane == j) {
        best = mn;
        best_id = tid;
      }
    }
    if ((it.w & kLast) && lane < it.z) win[it.y + lane] = best_id;
    __syncwarp();                // stage m % kStages is free for item m + 2
  }
}

}  // namespace

extern "C" int sdf_scan_grouped(const int* bucket_ids, const float* bucket_fields,
                                int num_rows, const float* points,
                                const int* point_leaf, const int* group_start,
                                int num_groups, const int* leaf_row0,
                                const int* leaf_nrows, int* win, void* stream) {
  if (num_groups > 0) {
    const int per_cta = kWarps * kRun;
    scan_grouped_kernel<<<(num_groups + per_cta - 1) / per_cta, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        bucket_ids, bucket_fields, num_rows, points, point_leaf, group_start, num_groups,
        leaf_row0, leaf_nrows, win);
  }
  return static_cast<int>(cudaGetLastError());
}

// Warps of the kernel an SM holds at once (-1 if the query fails).
extern "C" int sdf_scan_grouped_warps_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scan_grouped_kernel,
                                                    kWarps * 32, 0) != cudaSuccess)
    return -1;
  return blocks * kWarps;
}
