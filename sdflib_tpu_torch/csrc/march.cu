// K5 and K6: the sphere tracer's march and beam on the approximate
// octree's dense leaf grid, one thread a ray.
//
// K5, march_kernel, replaces the body of the JAX package's march loops,
// sdflib_tpu/render/sphere_trace.py _march_pyramid_jit (:411) over
// _grid_distance_and_step (:44), which XLA fused into one loop; the torch
// copy (render/sphere_trace.py _trip over ops/march.py
// _grid_distance_and_step) ran ~105 eager kernels a trip. A thread runs
// up to `trips` consecutive trips of its ray with the state (position,
// distance so far, last distance, active flag, step count) in registers:
// the distance and safe step of leaf_eval.cuh's leaf row (in a cell
// flagged surface-free, the exit of the free-radius box of bits 17-21 when
// that is farther), the move, the hit and far tests. A ray that is
// inactive at a trip leaves the loop: the torch trip moves it by step * 0
// and keeps its state, and its step is finite for a finite position and a
// direction with a non-zero component (the box exit takes the least axis
// time over the non-zero components). So one launch carries a whole
// round's budget (the tracer's frame launches it once a round, with no
// host check): a done ray costs one flag read.
//
// K6, beam_kernel, replaces _beam_prepass_jit (:541): up to `trips` trips
// of the beam rays (one a 4 x 4 tile), each step the longer of the
// radius-widened distance step and the tube-safe exit of the free box
// (every wall moved in by the tube radius, the exit where the first gap
// closes), stopping on proximity, past far, or on stagnation.
//
// Bound: bytes, the rays' state read and written once and each touched
// row read once: on the thin grid the 8-B grid row and the 256-B
// coefficient row its word names. The tracer marches the thin grid (2 MiB
// at bench.py's d6, with the octree words' ~1 MB), which stays in the
// H100's 50 MB L2 where the fused rows (128 MiB there) cannot; both hold
// the same values, so both routes give the same bits. The state stays in
// registers across the trips, where the torch trip wrote some 100
// temporaries of the ray count to device memory each trip; a launch
// allocates nothing, so a captured frame holds it as one node.
#include <cuda_runtime.h>
#include <math.h>

#include "leaf_eval.cuh"

namespace {

constexpr int kThreads = 256;

// _grid_distance_and_step's reads at one point: d, and in a free cell the
// free-radius box (outside the box: the box fallback, no row read).
struct Sample {
  float d;
  bool free_in;  // in the box, in a cell flagged surface-free (bit 16)
  float rmin[3], rsize[3];  // the free-radius box, valid when free_in
};

__device__ __forceinline__ Sample sample(const leaf::Grid& G, const leaf::Box& b,
                                         const float p[3]) {
  Sample s;
  float rel[3];
  int c[3];
  s.free_in = false;
  if (!leaf::grid_cell(G, b, p, rel, c)) {
    s.d = leaf::box_value(b, p, G.min_border);
    return s;
  }
  int dw;
  const float4* base = leaf::leaf_row(G, c, &dw);
  s.d = leaf::leaf_value<false>(G, base, rel, dw).x;
  s.free_in = ((dw >> 16) & 1) == 1;
  if (s.free_in) {
    const float rad = static_cast<float>((dw >> 17) & 0x1F);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s.rmin[a] = b.mn[a] + (static_cast<float>(c[a]) - rad) * b.cell;
      s.rsize[a] = (2.0f * rad + 1.0f) * b.cell;
    }
  }
  return s;
}

// The march's safe step: in a free cell the farther of d and the exit of
// the free-radius box (plus 1e-3 of a cell), else max(d, 0).
__device__ __forceinline__ float march_step(const Sample& s, const leaf::Box& b,
                                            const float p[3], const float u[3]) {
  if (!s.free_in) return leaf::nan_max(s.d, 0.0f);
  float t = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float far_face = s.rmin[a] + (u[a] > 0.0f ? 1.0f : 0.0f) * s.rsize[a];
    t = leaf::nan_min(t, u[a] != 0.0f ? (far_face - p[a]) / u[a] : INFINITY);
  }
  return leaf::nan_max(s.d, t + 1e-3f * b.cell);
}

// The beam's tube-safe exit step for a tube of radius sh growing by gr a
// unit of arclength: -inf unless the cell is free and the tube sits
// inside every wall of the free box.
__device__ __forceinline__ float beam_exit(const Sample& s, const leaf::Box& b,
                                           const float p[3], const float u[3],
                                           float sh, float gr) {
  if (!s.free_in) return -INFINITY;
  bool contained = true;
  float tn = INFINITY, tf = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gap_n = (p[a] - s.rmin[a]) - sh;
    const float gap_f = ((s.rmin[a] + s.rsize[a]) - p[a]) - sh;
    contained = contained && gap_n >= 0.0f && gap_f >= 0.0f;
    const float rate_n = gr - u[a];
    const float rate_f = gr + u[a];
    tn = leaf::nan_min(tn, rate_n > 0.0f ? gap_n / leaf::nan_max(rate_n, 1e-20f) : INFINITY);
    tf = leaf::nan_min(tf, rate_f > 0.0f ? gap_f / leaf::nan_max(rate_f, 1e-20f) : INFINITY);
  }
  return (contained ? leaf::nan_min(tn, tf) : -INFINITY) + 1e-3f * b.cell;
}

__global__ void __launch_bounds__(kThreads)
march_kernel(leaf::Grid G, float* __restrict__ pos, float* __restrict__ acc,
             float* __restrict__ last_d, float* __restrict__ active,
             int* __restrict__ its, const float* __restrict__ dirs, int n,
             float eps, float far, int trips) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  float a = active[r];
  if (!(a > 0.0f)) return;  // inactive: every trip leaves the ray as it is
  const leaf::Box b = leaf::load_box(G);
  const size_t o = 3 * static_cast<size_t>(r);
  float p[3] = {pos[o], pos[o + 1], pos[o + 2]};
  const float u[3] = {dirs[o], dirs[o + 1], dirs[o + 2]};
  float ac = acc[r], ld = last_d[r];
  int it = its[r];
  for (int t = 0; t < trips && a > 0.0f; ++t) {
    const Sample s = sample(G, b, p);
    const float moved = march_step(s, b, p, u) * a;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p[k] + u[k] * moved;
    ac = ac + moved;
    ld = s.d;
    it += 1;
    a = a * ((ld > eps && ac < far) ? 1.0f : 0.0f);
  }
  pos[o] = p[0];
  pos[o + 1] = p[1];
  pos[o + 2] = p[2];
  acc[r] = ac;
  last_d[r] = ld;
  active[r] = a;
  its[r] = it;
}

__global__ void __launch_bounds__(kThreads)
beam_kernel(leaf::Grid G, float* __restrict__ pos, float* __restrict__ acc,
            float* __restrict__ active, const float* __restrict__ dirs,
            const float* __restrict__ r0, const float* __restrict__ rd, int n,
            float margin, float half_margin, float far, int trips) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  float a = active[r];
  if (!(a > 0.0f)) return;
  const leaf::Box b = leaf::load_box(G);
  const size_t o = 3 * static_cast<size_t>(r);
  float p[3] = {pos[o], pos[o + 1], pos[o + 2]};
  const float u[3] = {dirs[o], dirs[o + 1], dirs[o + 2]};
  const float rr0 = r0[r], grow = rd[r];
  float ac = acc[r];
  for (int t = 0; t < trips && a > 0.0f; ++t) {
    const float radius = rr0 + ac * grow;
    const Sample s = sample(G, b, p);
    const float fstep = beam_exit(s, b, p, u, radius + margin, grow);
    const float dstep = leaf::nan_max(((s.d - radius) - margin) / (1.0f + grow), 0.0f);
    const float step = leaf::nan_max(dstep, fstep);
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

}  // namespace

extern "C" int sdf_march(const int* rows, int width, const float* coeffs,
                         int num_words, int depth, int tricubic,
                         const float* box_min, const float* box_size3,
                         float min_border, float* pos, float* acc, float* last_d,
                         float* active, int* its, const float* dirs, int n,
                         float eps, float far, int trips, void* stream) {
  if (n > 0 && trips > 0) {
    const leaf::Grid G{rows, width, coeffs, num_words, depth, tricubic,
                       box_min, box_size3, min_border};
    march_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        G, pos, acc, last_d, active, its, dirs, n, eps, far, trips);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sdf_beam(const int* rows, int width, const float* coeffs,
                        int num_words, int depth, int tricubic,
                        const float* box_min, const float* box_size3,
                        float min_border, float* pos, float* acc, float* active,
                        const float* dirs, const float* r0, const float* rd, int n,
                        float margin, float half_margin, float far, int trips,
                        void* stream) {
  if (n > 0 && trips > 0) {
    const leaf::Grid G{rows, width, coeffs, num_words, depth, tricubic,
                       box_min, box_size3, min_border};
    beam_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        G, pos, acc, active, dirs, r0, rd, n, margin, half_margin, far, trips);
  }
  return static_cast<int>(cudaGetLastError());
}
