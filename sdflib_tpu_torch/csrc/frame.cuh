// A slot triangle's frame, shared by the two modes of K1 (scan_grouped.cu,
// scan_window.cu): the point-independent part of sq_dist_from_vertex_cols
// (ops/point_triangle.py), derived once per slot and row, and the
// evaluation of one point against it. Every expression keeps the operand
// order of the torch version; the library is built with --fmad=false, so
// both round alike.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "region.cuh"

constexpr int kFrameFloats = 19;     // floats of a Frame

struct Frame {
  float ax, ay, az;
  float sxx, sxy, sxz, syx, syy, syz, szx, szy, szz;
  float v2x, v3x, v3y, b0, b1, c0, c1;
};
static_assert(sizeof(Frame) == kFrameFloats * sizeof(float), "Frame is 19 floats");

// The frame of a triangle from its world vertices a, b, c.
__device__ __forceinline__ Frame triangle_frame(float ax, float ay, float az,
                                                float bx, float by, float bz,
                                                float cx, float cy, float cz) {
  Frame r;
  r.ax = ax;
  r.ay = ay;
  r.az = az;
  const float e1x = bx - r.ax, e1y = by - r.ay, e1z = bz - r.az;
  const float e2x = cx - r.ax, e2y = cy - r.ay, e2z = cz - r.az;
  const float il1 = rsqrtf(e1x * e1x + e1y * e1y + e1z * e1z);
  r.sxx = e1x * il1;
  r.sxy = e1y * il1;
  r.sxz = e1z * il1;
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float iln = rsqrtf(nx * nx + ny * ny + nz * nz);
  r.szx = nx * iln;
  r.szy = ny * iln;
  r.szz = nz * iln;
  r.syx = r.szy * r.sxz - r.szz * r.sxy;
  r.syy = r.szz * r.sxx - r.szx * r.sxz;
  r.syz = r.szx * r.sxy - r.szy * r.sxx;
  r.v2x = r.sxx * e1x + r.sxy * e1y + r.sxz * e1z;
  r.v3x = r.sxx * e2x + r.sxy * e2y + r.sxz * e2z;
  r.v3y = r.syx * e2x + r.syy * e2y + r.syz * e2z;
  const float bx2 = r.v3x - r.v2x, by2 = r.v3y;
  const float ilb = rsqrtf(bx2 * bx2 + by2 * by2);
  r.b0 = bx2 * ilb;
  r.b1 = by2 * ilb;
  const float cx2 = -r.v3x, cy2 = -r.v3y;
  const float ilc = rsqrtf(cx2 * cx2 + cy2 * cy2);
  r.c0 = cx2 * ilc;
  r.c1 = cy2 * ilc;
  return r;
}

// The frame of slot c of a field-major bucket row f of `ch` slots
// (component k of slot c at f[k * ch + c]).
__device__ __forceinline__ Frame slot_frame(const float* __restrict__ f, int c,
                                            int ch) {
  return triangle_frame(f[0 * ch + c], f[1 * ch + c], f[2 * ch + c],
                        f[3 * ch + c], f[4 * ch + c], f[5 * ch + c],
                        f[6 * ch + c], f[7 * ch + c], f[8 * ch + c]);
}

// kSelect: the select form of the region ladder (region.cuh).
template <bool kSelect = false>
__device__ __forceinline__ float frame_sq_dist(float px, float py, float pz,
                                               const Frame& r) {
  const float dx = px - r.ax, dy = py - r.ay, dz = pz - r.az;
  const float ppx = r.sxx * dx + r.sxy * dy + r.sxz * dz;
  const float ppy = r.syx * dx + r.syy * dy + r.syz * dz;
  const float ppz = r.szx * dx + r.szy * dy + r.szz * dz;
  return kSelect ? region_sq_dist_sel(ppx, ppy, ppz, r.v2x, r.v3x, r.v3y, r.b0,
                                      r.b1, r.c0, r.c1)
                 : region_sq_dist(ppx, ppy, ppz, r.v2x, r.v3x, r.v3y, r.b0, r.b1,
                                  r.c0, r.c1);
}
