// Point-triangle squared distance shared by the kernels: the region
// ladder of TriangleUtils.h:76-135 with its tie-breaking (>= vs <=), as
// sdflib_tpu_torch/ops/point_triangle.py (_ladder) computes it. Every
// expression keeps the operand order of the torch version; the library is
// built with --fmad=false, so both round alike.
//
// Two forms with the same result bit for bit: region_sq_dist branches,
// which is cheaper where the threads of a warp take the same region of
// their triangles (K2 with its points in Morton order); region_sq_dist_sel
// computes every region's operands and selects, which is cheaper where
// they do not (K1w and K1g, whose lanes evaluate different triangles for
// one point, and K2 on points as given). PERF.md has the paired timings.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float region_sq_dist(
    float ppx, float ppy, float ppz, float v2x, float v3x, float v3y,
    float b0, float b1, float c0, float c1) {
  const float de1 = -ppy;
  const float de2 = (ppx - v2x) * b1 - ppy * b0;
  const float de3 = ppx * c1 - ppy * c0;
  const float z2 = ppz * ppz;
  const float rx2 = ppx - v2x;
  const float rx3 = ppx - v3x;
  const float ry3 = ppy - v3y;
  if (de1 >= 0.0f) {
    if (ppx <= 0.0f) return ppx * ppx + ppy * ppy + z2;
    if (ppx >= v2x) return rx2 * rx2 + ppy * ppy + z2;
    return de1 * de1 + z2;
  }
  if (de2 >= 0.0f) {
    if (rx2 * b0 + ppy * b1 <= 0.0f) return rx2 * rx2 + ppy * ppy + z2;
    if (rx3 * b0 + ry3 * b1 >= 0.0f) return rx3 * rx3 + ry3 * ry3 + z2;
    return de2 * de2 + z2;
  }
  if (de3 >= 0.0f) {
    if (ppx * c0 + ppy * c1 >= 0.0f) return ppx * ppx + ppy * ppy + z2;
    if (rx3 * c0 + ry3 * c1 <= 0.0f) return rx3 * rx3 + ry3 * ry3 + z2;
    return de3 * de3 + z2;
  }
  return z2;
}

// region_sq_dist with every region's return written as x * x + y * y + z2
// (an edge as (de, 0), the inside as (0, 0): adding +0 is exact), the
// region chosen by selects in the ladder's order: no branches.
__device__ __forceinline__ float region_sq_dist_sel(
    float ppx, float ppy, float ppz, float v2x, float v3x, float v3y,
    float b0, float b1, float c0, float c1) {
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
  const float x = de1 >= 0.0f ? x1 : (de2 >= 0.0f ? x2 : (de3 >= 0.0f ? x3 : 0.0f));
  const float y = de1 >= 0.0f ? y1 : (de2 >= 0.0f ? y2 : (de3 >= 0.0f ? y3 : 0.0f));
  return x * x + y * y + z2;
}
