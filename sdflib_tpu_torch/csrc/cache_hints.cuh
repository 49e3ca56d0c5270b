// L2 cache hints for the exact query's streams (K7, K9).
//
// A stream read once (the sort order, the sorted keys, points and
// winners) is loaded evict-first and not kept in L1, so it does not push
// out what is read again (the points K9 gathers, the rows K7 reads, the
// outputs K7 scatters). An output written in a random order (K7's unsort)
// is stored evict-last, so a 32-byte sector stays in L2 until its other
// points have filled it instead of going back to memory half written.
// Each hint was taken out on its own on an H100
// (sdflib_tpu_torch/tools/exact_ab.py --variants, PERF.md): without any
// one of K7's the gradient query was slower in every run; without K9's,
// K9 was 5-6% slower at d6 2^21.
#pragma once

#include <cuda_runtime.h>

namespace hint {

__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ unsigned long long evict_last() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// ld.global.nc, not allocated in L1, under an L2 policy
__device__ __forceinline__ float load(const float* a, unsigned long long policy) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(a), "l"(policy));
  return v;
}

__device__ __forceinline__ int load(const int* a, unsigned long long policy) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
               : "=r"(v)
               : "l"(a), "l"(policy));
  return v;
}

__device__ __forceinline__ long long load(const long long* a, unsigned long long policy) {
  long long v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.s64 %0, [%1], %2;"
               : "=l"(v)
               : "l"(a), "l"(policy));
  return v;
}

// st.global under an L2 policy: one float, or two at an 8-byte-aligned a
__device__ __forceinline__ void store(float* a, float v, unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(a), "f"(v), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void store2(float* a, float x, float y, unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;" ::"l"(a), "f"(x), "f"(y),
               "l"(policy)
               : "memory");
}

}  // namespace hint
