// K3a and K3b: the row-fetch probes. For each of N row ids into a (NB, W)
// float table, fetch the row and write its minimum (NaN if the row holds
// one, as torch's amin gives). Row ids outside [0, NB) are clamped.
//
// K3a, row_min_block, replaces scripts/perf_pallas_gather.py:_blk_kernel
// (pallas_block_min), which fetched one row per grid step through a
// scalar-prefetched index map. Here one warp fetches one row with plain
// coalesced 16-byte loads and reduces it with shuffles.
//
// K3b, row_min_tile, replaces scripts/perf_pallas_gather.py:_dma_kernel
// (pallas_dma_min), which started `tile` manual row DMAs per grid step.
// Here each CTA owns `tile` consecutive row ids; each of its 8 warps
// fetches every 8th of them with cp.async 16-byte copies into its own ring
// of 4 shared-memory stages, keeping 3 rows in flight while it reduces the
// oldest.
//
// Bound: bytes. Each fetched row is W * 4 bytes and costs W comparisons,
// so both kernels are bounded by the device-memory rate (L2 where rows
// repeat); they measure the rate at which the card fetches scattered rows,
// which bounds K1's row stream. Both need W % 4 == 0 (16-byte loads).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;    // rows in flight per CTA (K3a), warps (K3b)
constexpr int kStages = 4;   // K3b: ring depth per warp
constexpr unsigned kFull = 0xffffffffu;

// min that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

__device__ __forceinline__ float min4(float m, float4 v) {
  return nan_min(nan_min(nan_min(nan_min(m, v.x), v.y), v.z), v.w);
}

__device__ __forceinline__ float warp_nan_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int clamp_row(int r, int num_rows) {
  return min(max(r, 0), num_rows - 1);
}

__global__ void __launch_bounds__(kWarps * 32)
row_min_block_kernel(const float4* __restrict__ table, int num_rows, int w4,
                     const int* __restrict__ rows, int n,
                     float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n) return;
  const float4* src = table + static_cast<size_t>(clamp_row(rows[i], num_rows)) * w4;
  float m = INFINITY;
  for (int k = lane; k < w4; k += 32) m = min4(m, src[k]);
  m = warp_nan_min(m);
  if (lane == 0) out[i] = m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kWarps * 32)
row_min_tile_kernel(const float4* __restrict__ table, int num_rows, int w4,
                    const int* __restrict__ rows, int tile,
                    float* __restrict__ out) {
  extern __shared__ float4 ring[];  // [kWarps][kStages][w4]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float4* mine = ring + static_cast<size_t>(warp) * kStages * w4;
  const int base = blockIdx.x * tile + warp;     // this warp's first row id
  const int count = warp < tile ? (tile - warp + kWarps - 1) / kWarps : 0;

  // one commit group per row (empty past the end, so the wait count holds)
  auto fetch = [&](int k) {
    if (k < count) {
      const float4* src =
          table + static_cast<size_t>(clamp_row(rows[base + k * kWarps], num_rows)) * w4;
      float4* dst = mine + (k % kStages) * w4;
      for (int i = lane; i < w4; i += 32) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  for (int k = 0; k < count; ++k) {
    // stage (k - 1) % kStages was reduced in the previous step
    fetch(k + kStages - 1);
    cp_async_wait<kStages - 1>();  // row k has landed (for this lane)
    __syncwarp();                  // ... and for every lane of the warp
    const float4* buf = mine + (k % kStages) * w4;
    float m = INFINITY;
    for (int i = lane; i < w4; i += 32) m = min4(m, buf[i]);
    m = warp_nan_min(m);
    if (lane == 0) out[base + k * kWarps] = m;
    __syncwarp();                  // the stage is free for reuse
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int sdf_row_min_block(const float* table, int num_rows, int w,
                                 const int* rows, int n, float* out,
                                 void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    row_min_block_kernel<<<blocks, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(table), num_rows, w / 4, rows, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory the tile kernel needs for rows of w floats.
extern "C" int sdf_row_min_tile_smem(int w) {
  return kWarps * kStages * w * static_cast<int>(sizeof(float));
}

extern "C" int sdf_row_min_tile(const float* table, int num_rows, int w,
                                const int* rows, int n, int tile, float* out,
                                void* stream) {
  const int smem = sdf_row_min_tile_smem(w);
  cudaError_t err = cudaFuncSetAttribute(
      row_min_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    row_min_tile_kernel<<<n / tile, kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(table), num_rows, w / 4, rows, tile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
