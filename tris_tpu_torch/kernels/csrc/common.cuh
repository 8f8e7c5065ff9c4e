// Warp and block reductions shared by the kernels in this directory, and
// bfloat16 loads, stores and rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tris {

// bfloat16's round to nearest even of v, as a float
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 bfloat16 values at p (8-byte aligned) as a float4, one 8-byte load
__device__ __forceinline__ float4 load4_bf16(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// v rounded to bfloat16 at p (8-byte aligned), one 8-byte store
__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max / sum; every thread gets the result. `red` holds >= 32
// floats of shared memory; blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : -INFINITY;
  return warp_max(v);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : 0.f;
  return warp_sum(v);
}

// Bilinear sample with the interpolation-matrix taps, rows first then
// columns, each product and sum rounded on its own (no FMA contraction) so
// the plain PyTorch version, which does the same operations, agrees bit for
// bit:  t_j = wy0*x[y0][j] + wy1*x[y1][j];  out = wx0*t_x0 + wx1*t_x1.
__device__ __forceinline__ float sample2(const float* __restrict__ plane, int w, int y0,
                                         int y1, float wy0, float wy1, int x0, int x1,
                                         float wx0, float wx1) {
  const float t0 = __fadd_rn(__fmul_rn(wy0, plane[y0 * w + x0]), __fmul_rn(wy1, plane[y1 * w + x0]));
  const float t1 = __fadd_rn(__fmul_rn(wy0, plane[y0 * w + x1]), __fmul_rn(wy1, plane[y1 * w + x1]));
  return __fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1, t1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// until at most N of this thread's groups of copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Opt `kernel` in to `bytes` of dynamic shared memory when that is more than
// the 48 KiB every kernel may use without asking.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace tris
