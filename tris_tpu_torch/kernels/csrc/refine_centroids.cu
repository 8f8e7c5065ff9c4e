// K9: centroid refinement, up to 300 steps of c += bilinear(displacement, c).
//
// Replaces tris_tpu/pseudo/labels.py::_refine_centroids (line 71), a
// lax.scan over an [HW, 8] table of each pixel's four corner values of both
// displacement fields (the field edge-replicated to [H + 1, W + 1], corners
// (y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1)).
//
// Exactness: the step's terms are rounded one by one in the JAX order
// (labels.py:105-110): t1 = (n[6:8] * yc) * xc, t2 = (n[2:4] * (1 - yc)) *
// xc, t3 = (n[4:6] * yc) * (1 - xc), t4 = (n[0:2] * (1 - yc)) * (1 - xc),
// v = ((t1 + t2) + t3) + t4, then clip(c + v, 0, size - 1), with
// __fmul_rn/__fadd_rn/__fsub_rn: an FMA contracted by nvcc would move a
// centroid after 300 steps. The end is rintf (round half to even, as
// jnp.round), so the int32 centroids equal the plain version's and JAX's.
//
// Shapes: the stride-4 grid of one image, [2, 120, 160] at 480x640.
//
// Bound: not the table's throughput (300 steps of about 30 flops a pixel:
// 0.0026 ms at 67 TFLOP/s; the field, 0.15 MB, is read once) but the chain
// of each step: its loads' addresses come from the previous step's
// centroid, and a step's FMUL/FADD/FMNMX depend on each other. The first
// design (kept below as the direct path) read the 8 corners from device
// memory through L1 at each step, with the +1 indices clamped: about 230
// cycles a step. Design (launchers.h, refine_centroids_plan): each block
// stages the JAX package's own table, edge-replicated [H + 1, W + 1] with
// (dy, dx) as a float2, in shared memory once (156 KB at 120 x 160, every
// copy in flight), so a corner is one 8-byte shared load and the clamps
// leave the loop; floor and the corner's address come from one FADD rounded
// down (no F2I); the pixels are spread evenly over at most one block an SM.
// A warp stops at a fixed point: once a step leaves every lane's centroid as
// it was, bit for bit, every later step would repeat it (a step is a pure
// function of the centroid and the field), so the exit is exact. It votes
// once every kCentroidsCheck steps (a vote and its branch every step added
// about a fifth to the kernel), keeps the group's centroids and counts in
// steps[warp] the first step at which the warp was fixed. A step is then
// about 105 cycles on a warp alone on its scheduler, the chain's latency
// (clock64 stamps), and 120 on average at five warps an SM.

#include <math.h>

#include "common.cuh"
#include "launchers.h"

namespace {

// v = ((t1 + t2) + t3) + t4 of one field from its four corners, in the JAX term order
__device__ __forceinline__ float bilinear(float c00, float c01, float c10, float c11, float yc,
                                          float xc, float omy, float omx) {
  const float t1 = __fmul_rn(__fmul_rn(c11, yc), xc);
  const float t2 = __fmul_rn(__fmul_rn(c01, omy), xc);
  const float t3 = __fmul_rn(__fmul_rn(c10, yc), omx);
  const float t4 = __fmul_rn(__fmul_rn(c00, omy), omx);
  return __fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// One step of a centroid (cy, cx) on the staged table: the JAX order's arithmetic. floor(c)
// for 0 <= c < 2^23 is c + 2^23 rounded down, less 2^23 (two FADDs, exact), and that sum's
// bits are 0x4b000000 + floor(c): the address needs no F2I, its constant part folded into
// tbase.
__device__ __forceinline__ void staged_step(unsigned tbase, int W1, float hmax, float wmax,
                                            float& cy, float& cx) {
  constexpr float kMagic = 8388608.f;  // 2^23
  const float ry = __fadd_rd(cy, kMagic), rx = __fadd_rd(cx, kMagic);
  const float yc = __fsub_rn(cy, __fsub_rn(ry, kMagic)), xc = __fsub_rn(cx, __fsub_rn(rx, kMagic));
  const float omy = __fsub_rn(1.f, yc), omx = __fsub_rn(1.f, xc);
  // tbase is the table's address less 8 * 0x4b000000 * (W1 + 1) bytes (mod 2^32), so the
  // magic's bits cancel
  const unsigned a =
      tbase + 8u * ((unsigned)__float_as_int(ry) * (unsigned)W1 + (unsigned)__float_as_int(rx));
  const unsigned b = a + 8u * (unsigned)W1;
  float2 c00, c01, c10, c11;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(c00.x), "=f"(c00.y) : "r"(a) : "memory");
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2 + 8];" : "=f"(c01.x), "=f"(c01.y) : "r"(a) : "memory");
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(c10.x), "=f"(c10.y) : "r"(b) : "memory");
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2 + 8];" : "=f"(c11.x), "=f"(c11.y) : "r"(b) : "memory");
  const float vy = bilinear(c00.x, c01.x, c10.x, c11.x, yc, xc, omy, omx);
  const float vx = bilinear(c00.y, c01.y, c10.y, c11.y, yc, xc, omy, omx);
  cy = fminf(fmaxf(__fadd_rn(cy, vy), 0.f), hmax);
  cx = fminf(fmaxf(__fadd_rn(cx, vx), 0.f), wmax);
}

// Grid (blocks): block b takes the flat pixels [b * n / blocks, (b + 1) * n / blocks).
// smem: the table [(H + 1) * (W + 1)] of (dy, dx).
__global__ void __launch_bounds__(1024)
refine_centroids_staged_kernel(const float* __restrict__ disp, int* __restrict__ out,
                               int* __restrict__ steps, int H, int W, int iterations) {
  extern __shared__ __align__(16) float table[];
  const int n = H * W, W1 = W + 1, T = blockDim.x, tid = threadIdx.x;

  // stage the table, every copy in flight at once: entry (r, c) holds the field at
  // (min(r, H - 1), min(c, W - 1)), dy then dx; entry k of the block's walk is row k / W1,
  // column k % W1, walked without a division
  {
    const int ne = (H + 1) * W1, step_r = T / W1, step_c = T - step_r * W1;
    int r = tid / W1, c = tid - r * W1;
    for (int k = tid; k < ne; k += T) {
      const int src = min(r, H - 1) * W + min(c, W - 1);
      tris::cp_async4(table + 2 * k, disp + src, true);
      tris::cp_async4(table + 2 * k + 1, disp + n + src, true);
      r += step_r;
      c += step_c;
      if (c >= W1) {
        c -= W1;
        ++r;
      }
    }
    tris::cp_async_commit();
    tris::cp_async_wait<0>();
  }
  __syncthreads();

  const int begin = (int)((long long)blockIdx.x * n / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * n / gridDim.x);
  const int i = begin + tid;
  const bool live = i < end;
  // the table's 32-bit shared address, opaque to the compiler, so that a corner's address is
  // one multiply-add and a shift from the step's rounded sums
  unsigned tbase;
  asm volatile("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
               : "=r"(tbase) : "l"(table));
  tbase -= 8u * 0x4b000000u * (unsigned)(W1 + 1);  // mod 2^32
  const float hmax = (float)(H - 1), wmax = (float)(W - 1);
  float cy = live ? (float)(i / W) : 0.f, cx = live ? (float)(i % W) : 0.f;
  // groups of kCentroidsCheck steps, then a vote: has every lane's last step left its centroid
  // as it was? A lane once fixed stays fixed, so on a yes the steps run past the first such
  // step changed nothing; the group's centroids, kept, tell which step that was
  constexpr int kCheck = tris::kCentroidsCheck;
  int it = 0, taken = iterations;
  bool settled = false;
  while (it + kCheck <= iterations) {
    float sy[kCheck + 1], sx[kCheck + 1];
    sy[0] = cy;
    sx[0] = cx;
#pragma unroll
    for (int j = 1; j <= kCheck; ++j) {
      staged_step(tbase, W1, hmax, wmax, cy, cx);
      sy[j] = cy;
      sx[j] = cx;
    }
    it += kCheck;
    if (__all_sync(0xffffffffu, !live | (same_bits(sy[kCheck], sy[kCheck - 1]) &
                                         same_bits(sx[kCheck], sx[kCheck - 1])))) {
      // the first step of the group at which every lane was fixed
      int j = kCheck;
#pragma unroll
      for (int k = kCheck - 1; k >= 1; --k) {
        if (!__all_sync(0xffffffffu, !live | (same_bits(sy[k], sy[k - 1]) &
                                              same_bits(sx[k], sx[k - 1]))))
          break;
        j = k;
      }
      taken = it - kCheck + j;
      settled = true;
      break;
    }
  }
  while (!settled && it < iterations) {  // the last iterations % kCheck steps, a vote each
    const float py = cy, px = cx;
    staged_step(tbase, W1, hmax, wmax, cy, cx);
    ++it;
    if (__all_sync(0xffffffffu, !live | (same_bits(cy, py) & same_bits(cx, px)))) {
      taken = it;
      break;
    }
  }
  if (live) {
    out[i] = (int)rintf(cy);
    out[n + i] = (int)rintf(cx);
  }
  if (tid % 32 == 0) steps[blockIdx.x * (T / 32) + tid / 32] = iterations > 0 ? taken : 0;
}

// The direct path (a table past shared memory): the first design, a thread a pixel reading the
// corners from device memory with the +1 index clamped to the last row or column (the
// edge-replicated table's values), with the same exit.
__global__ void __launch_bounds__(tris::kCentroidsDirectThreads)
refine_centroids_direct_kernel(const float* __restrict__ disp, int* __restrict__ out,
                               int* __restrict__ steps, int H, int W, int iterations) {
  const int i = blockIdx.x * tris::kCentroidsDirectThreads + threadIdx.x;
  const int n = H * W;
  const bool live = i < n;
  const float* fy = disp;
  const float* fx = disp + n;
  const float hmax = (float)(H - 1), wmax = (float)(W - 1);
  float cy = live ? (float)(i / W) : 0.f, cx = live ? (float)(i % W) : 0.f;
  int it = 0;
  while (it < iterations) {
    const int iy = (int)floorf(cy), ix = (int)floorf(cx);
    const float yc = __fsub_rn(cy, (float)iy), xc = __fsub_rn(cx, (float)ix);
    const float omy = __fsub_rn(1.f, yc), omx = __fsub_rn(1.f, xc);
    const int row0 = iy * W, row1 = min(iy + 1, H - 1) * W, x1 = min(ix + 1, W - 1);
    const float vy = bilinear(fy[row0 + ix], fy[row0 + x1], fy[row1 + ix], fy[row1 + x1], yc, xc,
                              omy, omx);
    const float vx = bilinear(fx[row0 + ix], fx[row0 + x1], fx[row1 + ix], fx[row1 + x1], yc, xc,
                              omy, omx);
    const float ny = fminf(fmaxf(__fadd_rn(cy, vy), 0.f), hmax);
    const float nx = fminf(fmaxf(__fadd_rn(cx, vx), 0.f), wmax);
    const bool fixed = !live || (same_bits(ny, cy) && same_bits(nx, cx));
    cy = ny;
    cx = nx;
    ++it;
    if (__all_sync(0xffffffffu, fixed)) break;
  }
  if (live) {
    out[i] = (int)rintf(cy);
    out[n + i] = (int)rintf(cx);
  }
  if (threadIdx.x % 32 == 0) steps[i / 32] = it;
}

}  // namespace

cudaError_t tris::refine_centroids(const float* disp, int* out, int* steps, int H, int W,
                                   int iterations, cudaStream_t stream) {
  if ((long long)H * W == 0) return cudaSuccess;
  const CentroidsPlan p = refine_centroids_plan(H, W);
  if (p.staged) {
    const cudaError_t err = tris::allow_smem(refine_centroids_staged_kernel, (size_t)p.smem);
    if (err != cudaSuccess) return err;
    refine_centroids_staged_kernel<<<(unsigned)p.blocks, p.threads, p.smem, stream>>>(
        disp, out, steps, H, W, iterations);
  } else {
    refine_centroids_direct_kernel<<<(unsigned)p.blocks, p.threads, 0, stream>>>(
        disp, out, steps, H, W, iterations);
  }
  return cudaGetLastError();
}
