// K12: the EMA teacher update over every leaf of a model, one launch.
//
// Replaces the JAX package's tris_tpu/train/state.py::ema_update (line 161),
// the per-leaf lerp e * d + p * (1 - d) in float32 that the stage-2 step
// applies to the teacher's parameters and BatchNorm statistics
// (tris_tpu/train/stage2.py:91-121). Integer buffers (BatchNorm's
// num_batches_tracked, which JAX does not have) are copied from the
// student, as ema_pytorch does.
//
// Shapes on the stage-2 train path: RN50 stage 2, every parameter and float
// buffer of the model (hundreds of leaves, 0-d to 9.4 M elements).
//
// Bound: bytes (each teacher element read and written, each student element
// read: 3 x 4 bytes; two multiplies and an add). Design: a table in device
// memory of (teacher pointer, student pointer, numel, kind) per leaf, built
// once per train state, and the first chunk of each leaf (prefix sums of
// ceil(numel / chunk)); one block per chunk of `chunk` elements finds its
// leaf by a binary search over the chunk starts and streams the chunk with
// consecutive threads on consecutive elements. The products and the sum are
// rounded on their own (__fmul_rn / __fadd_rn: nvcc would contract them into
// an FMA), so the result equals the plain PyTorch version bit for bit.

#include "common.cuh"
#include "launchers.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ema_update_kernel(const long long* __restrict__ table, const long long* __restrict__ starts,
                  int n_leaves, long long chunk, float d, float omd) {
  const long long b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;   // the last leaf whose first chunk is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (starts[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const long long* leaf = table + 4 * (long long)lo;
  const long long numel = leaf[2];
  const long long begin = (b - starts[lo]) * chunk;
  const long long end = min(begin + chunk, numel);
  if (leaf[3] == 0) {
    float* e = reinterpret_cast<float*>(leaf[0]);
    const float* p = reinterpret_cast<const float*>(leaf[1]);
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      e[i] = __fadd_rn(__fmul_rn(e[i], d), __fmul_rn(p[i], omd));
  } else {
    long long* e = reinterpret_cast<long long*>(leaf[0]);
    const long long* p = reinterpret_cast<const long long*>(leaf[1]);
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) e[i] = p[i];
  }
}

}  // namespace

cudaError_t tris::ema_update(const long long* table, const long long* starts, int n_leaves,
                             long long n_chunks, long long chunk, float d, float omd,
                             cudaStream_t stream) {
  if (n_chunks == 0) return cudaSuccess;
  ema_update_kernel<<<(unsigned)n_chunks, kThreads, 0, stream>>>(table, starts, n_leaves, chunk,
                                                                  d, omd);
  return cudaGetLastError();
}
