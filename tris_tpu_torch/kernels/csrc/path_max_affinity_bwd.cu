// K7, backward: the gradient of aff = 1 - max(edge along each pair's path) with respect to
// the edge map.
//
// The gradient of tris_tpu/pseudo/indexing.py::path_max_affinity_slices (line 110), which
// the JAX package takes by autodiff of vals.max(axis=0): reduce_max's VJP splits the
// cotangent evenly among all the elements equal to the max, so a pair (b, d, r, c) whose path
// max m is reached at `count` steps sends -g / count to each of them (torch.amax's backward
// does the same). Ties are real in IRN training: crops are padded with a constant, and flat
// regions give bit-equal edge values.
//
// One launch of path_max_tiles.cuh's tiled gather with the cotangent g read from device
// memory: a block per tile of pixels stages the edge map over the tile and its halo, and for
// each direction recomputes the path max and tie count of the pairs whose path reaches the
// tile and reads their g, then each pixel adds -g / count over the steps whose pair's max it
// equals, in double, rounded once: the exact gradient rounded to float, the same run to run
// and whatever the tiling (up to 2134 terms reach one pixel at radius 10, whose float sum
// would depend on its order).
//
// Shapes: IRN training's (crop 512, radius 10, B = 24): edge [24, 128, 128], g
// [24, 152, 119, 110] (191 MB). The IRN step itself no longer calls it: its loss is fused with
// K7 (irn_affinity.cu), whose backward is this gather with the cotangent formed on chip.
//
// Bound: bytes - g read once and d edge written once.

#include "path_max_tiles.cuh"

cudaError_t tris::path_max_affinity_bwd(const PathTilePlan& plan, const PathSteps& table,
                                        const float* edge, const float* g, float* dedge,
                                        int H, int W, int rf, cudaStream_t stream) {
  return launch_path_max_gather<false>(plan, table, edge, g, nullptr, nullptr, nullptr, dedge,
                                       nullptr, H, W, rf, 0.f, 0.f, 0, stream);
}
