"""K7's forward (``csrc/path_max_affinity.cu``) emulated on the CPU.

``tris_tpu_torch/tools/irn_affinity_schedule.py`` reads the ``kPathMaxForward``
plan from ``csrc/launchers.h`` and runs the launch it makes block by block:
the tiled kernel (each tile's edge map staged from its first pair with -inf
off the image, a tile's directions split among its blocks in table order,
each pair's max over the staged step offsets) or, for a table past the
kernel parameter's limits, the direct kernel. Each is held bit for bit
against the plain version (``kernels.path_max_affinity_plain``) and the JAX
package's ``path_max_affinity_slices``, with every output written once: at
radius 5 on the walk's padded grids, at radius 10, with partial last tiles
in both axes, on edge maps full of ties, with every count of direction
groups, and with a radius-13 table, which the plan sends to the direct
kernel. The plan is pinned at the main paths' shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.pseudo.indexing import PathIndex as JPathIndex
from tris_tpu.pseudo.indexing import path_max_affinity_slices as j_path_max
from tris_tpu_torch import kernels
from tris_tpu_torch.kernels import path_max as K7
from tris_tpu_torch.pseudo.indexing import PathIndex
from tris_tpu_torch.tools import irn_affinity_schedule as T

torch.set_num_threads(2)


def _edge(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "tied":       # one value everywhere: every step of every path ties
        return np.full(shape, 0.625, np.float32)
    if kind == "levels":     # four levels, zero among them: ties along most paths
        return (rng.integers(0, 4, shape) / 4).astype(np.float32)
    if kind == "walk":       # the walk's padding: edge 1 right, left and below
        e = np.ones(shape, np.float32)
        e[..., :shape[-2] - 5, 5:shape[-1] - 5] = rng.random(
            (*shape[:-2], shape[-2] - 5, shape[-1] - 10), dtype=np.float32)
        return e
    return rng.random(shape, dtype=np.float32)


def _jax(edge, radius):
    jpi = JPathIndex(radius, edge.shape[-2:])
    groups = j_path_max(jnp.asarray(edge), jpi)
    H, W = edge.shape[-2:]
    rf = jpi.radius_floor
    out = np.concatenate([np.asarray(g) for g in groups], axis=-2)
    return out.reshape(*edge.shape[:-2], -1, H - rf, W - 2 * rf)


def _check(edge, radius, groups=0):
    pi = PathIndex(radius, edge.shape[-2:])
    steps = K7.path_steps(pi.paths_by_length)
    flat = edge.reshape(-1, *edge.shape[-2:])
    got, writes = T.tiled_forward(flat, steps, pi.radius_floor, groups)
    assert (writes == 1).all()      # every output written once, by one block
    got = got.reshape(*edge.shape[:-2], *got.shape[1:])
    plain = kernels.path_max_affinity_plain(torch.from_numpy(edge), pi.paths_by_length,
                                            pi.radius_floor).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, _jax(edge, radius))
    return T.forward_plan(flat.shape[0], *edge.shape[-2:], pi.radius_floor, len(steps),
                          sum(map(len, steps)))


@pytest.mark.parametrize("radius,shape,kind", [
    (5, (21, 30), "walk"),          # the walk's padded grid of a 16 x 20 bucket
    (5, (2, 37, 42), "random"),     # rows 33 = 4 tiles + 1, columns 34 = 32 + 2
    (10, (2, 45, 77), "random"),    # radius 10: rows 36, columns 59 (partial in both)
    (10, (1, 128, 128), "levels"),  # IRN training's crop, ties along most paths
    (5, (3, 21, 30), "tied"),       # one value everywhere
    (10, (2, 40, 41), "tied"),
    (3, (1, 3, 5), "random"),       # the narrowest window at radius 3: one pair column
])
def test_tiled_forward_matches_plain_and_jax(radius, shape, kind):
    plan = _check(_edge(shape, kind), radius)
    assert plan["tiled"] == 1


def test_radius_13_takes_the_direct_kernel():
    # 258 directions and 4652 steps: past the kernel parameter (256, 4096), so the plan
    # sends the table to the direct kernel, whatever the shape; the forward still takes it
    plan = _check(_edge((2, 30, 31), "random", 3), 13)
    assert plan["tiled"] == 0
    pi = PathIndex(13, (30, 31))
    steps = K7.path_steps(pi.paths_by_length)
    assert (len(steps), sum(map(len, steps))) == (258, 4652)
    assert T.forward_plan(1, 30, 31, 12, 256, 4096)["tiled"] == 1   # the limits themselves fit


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8, 40])
def test_any_direction_groups_cover_every_direction_once(groups):
    # the binding's override of the plan's groups (to measure them): 40 > 34 directions
    # leaves some blocks without a direction
    _check(_edge((2, 21, 30), "walk", 1), 5, groups)


def test_forward_plan_at_the_main_paths():
    # the walk at radius 5 on a 480 x 640 image ([128, 160] padded to [133, 170]): 102 tiles
    # of 8 x 32 pairs, too few to fill the card, so 2 blocks a tile take its 34 directions;
    # IRN training's batch at radius 10: 384 tiles of 32 x 32, one group
    assert T.forward_plan(1, 133, 170, 4, 34, 242) == {
        "tiled": 1, "rpt": 1, "tile_rows": 8, "tile_cols": 32, "pitch": 40, "staged_rows": 12,
        "tiles_y": 17, "tiles_x": 6, "dir_groups": 2, "blocks": 204, "smem_bytes": 10112}
    assert T.forward_plan(24, 128, 128, 9, 152, 2134) == {
        "tiled": 1, "rpt": 4, "tile_rows": 32, "tile_cols": 32, "pitch": 50, "staged_rows": 41,
        "tiles_y": 4, "tiles_x": 4, "dir_groups": 1, "blocks": 384, "smem_bytes": 16400}
    # the other kinds keep one group
    for kind in (T.LOSS_FORWARD, T.LOSS_BACKWARD, T.MAX_BACKWARD):
        assert T.plan(kind, 1, 133, 170, 4)["dir_groups"] == 1


@pytest.mark.parametrize("B,H,W,rf", [(1, 133, 170, 4), (24, 128, 128, 9), (2, 45, 77, 9),
                                      (1, 3, 5, 2), (64, 133, 170, 4)])
def test_forward_plan_rule(B, H, W, rf):
    # rpt halves first, then direction groups double while the grid is below a wave of
    # kPathWaveBlocks, up to kPathForwardGroups; the tiles cover the window once
    k = T.constants()
    p = T.plan(T.MAX_FORWARD, B, H, W, rf)
    tiles = p["blocks"] // p["dir_groups"]
    assert tiles == B * p["tiles_y"] * p["tiles_x"]
    assert p["tiles_y"] * p["tile_rows"] >= H - rf > (p["tiles_y"] - 1) * p["tile_rows"]
    assert p["tiles_x"] * 32 >= W - 2 * rf > (p["tiles_x"] - 1) * 32
    assert p["dir_groups"] == 1 or p["rpt"] == 1
    if p["dir_groups"] < k["kPathForwardGroups"]:
        assert p["blocks"] >= k["kPathWaveBlocks"]
    assert p["smem_bytes"] == 2 * 4096 + -(-(p["staged_rows"] * p["pitch"] * 4) // 16) * 16


def test_shared_loads_count_a_tile_once():
    # the direction groups split a tile's steps: the loads are the tiles' lanes times the steps
    pi = PathIndex(5, (133, 170))
    steps = K7.path_steps(pi.paths_by_length)
    assert T.shared_loads(T.MAX_FORWARD, 1, 133, 170, 4, steps) == 102 * 256 * 242
