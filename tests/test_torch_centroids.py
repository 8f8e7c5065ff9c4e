"""K9's early exit and its split of the pixels on the CPU:
``tris_tpu_torch/tools/centroids_schedule.py`` runs the kernel's partition
(at most one block an SM, each taking its share of the flat pixels, a warp
32 consecutive pixels; the direct path's blocks of 128 past shared memory)
and stops each warp after the first step that leaves all its centroids as
they were, bit for bit. The int32 centroids must equal the plain version's
full 300-step loop exactly on awkward fields (a zero field, one whose
centroids end clamped on the edges, a two-cycle field that never settles,
narrow and tiny grids, a grid on the direct path) and JAX's
``_refine_centroids`` on the fields ``tests/test_torch_irnet.py`` holds it
to. The plan is pinned at the ``make_ins_seg`` grids to ``csrc/launchers.h``'s
answers, worked from the rule by hand (the card's tests hold the
extension's own answers and the kernel's steps to the tool's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.pseudo import labels as JL
from tris_tpu_torch import kernels
from tris_tpu_torch.tools import centroids_schedule as C

torch.set_num_threads(2)


def _grid(H, W):
    yy = np.broadcast_to(np.arange(H, dtype=np.float32)[:, None], (H, W))
    xx = np.broadcast_to(np.arange(W, dtype=np.float32)[None, :], (H, W))
    return yy, xx


def _smooth(H, W, seed, scale=12.0):
    """A smooth field of a few pixels, as chip_smoke's (a 9 x 9 mean of noise)."""
    rng = np.random.default_rng(seed)
    n = torch.from_numpy(rng.standard_normal((1, 2, H + 8, W + 8)).astype(np.float32))
    return (torch.nn.functional.avg_pool2d(n, 9, 1)[0] * scale).numpy()


def _field(kind, H, W):
    yy, xx = _grid(H, W)
    if kind == "zero":
        return np.zeros((2, H, W), np.float32)
    if kind == "edges":     # pushed out hard: every centroid ends clamped on an edge
        return np.stack([np.sign(yy - H / 2 + 0.25), np.sign(xx - W / 2 + 0.25)]) * 7
    if kind == "two_cycle":  # +1 on even columns, -1 on odd: x -> x + 1 -> x for ever
        return np.stack([np.zeros_like(xx), np.where(xx % 2 == 0, 1.0, -1.0)]).astype(np.float32)
    if kind == "sink":       # towards one point, as test_pseudo.py's
        return np.stack([(H // 2 - yy) * 0.5, (W // 2 - xx) * 0.5]).astype(np.float32)
    if kind == "smooth":
        return _smooth(H, W, H * W)
    if kind == "rough":
        return (np.random.default_rng(W).standard_normal((2, H, W)) * 2).astype(np.float32)
    raise ValueError(kind)


# (field, grid): the chip_smoke and make_ins_seg grid (120 x 160), narrow and tiny grids, and
# a grid whose table (201 x 201 float2, 323 KB) does not fit shared memory
CASES = [("zero", (120, 160)), ("edges", (120, 160)), ("two_cycle", (120, 160)),
         ("smooth", (120, 160)), ("sink", (33, 47)), ("rough", (30, 40)),
         ("smooth", (1, 9)), ("edges", (1, 9)), ("smooth", (7, 5)), ("two_cycle", (7, 5)),
         ("smooth", (200, 200)), ("zero", (200, 200))]


@pytest.mark.parametrize("kind,hw", CASES, ids=[f"{k}_{h}x{w}" for k, (h, w) in CASES])
def test_early_exit_equals_the_full_loop(kind, hw):
    disp = _field(kind, *hw)
    got, steps = C.refine_centroids_early_exit(disp, 300)
    want = kernels.refine_centroids_plain(torch.from_numpy(disp), 300).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    p = C.plan(*hw)
    assert p["staged"] == (hw != (200, 200))
    assert steps.shape == (p["warps"],) and steps.min() >= 1 and steps.max() <= 300
    if kind == "zero":       # the first step leaves every centroid where it started
        assert (steps == 1).all()
    if kind == "two_cycle":  # never settles: every warp takes all the steps
        assert (steps == 300).all()
    if kind == "edges":      # clamped on the edges, then fixed though v is not 0
        H, W = hw
        assert ((got[0] == 0) | (got[0] == H - 1)).all()
        assert steps.max() < 300


@pytest.mark.parametrize("iterations", [0, 1, 2, 7])
def test_early_exit_at_few_steps(iterations):
    disp = _field("smooth", 30, 41)
    got, steps = C.refine_centroids_early_exit(disp, iterations)
    np.testing.assert_array_equal(
        got, kernels.refine_centroids_plain(torch.from_numpy(disp), iterations).numpy())
    assert steps.max() == iterations


@pytest.mark.parametrize("kind,hw", [("smooth", (40, 52)), ("sink", (17, 19))])
def test_early_exit_matches_jax(kind, hw):
    # exact int32 centroids against the JAX package's scan on fields where XLA's fused
    # multiply-adds on the CPU move no centroid (tests/test_torch_irnet.py:116)
    disp = _field(kind, *hw)
    got, _ = C.refine_centroids_early_exit(disp, 300)
    np.testing.assert_array_equal(got, np.asarray(JL._refine_centroids(jnp.asarray(disp))))


@pytest.mark.parametrize("hw", [(120, 160), (160, 120), (107, 160), (1, 9), (7, 5), (1, 1),
                                (3, 1000), (200, 200), (1, 14000)])
def test_split_takes_every_pixel_once_and_evenly(hw):
    H, W = hw
    p = C.plan(H, W)
    lanes = C.warp_pixels(H, W, p)
    live = lanes[lanes >= 0]
    assert np.array_equal(np.sort(live), np.arange(H * W))
    per_block = lanes.reshape(p["blocks"], -1)
    counts = (per_block >= 0).sum(axis=1)
    if p["staged"]:          # one block an SM at most, shares differing by one pixel
        assert p["blocks"] <= 132 and counts.max() - counts.min() <= 1
        assert p["threads"] % 32 == 0 and p["threads"] - counts.max() < 32
        assert p["smem_bytes"] == 8 * (H + 1) * (W + 1) <= 232448
        for b in per_block:  # a block's pixels are consecutive
            b = b[b >= 0]
            assert np.array_equal(b, np.arange(b[0], b[0] + len(b)))
    else:
        assert p["threads"] == 128 and p["smem_bytes"] == 0
    assert C.live_lanes(H, W, p).sum() == H * W


def test_plan_at_the_ins_seg_grids():
    # worked by hand from launchers.h's rule: 19200 pixels over min(600, 132) blocks, 146 at
    # most a block (160 threads); the table 121 x 161 x 8 = 155848 bytes; a 200 x 200 grid's
    # 201 x 201 x 8 = 323208 bytes take the direct path, 313 blocks of 128
    assert C.plan(120, 160) == {"staged": 1, "threads": 160, "blocks": 132, "warps": 660,
                                "smem_bytes": 155848}
    assert C.plan(160, 120) == {"staged": 1, "threads": 160, "blocks": 132, "warps": 660,
                                "smem_bytes": 155848}
    assert C.plan(200, 200) == {"staged": 0, "threads": 128, "blocks": 313, "warps": 1252,
                                "smem_bytes": 0}
    assert C.plan(160, 160)["staged"] == 1   # RefCOCO's 640-px side: 161 x 161 x 8 = 207368
    assert C.constants() == {"kCentroidsBlocks": 132, "kCentroidsCheck": 8,
                             "kCentroidsDirectThreads": 128, "kCentroidsSmemMax": 232448}


def test_table_corners_are_the_clamped_field():
    # the staged table's four corners are the first design's reads with the +1 index clamped
    disp = _field("rough", 6, 9)
    tab = C.table(disp)
    H, W = 6, 9
    for y in range(H):
        for x in range(W):
            y1, x1 = min(y + 1, H - 1), min(x + 1, W - 1)
            assert np.array_equal(tab[y, x], disp[:, y, x])
            assert np.array_equal(tab[y + 1, x + 1], disp[:, y1, x1])
            assert np.array_equal(tab[y, x + 1], disp[:, y, x1])
            assert np.array_equal(tab[y + 1, x], disp[:, y1, x])
