"""How K9 (``tris_tpu_torch/kernels/csrc/refine_centroids.cu``) spreads a
grid's pixels over its blocks and warps and where each warp stops, emulated
on the host: the CPU tests hold the plan against ``launchers.h``'s rule, the
split (every pixel once, blocks even to one pixel) and the early exit bit
for bit against the full loop of the plain version and against JAX
(``tests/test_torch_centroids.py``); the card tests hold the kernel's steps
a warp to :func:`refine_centroids_early_exit`'s. Nothing on K9's path calls
it.

The constants are read from ``csrc/launchers.h``, the kernel's own source of
them; :func:`plan` is that file's ``refine_centroids_plan``.

The partition: staged, block b of ``blocks`` takes the flat pixels [b * n //
blocks, (b + 1) * n // blocks), thread t its pixel begin + t, warp w of the
block its threads [32 w, 32 w + 32); direct, thread i of the grid pixel i,
warp i // 32. Each step reads the four corners of the edge-replicated table
[H + 1, W + 1] of (dy, dx) (the staged kernel's shared copy; the direct
kernel reads the same values with its +1 index clamped). A warp stops after
the first step at which every live lane's (cy, cx) equals the previous
step's bit for bit.
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kCentroids* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kCentroids\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(H: int, W: int) -> dict:
    """``launchers.h::refine_centroids_plan``: the launch for the grid ``[H, W]``."""
    k = constants()
    n = H * W
    table = 8 * (H + 1) * (W + 1)
    blocks = min(_ceil(n, 32), k["kCentroidsBlocks"])
    per = _ceil(n, blocks) if blocks else 0
    staged = int(n > 0 and table <= k["kCentroidsSmemMax"] and per <= 1024)
    if staged:
        threads, smem = _ceil(per, 32) * 32, table
    else:
        threads, smem = k["kCentroidsDirectThreads"], 0
        blocks = _ceil(n, threads)
    return {"staged": staged, "threads": threads, "blocks": blocks,
            "warps": blocks * (threads // 32), "smem_bytes": smem}


def warp_pixels(H: int, W: int, p=None) -> np.ndarray:
    """The flat pixel of every thread of the grid, [warps, 32], -1 where a
    lane has none."""
    p = p or plan(H, W)
    n = H * W
    lanes = np.full((p["warps"], 32), -1, np.int64)
    per_block = p["threads"] // 32
    for b in range(p["blocks"]):
        if p["staged"]:
            begin, end = b * n // p["blocks"], (b + 1) * n // p["blocks"]
        else:
            begin, end = b * p["threads"], min((b + 1) * p["threads"], n)
        t = np.arange(p["threads"])
        pix = np.where(begin + t < end, begin + t, -1)
        lanes[b * per_block:(b + 1) * per_block] = pix.reshape(per_block, 32)
    return lanes


def table(displacement) -> np.ndarray:
    """The JAX package's edge-replicated field [H + 1, W + 1, 2] of (dy, dx)."""
    d = np.asarray(displacement, np.float32)
    return np.pad(d.transpose(1, 2, 0), ((0, 1), (0, 1), (0, 0)), mode="edge")


def step(tab, cy, cx, H: int, W: int):
    """One step of every centroid, each operation rounded alone in float32
    in the JAX term order (``labels.py:105-110``)."""
    one = np.float32(1)
    iy, ix = np.floor(cy).astype(np.int64), np.floor(cx).astype(np.int64)
    yc, xc = cy - iy.astype(np.float32), cx - ix.astype(np.float32)
    omy, omx = one - yc, one - xc
    c00, c01, c10, c11 = tab[iy, ix], tab[iy, ix + 1], tab[iy + 1, ix], tab[iy + 1, ix + 1]
    yc, xc, omy, omx = (a[:, None] for a in (yc, xc, omy, omx))
    v = (((c11 * yc) * xc + (c01 * omy) * xc) + (c10 * yc) * omx) + (c00 * omy) * omx
    ny = np.minimum(np.maximum(cy + v[:, 0], np.float32(0)), np.float32(H - 1))
    nx = np.minimum(np.maximum(cx + v[:, 1], np.float32(0)), np.float32(W - 1))
    return ny, nx


def refine_centroids_early_exit(displacement, iterations: int = 300, p=None):
    """``(centroids int32 [2, H, W], steps int32 [warps])`` as the kernel's
    warps take them: each warp stops after the first step that leaves its
    live lanes' centroids as they were, bit for bit."""
    d = np.asarray(displacement, np.float32)
    _, H, W = d.shape
    p = p or plan(H, W)
    tab = table(d)
    lanes = warp_pixels(H, W, p)
    live = lanes >= 0
    pix = np.where(live, lanes, 0).reshape(-1)
    cy = (pix // W).astype(np.float32)
    cx = (pix % W).astype(np.float32)
    steps = np.zeros(len(lanes), np.int32)
    running = np.ones(len(lanes), bool)
    for it in range(1, iterations + 1):
        if not running.any():
            break
        ny, nx = step(tab, cy, cx, H, W)
        lane_run = np.repeat(running, 32)
        same = ((ny.view(np.uint32) == cy.view(np.uint32))
                & (nx.view(np.uint32) == cx.view(np.uint32))).reshape(-1, 32)
        cy, cx = np.where(lane_run, ny, cy), np.where(lane_run, nx, cx)
        steps[running] = it
        running &= ~(same | ~live).all(axis=1)
    out = np.zeros((2, H * W), np.int32)
    out[0, lanes[live]] = np.rint(cy.reshape(-1, 32)[live]).astype(np.int32)
    out[1, lanes[live]] = np.rint(cx.reshape(-1, 32)[live]).astype(np.int32)
    return out.reshape(2, H, W), steps


def live_lanes(H: int, W: int, p=None) -> np.ndarray:
    """The live lanes of every warp, int [warps]."""
    return (warp_pixels(H, W, p) >= 0).sum(axis=1)
