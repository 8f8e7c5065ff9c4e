"""What K10's product kernels (``tris_tpu_torch/kernels/csrc/walk_matmul.cu``)
sum, emulated on the host in float64: the CPU tests hold the schedule to the
float64 product with it (``tests/test_torch_walk.py``), and ``chip_smoke.py``
counts the k-tiles skipped with it. Nothing on the walk's path calls it.

The tile sizes are read from ``csrc/launchers.h``, the kernels' own source
of them. The emulations fix which products each group of 16 adds and the
order in which the groups are added; inside a group the order is the tensor
core's, which the host cannot reproduce, so an emulation equals its kernel
to one float32 rounding, not bit for bit.

- :func:`square_sums`, ``walk_square``: each tile of C adds, in ascending k,
  the k-tiles of :func:`square_schedule`: those inside the band's range on a
  global grid of k-steps where both occupancy maps hold.
- :func:`thin_sums`, ``walk_thin``: each block of rows and columns runs the
  chunks of 16 rows of b from a multiple of chunk x warps below the band's
  first row up to its last; chunk q goes to warp q % warps, each warp adds
  its chunks in ascending q, the products past the band's last row are
  zero (a is copied only up to it), and the warps' sums are added in
  ascending warp.
"""

from __future__ import annotations

import functools
import pathlib
import re

import torch

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def tiles() -> dict:
    """The ``constexpr int kWalk* = n;`` constants of ``launchers.h``."""
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (kWalk\w+) = (\d+);", LAUNCHERS.read_text())}


def _dense_bands(M, N, K, band_a, band_b):
    dense = max(M, N, K)
    return tuple(dense if band is None else min(int(band), dense) for band in (band_a, band_b))


def _band_range(M, N, K, band_a, band_b, tm, tn, device):
    """[lo, hi) of k each tm x tn block of C may need: [n_i, n_j] each."""
    ba, bb = _dense_bands(M, N, K, band_a, band_b)
    i0 = torch.arange(0, M, tm, device=device)[:, None]
    j0 = torch.arange(0, N, tn, device=device)[None]
    lo = torch.clamp(torch.maximum(i0 - ba, j0 - bb), min=0)
    hi = torch.clamp(torch.minimum(i0 + tm - 1 + ba, j0 + tn - 1 + bb) + 1, max=K)
    return lo, hi


def square_schedule(occ_a, occ_b, M: int, N: int, K: int, band_a=None, band_b=None,
                    device=None):
    """[ceil(M / tile), ceil(N / tile), ceil(K / step)] bool: whether tile
    (i, j) of C runs k-tile s. Maps None: every k-tile of the band's range."""
    tile, step = tiles()["kWalkTile"], tiles()["kWalkStep"]
    device = occ_a.device if occ_a is not None else device
    lo, hi = _band_range(M, N, K, band_a, band_b, tile, tile, device)
    s = torch.arange(-(-K // step), device=device)
    run = ((s >= (lo // step)[..., None]) & (s < (-(-hi // step))[..., None])
           & (lo < hi)[..., None])
    if occ_a is not None:
        run &= occ_a[:, None, :] & occ_b.T[None]
    return run


def skipped_share(occ_a, occ_b, M: int, N: int, K: int, band_a=None, band_b=None):
    """(k-tiles walk_square skips for empty tiles, k-tiles in the band's range)."""
    run = int(square_schedule(occ_a, occ_b, M, N, K, band_a, band_b).sum())
    in_band = int(square_schedule(None, None, M, N, K, band_a, band_b, occ_a.device).sum())
    return in_band - run, in_band


def _padded(x, rows, cols):
    out = x.new_zeros(rows, cols, dtype=torch.float64)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def square_sums(a, b, occ_a=None, occ_b=None, band_a=None, band_b=None):
    """``walk_square``'s sums in float64, [M, N]."""
    tile, step = tiles()["kWalkTile"], tiles()["kWalkStep"]
    (M, K), N = a.shape, b.shape[1]
    run = square_schedule(occ_a, occ_b, M, N, K, band_a, band_b, a.device)
    n_i, n_j, n_s = run.shape
    a4 = _padded(a, n_i * tile, n_s * step).reshape(n_i, tile, n_s, step)
    b4 = _padded(b, n_s * step, n_j * tile).reshape(n_s, step, n_j, tile)
    out = a.new_zeros(n_i, tile, n_j, tile, dtype=torch.float64)
    for s in range(n_s):
        if bool(run[:, :, s].any()):
            prod = torch.einsum("iak,kjb->iajb", a4[:, :, s], b4[s])
            out += torch.where(run[:, None, :, None, s], prod, 0.0)
    return out.reshape(n_i * tile, n_j * tile)[:M, :N]


def thin_sums(a, b, band_a=None, band_b=None):
    """``walk_thin``'s sums in float64, [M, N]."""
    c = tiles()
    rows, cols, chunk, warps = (c["kWalkThinRows"], c["kWalkThinCols"], c["kWalkThinChunk"],
                                c["kWalkThinWarps"])
    (M, K), N = a.shape, b.shape[1]
    n_i, n_j, n_s = -(-M // rows), -(-N // cols), -(-K // chunk)
    k_lo, k_hi = _band_range(M, N, K, band_a, band_b, rows, cols, a.device)
    lo = k_lo // (chunk * warps) * (chunk * warps)
    hi = torch.where(k_lo < k_hi, k_hi, lo)
    a4 = _padded(a, n_i * rows, n_s * chunk).reshape(n_i, rows, n_s, chunk)
    b4 = _padded(b, n_s * chunk, n_j * cols).reshape(n_s, chunk, n_j, cols)
    acc = a.new_zeros(warps, n_i, rows, n_j, cols, dtype=torch.float64)
    for q in range(n_s):
        k = q * chunk + torch.arange(chunk, device=a.device)
        run = (q * chunk >= lo) & (q * chunk < hi)
        if bool(run.any()):
            keep = ((k < hi[..., None]) & run[..., None]).double()  # [n_i, n_j, chunk]
            acc[q % warps] += torch.einsum("iak,ijk,kjb->iajb", a4[:, :, q], keep, b4[q])
    out = a.new_zeros(n_i, rows, n_j, cols, dtype=torch.float64)
    for w in range(warps):
        out = out + acc[w]
    return out.reshape(n_i * rows, n_j * cols)[:M, :N]
