"""K10, the random walk's program ``tris_tpu/pseudo/indexing.py::_walk_program``
in two kernels, each beside its plain PyTorch version:

- :func:`walk_transition` (``csrc/walk_transition.cu``): the dense
  column-normalised matrix ``T = A ** beta / colsum``, the prefix of the
  reference formulation (float32, dense build): the symmetric [HW, HW]
  affinity with unit diagonal assembled from K7's per-direction grids
  ``[n_dirs, ch, cw]`` in band form (``_affinity_band``), made dense
  (``_band_to_dense``), raised to ``beta`` and divided by its column sums;
- :func:`walk_matmul` (``csrc/walk_matmul.cu``): the products after it, the
  squarings ``T @ T`` and the thin step ``x * (1 - edge) @ T``, summed in
  float64 on the FP64 tensor cores. A squaring runs each 128 x 128 tile of
  the output only over the k-tiles of 16 inside the band (as the JAX
  package's ``_block_banded_squarings``) where both operands' tiles hold a
  nonzero: :func:`walk_tile_occupancy` maps them first (T's powers round to
  float32, and far from the diagonal they underflow to exact zeros). The
  thin step (at most 32 rows) takes a kernel of its own that streams T once.

Both sum in float64 and round once to float32, so that the result does not
depend on the order of the sum: the walk's eight squarings amplify T's
rounding. Summed in float32 in two orders, T's column sums put T 3e-6 of
its scale apart at the 128x160 bucket on an H100 and the walks 4e-4 of
their max; the products' float32 sums put two walks 1e-4 of their max
apart at the 32x32 bucket (``tests/test_torch_irnet.py``). The JAX package
sums both in float32; the port holds it to those bars.

For T the power is taken on the band, and each column sum adds the band's
nonzero columns in ascending offset (:func:`band_offsets`), as the kernel
does: kernel and plain version agree bit for bit. (The JAX package's
option ``TRIS_WALK_BANDPREFIX`` takes the same band-domain prefix.) For the
products the plain version is a float64 matrix product: it and the kernel
agree to one float32 rounding.

A direction (dy, dx) holds the flat offset ``dy * W + dx``; the kernel
needs distinct positive offsets, which every grid wider than
``2 * (radius - 1)`` gives (the walk's buckets of 32 do). The plain version
also takes narrower grids, where directions share an offset and their
affinities add, as the JAX band build does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tris_tpu_torch.kernels import build


def affinity_band(aff_grids, dirs, H: int, W: int, woff: int):
    """``_affinity_band``: ``(band [HW, 2 * max_off + 1], max_off)`` with
    ``band[i, o + max_off] == dense[i, i + o]``; aff_grids [n_dirs, ch, cw],
    the source at window (r, c + woff) is the grid pixel (r, c)."""
    n = H * W
    max_off = max(int(dy) * W + int(dx) for dy, dx in dirs)
    width = 2 * max_off + 1
    pieces = {}

    def acc(key, arr):
        pieces[key] = arr if key not in pieces else pieces[key] + arr

    for d, (dy, dx) in enumerate(dirs):
        dy, dx = int(dy), int(dx)
        off = dy * W + dx
        c0, c1 = max(0, -dx), min(W, W - dx)
        r1 = H - dy
        if c1 <= c0 or r1 <= 0:
            continue
        vals = aff_grids[d, 0:r1, c0 + woff:c1 + woff]
        acc(off + max_off, F.pad(vals, (c0, W - c1, 0, H - r1)).reshape(n))
        acc(-off + max_off, F.pad(vals, (c0 + dx, W - c1 - dx, dy, 0)).reshape(n))
    acc(max_off, torch.ones(n, dtype=aff_grids.dtype, device=aff_grids.device))
    rows, prev = [], 0
    for k in sorted(pieces):
        if k > prev:
            rows.append(aff_grids.new_zeros(k - prev, n))
        rows.append(pieces[k][None])
        prev = k + 1
    if prev < width:
        rows.append(aff_grids.new_zeros(width - prev, n))
    return torch.cat(rows, 0).T, max_off


def band_to_dense(band, max_off: int):
    """``_band_to_dense``: the [HW, HW] matrix by one pad and one flat slice."""
    n, width = band.shape
    flat = F.pad(band, (0, n + 1 - width)).reshape(-1)
    return flat[max_off:max_off + n * n].reshape(n, n)


def band_offsets(dirs, H: int, W: int) -> list:
    """The band's nonzero offsets in ascending order: 0 (the diagonal) and
    +-(dy * W + dx) of each direction that has pairs on the H x W grid."""
    offs = {0}
    for dy, dx in dirs:
        if dy < H and abs(dx) < W:
            offs |= {int(dy) * W + int(dx), -(int(dy) * W + int(dx))}
    return sorted(offs)


def walk_transition_plain(aff_grids, dirs, H: int, W: int, woff: int, beta: float):
    """The plain version: the JAX band assembly, ``** beta`` on the band, the
    column sums (= row sums: the matrix is symmetric) added in float64 column
    by column of the band in ascending offset, then the dense matrix divided
    by them rounded to float32."""
    band, max_off = affinity_band(aff_grids, dirs, H, W, woff)
    band = band.pow(beta)
    colsum = torch.zeros(band.shape[0], dtype=torch.float64, device=band.device)
    for off in band_offsets(dirs, H, W):
        colsum = colsum + band[:, off + max_off].double()
    return band_to_dense(band, max_off) / colsum.to(band.dtype)


@functools.lru_cache(maxsize=16)
def _tables(dirs: tuple, H: int, W: int, device: torch.device):
    """(dirs [n_dirs, 2], seq, lut) int32 on ``device``: ``seq`` lists the
    band's nonzero offsets in ascending order (``2 * d + (offset > 0)``, -1
    the diagonal), ``lut [2 * max_off + 1]`` gives each flat offset's
    direction (-2 the diagonal, -1 none). Raises when two directions that
    have pairs share an offset (every such offset is positive)."""
    by_off = {dy * W + dx: d for d, (dy, dx) in enumerate(dirs) if dy < H and abs(dx) < W}
    if len(by_off) != sum(1 for dy, dx in dirs if dy < H and abs(dx) < W):
        raise ValueError(f"walk_transition: directions share a flat offset on a grid {W} wide "
                         f"(needs W > 2 * (radius - 1)); use the plain version")
    max_off = max(by_off)
    lut = np.full(2 * max_off + 1, -1, np.int32)
    lut[max_off] = -2
    for off, d in by_off.items():
        lut[max_off + off] = lut[max_off - off] = d
    seq = [-1 if o == 0 else 2 * by_off[abs(o)] + (o > 0) for o in band_offsets(dirs, H, W)]
    return tuple(torch.as_tensor(np.asarray(a, np.int32), device=device)
                 for a in (np.reshape(dirs, (-1, 2)), seq, lut))


def walk_transition(aff_grids, dirs, H: int, W: int, woff: int, beta: float):
    """K10 on a CUDA tensor (one launch); the plain version on a CPU tensor.
    aff_grids [n_dirs, ch, cw] float32 (K7's), dirs [n_dirs, 2] (dy, dx) ->
    T [H * W, H * W]."""
    if aff_grids.device.type == "cpu":
        return walk_transition_plain(aff_grids, dirs, H, W, woff, beta)
    build.require_cuda("walk_transition", aff_grids)
    key = tuple((int(dy), int(dx)) for dy, dx in dirs)
    if (aff_grids.dtype != torch.float32 or aff_grids.dim() != 3
            or aff_grids.shape[0] != len(key) or aff_grids.shape[1] < H
            or aff_grids.shape[2] < W + woff or any(dy < 0 for dy, _ in key)):
        raise ValueError(f"walk_transition: bad shapes aff {aff_grids.dtype} "
                         f"{tuple(aff_grids.shape)} for {len(key)} directions on {H}x{W}")
    dirs_t, seq, lut = _tables(key, int(H), int(W), aff_grids.device)
    out = build.ops().walk_transition(aff_grids.contiguous(), dirs_t, seq, lut, int(H), int(W),
                                      int(woff), float(beta))
    build.count("walk_transition")
    return out


# K10's products: the square kernel's tile of C and k-step (``csrc/launchers.h``
# kWalkTile, kWalkStep), on which the occupancy maps lie, and the most rows of a
# that take the thin kernel
TILE, STEP, THIN_ROWS = 128, 16, 32


def walk_matmul_plain(a, b, band_a=None, band_b=None):
    """The plain version: ``a @ b`` in float64, rounded once to float32 (the
    bands only say which entries are zero)."""
    a64 = a.double()
    return (a64 @ (a64 if b is a else b.double())).to(torch.float32)


def walk_tile_occupancy_plain(x):
    """The plain version: ``(rows, cols)``, bool: ``rows[i, k]`` whether the
    TILE x STEP tile (i, k) of x [R, C] holds a nonzero, ``cols[k, j]`` the
    same for the STEP x TILE tile (k, j); a tile cut by the edge counts what
    it has."""
    nz = x != 0

    def tiles(rt, ct):
        R, C = nz.shape
        padded = nz.new_zeros(-(-R // rt) * rt, -(-C // ct) * ct)
        padded[:R, :C] = nz
        return padded.reshape(padded.shape[0] // rt, rt, -1, ct).any(3).any(1)

    return tiles(TILE, STEP), tiles(STEP, TILE)


def walk_tile_occupancy(x):
    """K10's occupancy maps on a CUDA tensor (one launch); the plain version
    on a CPU tensor. x [R, C] float32, C % 4 == 0."""
    if x.device.type == "cpu":
        return walk_tile_occupancy_plain(x)
    build.require_cuda("walk_tile_occupancy", x)
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError(f"walk_tile_occupancy: bad shape {tuple(x.shape)} (needs [R, C], "
                         f"C % 4 == 0)")
    rows, cols = build.ops().walk_tile_occupancy(x.contiguous())
    build.count("walk_tile_occupancy")
    return rows, cols


def _check_products(a, b):
    build.require_cuda("walk_matmul", a, b)
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or a.shape[1] % 8
            or b.shape[1] % 4):
        raise ValueError(f"walk_matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"(needs [M, K] @ [K, N], K % 8 == 0, N % 4 == 0)")


def _bands(a, b, band_a, band_b):
    """The bands as ints; None (dense) is the largest size, which no offset exceeds."""
    dense = max(a.shape[0], a.shape[1], b.shape[1])
    return tuple(dense if band is None else int(band) for band in (band_a, band_b))


def walk_square(a, b, occ_a, occ_b, band_a=None, band_b=None):
    """The square kernel on CUDA tensors (one launch) with the occupancy
    maps given: ``occ_a`` the rows map of a, ``occ_b`` the cols map of b
    (:func:`walk_tile_occupancy`; all true runs every k-tile of the band);
    the plain version on CPU tensors (the maps, as the bands, only say
    where the products are zero)."""
    if a.device.type == "cpu":
        return walk_matmul_plain(a, b, band_a, band_b)
    _check_products(a, b)
    out = build.ops().walk_square(a.contiguous(), b.contiguous(), occ_a.contiguous(),
                                  occ_b.contiguous(), *_bands(a, b, band_a, band_b))
    build.count("walk_matmul")
    return out


def walk_matmul(a, b, band_a=None, band_b=None):
    """K10's products on CUDA tensors; the plain version on CPU tensors.
    a [M, K], b [K, N] float32; ``a[i, k]`` is zero where ``|k - i| >
    band_a`` and ``b[k, j]`` where ``|j - k| > band_b`` (None: dense).
    Returns ``a @ b`` [M, N], summed in float64 and rounded once, so the
    result does not depend on the order of the sum: float32 sums in two
    orders put the walk's outputs 1e-4 of their max apart. M <= THIN_ROWS
    (the thin step) takes the thin kernel (one launch); larger M the FP64
    tensor-core kernel (one launch, :func:`walk_square`), which skips the
    k-tiles that :func:`walk_tile_occupancy` finds empty (one launch of it
    for a square ``walk_matmul(t, t)``, two otherwise)."""
    if a.device.type == "cpu":
        return walk_matmul_plain(a, b, band_a, band_b)
    _check_products(a, b)
    if a.shape[0] <= THIN_ROWS:
        out = build.ops().walk_thin(a.contiguous(), b.contiguous(),
                                    *_bands(a, b, band_a, band_b))
        build.count("walk_matmul")
        return out
    occ_a, occ_b = walk_tile_occupancy(a)
    if b is not a:
        occ_b = walk_tile_occupancy(b)[1]
    return walk_square(a, b, occ_a, occ_b, band_a, band_b)
