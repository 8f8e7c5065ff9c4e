"""How K6's bilinear forward (``tris_tpu_torch/kernels/csrc/bilinear_resize.cu``)
cuts a resize among its blocks and threads, emulated on the host: the CPU
tests hold the plan against ``launchers.h``'s rule at the paths' shapes and
the banded partition against the plain version bit for bit
(``tests/test_torch_resize.py``). Nothing on K6's path calls it.

The constants are read from ``csrc/launchers.h``, the kernel's own source of
them; :func:`plan` is that file's ``bilinear_resize_plan``.

The partition: the planes' output rows are flattened (row r is plane r // oh,
output row r % oh); block (band, tile) takes rows [band * band_rows, (band +
1) * band_rows) and the tile's ``tile_groups * vec`` columns, with one tile
first copying the input rows the band spans (``in_floats`` at most); a chunk of
``rows * rpt`` consecutive rows at a time, each row's t = wy0 x[y0] + wy1 x[y1] is
formed over the input columns the tile's taps span, [lo[c_begin], hi[c_end -
1]] (at most ``pitch``), then thread (row, q) writes its ``vec`` columns from
it as wx0 t[x0] + wx1 t[x1], every product and sum in float32
(:func:`banded_resize`).
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import torch

from tris_tpu_torch.ops.resize import interp_taps

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kResize* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kResize\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def span_rows(d: int, h: int, oh: int) -> int:
    """``launchers.h::bilinear_resize_span_rows``: the flattened input rows that
    ``d + 1`` consecutive output rows span at most."""
    s1 = _ceil(d * h, oh)
    s2 = _ceil(d * (h - 1), oh - 1) if oh > 1 else 0
    return max(s1, s2) + d // oh + 1 + 3


def plan(planes: int, h: int, w: int, oh: int, ow: int) -> dict:
    """``launchers.h::bilinear_resize_plan``: the launch of ``[planes, h, w] ->
    [oh, ow]``."""
    k = constants()
    vec = 4 if ow % 4 == 0 and w <= ow else 1
    groups = _ceil(ow, vec)
    tile_groups = min(groups, k["kResizeTileGroups"])
    tiles = _ceil(groups, tile_groups)
    total = planes * oh
    rows = k["kResizeThreads"] // tile_groups
    rpt = k["kResizeRowsPerThread"]
    while rpt > 1 and _ceil(total, rows * rpt) < k["kResizeMinBands"]:
        rpt //= 2
    if _ceil(total, rows) < k["kResizeMinBands"]:
        rows = max(1, total // k["kResizeMinBands"])
    n = tile_groups * vec
    span = w if tiles == 1 else (n - 1) * w // (ow - 1 if ow > 1 else 1) + 3
    pitch = min(span, w)
    t_smem = 2 * rows * rpt * pitch * 4
    staged = int(w <= ow and t_smem <= k["kResizeSmem"])
    c = _ceil(total, rows * rpt) * tiles // k["kResizeWaveBlocks"]
    chunks = max(1, min(c, k["kResizeMaxChunks"]))
    band_rows = rows * rpt * chunks
    bands = _ceil(total, band_rows)
    in_floats = _ceil(min(span_rows(band_rows - 1, h, oh), planes * h) * w, 4) * 4
    if not staged or tiles > 1 or in_floats * 4 + t_smem > k["kResizeSmem"]:
        in_floats = 0
    return {"vec": vec, "groups": groups, "tile_groups": tile_groups, "tiles": tiles,
            "rows": rows, "rpt": rpt, "threads": rows * tile_groups, "pitch": pitch,
            "staged": staged,
            "chunks": chunks, "band_rows": band_rows, "bands": bands, "blocks": bands * tiles,
            "in_floats": in_floats, "smem_bytes": in_floats * 4 + t_smem if staged else 0}


def banded_resize(x, size, align_corners: bool = False, visits=None):
    """``x`` [..., h, w] (float32) resized to ``size`` as the kernel's blocks
    take it, on the host in float32. ``visits``, where given, is an int array
    [planes * oh, ow] to which each write adds 1. Raises if a tile's t-rows
    span more input columns than the plan's pitch, or a band's input rows more
    than its staged copy holds."""
    x = torch.as_tensor(x)
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    lead = x.shape[:-2]
    xs = x.reshape(-1, h, w).numpy().astype(np.float32)
    planes = xs.shape[0]
    ylo, yhi, wy0, wy1 = interp_taps(h, oh, align_corners)
    xlo, xhi, wx0, wx1 = interp_taps(w, ow, align_corners)
    p = plan(planes, h, w, oh, ow)
    total = planes * oh
    out = np.full((total, ow), np.nan, np.float32)
    cols = p["tile_groups"] * p["vec"]
    for tile in range(p["tiles"]):
        c0, c1 = tile * cols, min((tile + 1) * cols, ow)
        j0, j1 = int(xlo[c0]), int(xhi[c1 - 1]) + 1
        if j1 - j0 > p["pitch"]:
            raise AssertionError(f"tile {tile} spans {j1 - j0} > pitch {p['pitch']}")
        lo, hi = xlo[c0:c1] - j0, xhi[c0:c1] - j0
        for band in range(p["bands"]):
            if p["in_floats"]:
                # the band's input rows, flattened, must fit the staged copy
                r0, r1 = band * p["band_rows"], min((band + 1) * p["band_rows"], total) - 1
                f0 = (r0 // oh) * h + int(ylo[r0 % oh])
                f1 = (r1 // oh) * h + int(yhi[r1 % oh]) + 1
                if (f1 - f0) * w > p["in_floats"]:
                    raise AssertionError(f"band {band} spans {(f1 - f0) * w} > {p['in_floats']}")
            crow = p["rows"] * p["rpt"]
            for chunk in range(p["chunks"]):
                r0 = band * p["band_rows"] + chunk * crow
                r = np.arange(r0, min(r0 + crow, total))
                if r.size == 0:
                    continue
                plane, oy = r // oh, r % oh
                rows0 = xs[plane, ylo[oy], j0:j1]
                rows1 = xs[plane, yhi[oy], j0:j1]
                t = wy0[oy][:, None] * rows0 + wy1[oy][:, None] * rows1   # [rows, span]
                out[r, c0:c1] = wx0[c0:c1] * t[:, lo] + wx1[c0:c1] * t[:, hi]
                if visits is not None:
                    visits[r[:, None], np.arange(c0, c1)] += 1
    return torch.from_numpy(out).reshape(*lead, oh, ow)
