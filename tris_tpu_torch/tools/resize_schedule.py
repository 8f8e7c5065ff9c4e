"""How K6's bilinear forward (``tris_tpu_torch/kernels/csrc/bilinear_resize.cu``)
and backward (``csrc/bilinear_resize_bwd.cu``) cut a resize among their
blocks and threads, emulated on the host: the CPU tests hold the plans
against ``launchers.h``'s rules at the paths' shapes, the banded forward
against the plain version bit for bit, and the banded backward against the
first design's per-element gather bit for bit and against the plain
version's and JAX's gradients (``tests/test_torch_resize.py``). Nothing on
K6's path calls it.

The constants are read from ``csrc/launchers.h``, the kernels' own source of
them; :func:`plan` is that file's ``bilinear_resize_plan`` and
:func:`bwd_plan` its ``bilinear_resize_bwd_plan``.

The partition: the planes' output rows are flattened (row r is plane r // oh,
output row r % oh); block (band, tile) takes rows [band * band_rows, (band +
1) * band_rows) and the tile's ``tile_groups * vec`` columns, with one tile
first copying the input rows the band spans (``in_floats`` at most); a chunk of
``rows * rpt`` consecutive rows at a time, each row's t = wy0 x[y0] + wy1 x[y1] is
formed over the input columns the tile's taps span, [lo[c_begin], hi[c_end -
1]] (at most ``pitch``), then thread (row, q) writes its ``vec`` columns from
it as wx0 t[x0] + wx1 t[x1], every product and sum in float32
(:func:`banded_resize`).

The backward's partition: the planes' input rows are flattened (row f is
plane f // h, input row f % h); block b takes rows [b * band, (b + 1) *
band) and stages the g rows [g0, g0 + S) their adjoint ranges cover (from the
first row's hi range to the last row's lo range, S at most ``span_rows``);
it forms R[s, X] = the lo range's fmaf chain of wx0 g[s, ox], then the hi
range's of wx1, for every staged row and input column, then dx[f, X] = the
chain of wy0 R over the row's lo range, then of wy1 over its hi range
(:func:`banded_resize_bwd`; :func:`direct_resize_bwd` is the first design's
thread per input element, the same chains).
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


def fmaf(a, b, c):
    """CUDA's ``fmaf``, elementwise: float32 ``a * b + c`` rounded once. The
    product is exact in float64; the sum is formed in float64 rounded to odd
    (its exact error by TwoSum; where inexact, the odd one of the two doubles
    around it), which the cast to float32 then rounds once, as the card does."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def bwd_span_rows(d: int, h: int, oh: int) -> int:
    """``launchers.h::bilinear_resize_bwd_span_rows``: the flattened g rows that
    ``d + 1`` consecutive input rows' adjoint ranges span at most."""
    s1 = _ceil((2 * d + 5) * oh, 2 * h)
    s2 = _ceil((d + 2) * (oh - 1), h - 1) + 1 if h > 1 else 0
    return max(s1, s2) + d // h + 2


def _round4(n: int) -> int:
    return _ceil(n, 4) * 4


def bwd_smem(span: int, w: int, ow: int, g_pitch: int, r_pitch: int) -> int:
    """``launchers.h::bilinear_resize_bwd_smem``: a staged block's bytes."""
    return 4 * (span * r_pitch + _round4(span * g_pitch) + 2 * _round4(ow) + 2 * _round4(span)
                + _round4(4 * w))


def bwd_plan(planes: int, h: int, w: int, oh: int, ow: int) -> dict:
    """``launchers.h::bilinear_resize_bwd_plan``: the backward's launch of
    ``[planes, h, w] <- [oh, ow]``."""
    k = constants()
    total = planes * h
    vec = 4 if w % 4 == 0 else 1
    col_lanes = int(ow <= 2 * w)
    g_pitch = ow if col_lanes else ow | 1
    r_pitch = _round4(w)
    if r_pitch % 8 == 0:
        r_pitch += 4
    wave = k["kResizeBwdWaveBlocks"] if col_lanes else k["kResizeBwdRowsWaveBlocks"]
    most = k["kResizeBwdSmem"] if col_lanes else k["kResizeBwdRowsSmem"]
    band = k["kResizeBwdMaxBand"]
    while True:
        span = min(bwd_span_rows(band - 1, h, oh), planes * oh)
        if band == 1 or (_ceil(total, band) >= wave and
                         bwd_smem(span, w, ow, g_pitch, r_pitch) <= most):
            break
        band //= 2
    smem = bwd_smem(span, w, ow, g_pitch, r_pitch)
    staged = int(smem <= k["kResizeBwdSmemMax"])
    threads = k["kResizeBwdColThreads"] if staged and col_lanes else k["kResizeBwdThreads"]
    return {"staged": staged, "band": band if staged else 0, "span_rows": span if staged else 0,
            "g_pitch": g_pitch, "r_pitch": r_pitch, "vec": vec, "col_lanes": col_lanes,
            "threads": threads,
            "blocks": _ceil(total, band) if staged else _ceil(total * w, threads),
            "smem_bytes": smem if staged else 0}


def adjoint_ranges(in_size: int, out_size: int, align_corners: bool):
    """``kernels/response_head.py::adjoint_taps_on`` on the host: (lo_begin,
    lo_end, hi_begin, hi_end) of every input index, int64."""
    lo, hi, _, _ = interp_taps(in_size, out_size, align_corners)
    idx = np.arange(in_size)
    return (np.searchsorted(lo, idx, "left"), np.searchsorted(lo, idx, "right"),
            np.searchsorted(hi, idx, "left"), np.searchsorted(hi, idx, "right"))


def band_spans(planes: int, h: int, oh: int, band: int, align_corners: bool):
    """Each band's input rows and the g rows it stages: (f0, f1, g0, S) a band
    of ``band`` flattened input rows."""
    _, lo_end, hi_begin, _ = adjoint_ranges(h, oh, align_corners)
    total = planes * h
    out = []
    for f0 in range(0, total, band):
        f1 = min(f0 + band, total)
        g0 = (f0 // h) * oh + int(hi_begin[f0 % h])
        out.append((f0, f1, g0, ((f1 - 1) // h) * oh + int(lo_end[(f1 - 1) % h]) - g0))
    return out


def _chains(src, w0, w1, lb, le, hb, he):
    """``out[..., i]`` = the fmaf chain of ``w0[k] * src[..., k]`` over k in [lb[i],
    le[i]), then of ``w1[k] * src[..., k]`` over [hb[i], he[i]), from 0."""
    acc = np.zeros(src.shape[:-1] + (len(lb),), np.float32)
    for wt, b, e in ((w0, lb, le), (w1, hb, he)):
        for k in range(int((e - b).max(initial=0))):
            idx = np.minimum(b + k, src.shape[-1] - 1)
            acc = np.where(b + k < e, fmaf(wt[idx], src[..., idx], acc), acc)
    return acc


def _adjoint_taps(h, w, oh, ow, align_corners):
    _, _, wy0, wy1 = interp_taps(h, oh, align_corners)
    _, _, wx0, wx1 = interp_taps(w, ow, align_corners)
    return (wy0, wy1, adjoint_ranges(h, oh, align_corners),
            wx0, wx1, adjoint_ranges(w, ow, align_corners))


def banded_resize_bwd(g, in_hw, align_corners: bool = False, plan=None, visits=None):
    """``dx`` [..., h, w] of the resize ``[h, w] -> g.shape[-2:]`` from ``g``
    (float32) as the backward's blocks take it, on the host: each band sees
    only its staged g rows. ``plan``: the backward's plan to emulate (default
    :func:`bwd_plan` of this shape; the paths' plans at fewer planes).
    ``visits``, where given, is an int array [planes * h, w] to which each write
    adds 1. Raises if a band's span exceeds the plan's ``span_rows`` or a row
    reads a g row outside its band's."""
    g = torch.as_tensor(g)
    oh, ow = g.shape[-2:]
    h, w = int(in_hw[0]), int(in_hw[1])
    lead = g.shape[:-2]
    gs = g.reshape(-1, ow).numpy().astype(np.float32)            # [planes * oh, ow]
    planes = gs.shape[0] // oh
    p = plan or bwd_plan(planes, h, w, oh, ow)
    wy0, wy1, (ylb, yle, yhb, yhe), wx0, wx1, xr = _adjoint_taps(h, w, oh, ow, align_corners)
    dx = np.full((planes * h, w), np.nan, np.float32)
    for f0, f1, g0, S in band_spans(planes, h, oh, p["band"], align_corners):
        if S > p["span_rows"]:
            raise AssertionError(f"band at row {f0} spans {S} > {p['span_rows']} g rows")
        R = _chains(gs[g0:g0 + S], wx0, wx1, *xr)                 # [S, w]
        wrow = [wy0[(g0 + np.arange(S)) % oh], wy1[(g0 + np.arange(S)) % oh]]
        f = np.arange(f0, f1)
        Y = f % h
        base = (f // h) * oh - g0                                  # staged row of oy: base + oy
        acc = np.zeros((f1 - f0, w), np.float32)
        for wt, b, e in ((wrow[0], ylb[Y], yle[Y]), (wrow[1], yhb[Y], yhe[Y])):
            for k in range(int((e - b).max(initial=0))):
                on = b + k < e
                s = base + b + k
                if not ((s[on] >= 0) & (s[on] < S)).all():
                    raise AssertionError(f"band at row {f0} reads g rows outside its span")
                s = np.where(on, s, 0)
                acc = np.where(on[:, None], fmaf(wt[s][:, None], R[s], acc), acc)
        dx[f0:f1] = acc
        if visits is not None:
            visits[f0:f1] += 1
    return torch.from_numpy(dx).reshape(*lead, h, w)


def direct_resize_bwd(g, in_hw, align_corners: bool = False):
    """The first design's order (a thread an input element, R formed per output
    row it reads): the same chains, on the whole of g."""
    g = torch.as_tensor(g)
    oh, ow = g.shape[-2:]
    h, w = int(in_hw[0]), int(in_hw[1])
    lead = g.shape[:-2]
    gs = g.reshape(-1, oh, ow).numpy().astype(np.float32)
    wy0, wy1, yr, wx0, wx1, xr = _adjoint_taps(h, w, oh, ow, align_corners)
    R = _chains(gs, wx0, wx1, *xr)                                 # [planes, oh, w]
    dx = _chains(np.swapaxes(R, 1, 2), wy0, wy1, *yr)              # [planes, w, h]
    return torch.from_numpy(np.swapaxes(dx, 1, 2).copy()).reshape(*lead, h, w)
