"""How K5's backward (``tris_tpu_torch/kernels/csrc/critic_input_bwd.cu``)
cuts the maps' gradient among its blocks, emulated on the host: the CPU
tests hold its plan against ``launchers.h``'s rule at the train step's
shape, the banded gradient bit for bit against the first design's two
passes, and both against the plain version's and JAX's gradients
(``tests/test_torch_critic_input.py``); the card tests hold the kernel bit
for bit against :func:`banded_critic_input_bwd`. Nothing on K5's path calls
it.

The constants are read from ``csrc/launchers.h``, the kernel's own source of
them; :func:`plan` is that file's ``critic_input_bwd_plan``.

The partition: block b takes band b % bands of map p = b // bands, source
rows [Y0, Y1) (Y1 - Y0 = band, less in the last band). The output rows its
adjoint ranges cover are [y0, y0 + S), from the first row's hi range to the
last row's lo range (S at most ``span_rows``); they sample the image rows
[r0, r0 + nr) within [Y0 - 1, Y1] (nr at most ``img_rows``), which the block
stages with dA's S rows. For each output row it forms d cam_n[y,
x] = the fmaf chain over the channels c of dA[p, y, x, c] times the image
sampled at (y, x) (``tris::sample2``: rows first, each product and sum
rounded alone), then R[y, X] = the fmaf chain of wx0 d cam_n over X's lo
range, then of wx1 over its hi range, then d cams[p, Y, X] = the chain of
wy0 R over Y's lo range, then of wy1 over its hi range
(:func:`banded_critic_input_bwd`; :func:`direct_critic_input_bwd` is the
first design's two passes through the scratch R [P, n, W], the same chains).
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import torch

from tris_tpu_torch.ops.resize import interp_taps
from tris_tpu_torch.tools.resize_schedule import _chains, adjoint_ranges, bwd_span_rows, fmaf

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kCriticBwd* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kCriticBwd\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return _ceil(n, 4) * 4


def img_rows(band: int, H: int) -> int:
    """``launchers.h::critic_input_bwd_img_rows``: image rows a band samples at most."""
    return min(band + 2, H)


def smem(span: int, band: int, H: int, W: int, n: int) -> int:
    """``launchers.h::critic_input_bwd_smem``: a block's bytes (the image rows' space, which R
    reuses, d cam_n's rows, the taps)."""
    return 4 * (_round4(max(3 * img_rows(band, H), span) * W) + _round4(span * n) + 4 * n
                + 4 * W + 4 * span + 4 * band)


def plan(P: int, H: int, W: int, n: int) -> dict:
    """``launchers.h::critic_input_bwd_plan``: the launch for ``P`` maps
    ``[H, W] <- [n, n]``."""
    k = constants()
    threads = min(_ceil(max(n, W), 32) * 32, k["kCriticBwdMaxThreads"])
    band = k["kCriticBwdMaxBand"]
    while True:
        span = min(bwd_span_rows(band - 1, H, n), n)
        if band == 1 or (P * _ceil(H, band) >= k["kCriticBwdWaveBlocks"]
                         and smem(span, band, H, W, n) <= k["kCriticBwdSmem"]):
            break
        band //= 2
    b = smem(span, band, H, W, n)
    return {"fits": int(b <= k["kCriticBwdSmemMax"] and n <= threads), "band": band,
            "span_rows": span, "img_rows": img_rows(band, H), "threads": threads,
            "blocks": P * _ceil(H, band), "smem_bytes": b}


def band_spans(H: int, n: int, band: int):
    """Each band's source rows, the output rows it covers and the image rows
    they sample: (Y0, Y1, y0, S, r0, nr)."""
    lo, hi, _, _ = interp_taps(H, n, True)
    _, lo_end, hi_begin, _ = adjoint_ranges(H, n, True)
    out = []
    for Y0 in range(0, H, band):
        Y1 = min(Y0 + band, H)
        y0 = int(hi_begin[Y0])
        S = int(lo_end[Y1 - 1]) - y0
        r0 = int(lo[y0]) if S > 0 else Y0
        out.append((Y0, Y1, y0, S, r0, int(hi[y0 + S - 1]) + 1 - r0 if S > 0 else 0))
    return out


def _unpatch(dA, P: int, n: int, ps: int) -> np.ndarray:
    """dA [P * g², 3 * ps²] (columns (c, py, px)) as [P, 3, n, n]."""
    g = n // ps
    a = np.asarray(dA, np.float32).reshape(P, g, g, 3, ps, ps)
    return np.ascontiguousarray(a.transpose(0, 3, 1, 4, 2, 5).reshape(P, 3, n, n))


def sampled_image(image, n: int) -> np.ndarray:
    """``tris::sample2`` of every image plane at every (y, x) of n x n: rows
    first, each product and sum rounded alone in float32 (the forward's taps)."""
    image = np.asarray(image, np.float32)
    H, W = image.shape[-2:]
    ylo, yhi, wy0, wy1 = interp_taps(H, n, True)
    xlo, xhi, wx0, wx1 = interp_taps(W, n, True)

    def col(xi):
        return wy0[:, None] * image[..., ylo, :][..., xi] + wy1[:, None] * image[..., yhi, :][..., xi]

    return wx0 * col(xlo) + wx1 * col(xhi)


def _dcam_rows(d, img_n, rows):
    """d cam_n's rows ``rows`` of one map: the channels' fmaf chain from 0."""
    acc = np.zeros((len(rows), d.shape[-1]), np.float32)
    for c in range(3):
        acc = fmaf(d[c, rows], img_n[c, rows], acc)
    return acc


def _inputs(dA, image, S: int, n: int, ps: int):
    image = np.asarray(torch.as_tensor(image), np.float32)
    P = image.shape[0] * S
    return P, image.shape[-2], image.shape[-1], _unpatch(torch.as_tensor(dA), P, n, ps), \
        sampled_image(image, n)


def banded_critic_input_bwd(dA, image, S: int, n: int, ps: int, plan=None, visits=None):
    """d cams [P, H, W] (float32) as the kernel's blocks form it, on the host:
    each band sees only its span's rows. ``plan``: the plan to emulate (default
    :func:`plan` of this shape; the path's at fewer maps). ``visits``, where
    given, is an int array [P, H, W] to which each write adds 1. Raises if a
    band spans more output rows than the plan's ``span_rows`` or reads a row
    outside its span."""
    P, H, W, d, img_n = _inputs(dA, image, S, n, ps)
    p = plan or globals()["plan"](P, H, W, n)
    _, _, wy0, wy1 = interp_taps(H, n, True)
    _, _, wx0, wx1 = interp_taps(W, n, True)
    ylb, yle, yhb, yhe = adjoint_ranges(H, n, True)
    xr = adjoint_ranges(W, n, True)
    out = np.full((P, H, W), np.nan, np.float32)
    for Y0, Y1, y0, span, r0, nr in band_spans(H, n, p["band"]):
        if span > p["span_rows"] or nr > p["img_rows"] or (span and not Y0 - 1 <= r0 <= Y0):
            raise AssertionError(f"band at row {Y0} spans {span} > {p['span_rows']} rows or "
                                 f"samples image rows [{r0}, {r0 + nr}) past {p['img_rows']}")
        for m in range(P):
            rows = np.arange(y0, y0 + span)
            R = _chains(_dcam_rows(d[m], img_n[m // S], rows), wx0, wx1, *xr)   # [span, W]
            Y = np.arange(Y0, Y1)
            acc = np.zeros((Y1 - Y0, W), np.float32)
            for wt, b, e in ((wy0, ylb[Y], yle[Y]), (wy1, yhb[Y], yhe[Y])):
                for k in range(int((e - b).max(initial=0))):
                    on = b + k < e
                    s = b + k - y0
                    if not ((s[on] >= 0) & (s[on] < span)).all():
                        raise AssertionError(f"band at row {Y0} reads rows outside its span")
                    s = np.where(on, s, 0)
                    y = np.where(on, b + k, 0)
                    acc = np.where(on[:, None], fmaf(wt[y][:, None], R[s], acc), acc)
            out[m, Y0:Y1] = acc
            if visits is not None:
                visits[m, Y0:Y1] += 1
    return torch.from_numpy(out)


def direct_critic_input_bwd(dA, image, S: int, n: int, ps: int):
    """The first design's two passes: d cam_n's rows and their column
    adjoint into the scratch R [P, n, W], then the row adjoint of R."""
    P, H, W, d, img_n = _inputs(dA, image, S, n, ps)
    _, _, wy0, wy1 = interp_taps(H, n, True)
    _, _, wx0, wx1 = interp_taps(W, n, True)
    rows = np.arange(n)
    R = np.stack([_chains(_dcam_rows(d[m], img_n[m // S], rows), wx0, wx1,
                          *adjoint_ranges(W, n, True)) for m in range(P)])   # [P, n, W]
    dc = _chains(np.swapaxes(R, 1, 2), wy0, wy1, *adjoint_ranges(H, n, True))  # [P, W, H]
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(dc, 1, 2)))
