"""How K4 (``tris_tpu_torch/kernels/csrc/eval_metrics.cu``) cuts a map among
the blocks of its cluster and combines their results, emulated on the host:
the CPU tests hold the plan against ``launchers.h``'s rule at the paths'
shapes and the clustered computation against the plain version exactly
(``tests/test_torch_eval_metrics.py``). Nothing on K4's path calls it.

The constants are read from ``csrc/launchers.h``, the kernel's own source of
them; :func:`plan` is that file's ``eval_metrics_plan``.

The partition: map (b, s) takes a cluster of R blocks; rank r owns the valid
output rows [r oh / R, (r + 1) oh / R) of image b's original (oh, ow) (none
where oh < R leaves it empty) and forms their interpolated rows t = wy0
x[y0] + wy1 x[y1]. Pass 1: each rank's max over its band (-inf when empty);
every rank takes the max over the R of them. Pass 2: v = RN(u / d), d = max
+ 1e-5, does not decrease in u where d > 0, so each rank compares its
samples with two cuts found by search (:func:`least_quotient`): v > 1e-9
exactly where u >= u_p, and v is the peak RN(max / d) exactly where u >=
u_lo; it counts I and U in integers and keeps its band's first peak (value,
flat index y * maxW + x; INT_MAX when empty). Where d <= 0 it divides each
sample by d instead;
rank 0 adds the counts and takes the peak over the ranks in rank order, ties
to the lower index. With ``want_norm`` each rank writes its band's
normalised rows and its share [oh + r (maxH - oh) / R, oh + (r + 1) (maxH -
oh) / R) of the zero rows (:func:`clustered_metrics`).
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import torch

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"
INT_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kEval* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kEval\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def band_rows(maxH: int, R: int) -> int:
    return _ceil(maxH, R)


def smem(maxH: int, w: int, R: int) -> int:
    """Bytes of a staged block: the band's t-rows and its rows' y taps."""
    return 4 * band_rows(maxH, R) * (w + 4)


def plan(B: int, S: int, maxH: int, maxW: int, h: int, w: int, max_ranks: int | None = None):
    """``launchers.h::eval_metrics_plan`` with ``max_ranks`` (the wide cluster by
    default, as on a card that runs one)."""
    k = constants()
    max_ranks = k["kEvalWideRanks"] if max_ranks is None else max_ranks
    R = 1
    while R < max_ranks and B * S * R < k["kEvalWaveBlocks"] and 2 * R * k["kEvalMinRows"] <= maxH:
        R *= 2
    while R < max_ranks and smem(maxH, w, R) > k["kEvalSmemTarget"]:
        R *= 2
    b = smem(maxH, w, R)
    staged = int(b <= k["kEvalSmemTarget"])
    return {"ranks": R, "threads": k["kEvalThreads"], "band_rows": band_rows(maxH, R),
            "staged": staged, "smem_bytes": b if staged else 0, "blocks": B * S * R,
            "max_ranks": max_ranks}


def _key(f) -> int:
    """The float's ordered key: a < b exactly where key(a) < key(b)."""
    b = int(np.float32(f).view(np.int32))
    return b if b >= 0 else -(b & 0x7FFFFFFF)


def _float(k: int):
    return (np.array([k], np.int32) if k >= 0
            else np.array([(-k) | 0x80000000], np.uint32)).view(np.float32)[0]


def least_quotient(lo: int, hi: int, d, thr, strict: bool):
    """The least float u (as a key in (lo, hi]) with RN(u / d) > thr (strict) or >= thr,
    where that holds at hi and not at lo: the cut the kernel's warps find (RN(u / d) does not
    decrease in u for d > 0)."""
    f32 = np.float32
    while hi - lo > 1:
        mid = (lo + hi) // 2
        v = f32(_float(mid) / f32(d))
        if (v > thr) if strict else (v >= thr):
            hi = mid
        else:
            lo = mid
    return _float(hi)


def rank_rows(rank: int, R: int, oh: int) -> range:
    return range(rank * oh // R, (rank + 1) * oh // R)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def clustered_metrics(cams, tables, targets=None, boxes=None, R: int = 8,
                      want_norm: bool = False):
    """K4 as a cluster of ``R`` ranks a map takes it, on the host in float32:
    ``(I, U, hit, hitm)`` each [B, S], or with ``want_norm`` the normalised
    maps [B, S, maxH, maxW], as ``kernels.eval_metrics_plain`` returns them."""
    f32 = np.float32
    x = _np(cams).astype(f32)
    B, S, h, w = x.shape
    ylo, yhi, wy0, wy1 = (_np(t) for t in tables["y"])
    xlo, xhi, wx0, wx1 = (_np(t) for t in tables["x"])
    orig = _np(tables["orig_hw"]).astype(np.int64)
    maxH, maxW = ylo.shape[1], xlo.shape[1]
    tg = None if want_norm else _np(targets).astype(bool)
    bx = None if want_norm else _np(boxes).astype(f32)
    norm = np.full((B, S, maxH, maxW), np.nan, f32)     # every element written once below
    stats = np.zeros((4, B, S), f32)
    for b in range(B):
        oh, ow = int(orig[b, 0]), int(orig[b, 1])
        xl, xh, xa, xb = xlo[b, :ow], xhi[b, :ow], wx0[b, :ow], wx1[b, :ow]
        for s in range(S):
            bands = []
            for r in range(R):
                ys = np.asarray(rank_rows(r, R, oh), np.int64)
                t = (wy0[b, ys][:, None] * x[b, s, ylo[b, ys]]
                     + wy1[b, ys][:, None] * x[b, s, yhi[b, ys]])     # the band's t-rows
                bands.append((ys, xa * t[:, xl] + xb * t[:, xh]))
            maxes = [u.max() if u.size else f32(-np.inf) for _, u in bands]
            m = maxes[0]
            for q in maxes[1:]:
                m = max(m, q)
            denom = f32(m + f32(1e-5))
            if want_norm:
                for r, (ys, u) in enumerate(bands):
                    norm[b, s, ys, :ow] = u / denom
                    norm[b, s, ys, ow:] = 0
                    z0, z1 = (oh + q * (maxH - oh) // R for q in (r, r + 1))
                    norm[b, s, z0:z1] = 0
                continue
            total_i = total_u = 0
            best, best_i = f32(-np.inf), INT_MAX
            if denom > 0:
                # the samples are compared with the two cuts, not divided
                peak = f32(m / denom)
                inf = np.float32(np.inf)
                u_p = least_quotient(_key(-inf), _key(inf), denom, f32(1e-9), True)
                u_lo = least_quotient(_key(-inf), _key(m), denom, peak, False)
            for ys, u in bands:
                if not u.size:
                    continue       # an empty rank: 0, 0 and (-inf, INT_MAX)
                gt = tg[b, ys, :ow]
                if denom > 0:
                    pred, top = u >= u_p, u >= u_lo
                    rv = peak if top.any() else f32(-np.inf)
                    k = int(np.argmax(top)) if top.any() else None
                else:
                    v = u / denom
                    pred = v > f32(1e-9)
                    k = int(np.argmax(v))
                    rv = v.flat[k]
                total_i += int((pred & gt).sum())
                total_u += int((pred | gt).sum())
                if k is None:
                    continue
                ri = int(ys[k // ow]) * maxW + k % ow     # the band's first peak
                if rv > best or (rv == best and ri < best_i):
                    best, best_i = rv, ri
            peak = 0 if best_i == INT_MAX else best_i
            py, px = f32(peak // maxW), f32(peak % maxW)
            x1, y1, x2, y2 = bx[b]
            stats[:, b, s] = (total_i, total_u,
                              float(x1 <= px <= x2 and y1 <= py <= y2),
                              float(tg[b].flat[peak]))
    if want_norm:
        return torch.from_numpy(norm)
    return tuple(torch.from_numpy(a) for a in stats)
