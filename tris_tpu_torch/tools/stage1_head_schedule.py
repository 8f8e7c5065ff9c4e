"""How K3's training head (``tris_tpu_torch/kernels/csrc/stage1_head.cu``) cuts
an image among its cluster's ranks, forward and backward, emulated on the
host: the CPU tests hold the plan against ``launchers.h``'s rule at the train
path's shape, the ranks' shares of the pixels, texts, output rows and channel
groups (each taken once), and the kernels' arithmetic against the plain
version and, through the stage-1 model and its loss, against JAX
(``tests/test_torch_stage1_head.py``); the card's tests hold the kernel's score
plane and relu map to :func:`emulate_forward` bit for bit. Nothing on K3's
path calls it.

The constants are read from ``csrc/launchers.h``, the kernels' own source of
them; :func:`plan` is that file's ``stage1_head_plan``.

The forward: image b is a cluster of R ranks; rank r forms the scores of pixels
[r hw / R, (r + 1) hw / R) (:func:`share`) against the T texts (T = B on one
process; a rank's images against the global batch's texts in a process group,
image b's own text at b + offset), a tile of
56 pixels by 48 texts a pass, a lane 14 pixels by 6 texts
(:func:`score_tiles`); the block's warps split the channels by groups of 4,
each score ``scale * sum`` with sum the warps' fmaf chains over their groups
added in warp order (:func:`split_chain`); every rank then holds the plane,
writes cls_out on its share of the texts and both maps on output rows [r H / R,
(r + 1) H / R), each from its t-row t = wy0 s[y0] + wy1 s[y1] as wx0 t[x0] +
wx1 t[x1], every product and sum rounded alone (:func:`upsample_rows`). The
backward: rank r forms d seg on its band (d sig_map * s * (1 - s), plus d
relu_map where seg > 0), reduces each row onto the w columns (a chain over the
column adjoint's lo range then its hi range) and the band's rows onto the h
rows (the row adjoint's ranges cut to the band), and the ranks' partials are
added in rank order (:func:`down`); dscore follows (:func:`dscore`, the GMP's
gradient to the first argmax), and rank r writes both input gradients on its
channel groups (:func:`share` of D / 4), d vis_p a chain over the texts and d
lan_p over the pixels, in order, times the scale (:func:`emulate_backward`).
The softmax head's sums run in another order on the card: cls_out, cls_fg,
sig_map, dscore and the gradients agree with it within the tests' bars, not bit
for bit.
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import torch

from tris_tpu_torch.ops.resize import interp_taps
from tris_tpu_torch.tools.resize_schedule import fmaf

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kStage1Head* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kStage1Head\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round(n: int, m: int) -> int:
    return _ceil(n, m) * m


def plan(B: int, h: int, w: int, D: int, H: int, W: int, backward: bool = False,
         T: int = None) -> dict:
    """``launchers.h::stage1_head_plan``: the launch for ``B`` images and ``T``
    texts (default ``B``)."""
    T = B if T is None else T
    k = constants()
    hw = h * w
    wave = k["kStage1HeadBwdWaveBlocks" if backward else "kStage1HeadWaveBlocks"]
    R = 1
    while (R < k["kStage1HeadMaxRanks"] and B * 2 * R <= wave
           and 2 * R * k["kStage1HeadMinRows"] <= H):
        R *= 2
    pixels, band = _ceil(hw, R), _ceil(H, R)
    tp, tt = k["kStage1HeadTilePixels"], k["kStage1HeadTileTexts"]
    vec_hw, trows = _round(hw, 4), _round(band * w, 4)
    stages = 0
    if not backward:
        stage = (tp + tt) * (k["kStage1HeadChunk"] + k["kStage1HeadPad"])
        after = max(2 * vec_hw + trows, k["kStage1HeadKSplit"] * tp * tt)
        for stages in range(k["kStage1HeadStages"], 1, -1):
            floats = _round(hw * T, 4) + max(stages * stage, after)
            if 4 * floats <= k["kStage1HeadMaxSmem"]:
                break
    else:
        seg = map_groups(W) * h * (W | 1)
        grads = T * _round(hw, 8) + 4 * k["kStage1HeadGradStages"] * k["kStage1HeadGradChunk"] * (
            _ceil(D // 4, R))
        floats = hw * _round(T, 8) + 6 * vec_hw + 3 * _round(T, 4) + trows + max(seg, grads)
    return {"ranks": R, "threads": k["kStage1HeadThreads"], "pixels": pixels,
            "band_rows": band, "vec": 4 if W % 4 == 0 else 1,
            "passes": 0 if backward else _ceil(pixels, tp) * _ceil(T, tt),
            "stages": stages, "groups": _ceil(D // 4, R) if backward else 0, "blocks": B * R,
            "smem_bytes": 4 * floats}


def map_groups(W: int) -> int:
    """``launchers.h::stage1_head_map_groups``: the backward's row groups."""
    k = constants()
    groups = W // 4 if W % 4 == 0 else W
    return min(k["kStage1HeadThreads"] // min(groups, k["kStage1HeadThreads"]),
               k["kStage1HeadMapGroups"])


def share(n: int, R: int, rank: int) -> range:
    """Rank ``rank`` of ``R``'s share of ``n`` pixels, texts, output rows or
    channel groups."""
    return range(rank * n // R, (rank + 1) * n // R)


def score_tiles(n_pixels: int, T: int):
    """The forward's lanes over a share of ``n_pixels`` pixels: for each pass (a tile of
    kStage1HeadTilePixels pixels by kStage1HeadTileTexts texts) and each lane (pl, tl) of a
    warp's 4 x 8, its pixels pl + 4 i and texts tl + 8 j of the tile, those past the share or
    T dropped. Every warp sums its split of the channels over the same lanes."""
    k = constants()
    tp, tt = k["kStage1HeadTilePixels"], k["kStage1HeadTileTexts"]
    for p0 in range(0, n_pixels, tp):
        for t0 in range(0, T, tt):
            for pl in range(4):
                for tl in range(8):
                    yield ([p for p in range(p0 + pl, p0 + tp, 4) if p < n_pixels],
                           [t for t in range(t0 + tl, t0 + tt, 8) if t < T])


def fmaf_chain(a, b):
    """``a [..., n, K]`` against ``b [..., m, K]`` -> ``[..., n, m]``: for each
    pair, ``acc = fmaf(a[k], b[k], acc)`` over k in order, from 0."""
    acc = np.zeros(a.shape[:-1] + (b.shape[-2],), np.float32)
    for c in range(a.shape[-1]):
        acc = fmaf(a[..., :, None, c], b[..., None, :, c], acc)
    return acc


def split_chain(a, b):
    """The forward's scores before the scale: ``a [..., n, D]`` against ``b [..., m, D]``,
    warp j's fmaf chain over the groups of 4 channels j, j + S, ... (S = kStage1HeadKSplit) in
    order, the S sums then added in warp order."""
    S = constants()["kStage1HeadKSplit"]
    D = a.shape[-1]
    pad = _round(D, 4 * S) - D
    a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), np.float32)], -1)
    b = np.concatenate([b, np.zeros(b.shape[:-1] + (pad,), np.float32)], -1)
    groups = a.shape[-1] // (4 * S)

    def warp(x, j):  # warp j's channels in its order
        return x.reshape(x.shape[:-1] + (groups, S, 4))[..., j, :].reshape(x.shape[:-1] + (-1,))

    total = fmaf_chain(warp(a, 0), warp(b, 0))
    for j in range(1, S):
        total = total + fmaf_chain(warp(a, j), warp(b, j))
    return total


def upsample_rows(own, out_hw, rows):
    """``own [B, h, w]`` on output rows ``rows`` -> ``[B, len(rows), W]``: each
    row's t-row, then its columns, every product and sum rounded alone."""
    (H, W), (h, w) = out_hw, own.shape[1:]
    ylo, yhi, wy0, wy1 = interp_taps(h, H, False)
    xlo, xhi, wx0, wx1 = interp_taps(w, W, False)
    rows = np.asarray(rows, np.int64)
    t = wy0[rows][:, None] * own[:, ylo[rows]] + wy1[rows][:, None] * own[:, yhi[rows]]
    return wx0 * t[..., xlo] + wx1 * t[..., xhi]


def _diagonal(score, offset: int = 0):
    B = score.shape[0]
    return score[np.arange(B), :, np.arange(B) + offset]  # [B, hw]: score[b, :, b + offset]


def _softmax(score):
    """Per pixel, the masks of the T texts (the bg logit 1 beside them)."""
    mx = np.maximum(np.float32(1), score.max(-1, keepdims=True))
    e = np.exp(score - mx)
    z = e.sum(-1, keepdims=True) + np.exp(np.float32(1) - mx)
    return e / z


def emulate_forward(vis, lan, scale, hw_shape, out_hw, focal_p: float, focal_lambda: float,
                    score_visits=None, row_visits=None, offset: int = 0):
    """The kernel's ``(score [B, hw, T], cls_out [B, T], cls_fg [B], relu_map,
    sig_map [B, H, W])`` (numpy float32), image b's own text ``b + offset``.
    ``score_visits`` [B, hw, T] and ``row_visits`` [B, H], where given, count
    each score formed and each output row written, by any rank's any thread."""
    (h, w), (H, W) = hw_shape, out_hw
    vis, lan = np.asarray(vis, np.float32), np.asarray(lan, np.float32)
    B, hw, D = vis.shape
    T = lan.shape[1]
    scale = np.float32(scale)
    R = plan(B, h, w, D, H, W, T=T)["ranks"]
    score = np.full((B, hw, T), np.nan, np.float32)
    for rank in range(R):
        px = share(hw, R, rank)
        score[:, px.start:px.stop] = scale * split_chain(vis[:, px.start:px.stop], lan)
        if score_visits is not None:
            for pixels, texts in score_tiles(len(px), T):
                score_visits[:, np.asarray(pixels, np.int64)[:, None] + px.start,
                             np.asarray(texts, np.int64)[None]] += 1
    masks = _softmax(score)
    mbar = masks.mean(1)
    cls_out = (score.mean(1) + score.max(1)
               + np.power(1 - mbar, np.float32(focal_p)) * np.log(np.float32(focal_lambda) + mbar))
    cls_fg = mbar[np.arange(B), np.arange(B) + offset]
    own = _diagonal(score, offset).reshape(B, h, w)
    relu = np.full((B, H, W), np.nan, np.float32)
    sig = np.full((B, H, W), np.nan, np.float32)
    for rank in range(R):
        rows = share(H, R, rank)
        seg = upsample_rows(own, out_hw, rows)
        relu[:, rows.start:rows.stop] = np.maximum(seg, np.float32(0))
        sig[:, rows.start:rows.stop] = np.float32(1) / (np.float32(1) + np.exp(-seg))
        if row_visits is not None:
            row_visits[:, rows.start:rows.stop] += 1
    return score, cls_out.astype(np.float32), cls_fg, relu, sig


def adjoint_ranges(in_size: int, out_size: int):
    """For each input index, the output indices whose lo tap is it and those
    whose hi tap is it, as ranges (``kernels.response_head.adjoint_taps_on``)."""
    lo, hi, _, _ = interp_taps(in_size, out_size, False)
    idx = np.arange(in_size)
    return [(range(a, b), range(c, d)) for a, b, c, d in zip(
        np.searchsorted(lo, idx, "left"), np.searchsorted(lo, idx, "right"),
        np.searchsorted(hi, idx, "left"), np.searchsorted(hi, idx, "right"))]


def down(score, g_relu, g_sig, hw_shape, out_hw, R: int, row_visits=None, offset: int = 0):
    """d seg onto the [h, w] plane [B, hw]: rank r's band cut into the row groups' sub-bands,
    each streamed in order onto the h rows (row y's lo tap, then its hi tap, an fmaf each),
    the groups' sums added in order, each h row reduced onto the w columns (the column
    adjoint's lo range, then its hi range); the ranks' partials added in rank order."""
    (h, w), (H, W) = hw_shape, out_hw
    B = score.shape[0]
    own = _diagonal(score, offset).reshape(B, h, w)
    ylo, yhi, wy0, wy1 = interp_taps(h, H, False)
    _, _, wx0, wx1 = interp_taps(w, W, False)
    cols = adjoint_ranges(w, W)
    G = map_groups(W)
    out = np.zeros((B, h * w), np.float32)
    for rank in range(R):
        band = share(H, R, rank)
        y0, n = band.start, len(band)
        u = np.zeros((G, B, h, W), np.float32)
        for g in range(G):
            rows = range(y0 + g * n // G, y0 + (g + 1) * n // G)
            if not len(rows):
                continue
            seg = upsample_rows(own, out_hw, rows)
            s = np.float32(1) / (np.float32(1) + np.exp(-seg))
            gs = (np.zeros_like(seg) if g_sig is None
                  else np.asarray(g_sig, np.float32)[:, rows.start:rows.stop])
            gr = (np.zeros_like(seg) if g_relu is None
                  else np.asarray(g_relu, np.float32)[:, rows.start:rows.stop])
            d = gs * s * (np.float32(1) - s)
            d = np.where(seg > 0, d + gr, d)
            for e, y in enumerate(rows):
                u[g, :, ylo[y]] = fmaf(wy0[y], d[:, e], u[g, :, ylo[y]])
                u[g, :, yhi[y]] = fmaf(wy1[y], d[:, e], u[g, :, yhi[y]])
        total = u[0]
        for g in range(1, G):
            total = total + u[g]
        part = np.zeros((B, h, w), np.float32)
        for j, (lo_r, hi_r) in enumerate(cols):
            acc = np.zeros((B, h), np.float32)
            for x in lo_r:
                acc = fmaf(wx0[x], total[..., x], acc)
            for x in hi_r:
                acc = fmaf(wx1[x], total[..., x], acc)
            part[..., j] = acc
        out = out + part.reshape(B, h * w)
        if row_visits is not None:
            row_visits[:, band.start:band.stop] += 1
    return out


def dscore(g_cls, score, seg_grad, focal_p: float, focal_lambda: float, offset: int = 0):
    """d score [B, hw, T] from d cls_out [B, T] and d seg on the plane [B, hw]:
    the mean's, the first argmax's (the whole GMP gradient), the focal term's
    through the softmax, and the own texts' (``b + offset``)."""
    g_cls = np.asarray(g_cls, np.float32)
    B, hw, T = score.shape
    fp, fc = np.float32(focal_p), np.float32(focal_lambda)
    masks = _softmax(score)
    mbar = masks.mean(1)
    fgrad = (-fp * np.power(1 - mbar, fp - 1) * np.log(fc + mbar)
             + np.power(1 - mbar, fp) / (fc + mbar))
    gq = g_cls * fgrad / np.float32(hw)
    dot = (masks * gq[:, None, :]).sum(-1, keepdims=True)
    ds = g_cls[:, None, :] / np.float32(hw) + masks * (gq[:, None, :] - dot)
    am = score.argmax(1)                                  # the first argmax a text
    bb, qq = np.meshgrid(np.arange(B), np.arange(T), indexing="ij")
    ds[bb, am, qq] += g_cls
    ds[np.arange(B), :, np.arange(B) + offset] += seg_grad
    return ds.astype(np.float32)


def emulate_backward(g_cls, g_relu, g_sig, vis, lan, scale, score, hw_shape, out_hw,
                     focal_p: float, focal_lambda: float, row_visits=None, group_visits=None,
                     offset: int = 0):
    """The kernel's ``(d_vis [B, hw, D], d_lan [B, T, D])`` (numpy float32) from
    ``d cls_out``, ``d relu_map`` and ``d sig_map`` (either may be None) and
    the forward's ``score``. ``row_visits`` [B, H] and ``group_visits``
    [B, D // 4], where given, count each map row read and each channel group
    written, by any rank."""
    (h, w), (H, W) = hw_shape, out_hw
    vis, lan = np.asarray(vis, np.float32), np.asarray(lan, np.float32)
    B, hw, D = vis.shape
    R = plan(B, h, w, D, H, W, backward=True, T=lan.shape[1])["ranks"]
    seg_grad = (down(score, g_relu, g_sig, hw_shape, out_hw, R, row_visits, offset)
                if g_relu is not None or g_sig is not None else np.zeros((B, hw), np.float32))
    ds = dscore(g_cls, score, seg_grad, focal_p, focal_lambda, offset)
    scale = np.float32(scale)
    d_vis = np.full(vis.shape, np.nan, np.float32)
    d_lan = np.full(lan.shape, np.nan, np.float32)
    for rank in range(R):
        g = share(D // 4, R, rank)
        c = slice(4 * g.start, 4 * g.stop)
        d_vis[..., c] = scale * fmaf_chain(ds, lan[..., c].transpose(0, 2, 1))
        d_lan[..., c] = scale * fmaf_chain(ds.transpose(0, 2, 1), vis[..., c].transpose(0, 2, 1))
        if group_visits is not None:
            group_visits[:, g.start:g.stop] += 1
    return d_vis, d_lan


class _Emulated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vis_p, lan_p, scale, h, w, H, W, focal_p, focal_lambda, offset):
        score, *outs = emulate_forward(vis_p.detach().numpy(), lan_p.detach().numpy(),
                                       float(scale), (h, w), (H, W), focal_p, focal_lambda,
                                       offset=offset)
        ctx.save_for_backward(vis_p, lan_p)
        ctx.args = (float(scale), score, (h, w), (H, W), focal_p, focal_lambda, offset)
        cls_out, cls_fg, relu_map, sig_map = (torch.from_numpy(o) for o in outs)
        ctx.mark_non_differentiable(cls_fg)
        ctx.set_materialize_grads(False)
        return cls_out, cls_fg, relu_map, sig_map

    @staticmethod
    def backward(ctx, g_cls, _g_fg, g_relu, g_sig):
        vis_p, lan_p = ctx.saved_tensors
        scale, score, hw_shape, out_hw, fp, fc, offset = ctx.args
        B, _, T = score.shape
        g_cls = np.zeros((B, T), np.float32) if g_cls is None else g_cls.numpy()
        d_vis, d_lan = emulate_backward(
            g_cls, None if g_relu is None else g_relu.numpy(),
            None if g_sig is None else g_sig.numpy(), vis_p.detach().numpy(),
            lan_p.detach().numpy(), scale, score, hw_shape, out_hw, fp, fc, offset=offset)
        return torch.from_numpy(d_vis), torch.from_numpy(d_lan), *([None] * 8)


def emulated_head(vis_p, lan_p, scale, hw_shape, out_hw, focal_p: float, focal_lambda: float,
                  offset: int = 0):
    """``kernels.stage1_head`` as the kernels compute it, on CPU float32
    tensors: forward and backward emulated (``scale`` gets no gradient, as
    from the kernels)."""
    (h, w), (H, W) = hw_shape, out_hw
    return _Emulated.apply(vis_p, lan_p.contiguous(), scale.detach().reshape(()), h, w, H, W,
                           float(focal_p), float(focal_lambda), int(offset))
