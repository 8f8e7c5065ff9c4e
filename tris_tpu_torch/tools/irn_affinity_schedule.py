"""How K7's tiles (``tris_tpu_torch/kernels/csrc/path_max_tiles.cuh``) cut
the IRN loss fused with K7 (``csrc/irn_affinity.cu``), K7's backward
(``csrc/path_max_affinity_bwd.cu``) and K7's forward
(``csrc/path_max_affinity.cu``) among their blocks, emulated on the host:
the CPU tests hold the plan against ``launchers.h``'s rule, the partition
(each pair summed by one block; each backward tile's pairs covering every
pair and step that reaches its pixels; each forward output written by one
block) and the kernels' arithmetic against the plain version and JAX
(``tests/test_torch_irn_affinity.py``, ``tests/test_torch_path_max.py``).
Nothing on the path calls it; ``chip_smoke.py`` reads :func:`shared_loads`
for its yardsticks.

The constants are read from ``csrc/launchers.h``, the kernels' own source
of them; :func:`plan` is that file's ``path_tile_plan``.

The partition: block (b, ty, tx) takes tile (ty, tx) of ``tile_rows`` x
``tile_cols`` of image b: pairs (r, c) of the window [H - rf, W - 2 rf] in
the loss's forward, pixels (y, x) of [H, W] in a backward. The forward stages
``staged_rows`` x ``pitch`` values from the tile's first source pixel (r0,
c0) (image rows r0.., columns c0..) and sums every direction of its pairs.
A backward stages them from (y0 - rf, x0 - rf) and, for direction d with
steps in the box 0 <= dy <= dy_max, dx_min <= dx <= dx_max, computes the
pairs whose sources sit at staged rows [rf - dy_max, rf + tile_rows) and
columns [rf - dx_max, rf + tile_cols - dx_min): each one's path max, tie
count and q = cot / count in double; each pixel then subtracts q over d's
steps whose pair's max equals it, directions in table order, steps in path
order (:func:`tiled_backward`). K7's forward stages as the loss's forward
does, with -inf off the image, and splits the table's directions among
``dir_groups`` blocks a tile, contiguous runs in table order; a table the
kernel parameter cannot hold takes the direct kernel (:func:`forward_plan`,
:func:`tiled_forward`).
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"
LOSS_FORWARD, LOSS_BACKWARD, MAX_BACKWARD, MAX_FORWARD = 0, 1, 2, 3


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kPath* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kPath\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(kind: int, B: int, H: int, W: int, rf: int) -> dict:
    """``launchers.h::path_tile_plan``: the tiles of ``kind`` over B images
    of [H, W] at radius floor rf."""
    k = constants()
    pairs = kind in (LOSS_FORWARD, MAX_FORWARD)
    rows, cols = (H - rf, W - 2 * rf) if pairs else (H, W)
    warps = k["kPathThreads"] // k["kPathTileCols"]
    tiles_x = _ceil(cols, k["kPathTileCols"])
    rpt = k["kPathRowsPerThread"]
    while rpt > 1 and B * _ceil(rows, warps * rpt) * tiles_x < k["kPathWaveBlocks"]:
        rpt //= 2
    tile_rows = warps * rpt
    tiles_y = _ceil(rows, tile_rows)
    tiles = B * tiles_y * tiles_x
    groups = 1
    while (kind == MAX_FORWARD and groups < k["kPathForwardGroups"]
           and tiles * groups < k["kPathWaveBlocks"]):
        groups *= 2
    pitch = k["kPathTileCols"] + 2 * rf
    staged_rows = tile_rows + (rf if pairs else 2 * rf)
    region_rows = 0 if pairs else tile_rows + rf
    edge_only = kind in (MAX_BACKWARD, MAX_FORWARD)
    smem = region_rows * pitch * 12 + staged_rows * pitch * (4 if edge_only else 13)
    return {"rpt": rpt, "tile_rows": tile_rows, "tile_cols": k["kPathTileCols"], "pitch": pitch,
            "staged_rows": staged_rows, "region_rows": region_rows, "tiles_y": tiles_y,
            "tiles_x": tiles_x, "dir_groups": groups, "blocks": tiles * groups,
            "smem_bytes": 2 * k["kPathTableSteps"] + _ceil(smem, 16) * 16}


def forward_plan(B: int, H: int, W: int, rf: int, n_dirs: int, n_steps: int) -> dict:
    """K7's forward (``path_max_forward_tiled``): the tiles of
    :func:`plan` (``MAX_FORWARD``) with ``tiled`` 1 where the table fits the
    kernel parameter and the tile a block's shared memory, else ``tiled`` 0
    (the direct kernel)."""
    k = constants()
    p = plan(MAX_FORWARD, B, H, W, rf)
    tiled = (n_dirs <= k["kPathTableDirs"] and n_steps <= k["kPathTableSteps"]
             and p["smem_bytes"] <= k["kPathMaxSmem"])
    return {"tiled": int(tiled), **{key: v for key, v in p.items() if key != "region_rows"}}


def table(steps, pitch: int) -> dict:
    """``path_max_tiles.cuh::path_table``: per direction its steps' offsets in
    the staged rows, the box of its steps (and the source), its destination."""
    begin = np.cumsum([0] + [len(p) for p in steps])
    off = np.asarray([dy * pitch + dx for p in steps for dy, dx in p], np.int64)
    box = np.asarray([(max(0, *(s[0] for s in p)), min(0, *(s[1] for s in p)),
                       max(0, *(s[1] for s in p))) for p in steps], np.int64).reshape(-1, 3)
    dst = np.asarray([p[0] for p in steps], np.int64).reshape(-1, 2)
    return {"begin": begin, "off": off, "dy_max": box[:, 0], "dx_min": box[:, 1],
            "dx_max": box[:, 2], "dst": dst}


def _windows(a, steps, rf):
    """Each step's window a[..., dy : dy + ch, rf + dx : rf + dx + cw] of ``a [..., H, W]``."""
    H, W = a.shape[-2:]
    ch, cw = H - rf, W - 2 * rf
    return [a[..., dy:dy + ch, rf + dx:rf + dx + cw] for dy, dx in steps]


def _path_max_count(edge, path, rf):
    w = _windows(edge, path, rf)
    m = np.max(np.stack(w), axis=0)
    return m, sum((x == m).astype(np.int64) for x in w)


def _pair_class(a, b, max_valid):
    """0 none, 1 bg positive, 2 fg positive, 3 negative (``pair_class``)."""
    a, b = a.astype(np.int64), b.astype(np.int64)
    valid = (a < max_valid) & (b < max_valid)
    return np.where(~valid, 0, np.where(a != b, 3, np.where(a == 0, 1, 2)))


def _f32(x):
    return np.asarray(x, np.float32)


def _sgn(v):
    """abs' slope as JAX takes it: 1 where ``v >= 0`` (exact zeros included), else -1."""
    return _f32(np.where(v >= 0, 1, -1))


def loss_terms(labels, edge, dp, path, rf, eps, one_eps, max_valid):
    """The forward's float terms of direction ``path`` at every pair of the
    window: (class, -log(aff + eps), -log(1 + eps - aff), |p - target|, |p|)."""
    m, _ = _path_max_count(edge, path, rf)
    a = _f32(1) - m
    dy, dx = path[0]
    lab_s, lab_d = _windows(labels, [(0, 0), (dy, dx)], rf)
    cls = _pair_class(lab_s, lab_d, max_valid)
    (d_s0, d_d0), (d_s1, d_d1) = (_windows(dp[:, k], [(0, 0), (dy, dx)], rf) for k in (0, 1))
    p0, p1 = d_s0 - d_d0, d_s1 - d_d1
    with np.errstate(divide="ignore", invalid="ignore"):
        pos = -np.log(a + _f32(eps))
        neg = -np.log(_f32(one_eps) - a)
    return (cls, pos, neg, np.abs(p0 - _f32(dy)) + np.abs(p1 - _f32(dx)),
            np.abs(p0) + np.abs(p1))


def fused_forward(labels, edge, dp, steps, rf, eps, one_eps, max_valid):
    """The loss's forward: each pair's float terms added in double (the
    kernel's tree of sums reorders them; a double sum of float terms does not
    move the float result) -> (sums [5] float32, counts [3] int64)."""
    s, c = np.zeros(5), np.zeros(3, np.int64)
    for path in steps:
        cls, pos, neg, fg_dp, bg_dp = loss_terms(labels, edge, dp, path, rf, eps, one_eps,
                                                 max_valid)
        bg, fg, ng = cls == 1, cls == 2, cls == 3
        s += [pos[bg].astype(np.float64).sum(), pos[fg].astype(np.float64).sum(),
              neg[ng].astype(np.float64).sum(), fg_dp[fg].astype(np.float64).sum(),
              bg_dp[bg].astype(np.float64).sum()]
        c += [bg.sum(), fg.sum(), ng.sum()]
    return s.astype(np.float32), c


def loss_cotangent(labels, edge, path, rf, gsum, eps, one_eps, max_valid):
    """d aff of direction ``path`` at every pair, in float as the kernel forms it."""
    m, _ = _path_max_count(edge, path, rf)
    a = _f32(1) - m
    lab_s, lab_d = _windows(labels, [(0, 0), path[0]], rf)
    cls = _pair_class(lab_s, lab_d, max_valid)
    gs = _f32(gsum)
    with np.errstate(divide="ignore", invalid="ignore"):
        neg = gs[2] / (_f32(one_eps) - a)
        pos = -(np.where(cls == 1, gs[0], gs[1]) / (a + _f32(eps)))
    return np.where(cls == 0, _f32(0), np.where(cls == 3, neg, pos)).astype(np.float32)


def gather(edge, cots, steps, rf):
    """d edge of K7 from each direction's cotangent ``cots[d]`` [B, ch, cw]:
    each pixel's -cot / count over (direction, step) in table order, in
    double, rounded to float32 once."""
    acc = np.zeros(edge.shape, np.float64)
    H, W = edge.shape[-2:]
    ch, cw = H - rf, W - 2 * rf
    for path, cot in zip(steps, cots):
        m, count = _path_max_count(edge, path, rf)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = cot.astype(np.float64) / count
        for dy, dx in path:
            view = acc[..., dy:dy + ch, rf + dx:rf + dx + cw]
            view -= np.where(edge[..., dy:dy + ch, rf + dx:rf + dx + cw] == m, q, 0.0)
    return acc.astype(np.float32)


def dp_gather(labels, dp, steps, rf, gsum, max_valid):
    """d dp of the loss: each pixel's displacement gradient as the source and
    then as the destination of each direction's pair, added in float32 in
    table order (K8's order)."""
    H, W = labels.shape[-2:]
    ch, cw = H - rf, W - 2 * rf
    acc = np.zeros(dp.shape, np.float32)
    g_fg, g_bg = _f32(gsum[3]), _f32(gsum[4])
    for path in steps:
        dy, dx = path[0]
        lab_s, lab_d = _windows(labels, [(0, 0), (dy, dx)], rf)
        cls = _pair_class(lab_s, lab_d, max_valid)
        grads = []
        for k, target in ((0, dy), (1, dx)):
            d_s, d_d = _windows(dp[:, k], [(0, 0), (dy, dx)], rf)
            p = d_s - d_d
            grads.append(np.where(cls == 2, g_fg * _sgn(p - _f32(target)), g_bg * _sgn(p)))
        take = (cls == 1) | (cls == 2)
        for k in (0, 1):
            src = acc[:, k, :ch, rf:rf + cw]
            src[...] = np.where(take, src + grads[k], src)
            dst = acc[:, k, dy:dy + ch, rf + dx:rf + dx + cw]
            dst[...] = np.where(take, dst + (-grads[k]), dst)
    return acc


def fused_backward(labels, edge, dp, gsum, steps, rf, eps, one_eps, max_valid):
    """The loss's backward as the kernel computes it: (d edge, d dp)."""
    cots = [loss_cotangent(labels, edge, p, rf, gsum, eps, one_eps, max_valid) for p in steps]
    return gather(edge, cots, steps, rf), dp_gather(labels, dp, steps, rf, gsum, max_valid)


def forward_visits(B: int, H: int, W: int, rf: int, n_dirs: int):
    """How many blocks of the loss's forward sum each pair [B, n_dirs, ch, cw]."""
    p = plan(LOSS_FORWARD, B, H, W, rf)
    ch, cw = H - rf, W - 2 * rf
    visits = np.zeros((B, n_dirs, ch, cw), np.int64)
    for blk in range(p["blocks"]):
        tx, ty, b = blk % p["tiles_x"], blk // p["tiles_x"] % p["tiles_y"], \
            blk // (p["tiles_x"] * p["tiles_y"])
        r0, c0 = ty * p["tile_rows"], tx * p["tile_cols"]
        visits[b, :, r0:r0 + p["tile_rows"], c0:c0 + p["tile_cols"]] += 1
    return visits


def _tile_regions(p, t, d, rf):
    """Direction d's pairs of a backward tile: staged (row, column) ranges of
    their sources."""
    rows = (rf - int(t["dy_max"][d]), rf + p["tile_rows"])
    cols = (rf - int(t["dx_max"][d]), rf + p["tile_cols"] - int(t["dx_min"][d]))
    return rows, cols


def backward_coverage(kind: int, B: int, H: int, W: int, rf: int, steps) -> dict:
    """For every tile and direction of a backward: each pair a step of whose
    path lands on one of the tile's pixels is among the tile's pairs, those
    pairs lie in the region rows, and their paths' reads in the staged rows.
    Returns the counts of pairs computed and needed (valid and reaching the
    tile) over the call and the failures found."""
    p = plan(kind, 1, H, W, rf)
    t = table(steps, p["pitch"])
    ch, cw = H - rf, W - 2 * rf
    P, TR, TC = p["pitch"], p["tile_rows"], p["tile_cols"]
    computed = needed = 0
    failures = []
    for ty in range(p["tiles_y"]):
        for tx in range(p["tiles_x"]):
            y0, x0 = ty * TR, tx * TC
            for d, path in enumerate(steps):
                (r_lo, r_hi), (c_lo, c_hi) = _tile_regions(p, t, d, rf)
                if r_lo < 0 or r_hi > p["region_rows"] or c_lo < 0 or c_hi > P:
                    failures.append((ty, tx, d, "region"))
                computed += (r_hi - r_lo) * (c_hi - c_lo)
                # every valid pair reaching a tile pixel through a step (staged coordinates)
                reach = set()
                for dy, dx in path:
                    fr = np.arange(rf, rf + TR)[:, None] - dy
                    fc = np.arange(rf, rf + TC)[None, :] - dx
                    r, c = y0 - rf + fr, x0 - rf + fc - rf
                    ok = (r >= 0) & (r < ch) & (c >= 0) & (c < cw) & \
                        (np.arange(y0, y0 + TR)[:, None] < H) & (np.arange(x0, x0 + TC) < W)
                    frr, fcc = np.broadcast_to(fr, ok.shape)[ok], np.broadcast_to(fc, ok.shape)[ok]
                    reach |= set(zip(frr.tolist(), fcc.tolist()))
                    if ((frr < r_lo) | (frr >= r_hi) | (fcc < c_lo) | (fcc >= c_hi)).any():
                        failures.append((ty, tx, d, "coverage"))
                needed += len(reach)
                ys = [dy for dy, _ in path]
                xs = [dx for _, dx in path]
                if (r_lo + min(ys) < 0 or r_hi - 1 + max(ys) >= p["staged_rows"]
                        or c_lo + min(xs) < 0 or c_hi - 1 + max(xs) >= P):
                    failures.append((ty, tx, d, "staged"))
    return {"computed": computed * B, "needed": needed * B, "failures": failures}


def tiled_backward(edge, steps, rf, cot_of=None, labels=None, dp=None, gsum=None, eps=0.0,
                   one_eps=0.0, max_valid=0):
    """A backward block by block as the kernel runs it: each tile's staged
    edge map (NaN off the image), each direction's pairs of the tile
    (:func:`backward_coverage`'s ranges, pairs off the window NaN), their
    max, tie count and q from the staged values, each pixel's gather from
    them. ``cot_of(b, d)``: the cotangent [ch, cw] of K7's backward; with
    ``labels`` the loss's, from the staged labels and ``gsum``. -> d edge."""
    B, H, W = edge.shape
    loss = labels is not None
    p = plan(LOSS_BACKWARD if loss else MAX_BACKWARD, B, H, W, rf)
    t = table(steps, p["pitch"])
    P, TR, TC, SR = p["pitch"], p["tile_rows"], p["tile_cols"], p["staged_rows"]
    ch, cw = H - rf, W - 2 * rf
    out = np.zeros_like(edge)
    pad = np.full((B, H + 2 * SR, W + 2 * P), np.nan, np.float32)
    pad[:, SR:SR + H, P:P + W] = edge
    if loss:
        lpad = np.full((B, H + 2 * SR, W + 2 * P), 255, np.uint8)
        lpad[:, SR:SR + H, P:P + W] = labels
    for blk in range(p["blocks"]):
        tx, ty = blk % p["tiles_x"], blk // p["tiles_x"] % p["tiles_y"]
        b = blk // (p["tiles_x"] * p["tiles_y"])
        y0, x0 = ty * TR, tx * TC
        se = pad[b, SR + y0 - rf:SR + y0 - rf + SR, P + x0 - rf:P + x0 - rf + P].reshape(-1)
        sl = lpad[b, SR + y0 - rf:SR + y0 - rf + SR, P + x0 - rf:P + x0 - rf + P].reshape(-1) \
            if loss else None
        pr, pc = np.mgrid[rf:rf + TR, rf:rf + TC]
        pix = (pr * P + pc).reshape(-1)
        v = se[pix]
        acc = np.zeros(pix.shape, np.float64)
        sm = np.full(p["region_rows"] * P, np.inf, np.float32)   # stale: never read
        sq = np.zeros(p["region_rows"] * P, np.float64)
        for d, path in enumerate(steps):
            (r_lo, r_hi), (c_lo, c_hi) = _tile_regions(p, t, d, rf)
            fr, fc = np.mgrid[r_lo:r_hi, c_lo:c_hi]
            idx = (fr * P + fc).reshape(-1)
            r, c = (y0 - rf + fr).reshape(-1), (x0 - rf + fc - rf).reshape(-1)
            ok = (r >= 0) & (r < ch) & (c >= 0) & (c < cw)
            offs = t["off"][t["begin"][d]:t["begin"][d + 1]]
            vals = np.stack([se[idx + o] for o in offs])
            with np.errstate(invalid="ignore"):
                m = np.max(np.where(np.isnan(vals), -np.inf, vals), axis=0).astype(np.float32)
            count = (vals == m).sum(0)
            if loss:
                cls = _pair_class(sl[idx], sl[idx + offs[0]], max_valid)
                a = _f32(1) - m
                gs = _f32(gsum)
                with np.errstate(divide="ignore", invalid="ignore"):
                    cot = np.where(cls == 0, _f32(0), np.where(
                        cls == 3, gs[2] / (_f32(one_eps) - a),
                        -(np.where(cls == 1, gs[0], gs[1]) / (a + _f32(eps)))))
            else:
                cot = np.zeros(idx.shape, np.float32)
                cot[ok] = cot_of(b, d)[r[ok], c[ok]]
            sm[idx] = np.where(ok, m, np.nan)
            with np.errstate(divide="ignore", invalid="ignore"):
                sq[idx] = np.where(ok, cot.astype(np.float64) / count, 0.0)
            for o in offs:
                j = pix - o
                acc -= np.where(sm[j] == v, sq[j], 0.0)
        y, x = (y0 + pr - rf).reshape(-1), (x0 + pc - rf).reshape(-1)
        keep = (y < H) & (x < W)
        out[b, y[keep], x[keep]] = acc[keep].astype(np.float32)
    return out


def tiled_forward(edge, steps, rf, groups: int = 0):
    """K7's forward as its plan launches it (``edge`` [B, H, W] float32):
    the tiled kernel block by block (each block's tile staged from its first
    pair with -inf off the image, its group's directions in table order, each
    pair's max over the step offsets from -inf, 1 - m written where the pair
    lies in the window), or, for a table the tiles cannot take, the direct
    kernel (a thread an output, the same steps in the same order). ``groups
    > 0`` overrides the plan's direction groups as the binding does.
    -> (out [B, n_dirs, ch, cw], writes: how many times each was written)."""
    B, H, W = edge.shape
    n_dirs, n_steps = len(steps), sum(len(s) for s in steps)
    fp = forward_plan(B, H, W, rf, n_dirs, n_steps)
    ch, cw = H - rf, W - 2 * rf
    out = np.full((B, n_dirs, ch, cw), np.nan, np.float32)
    writes = np.zeros(out.shape, np.int64)
    one = np.float32(1)
    if not fp["tiled"]:
        for d, path in enumerate(steps):
            m = np.full((B, ch, cw), -np.inf, np.float32)
            for dy, dx in path:
                m = np.maximum(m, edge[:, dy:dy + ch, rf + dx:rf + dx + cw])
            out[:, d] = one - m
            writes[:, d] += 1
        return out, writes
    G = groups or fp["dir_groups"]
    t = table(steps, fp["pitch"])
    P, TR, TC, SR = fp["pitch"], fp["tile_rows"], fp["tile_cols"], fp["staged_rows"]
    pad = np.full((B, H + SR, W + P), -np.inf, np.float32)
    pad[:, :H, :W] = edge
    rr, cc = np.mgrid[0:TR, 0:TC]
    pix = (rr * P + rf + cc).reshape(-1)
    for blk in range(fp["blocks"] // fp["dir_groups"] * G):
        g, tile = blk % G, blk // G
        tx, ty = tile % fp["tiles_x"], tile // fp["tiles_x"] % fp["tiles_y"]
        b = tile // (fp["tiles_x"] * fp["tiles_y"])
        r0, c0 = ty * TR, tx * TC
        se = pad[b, r0:r0 + SR, c0:c0 + P].reshape(-1)
        r, c = (r0 + rr).reshape(-1), (c0 + cc).reshape(-1)
        live = (r < ch) & (c < cw)
        for d in range(n_dirs * g // G, n_dirs * (g + 1) // G):
            m = np.full(pix.shape, -np.inf, np.float32)
            for o in t["off"][t["begin"][d]:t["begin"][d + 1]]:
                m = np.maximum(m, se[pix + o])
            out[b, d, r[live], c[live]] = one - m[live]
            writes[b, d, r[live], c[live]] += 1
    return out, writes


def shared_loads(kind: int, B: int, H: int, W: int, rf: int, steps) -> int:
    """The 4-byte shared-memory loads of a call's path steps, as issued
    (every lane of every block, ragged tiles included): a forward's maxima
    (K7's direction groups share a tile's steps); a backward's pairs' maxima
    and its pixels' gather."""
    p = plan(kind, B, H, W, rf)
    n_steps = sum(len(s) for s in steps)
    lanes = p["blocks"] // p["dir_groups"] * constants()["kPathThreads"] * p["rpt"]
    if kind in (LOSS_FORWARD, MAX_FORWARD):
        return lanes * n_steps
    t = table(steps, p["pitch"])
    pairs = sum((p["tile_rows"] + int(t["dy_max"][d])) *
                (p["tile_cols"] + int(t["dx_max"][d]) - int(t["dx_min"][d])) * len(s)
                for d, s in enumerate(steps)) * p["blocks"]
    return pairs + lanes * n_steps
