"""What K11's kernels (``tris_tpu_torch/kernels/csrc/pixel_attn.cu``,
``pixel_attn_bwd.cu`` and their tiles in ``pixel_attn_tiles.cuh``) compute,
block by block, emulated on the host in float64: the CPU tests hold the tile
map to the plain version with it (``tests/test_torch_pixel_attn.py``), and
the card tests hold the kernels' launches to its block counts. Nothing on
K11's path calls it.

The tile constants are read from ``csrc/launchers.h``, the kernels' own
source of them; the functions below are that file's ``pixel_attn_*`` rules.
Each emulation walks its kernel's grid in order, a cluster of ``ranks``
blocks per (image, pixel tile) in the forward and per (image, group of
tiles) in the backward, and per block does what the block does: it stages
its tile's rows and the pair's key and value rows for the held channels of
each sub-slice (zeros past the rows, the tokens up to the bucket and the
channels), sums each warp's share of the float4 channel pieces, the warps'
partials in warp order and the cluster's in rank order, forms the softmax
over the real tokens, then the products over tokens (in steps of 4,
ascending) and over the tile's pixels (ascending), and writes the elements
its threads own: channels below C of the rows below HW. Each returns,
beside its results, how many times each output element was stored.

- :func:`forward`, ``pixel_attn_kernel``: the group's tiles in turn, and
  per tile the image's pairs in ascending order, G for the block's slice.
- :func:`backward`, ``pixel_attn_bwd_probs_dq_kernel`` then
  ``pixel_attn_bwd_dkv_kernel``: per pair, each tile of the group in turn,
  A and dL again, dq for the slice (stored for the first pair, added to for
  the later ones), dL^T q and A^T dG added into the group's partials, which
  the second kernel sums over the groups in ascending order.
"""

from __future__ import annotations

import functools
import math
import pathlib
import re

import numpy as np
import torch

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"
T_BUCKETS = (8, 16, 20, 24, 32)  # pixel_attn_t_bucket, the backward's
T_BUCKETS_FORWARD = (40, 48)      # and the forward's past kPixelAttnMaxT
WARPS = 8


@functools.lru_cache(maxsize=1)
def tiles() -> dict:
    """The ``constexpr int kPixelAttn* = n;`` (and ``long long``, a product
    of integers) constants of ``launchers.h``."""
    found = re.findall(r"constexpr (?:int|long long) (kPixelAttn\w+) = ([\d *]+);",
                       LAUNCHERS.read_text())
    return {k: math.prod(int(x) for x in v.split("*")) for k, v in found}


def t_bucket(T):
    T = np.asarray(T)
    buckets = T_BUCKETS + T_BUCKETS_FORWARD
    out = np.full(T.shape, buckets[-1])
    for b in reversed(buckets[:-1]):
        out = np.where(T <= b, b, out)
    return out


def token_pitch(tb):
    """A [pixel][token] row: the bucket made an odd number of 16-byte units."""
    tb = np.asarray(tb)
    return np.where(tb // 4 % 2 == 1, tb, tb + 4)


def ranks(C, backward: bool):
    t = tiles()
    s = t["kPixelAttnSliceBwd"] if backward else t["kPixelAttnSlice"]
    return np.clip(-(-np.asarray(C, dtype=np.int64) // s), 1, t["kPixelAttnMaxRanks"])


def width(C, backward: bool):
    """Channels a rank takes, a multiple of 4."""
    r = ranks(C, backward)
    return (-(-np.asarray(C, dtype=np.int64) // r) + 3) // 4 * 4


def held(w):
    return np.minimum(w, tiles()["kPixelAttnSlice"])


def subslices(w):
    s = tiles()["kPixelAttnSlice"]
    return -(-np.asarray(w) // s)


def pitch(h):
    return (np.asarray(h) + 7) // 8 * 8 + 4


def n_tiles(HW):
    return -(-np.asarray(HW) // tiles()["kPixelAttnTile"])


def block_tiles(N, HW, C, backward: bool):
    """``pixel_attn_block_tiles``: tiles a block takes in turn (one where its
    width takes sub-slices), so that the grid stays near
    ``kPixelAttnWaveBlocks`` blocks."""
    t = tiles()
    units = np.asarray(N, dtype=np.int64) * n_tiles(HW) * ranks(C, backward)
    wave = t["kPixelAttnWaveBlocksBwd" if backward else "kPixelAttnWaveBlocks"]
    per = np.clip(units // wave, 1, t["kPixelAttnMaxBlockTiles"])
    return np.where(subslices(width(C, backward)) > 1, 1, per)


def groups(N, HW, C, backward: bool):
    """``pixel_attn_groups``: the groups of tiles an image's tiles make."""
    return -(-n_tiles(HW) // block_tiles(N, HW, C, backward))


def smem(tb, C, backward: bool):
    """``pixel_attn_smem``: bytes of dynamic shared memory a block takes."""
    t = tiles()
    p = pitch(held(width(C, backward)))
    tp, tile = token_pitch(tb), t["kPixelAttnTile"]
    part = tile * tp
    tb = np.asarray(tb)
    red = t["kPixelAttnThreads"] // 32 * tile * tp
    if not backward:
        return 4 * (tile * p + 2 * tb * p + red + part + tile * tp)
    return 4 * (2 * tile * p + 2 * tb * p + red + 2 * part + tile * tp + 2 * tb * (tile + 4))


def takes(T, C, S, backward: bool):
    """``pixel_attn_takes``, elementwise over arrays of shapes."""
    t = tiles()
    T, C, S = (np.asarray(x) for x in (T, C, S))
    max_t = t["kPixelAttnMaxT"] if backward else t["kPixelAttnMaxTForward"]
    return ((T >= 1) & (T <= max_t) & (C >= 1) & (S >= 1)
            & (smem(t_bucket(T), C, backward) <= t["kPixelAttnMaxSmem"]))


def block_counts(N: int, S: int, HW: int, C: int, T: int) -> dict:
    """Each launch's grid: ``{"pixel_attn": {...}, "pixel_attn_bwd_probs_dq":
    {...}, "pixel_attn_bwd_dkv": {...}}``, each with ``blocks``, ``cluster``,
    ``threads``, ``smem_bytes``, ``t_bucket``, ``tile``, ``width`` and
    ``groups``, as ``pixel_attn_launch_shape`` reports them."""
    t = tiles()
    tb, tile, threads = int(t_bucket(T)), t["kPixelAttnTile"], t["kPixelAttnThreads"]
    out = {}
    for name, backward in (("pixel_attn", False), ("pixel_attn_bwd_probs_dq", True)):
        r, g = int(ranks(C, backward)), int(groups(N, HW, C, backward))
        out[name] = {"blocks": N * g * r, "cluster": r, "threads": threads,
                     "smem_bytes": int(smem(tb, C, backward)), "t_bucket": tb, "tile": tile,
                     "width": int(width(C, backward)), "groups": g}
    items = -(-N * S * T * C // (4 if C % 4 == 0 else 1))
    out["pixel_attn_bwd_dkv"] = dict(out["pixel_attn_bwd_probs_dq"], cluster=1, smem_bytes=0,
                                      blocks=min(-(-items // threads), t["kPixelAttnSumBlocks"]))
    return out


def _share(pieces: int, m: int, members: int):
    """The float4 pieces [k0, k1) of `pieces` that member m of `members` takes."""
    per = -(-pieces // members)
    k0 = min(pieces, m * per)
    return k0, min(pieces, k0 + per)


def _sub(C: int, rank: int, w: int, u: int):
    """Sub-slice u of the rank's channels: first channel, channels a block holds, channels
    below C."""
    h = int(held(w))
    c0 = rank * w + u * tiles()["kPixelAttnSlice"]
    return c0, h, max(0, min(h, w - u * tiles()["kPixelAttnSlice"], C - c0))


def _stage(x, row0, nrows, c0, cw, cap, h):
    """Rows [row0, row0 + nrows) x channels [c0, c0 + cw) of x [R, C] into a
    zero [cap, h] tile."""
    out = x.new_zeros(cap, h)
    out[:nrows, :cw] = x[row0:row0 + nrows, c0:c0 + cw]
    return out


def _partials(a, b, h, members):
    """Each member's a b^T over its share of the held float4 pieces, and
    their sum in member order."""
    total = None
    for m in range(members):
        k0, k1 = _share(h // 4, m, members)
        part = a[:, 4 * k0:4 * k1] @ b[:, 4 * k0:4 * k1].T
        total = part if total is None else total + part
    return total


def _softmax(full, T):
    s = full.clone()
    s[:, T:] = -torch.inf
    e = torch.exp(s - s.max(1, keepdim=True).values)
    return e / e.sum(1, keepdim=True)


def _by_tokens(p, b):
    """p b over the tokens in steps of 4, ascending."""
    acc = p.new_zeros(p.shape[0], b.shape[1])
    for t in range(0, p.shape[1], 4):
        acc = acc + p[:, t:t + 4] @ b[t:t + 4]
    return acc


def _by_rows(y, x):
    """y^T x over the rows (pixels) ascending."""
    acc = y.new_zeros(y.shape[1], x.shape[1])
    for r in range(y.shape[0]):
        acc = acc + torch.outer(y[r], x[r])
    return acc


def _store(out, counts, idx, rows, c0, tile, nrows, cw, add=False):
    """The block's threads store tile's rows below nrows and channels below cw at
    out[idx][rows.., c0..] (with add, adding to what is there)."""
    if nrows <= 0 or cw <= 0:
        return
    region = (idx, slice(rows, rows + nrows), slice(c0, c0 + cw))
    out[region] = (out[region] if add else 0) + tile[:nrows, :cw]
    counts[region] += 1


def forward(q, Lk, Lv, S: int):
    """``pixel_attn_kernel``'s result in float64 and its store counts:
    ``(G [N*S, HW, C], counts [N*S, HW, C])``."""
    q, Lk, Lv = (x.double() for x in (q, Lk, Lv))
    N, HW, C = q.shape
    T = Lk.shape[1]
    tb, tile, R = int(t_bucket(T)), tiles()["kPixelAttnTile"], int(ranks(C, False))
    w, per = int(width(C, False)), int(block_tiles(N, HW, C, False))
    div = math.sqrt(C)
    out = q.new_zeros(N * S, HW, C)
    counts = torch.zeros(N * S, HW, C, dtype=torch.int64)
    for n in range(N):
        for g in range(int(groups(N, HW, C, False))):  # a cluster of R blocks
            for ti in range(g * per, min(int(n_tiles(HW)), (g + 1) * per)):
                p0 = ti * tile
                nrows = min(tile, HW - p0)
                for j in range(S):
                    pair = n * S + j
                    full = None
                    for rank in range(R):
                        block = None
                        for u in range(int(subslices(w))):
                            c0, h, cw = _sub(C, rank, w, u)
                            qs = _stage(q[n], p0, nrows, c0, cw, tile, h)
                            ks = _stage(Lk[pair], 0, T, c0, cw, tb, h)
                            part = _partials(qs, ks, h, WARPS)
                            block = part if block is None else block + part
                        full = block if full is None else full + block
                    prob = _softmax(full / div, T)
                    for rank in range(R):
                        for u in range(int(subslices(w))):
                            c0, h, cw = _sub(C, rank, w, u)
                            g_tile = _by_tokens(prob, _stage(Lv[pair], 0, T, c0, cw, tb, h))
                            _store(out, counts, pair, p0, c0, g_tile, nrows, cw)
    return out, counts


def backward(dG, q, Lk, Lv, S: int):
    """``pixel_attn_bwd_probs_dq_kernel`` and ``pixel_attn_bwd_dkv_kernel``'s
    gradients in float64 and their store counts: ``((dq, dLk, dLv),
    {"dq": ..., "dq_adds": ..., "partials": ..., "dLk": ..., "dLv": ...})``;
    dq is stored for the first pair of its image and added to for each later
    one (``dq_adds``)."""
    dG, q, Lk, Lv = (x.double() for x in (dG, q, Lk, Lv))
    N, HW, C = q.shape
    T = Lk.shape[1]
    tb, tile, R = int(t_bucket(T)), tiles()["kPixelAttnTile"], int(ranks(C, True))
    w, per = int(width(C, True)), int(block_tiles(N, HW, C, True))
    G = int(groups(N, HW, C, True))
    div = math.sqrt(C)
    nsub = int(subslices(w))
    dq = q.new_zeros(N, HW, C)
    parts = q.new_zeros(2, N * S, G, T, C)
    counts = {"dq": torch.zeros(N, HW, C, dtype=torch.int64),
              "dq_adds": torch.zeros(N, HW, C, dtype=torch.int64),
              "partials": torch.zeros(2, N * S, G, T, C, dtype=torch.int64)}
    for n in range(N):
        for g in range(G):  # a cluster of R blocks
            for j in range(S):
                pair = n * S + j
                kv = {}  # (rank, u) -> (dLk, dLv) sums over the group's tiles, [tb, h]
                for k in range(per):
                    ti = g * per + k
                    if ti >= int(n_tiles(HW)):
                        break
                    last = k == per - 1 or ti + 1 == int(n_tiles(HW))
                    p0 = ti * tile
                    nrows = min(tile, HW - p0)
                    s_full = d_full = None
                    staged = {}
                    for rank in range(R):
                        s_blk = d_blk = None
                        for u in range(nsub):
                            c0, h, cw = _sub(C, rank, w, u)
                            st = (_stage(q[n], p0, nrows, c0, cw, tile, h),
                                  _stage(dG[pair], p0, nrows, c0, cw, tile, h),
                                  _stage(Lk[pair], 0, T, c0, cw, tb, h),
                                  _stage(Lv[pair], 0, T, c0, cw, tb, h))
                            staged[rank, u] = st
                            s, d = _partials(st[0], st[2], h, 4), _partials(st[1], st[3], h, 4)
                            s_blk = s if s_blk is None else s_blk + s
                            d_blk = d if d_blk is None else d_blk + d
                        s_full = s_blk if s_full is None else s_full + s_blk
                        d_full = d_blk if d_full is None else d_full + d_blk
                    a = _softmax(s_full / div, T)
                    da = torch.where(torch.arange(tb) < T, d_full, 0.0)
                    dl = a * (da - (a * da).sum(1, keepdim=True))
                    for rank in range(R):
                        for u in range(nsub):
                            c0, h, cw = _sub(C, rank, w, u)
                            qs, gs, ks, _ = staged[rank, u]
                            _store(dq, counts["dq_adds" if j else "dq"], n, p0, c0,
                                   _by_tokens(dl, ks) / div, nrows, cw, add=j > 0)
                            dk, dv = kv.get((rank, u), (0, 0))
                            kv[rank, u] = (dk + _by_rows(dl, qs), dv + _by_rows(a, gs))
                            if last:
                                for which in (0, 1):
                                    _store(parts[which, pair], counts["partials"][which, pair],
                                           g, 0, c0, kv[rank, u][which], T, cw)
                                del kv[rank, u]
    # the second kernel: the groups' partials in ascending order
    sums = [parts.new_zeros(N * S, T, C) for _ in range(2)]
    for g in range(G):
        sums = [s + parts[which, :, g] for which, s in enumerate(sums)]
    grads = (dq, sums[0] / div, sums[1])
    # its threads' elements: 4 floats a thread (C % 4 == 0) or 1, the grid striding past
    vec = 4 if C % 4 == 0 else 1
    threads = block_counts(N, S, HW, C, T)["pixel_attn_bwd_dkv"]
    first = np.arange(threads["blocks"] * threads["threads"]) * vec
    total = N * S * T * C
    stored = np.zeros(total, dtype=np.int64)
    for start in range(0, total, len(first) * vec):
        e = first + start
        e = e[e < total]
        for k in range(vec):
            np.add.at(stored, e + k, 1)
    counts["dLk"] = counts["dLv"] = torch.from_numpy(stored.reshape(N * S, T, C))
    return grads, counts
