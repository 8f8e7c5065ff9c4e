"""What K1's kernels (``tris_tpu_torch/kernels/csrc/mha_short.cu``,
``mha_short_bwd.cu`` and their tiles in ``mha_short_tiles.cuh``) compute,
block by block, emulated on the host in float64: the CPU tests hold the tile
map to the plain version with it (``tests/test_torch_mha.py``), and the card
tests hold the kernels' launches to its block counts. Nothing on K1's path
calls it.

The tile constants are read from ``csrc/launchers.h``, the kernels' own
source of them; the bucket ladders below are ``mha_short_len_bucket`` (the
forward's has a 56-row bucket, the backward's not) and
``mha_short_hd_bucket`` there. Each emulation walks the grid in order, a
block per (sequence, head), and per block does what the block does: it
stages the head's operands padded to the buckets (zeros past the rows and
channels), sums the logits over chunks of 4 channels ascending, makes them
probabilities (the mask on the real rows, -inf past Lk), forms P V over the
keys in steps of 4 ascending, P^T X over the rows ascending, and writes the
elements its threads own: thread (ty, tx) owns rows ``ty + groups * i`` (or,
in dK and dV, keys ``rows * ty + i``) and channels ``4 tx + 4 lanes g ..+3``.
Each returns, beside its results, how many times each output element was
written.

- :func:`forward`, ``mha_short_kernel``.
- :func:`backward`, ``mha_short_bwd_kernel``: P again from q and k, dV =
  P^T dO, dP = dO V^T, dS = P (dP - D), dK = dS^T (q s), dQ = s dS K.
"""

from __future__ import annotations

import functools
import math
import pathlib
import re

import numpy as np
import torch

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"
LEN_BUCKETS = {False: (16, 32, 56, 64, 128), True: (16, 32, 64, 128)}  # by backward
HD_BUCKETS = (32, 64, 128)


@functools.lru_cache(maxsize=1)
def tiles() -> dict:
    """The ``constexpr int kMhaShort* = n;`` (and ``long long``, a product
    of integers) constants of ``launchers.h``."""
    found = re.findall(r"constexpr (?:int|long long) (kMhaShort\w+) = ([\d *]+);",
                       LAUNCHERS.read_text())
    return {k: math.prod(int(x) for x in v.split("*")) for k, v in found}


def _bucket(x, ladder):
    x = np.asarray(x)
    out = np.full(x.shape, ladder[-1])
    for b in reversed(ladder[:-1]):
        out = np.where(x <= b, b, out)
    return out


def len_bucket(L, backward: bool):
    return _bucket(L, LEN_BUCKETS[backward])


def hd_bucket(hd):
    return _bucket(hd, HD_BUCKETS)


def rows(lp):
    """``mha_short_rows``: rows (or keys) of a thread's tiles."""
    t = tiles()
    return t["kMhaShortRowsLong"] if lp >= t["kMhaShortLong"] else t["kMhaShortRows"]


def threads(lp):
    return lp // rows(lp) * tiles()["kMhaShortLanes"]


def _floats(lp, hdb):
    """Floats of one staged operand and of the P / dS tile
    (``mha_short_operand``, ``mha_short_probs``)."""
    t = tiles()
    return (lp * (hdb + t["kMhaShortPad"]),
            lp * ((lp + 31) // 32 * 32 + t["kMhaShortProbPad"]))


def bwd_buffers(lp, hdb):
    """``mha_short_bwd_buffers``: operands the backward holds at once."""
    op, pr = _floats(lp, hdb)
    return np.where(4 * (3 * op + pr) <= tiles()["kMhaShortMaxSmem"], 3, 2)


def smem(lp, hdb, backward: bool):
    """``mha_short_smem``: bytes of dynamic shared memory a block takes."""
    op, pr = _floats(lp, hdb)
    if not backward:
        return 4 * (np.maximum(2 * op, pr) + op)
    return 4 * (bwd_buffers(lp, hdb) * op + pr)


def takes(Lq, Lk, hd, backward: bool):
    """``mha_short_takes``, elementwise over arrays of shapes."""
    t = tiles()
    Lq, Lk, hd = (np.asarray(x) for x in (Lq, Lk, hd))
    lp, hdb = len_bucket(np.maximum(Lq, Lk), backward), hd_bucket(hd)
    return ((Lq >= 1) & (Lk >= 1) & (hd >= 1) & (Lq <= t["kMhaShortMaxLen"])
            & (Lk <= t["kMhaShortMaxLen"]) & (hd <= t["kMhaShortMaxHeadDim"])
            & (smem(lp, hdb, backward) <= t["kMhaShortMaxSmem"]))


def block_counts(N: int, n_head: int, Lq: int, Lk: int, hd: int) -> dict:
    """Each launch's grid: ``{"mha_short": {...}, "mha_short_bwd": {...}}``,
    each with ``blocks``, ``threads``, ``smem_bytes``, ``lp`` and ``hd_bucket``."""
    hdb = int(hd_bucket(hd))
    out = {}
    for name, backward in (("mha_short", False), ("mha_short_bwd", True)):
        lp = int(len_bucket(max(Lq, Lk), backward))
        out[name] = {"blocks": N * n_head, "threads": threads(lp),
                     "smem_bytes": int(smem(lp, hdb, backward)), "lp": lp, "hd_bucket": hdb}
    return out


@functools.lru_cache(maxsize=None)
def _owned(lp: int, hdb: int, by_keys: bool):
    """Every thread's (row, channel) pairs of an output tile: rows ty + groups i
    (by_keys: keys rows * ty + i), channels 4 tx + 4 lanes g + e."""
    R, X = rows(lp), tiles()["kMhaShortLanes"]
    n = threads(lp)
    ty, tx = np.arange(n) // X, np.arange(n) % X
    i = np.arange(R)
    owned = (R * ty[:, None] + i) if by_keys else (ty[:, None] + (lp // R) * i)
    chans = (4 * tx[:, None, None] + 4 * X * np.arange(hdb // (4 * X))[:, None]
             + np.arange(4)).reshape(n, -1)
    r = np.broadcast_to(owned[:, :, None], (n, R, chans.shape[1])).reshape(-1)
    c = np.broadcast_to(chans[:, None, :], (n, R, chans.shape[1])).reshape(-1)
    return torch.from_numpy(r.copy()), torch.from_numpy(c.copy())


def _write(out, counts, n, col, tile, nrows, hd, by_keys):
    """The block's threads write their elements of `tile` (below nrows, hd)."""
    r, c = _owned(tile.shape[0], tile.shape[1], by_keys)
    keep = (r < nrows) & (c < hd)
    r, c = r[keep], c[keep]
    out[n, r, col + c] = tile[r, c]
    counts[n].index_put_((r, col + c), torch.ones(len(r), dtype=torch.int64), accumulate=True)


def _stage(x, n, col, nrows, hd, lp, hdb):
    tile = x.new_zeros(lp, hdb)
    tile[:nrows, :hd] = x[n, :nrows, col:col + hd]
    return tile


def _logits(a, b):
    """a b^T over the channels in chunks of 4, ascending."""
    acc = a.new_zeros(a.shape[0], b.shape[0])
    for d in range(0, a.shape[1], 4):
        acc = acc + a[:, d:d + 4] @ b[:, d:d + 4].T
    return acc


def _probs(s, mask, Lq, Lk):
    s = s.clone()
    if mask is not None:
        s[:Lq, :Lk] += mask
    s[:, Lk:] = -torch.inf
    e = torch.exp(s - s.max(1, keepdim=True).values)
    return e / e.sum(1, keepdim=True)


def _rows_by_keys(p, x, nk):
    """p x over keys [0, nk) in steps of 4, ascending."""
    acc = p.new_zeros(p.shape[0], x.shape[1])
    for k0 in range(0, nk, 4):
        acc = acc + p[:, k0:k0 + 4] @ x[k0:k0 + 4]
    return acc


def _keys_by_rows(p, x, nr):
    """p^T x over rows [0, nr), ascending."""
    acc = p.new_zeros(p.shape[1], x.shape[1])
    for r in range(nr):
        acc = acc + torch.outer(p[r], x[r])
    return acc


def _blocks(q, k, n_head, backward):
    """The grid in launch order: (n, column of head h, Lq, Lk, hd, lp, hd bucket)."""
    N, Lq, C = q.shape
    Lk, hd = k.shape[1], C // n_head
    lp, hdb = int(len_bucket(max(Lq, Lk), backward)), int(hd_bucket(hd))
    for b in range(N * n_head):
        yield b // n_head, (b % n_head) * hd, Lq, Lk, hd, lp, hdb


def forward(q, k, v, n_head: int, mask=None):
    """``mha_short_kernel``'s result in float64 and its write counts:
    ``(out [N, Lq, C], counts [N, Lq, C])``."""
    q, k, v = (x.double() for x in (q, k, v))
    mask = None if mask is None else mask.double()
    N, Lq, C = q.shape
    scale = (C // n_head) ** -0.5
    out = q.new_zeros(N, Lq, C)
    counts = torch.zeros(N, Lq, C, dtype=torch.int64)
    for n, col, Lq, Lk, hd, lp, hdb in _blocks(q, k, n_head, False):
        qs = _stage(q, n, col, Lq, hd, lp, hdb) * scale
        ks, vs = (_stage(x, n, col, Lk, hd, lp, hdb) for x in (k, v))
        p = _probs(_logits(qs, ks), mask, Lq, Lk)
        _write(out, counts, n, col, _rows_by_keys(p, vs, -(-Lk // 4) * 4), Lq, hd, False)
    return out, counts


def backward(dout, q, k, v, n_head: int, mask=None):
    """``mha_short_bwd_kernel``'s gradients in float64 and their write
    counts: ``((dq, dk, dv), {"dq": ..., "dk": ..., "dv": ...})``."""
    dout, q, k, v = (x.double() for x in (dout, q, k, v))
    mask = None if mask is None else mask.double()
    N, Lq, C = q.shape
    Lk = k.shape[1]
    scale = (C // n_head) ** -0.5
    grads = {"dq": q.new_zeros(N, Lq, C), "dk": q.new_zeros(N, Lk, C), "dv": q.new_zeros(N, Lk, C)}
    counts = {name: torch.zeros(g.shape, dtype=torch.int64) for name, g in grads.items()}
    for n, col, Lq, Lk, hd, lp, hdb in _blocks(q, k, n_head, True):
        qs = _stage(q, n, col, Lq, hd, lp, hdb) * scale
        gs = _stage(dout, n, col, Lq, hd, lp, hdb)
        ks, vs = (_stage(x, n, col, Lk, hd, lp, hdb) for x in (k, v))
        p = _probs(_logits(qs, ks), mask, Lq, Lk)
        _write(grads["dv"], counts["dv"], n, col, _keys_by_rows(p, gs, Lq), Lk, hd, True)
        dp = _logits(gs, vs)
        ds = p * (dp - (p * dp).sum(1, keepdim=True))
        _write(grads["dk"], counts["dk"], n, col, _keys_by_rows(ds, qs, Lq), Lk, hd, True)
        dq = _rows_by_keys(ds, ks, -(-Lk // 4) * 4) * scale
        _write(grads["dq"], counts["dq"], n, col, dq, Lq, hd, False)
    return (grads["dq"], grads["dk"], grads["dv"]), counts
