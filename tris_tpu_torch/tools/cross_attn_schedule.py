"""What K2's kernels (``tris_tpu_torch/kernels/csrc/cross_attn.cu``,
``cross_attn_bwd.cu`` and their tiles in ``cross_attn_tiles.cuh``) compute,
block by block, emulated on the host in float64: the CPU tests hold the tile
map to the plain version with it (``tests/test_torch_cross_attn.py``), and
the card tests hold the kernels' launches to its block counts. Nothing on
K2's path calls it.

The tile sizes are read from ``csrc/launchers.h``, the kernels' own source
of them. Each emulation walks the kernel's grid in order and, per block,
does what the block does: which rows, keys and channels it reads, the order
of its sums (chunks of channels ascending, then the cluster's ranks
ascending, then keys ascending, key block after key block), and which
output elements it writes. Each returns, beside its results, how many times
each output element was written.

- :func:`forward`, ``cross_attn_kernel``: one launch; the text tiles
  (a group per image, its S x T text rows against HW keys), then the
  vision tiles (a group per pair, its image's HW rows against T keys); a
  cluster of :func:`slices` blocks per tile, one channel slice each; with
  more keys than a key block, each row's max and sum of exponentials over
  the blocks first (:func:`_softmax`), then each block's P V added on; at
  T = 1 a vision tile's probabilities are 1.
- :func:`backward`, the forward's probabilities, then
  ``cross_attn_probs_bwd_kernel`` and ``cross_attn_grads_bwd_kernel``: pass
  A per tile of each half (text first), block ``rank`` writing dL for rows
  rank, rank + slices, ... once the rows' sums of P dA are whole;
  pass B per (group of three products with the same rows, image, row
  tile, slice), the products in the launcher's order, each summed over the
  key blocks in order.
"""

from __future__ import annotations

import functools
import pathlib
import re

import torch

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def tiles() -> dict:
    """The ``constexpr int kCrossAttn* = n;`` constants of ``launchers.h``."""
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (kCrossAttn\w+) = (\d+);", LAUNCHERS.read_text())}


def slices(m: int) -> int:
    """Blocks in a tile's cluster: ``cross_attn_slices(m)``."""
    return -(-m // tiles()["kCrossAttnSlice"])


def _row_tiles(rows: int) -> int:
    return -(-rows // tiles()["kCrossAttnRows"])


def forward_halves(N: int, S: int, HW: int, T: int):
    """The forward's halves in grid order: (name, groups, rows, keys)."""
    return (("text", N, S * T, HW), ("vis", N * S, HW, T))


def backward_products(HW: int, T: int):
    """Pass B's products in grid order: (name, rows, keys)."""
    return (("dqt", T, HW), ("dkt", T, HW), ("dvt", T, HW),
            ("dqv", HW, T), ("dkv", HW, T), ("dvv", HW, T))


def block_counts(N: int, S: int, HW: int, T: int, m: int) -> dict:
    """Blocks of each launch: the forward, and the backward's passes A and B."""
    s = slices(m)
    fwd = sum(g * _row_tiles(rows) for _, g, rows, _ in forward_halves(N, S, HW, T))
    pass_a = N * (_row_tiles(T) + _row_tiles(HW))
    pass_b = N * (_row_tiles(T) + _row_tiles(HW))  # a block per group of three products
    return {"cross_attn": s * fwd, "cross_attn_bwd_a": s * pass_a, "cross_attn_bwd_b": s * pass_b,
            "cluster": s, "rows_per_tile": tiles()["kCrossAttnRows"]}


def _slice(rank: int, m: int):
    sl = tiles()["kCrossAttnSlice"]
    return rank * sl, min(sl, m - rank * sl)


def _partial(a, b, c0, mc):
    """A block's partial a b^T over channels [c0, c0 + mc), chunk by chunk."""
    chunk = tiles()["kCrossAttnChunk"]
    out = a.new_zeros(a.shape[0], b.shape[0])
    for c in range(c0, c0 + mc, chunk):
        e = min(c + chunk, c0 + mc)
        out = out + a[:, c:e] @ b[:, c:e].T
    return out


def _key_blocks(keys: int):
    """The key blocks of a tile: (first key, keys)."""
    kb = tiles()["kCrossAttnKeyBlock"]
    return [(j0, min(kb, keys - j0)) for j0 in range(0, keys, kb)]


def _softmax(blocks):
    """The kernel's softmax of a row tile's logits, given block by block:
    each row's running max and sum of exponentials over the blocks, then
    each block's probabilities."""
    mx = blocks[0].new_full((blocks[0].shape[0], 1), -torch.inf)
    total = blocks[0].new_zeros(blocks[0].shape[0], 1)
    for x in blocks:
        new = torch.maximum(mx, x.max(1, keepdim=True).values)
        total = total * torch.exp(mx - new) + torch.exp(x - new).sum(1, keepdim=True)
        mx = new
    return [torch.exp(x - mx) / total for x in blocks]


def _pv(pm, v, c0, mc, acc=None):
    """PvStream: acc (or zeros) + pm v[:, c0:c0 + mc] over key chunks, ascending."""
    kc = tiles()["kCrossAttnKeyChunk"]
    out = pm.new_zeros(pm.shape[0], mc) if acc is None else acc
    for j in range(0, v.shape[0], kc):
        out = out + pm[:, j:j + kc] @ v[j:j + kc, c0:c0 + mc]
    return out


def _tile_rows(plane, q0, rows):
    """kRows rows of plane from q0, zeros past its end."""
    R = tiles()["kCrossAttnRows"]
    out = plane.new_zeros(R, plane.shape[1])
    n = min(R, rows - q0)
    out[:n] = plane[q0:q0 + n]
    return out, n


def forward(qv, kv, vv, qt, kt, vt, S: int, div: float, keep_p: bool = False):
    """``cross_attn_kernel``'s result in float64 and the write counts:
    ``((new_vis, new_lan), (count_vis, count_lan))``; with ``keep_p`` also
    the probabilities it writes for the backward and their counts,
    ``{"pv": [N*S, HW, T], "pt": [N, S*T, HW]}`` each (rank 0 of a cluster
    writes them)."""
    qv, kv, vv, qt, kt, vt = (x.double() for x in (qv, kv, vv, qt, kt, vt))
    N, HW, m = qv.shape
    T = qt.shape[1]
    R, ns = tiles()["kCrossAttnRows"], slices(m)
    new_lan = qt.new_zeros(N, S * T, m)
    new_vis = qv.new_zeros(N * S, HW, m)
    counts = {"text": torch.zeros(N, S * T, m, dtype=torch.int64),
              "vis": torch.zeros(N * S, HW, m, dtype=torch.int64)}
    probs = {"text": qt.new_zeros(N, S * T, HW), "vis": qv.new_zeros(N * S, HW, T)}
    p_counts = {k: torch.zeros(x.shape, dtype=torch.int64) for k, x in probs.items()}
    planes = {"text": (qt.reshape(N, S * T, m), lambda g: g, kv, vv, new_lan),
              "vis": (qv, lambda g: g // S, kt.reshape(N * S, T, m), vt.reshape(N * S, T, m),
                      new_vis)}
    for name, groups, rows, keys in forward_halves(N, S, HW, T):
        q, q_of, k, v, out = planes[name]
        for g in range(groups):
            for q0 in range(0, rows, R):
                a, nrows = _tile_rows(q[q_of(g)], q0, rows)
                blocks = _key_blocks(keys)
                if keys == 1:
                    pms = [a.new_ones(R, 1)]
                else:
                    logits = []
                    for j0, kn in blocks:
                        x = a.new_zeros(R, kn)
                        for rank in range(ns):   # the cluster's partials, in rank order
                            x = x + _partial(a, k[g][j0:j0 + kn], *_slice(rank, m))
                        logits.append(x / div)
                    pms = _softmax(logits)
                for (j0, kn), pm in zip(blocks, pms):
                    probs[name][g, q0:q0 + nrows, j0:j0 + kn] = pm[:nrows]
                    p_counts[name][g, q0:q0 + nrows, j0:j0 + kn] += 1
                for rank in range(ns):
                    c0, mc = _slice(rank, m)
                    acc = None
                    for (j0, kn), pm in zip(blocks, pms):
                        acc = _pv(pm, v[g][j0:j0 + kn], c0, mc, acc)
                    out[g, q0:q0 + nrows, c0:c0 + mc] = acc[:nrows]
                    counts[name][g, q0:q0 + nrows, c0:c0 + mc] += 1
    result = ((new_vis, new_lan.reshape(N * S, T, m)),
              (counts["vis"], counts["text"].reshape(N * S, T, m)))
    if keep_p:
        return result + ({"pv": probs["vis"], "pt": probs["text"]},
                         {"pv": p_counts["vis"], "pt": p_counts["text"]})
    return result


def backward(g_vis, g_lan, qv, kv, vv, qt, kt, vt, div: float):
    """The backward's two passes in float64 at S = 1: ``(grads, scratch,
    counts)``, grads ``(dqv, dkv, dvv, dqt, dkt, dvt)``, scratch ``{pv, dlv,
    pt, dlt}`` and a write count for each of them by name."""
    g_vis, g_lan, qv, kv, vv, qt, kt, vt = (
        x.double() for x in (g_vis, g_lan, qv, kv, vv, qt, kt, vt))
    N, HW, m = qv.shape
    T = qt.shape[1]
    R, ns = tiles()["kCrossAttnRows"], slices(m)
    _, _, scratch, counts = forward(qv, kv, vv, qt, kt, vt, 1, div, keep_p=True)
    scratch["dlv"], scratch["dlt"] = qv.new_zeros(N, HW, T), qv.new_zeros(N, T, HW)
    counts["dlv"] = torch.zeros(N, HW, T, dtype=torch.int64)
    counts["dlt"] = torch.zeros(N, T, HW, dtype=torch.int64)
    # pass A: the text half first; dA = G V^T key block by key block, the
    # rows' sums of P dA over the blocks in order, then the softmax backward
    # with the forward's P
    for gq, v, p_name, dl_name, rows in ((g_lan, vv, "pt", "dlt", T), (g_vis, vt, "pv", "dlv", HW)):
        for n in range(N):
            for q0 in range(0, rows, R):
                ga, nrows = _tile_rows(gq[n], q0, rows)
                p, _ = _tile_rows(scratch[p_name][n], q0, rows)
                da, dsum = ga.new_zeros(R, v.shape[1]), ga.new_zeros(R, 1)
                for j0, kn in _key_blocks(v.shape[1]):
                    for rank in range(ns):
                        da[:, j0:j0 + kn] += _partial(ga, v[n][j0:j0 + kn], *_slice(rank, m))
                    dsum = dsum + (p[:, j0:j0 + kn] * da[:, j0:j0 + kn]).sum(1, keepdim=True)
                dl = p * (da - dsum) / div
                for rank in range(ns):              # block rank's rows
                    for r in range(rank, nrows, ns):
                        scratch[dl_name][n, q0 + r] = dl[r]
                        counts[dl_name][n, q0 + r] += 1
    # pass B, in the launcher's order: coefficient [rows, keys], operand [keys, m]
    coef = {"dqt": scratch["dlt"], "dkt": scratch["dlv"].transpose(1, 2),
            "dvt": scratch["pv"].transpose(1, 2), "dqv": scratch["dlv"],
            "dkv": scratch["dlt"].transpose(1, 2), "dvv": scratch["pt"].transpose(1, 2)}
    operand = {"dqt": kv, "dkt": qv, "dvt": g_vis, "dqv": kt, "dkv": qt, "dvv": g_lan}
    grads = {}
    for name, rows, keys in backward_products(HW, T):
        out = qv.new_zeros(N, rows, m)
        counts[name] = torch.zeros(N, rows, m, dtype=torch.int64)
        for n in range(N):
            for q0 in range(0, rows, R):
                cm, nrows = _tile_rows(coef[name][n], q0, rows)
                for rank in range(ns):
                    c0, mc = _slice(rank, m)
                    acc = None
                    for j0, kn in _key_blocks(keys):
                        acc = _pv(cm[:, j0:j0 + kn], operand[name][n][j0:j0 + kn], c0, mc, acc)
                    out[n, q0:q0 + nrows, c0:c0 + mc] = acc[:nrows]
                    counts[name][n, q0:q0 + nrows, c0:c0 + mc] += 1
        grads[name] = out
    order = ("dqv", "dkv", "dvv", "dqt", "dkt", "dvt")
    return tuple(grads[k] for k in order), scratch, counts
