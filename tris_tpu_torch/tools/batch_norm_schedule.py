"""How K13's kernels (``tris_tpu_torch/kernels/csrc/batch_norm.cu`` and
``batch_norm_bwd.cu``) choose their design, cut a channel's elements among
their blocks and warps, and the shapes the main paths give them, emulated
on the host: the CPU tests hold the plan, the partitions, and the
statistics' combine against numpy's float64 and the route reference, with
it (``tests/test_torch_batch_norm.py``), and ``chip_smoke.py`` takes its
launch counts from the plans here. Nothing on K13's path calls it.

The constants are read from ``csrc/launchers.h``, the kernels' own source of
them; :func:`slices` is that file's ``batch_norm_slices``, :func:`plan` its
``batch_norm_plan``.

The two-pass design: the statistics and the backward's sums take a warp per
(channel c, sample n, slice s of ``kBatchNormSlice`` elements of the plane),
lane l taking the elements from ``s * slice + 4 l`` in steps of 128, four at
a time (one at a time from ``s * slice + l`` in steps of 32 where HW % 4 !=
0). The statistics sum ``x - k`` and ``(x - k)^2`` in double (``k = x[0, c,
0]``); a sample's slices are added in order and rounded to float32, the
samples added in float32 in batch order (:func:`channel_stats`).

The fused design: a cluster of R blocks a channel, rank r staging samples
``[r N / R, (r + 1) N / R)``; in a block, ``threads / group`` groups of
``group`` lanes, group j taking the rank's samples j, j + groups, ...; lane l
of a group the plane's items (float4 where HW % 4 == 0, else floats) l, l +
group, ... (:func:`fused_visits`). A lane sums its items in order, a float4
as ``(d0 + d1) + (d2 + d3)`` and its squares alike, then the group's xor
tree, and a group of several warps adds its warps' totals in warp order;
the batch combine is the two-pass design's (:func:`fused_channel_stats`).
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"

# calls per forward: the CLIP RN50 trunk (3 stem norms, 3 per bottleneck, 1 per
# downsample); stage 2's ConvBNRelu blocks in a train forward (4 reduced_c, 4 output, 4 side
# heads) and in response_maps / an eval forward (out1's head only)
RN50_LAYERS = (3, 4, 6, 3)
DECODER_TRAIN_CALLS = 12
DECODER_EVAL_CALLS = 9


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kBatchNorm* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kBatchNorm\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def slices(HW: int) -> int:
    """Slices of a plane the statistics take, one warp each."""
    return _ceil(HW, constants()["kBatchNormSlice"])


def slice_elements(HW: int, s: int, lane: int) -> np.ndarray:
    """The elements of a plane lane ``lane`` of slice ``s``'s warp visits, in its order."""
    size = constants()["kBatchNormSlice"]
    e0, e1 = s * size, min((s + 1) * size, HW)
    if HW % 4:
        return np.arange(e0 + lane, e1, 32)
    starts = np.arange(e0 + 4 * lane, e1, 128)
    return (starts[:, None] + np.arange(4)).ravel()


def visits(N: int, C: int, HW: int) -> np.ndarray:
    """How many times the warps visit each element of x [N, C, HW] (small shapes)."""
    count = np.zeros(N * C * HW, np.int64)
    for c in range(C):
        for n in range(N):
            for s in range(slices(HW)):
                for lane in range(32):
                    np.add.at(count, (n * C + c) * HW + slice_elements(HW, s, lane), 1)
    return count


def _combine(m, q, HW: int, eps: float):
    """The batch combine of a channel's sample moments (float32, batch order):
    (mean, var, rstd) as float32."""
    f32 = np.float32
    N = len(m)
    s, qs = m[0], q[0]
    for n in range(1, N):
        s, qs = f32(s + m[n]), f32(qs + q[n])
    mean = f32(s / f32(N))
    between = f32(0)
    for n in range(N):
        t = f32(m[n] - mean)
        between = f32(t * t) if n == 0 else f32(between + f32(t * t))
    var = f32(f32(qs + f32(f32(HW) * between)) / f32(N * HW))
    return mean, var, f32(1.0 / np.sqrt(np.float64(var) + eps))


def _moments(s1: float, s2: float, k: float, HW: int):
    """A sample's mean and squared deviations from its double sums, each
    rounded once to float32."""
    d = s1 / HW
    return np.float32(k + d), np.float32(max(s2 - s1 * d, 0.0))


def channel_stats(planes: np.ndarray, eps: float = 1e-5):
    """One channel's statistics as the two-pass kernels form them from its
    planes ``[N, HW]`` (float32): each sample's slices' shifted sums in
    float64, added in order, give its mean and sum of squared deviations,
    each rounded to float32; then in float32, in batch order, mean = (sum
    m_n) / N and var = (sum q_n + HW * sum (m_n - mean)^2) / M; rstd in
    float64, rounded once. Returns (mean, var, rstd) as float32."""
    p = np.asarray(planes, np.float32)
    N, HW = p.shape
    size = constants()["kBatchNormSlice"]
    k = np.float64(p[0, 0])
    d = p.astype(np.float64) - k
    m, q = [], []
    for n in range(N):
        s1 = s2 = 0.0
        for s in range(slices(HW)):
            s1 += d[n, s * size:(s + 1) * size].sum()
            s2 += (d[n, s * size:(s + 1) * size] ** 2).sum()
        mn, qn = _moments(s1, s2, k, HW)
        m.append(mn)
        q.append(qn)
    return _combine(m, q, HW, eps)


# ---- the fused design's plan and partition -------------------------------------------------

def items(HW: int) -> int:
    """Items of a plane: float4 where HW % 4 == 0, else floats."""
    return HW // 4 if HW % 4 == 0 else HW


def pitch(HW: int) -> int:
    """Floats of a staged plane (16-byte rows)."""
    return _ceil(HW, 4) * 4


def fused_smem(N: int, HW: int, backward: bool, samples: int, threads: int) -> int:
    """Bytes of shared memory a fused block takes (``batch_norm_fused_smem``)."""
    return ((2 if backward else 1) * samples * pitch(HW) * 4 + (24 if backward else 8) * N
            + 24 * (threads // 32) + 8 * samples + 16)


def group(threads: int, samples: int, n_items: int) -> int:
    """Lanes that sum a sample (``batch_norm_group``)."""
    g = 1
    while 2 * g * samples <= threads and g < n_items:
        g *= 2
    return g


def plan(N: int, C: int, HW: int, training: bool = True, backward: bool = False,
         act: str = "relu", max_ranks: int | None = None) -> dict:
    """``batch_norm_plan``: the design a call takes, its blocks and launches,
    with the keys of the extension's ``batch_norm_plan`` op. ``max_ranks``
    defaults to the rule's largest cluster where the card fits it
    (``kBatchNormWideRanks`` backward, ``kBatchNormMaxRanks`` forward);
    ``design`` is 0 two-pass, 1 fused, 2 the eval fold's apply."""
    k = constants()
    if max_ranks is None:
        max_ranks = k["kBatchNormWideRanks"] if backward else k["kBatchNormMaxRanks"]
    out = {"design": 0, "ranks": 0, "samples": 0, "threads": 0, "group": 0, "smem_bytes": 0,
           "blocks": 0, "launches": 3, "max_ranks": max_ranks}
    if not training and not backward:
        return {**out, "design": 2, "launches": 1}
    if N > k["kBatchNormMaxBatch"] or N * HW >= 2 ** 24:
        return out
    portable = range(1, min(N, k["kBatchNormMaxRanks"]) + 1)
    wide = k["kBatchNormWideRanks"]
    passes = ((k["kBatchNormFusedThreads"], k["kBatchNormSmemSmall"], portable),
              (k["kBatchNormFusedThreads"], k["kBatchNormSmemTarget"], portable),
              (k["kBatchNormFusedThreadsWide"], k["kBatchNormSmemMax"], portable),
              (k["kBatchNormFusedThreadsWide"], k["kBatchNormSmemMax"],
               [wide] if backward and max_ranks >= wide and N >= wide else []))
    for threads, most, ranks in passes:
        for r in ranks:
            samples = _ceil(N, r)
            smem = fused_smem(N, HW, backward, samples, threads)
            if smem <= most:
                return {"design": 1, "ranks": r, "samples": samples, "threads": threads,
                        "group": group(threads, samples, items(HW)), "smem_bytes": smem,
                        "blocks": C * r, "launches": 2 if backward and act == "prelu" else 1,
                        "max_ranks": max_ranks}
    return out


def _layout(N: int, HW: int, backward: bool, ranks: int | None):
    """(ranks, samples, threads, group) of the fused blocks: the plan's, or
    at ``ranks`` with the plan's thread rule (within the target, else
    wide)."""
    if ranks is None:
        p = plan(N, 1, HW, backward=backward)
        assert p["design"] == 1, (N, HW, backward)
        return p["ranks"], p["samples"], p["threads"], p["group"]
    k = constants()
    samples = _ceil(N, ranks)
    threads = k["kBatchNormFusedThreads"]
    if fused_smem(N, HW, backward, samples, threads) > k["kBatchNormSmemTarget"]:
        threads = k["kBatchNormFusedThreadsWide"]
    return ranks, samples, threads, group(threads, samples, items(HW))


def rank_samples(rank: int, R: int, N: int) -> range:
    """The samples rank ``rank`` of ``R`` stages."""
    return range(rank * N // R, (rank + 1) * N // R)


def _lane_elements(HW: int, gl: int, g: int) -> np.ndarray:
    """The elements of a plane lane ``gl`` of a group of ``g`` visits, in order."""
    starts = np.arange(gl, items(HW), g)
    if HW % 4:
        return starts
    return (4 * starts[:, None] + np.arange(4)).ravel()


def fused_visits(N: int, C: int, HW: int, backward: bool = False,
                 ranks: int | None = None) -> dict:
    """How many times the fused kernel's blocks stage ("staged": each input
    plane set, g and x alike), sum ("summed") and write ("written") each
    element of x [N, C, HW] (small shapes), at the plan's ranks or
    ``ranks``."""
    R, samples, threads, g = _layout(N, HW, backward, ranks)
    groups = threads // g
    staged, summed, written = (np.zeros(N * C * HW, np.int64) for _ in range(3))
    for c in range(C):
        for rank in range(R):
            mine = rank_samples(rank, R, N)
            assert len(mine) <= samples
            for i, n in enumerate(mine):
                base = (n * C + c) * HW
                staged[base:base + HW] += 1
                assert (i % groups) * g + g <= threads
                for gl in range(g):
                    e = base + _lane_elements(HW, gl, g)
                    np.add.at(summed, e, 1)
                    np.add.at(written, e, 1)
    return {"staged": staged, "summed": summed, "written": written}


def _tree(v: np.ndarray) -> float:
    """An xor tree over len(v) (a power of two, at most 32) lanes: lane 0's total."""
    v = np.array(v, np.float64)
    o = len(v) // 2
    while o:
        v = v + v[np.arange(len(v)) ^ o]
        o //= 2
    return float(v[0])


def _group_total(lanes: np.ndarray) -> float:
    """A group's lanes' sums as the kernel adds them: the xor tree within each
    warp, then the warps' totals in warp order."""
    if len(lanes) <= 32:
        return _tree(lanes)
    total = _tree(lanes[:32])
    for w in range(1, len(lanes) // 32):
        total = total + _tree(lanes[32 * w:32 * (w + 1)])
    return total


def fused_channel_stats(planes: np.ndarray, eps: float = 1e-5, ranks: int | None = None):
    """One channel's statistics as the fused forward forms them from its
    planes ``[N, HW]`` (float32), at the plan's group or that of ``ranks``:
    per sample, each lane's items in order (a float4 as ``(d0 + d1) + (d2 +
    d3)``, its squares alike, d = x - k in float64), the group's total
    (:func:`_group_total`), the moments rounded to float32; then across the
    ranks' samples in batch order, the two-pass design's combine. Returns
    (mean, var, rstd) as float32."""
    p = np.asarray(planes, np.float32)
    N, HW = p.shape
    _, _, _, g = _layout(N, HW, False, ranks)
    k = np.float64(p[0, 0])
    d = p.astype(np.float64) - k
    if HW % 4 == 0:
        q = d.reshape(N, HW // 4, 4)
        t1 = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
        sq = q * q
        t2 = (sq[..., 0] + sq[..., 1]) + (sq[..., 2] + sq[..., 3])
    else:
        t1, t2 = d, d * d
    n_items = t1.shape[1]
    rows = _ceil(n_items, g)
    m, qs = [], []
    for n in range(N):
        sums = []
        for t in (t1[n], t2[n]):
            lanes = np.zeros(g)
            padded = np.zeros(rows * g)
            padded[:n_items] = t
            for row in padded.reshape(rows, g):
                lanes = lanes + row
            sums.append(_group_total(lanes))
        mn, qn = _moments(sums[0], sums[1], k, HW)
        m.append(mn)
        qs.append(qn)
    return _combine(m, qs, HW, eps)


def launches_per_forward(shapes, mode: str = "train", max_ranks: int | None = None) -> int:
    """K13's launches over one forward of ``shapes`` (N, C, H, W): ``mode``
    "train" or "teacher" (batch statistics) or "eval" (the fold)."""
    training = mode != "eval"
    return sum(plan(N, C, H * W, training, False, max_ranks=max_ranks)["launches"]
               for N, C, H, W in shapes)


def launches_per_backward(shapes, act: str = "relu", max_ranks: int | None = None) -> int:
    """K13's launches over one backward of ``shapes`` (train mode) with ``act``
    ("prelu": the fused design's second launch)."""
    return sum(plan(N, C, H * W, True, True, act, max_ranks)["launches"]
               for N, C, H, W in shapes)


def trunk_shapes(batch: int = 48, size: int = 320, width: int = 64, layers=RN50_LAYERS):
    """Each BatchNorm call of one CLIP ModifiedResNet forward, in order: (N, C, H, W)."""
    out = []
    h = size // 2
    out += [(batch, width // 2, h, h), (batch, width // 2, h, h), (batch, width, h, h)]
    h //= 2                                                   # the stem's avgpool
    inplanes = width
    for stage, blocks in enumerate(layers):
        planes = width * 2 ** stage
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            out += [(batch, planes, h, h), (batch, planes, h, h)]   # bn1, bn2 (before the pool)
            h //= stride
            out.append((batch, planes * 4, h, h))                   # bn3
            if stride > 1 or inplanes != planes * 4:
                out.append((batch, planes * 4, h, h))               # the downsample's
            inplanes = planes * 4
    return out


def decoder_shapes(batch: int = 48, size: int = 320, side: bool = True):
    """Each BatchNorm call of stage 2's decoder (one sentence an image), in order."""
    h = [size // 4, size // 8, size // 16, size // 32]        # c1..c4: 80, 40, 20, 10
    out = [(batch, 64, h[0], h[0]), (batch, 128, h[1], h[1]), (batch, 256, h[2], h[2]),
           (batch, 512, h[3], h[3]),                          # reduced_c1..c4
           (batch, 256, h[3], h[3]), (batch, 128, h[2], h[2]), (batch, 64, h[1], h[1]),
           (batch, 32, h[0], h[0]),                           # output4..output1
           (batch, 32, h[0], h[0])]                           # final_seg1
    if side:                                                  # final_seg2..4
        out += [(batch, 32, h[0], h[0]), (batch, 64, h[1], h[1]), (batch, 64, h[2], h[2])]
    return out
