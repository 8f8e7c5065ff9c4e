"""How K13's kernels (``tris_tpu_torch/kernels/csrc/batch_norm.cu`` and
``batch_norm_bwd.cu``) cut a channel's elements among their warps, and the
shapes the main paths give them, emulated on the host: the CPU tests hold
the partition, and the statistics' combine against numpy's float64 and the
route reference, with it (``tests/test_torch_batch_norm.py``), and
``chip_smoke.py`` takes its launch counts from the call counts here.
Nothing on K13's path calls it.

The constants are read from ``csrc/launchers.h``, the kernels' own source of
them; :func:`slices` is that file's ``batch_norm_slices``.

The statistics and the backward's sums take a warp per (channel c, sample
n, slice s of ``kBatchNormSlice`` elements of the plane), lane l taking the
elements from ``s * slice + 4 l`` in steps of 128, four at a time (one at a
time from ``s * slice + l`` in steps of 32 where HW % 4 != 0). The
statistics sum ``x - k`` and ``(x - k)^2`` in double (``k = x[0, c, 0]``); a
sample's slices are added in order and rounded to float32, the samples
added in float32 in batch order (:func:`channel_stats`).
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


def channel_stats(planes: np.ndarray, eps: float = 1e-5):
    """One channel's statistics as the kernels form them from its planes
    ``[N, HW]`` (float32): each sample's slices' shifted sums in float64,
    added in order, give its mean and sum of squared deviations, each
    rounded to float32; then in float32, in batch order, mean = (sum m_n) /
    N and var = (sum q_n + HW * sum (m_n - mean)^2) / M; rstd in float64,
    rounded once. Returns (mean, var, rstd) as float32."""
    p = np.asarray(planes, np.float32)
    N, HW = p.shape
    size = constants()["kBatchNormSlice"]
    k = np.float64(p[0, 0])
    d = p.astype(np.float64) - k
    f32 = np.float32
    m, q = [], []
    for n in range(N):
        s1 = s2 = 0.0
        for s in range(slices(HW)):
            s1 += d[n, s * size:(s + 1) * size].sum()
            s2 += (d[n, s * size:(s + 1) * size] ** 2).sum()
        dn = s1 / HW
        m.append(f32(k + dn))
        q.append(f32(max(s2 - s1 * dn, 0.0)))
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
