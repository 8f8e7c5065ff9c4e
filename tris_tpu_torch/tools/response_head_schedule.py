"""How K3's eval head (``tris_tpu_torch/kernels/csrc/response_head.cu``) cuts
the pairs among its clusters, emulated on the host: the CPU tests hold the
plan against ``launchers.h``'s rule at the paths' shapes, the ranks' shares
of the pixels and of the output rows (each formed or written once), and the
kernel's arithmetic against the plain version and, through the stage-1
model, against JAX (``tests/test_torch_response_head.py``). Nothing on K3's
path calls it.

The constants are read from ``csrc/launchers.h``, the kernel's own source of
them; :func:`plan` is that file's ``response_head_plan``.

The partition: pair i is a cluster of R ranks; rank r forms the scores of
pixels [r hw / R, (r + 1) hw / R) (:func:`pixel_share`), a warp a pixel whose
lane l sums ``fmaf(v[c], lan[c], s)`` over channels c = l, l + 32, ... with
v = RN(RN(vis_new * alpha) + vis_base), the lanes' sums added by a butterfly
of shuffles (16, 8, 4, 2, 1), times the scale; every rank then holds the
whole plane and writes output rows [r H / R, (r + 1) H / R)
(:func:`row_band`), each from its t-row t = wy0 s[y0] + wy1 s[y1] as
relu(wx0 t[x0] + wx1 t[x1]), every product and sum rounded alone
(:func:`emulate`).
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np

from tris_tpu_torch.ops.resize import interp_taps
from tris_tpu_torch.tools.resize_schedule import fmaf

LAUNCHERS = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "launchers.h"


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """The ``constexpr int kResponseHead* = n;`` constants of ``launchers.h``."""
    found = re.findall(r"constexpr int (kResponseHead\w+) = (\d+);", LAUNCHERS.read_text())
    return {k: int(v) for k, v in found}


def plan(P: int, S: int, h: int, w: int, D: int, H: int, W: int) -> dict:
    """``launchers.h::response_head_plan``: the launch of ``P`` pairs."""
    k = constants()
    R = 1
    while (R < k["kResponseHeadMaxRanks"] and P * 2 * R <= k["kResponseHeadWaveBlocks"]
           and 2 * R * k["kResponseHeadMinRows"] <= H):
        R *= 2
    band = -(-H // R)
    return {"ranks": R, "threads": k["kResponseHeadThreads"], "pixels": -(-(h * w) // R),
            "band_rows": band, "vec": 4 if W % 4 == 0 else 1, "blocks": P * R,
            "smem_bytes": 4 * (-(-(h * w) // 4) * 4 + band * w)}


def pixel_share(hw: int, R: int, rank: int) -> range:
    """The pixels whose scores rank ``rank`` of ``R`` forms."""
    return range(rank * hw // R, (rank + 1) * hw // R)


def row_band(H: int, R: int, rank: int) -> range:
    """The output rows rank ``rank`` of ``R`` writes."""
    return range(rank * H // R, (rank + 1) * H // R)


def _warp_scores(v, lan):
    """``<v[..., p, :], lan[..., :]>`` as a warp forms it: lane l's fmaf chain
    over channels l, l + 32, ..., then the butterfly of shuffles."""
    D = v.shape[-1]
    lanes = np.zeros(v.shape[:-1] + (32,), np.float32)
    for c0 in range(0, D, 32):
        n = min(32, D - c0)
        lanes[..., :n] = fmaf(v[..., c0:c0 + n], lan[..., None, c0:c0 + n], lanes[..., :n])
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    return lanes[..., 0]


def emulate(vis_new, vis_base, lan, S: int, scale, alpha: float, hw_shape, out_hw,
            score_visits=None, row_visits=None):
    """The kernel's maps ``[P, H, W]`` (numpy float32) as its clusters form
    them. ``score_visits`` [P, hw] and ``row_visits`` [P, H], where given, count
    each pixel's score formed and each output row written, by any rank."""
    (h, w), (H, W) = hw_shape, out_hw
    vb = np.asarray(vis_base, np.float32)
    N, hw, D = vb.shape
    ln = np.asarray(lan, np.float32).reshape(N, S, D)
    alpha, scale = np.float32(alpha), np.float32(scale)
    P = N * S
    R = plan(P, S, h, w, D, H, W)["ranks"]
    scores = np.full((N, S, hw), np.nan, np.float32)
    for rank in range(R):
        px = pixel_share(hw, R, rank)
        base = vb[:, None, px.start:px.stop]
        v = base if vis_new is None else (
            np.asarray(vis_new, np.float32).reshape(N, S, hw, D)[:, :, px.start:px.stop] * alpha
            + base)
        v = np.broadcast_to(v, (N, S) + v.shape[2:])
        scores[:, :, px.start:px.stop] = scale * _warp_scores(v, ln)
        if score_visits is not None:
            score_visits[:, px.start:px.stop] += 1
    plane = scores.reshape(P, h, w)
    ylo, yhi, wy0, wy1 = interp_taps(h, H, False)
    xlo, xhi, wx0, wx1 = interp_taps(w, W, False)
    out = np.full((P, H, W), np.nan, np.float32)
    for rank in range(R):
        rows = np.asarray(row_band(H, R, rank))
        t = wy0[rows][:, None] * plane[:, ylo[rows]] + wy1[rows][:, None] * plane[:, yhi[rows]]
        out[:, rows] = np.maximum(wx0 * t[..., xlo] + wx1 * t[..., xhi], np.float32(0))
        if row_visits is not None:
            row_visits[:, rows] += 1
    return out
