"""K4: the eval resize, normalise and metrics step (``csrc/eval_metrics.cu``)
and its plain PyTorch version.

Replaces ``tris_tpu/eval/validate.py::_resize_norm_valid`` + ``_metrics_core``
(``_device_resize_norm`` / ``_device_metrics``). Each [h, w] map of image b
is upsampled ``align_corners=True`` to that image's original (oh, ow) with
the two taps per row of the JAX package's interpolation matrices
(:func:`eval_tables`), max-normalised over that region, and either reduced
to per-map ``(I, U, hit, hitm)`` or returned as the normalised plane padded
to [maxH, maxW] with zeros.

The kernel takes a cluster of blocks a map, each owning a band of its rows;
the cluster's size is ``csrc/launchers.h::eval_metrics_plan``'s rule, which
:func:`eval_metrics_plan` reads back from the extension and
``tris_tpu_torch/tools/eval_metrics_schedule.py`` emulates on the host;
:func:`eval_metrics_launch_shape` gives the last launch's grid.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tris_tpu_torch.device import to_device
from tris_tpu_torch.kernels import build
from tris_tpu_torch.ops.resize import interp_taps


@functools.lru_cache(maxsize=256)
def _padded_taps(in_size: int, out_size: int, max_out: int, device: torch.device):
    """align_corners=True taps for one original size, padded to ``max_out``
    rows with (0, 0, 0, 0), as four tensors on ``device`` (cached: original
    sizes repeat heavily across a split)."""
    out = []
    for a in interp_taps(in_size, out_size, True):
        p = np.zeros(max_out, a.dtype)
        p[:out_size] = a
        out.append(torch.as_tensor(p, device=device))
    return tuple(out)


def eval_tables(h: int, w: int, sizes, max_hw, device) -> dict:
    """Per-batch sampling tables: ``y`` taps [B, maxH] x4, ``x`` taps
    [B, maxW] x4 and ``orig_hw`` [B, 2] int32, for maps of [h, w] and
    original sizes ``sizes`` (a list of (oh, ow))."""
    device = torch.device(device)
    maxh, maxw = max_hw
    ys = [_padded_taps(h, int(oh), maxh, device) for oh, _ in sizes]
    xs = [_padded_taps(w, int(ow), maxw, device) for _, ow in sizes]
    return {
        "y": tuple(torch.stack([t[i] for t in ys]) for i in range(4)),
        "x": tuple(torch.stack([t[i] for t in xs]) for i in range(4)),
        "orig_hw": to_device(np.asarray(sizes, np.int32).reshape(-1, 2), device),
    }


def eval_metrics_plain(cams, tables, targets=None, boxes=None, want_norm: bool = False):
    """The plain version: gathers, products and sums written out, in the
    kernel's order, then the JAX package's threshold/argmax chain."""
    B, S, h, w = cams.shape
    ylo, yhi, wy0, wy1 = tables["y"]
    xlo, xhi, wx0, wx1 = tables["x"]
    maxh, maxw = ylo.shape[1], xlo.shape[1]
    cams = cams.float()

    def rows(idx):
        return cams.gather(2, idx.long()[:, None, :, None].expand(B, S, maxh, w))

    r = wy0[:, None, :, None] * rows(ylo) + wy1[:, None, :, None] * rows(yhi)

    def cols(idx):
        return r.gather(3, idx.long()[:, None, None, :].expand(B, S, maxh, maxw))

    out = wx0[:, None, None, :] * cols(xlo) + wx1[:, None, None, :] * cols(xhi)
    oh, ow = tables["orig_hw"].long().unbind(1)
    ar_h = torch.arange(maxh, device=cams.device)
    ar_w = torch.arange(maxw, device=cams.device)
    valid = (ar_h[None, :, None] < oh[:, None, None]) & (ar_w[None, None, :] < ow[:, None, None])
    valid = valid[:, None]                                        # [B, 1, maxH, maxW]
    neg = torch.tensor(-torch.inf, device=cams.device)
    m = torch.where(valid, out, neg).amax(dim=(-2, -1), keepdim=True)
    norm = torch.where(valid, out / (m + 1e-5), torch.zeros((), device=cams.device))
    if want_norm:
        return norm
    pred = norm > 1e-9
    tgt = targets.bool()[:, None]
    I = (pred & tgt).sum(dim=(-2, -1)).float()
    U = (pred | tgt).sum(dim=(-2, -1)).float()
    peak = torch.where(valid, norm, neg).reshape(B, S, maxh * maxw).argmax(dim=-1)
    py = torch.div(peak, maxw, rounding_mode="floor").float()
    px = (peak % maxw).float()
    hitm = targets.reshape(B, 1, maxh * maxw).expand(B, S, maxh * maxw).gather(
        -1, peak[..., None])[..., 0].float()
    x1, y1, x2, y2 = (boxes[:, i:i + 1].float() for i in range(4))
    hit = ((x1 <= px) & (px <= x2) & (y1 <= py) & (py <= y2)).float()
    return I, U, hit, hitm


def eval_metrics_plan(B: int, S: int, maxH: int, maxW: int, h: int, w: int) -> dict:
    """The launch for B x S maps [h, w] to originals within [maxH, maxW] on this
    card (``launchers.h``'s rule, from the extension): ranks, threads,
    band_rows, staged, smem_bytes, blocks and max_ranks."""
    if (min(B, S, maxH, maxW, h, w) < 1 or max(B, S) > 65535 or maxH * maxW >= 2 ** 31
            or h * w >= 2 ** 31):
        raise ValueError(f"eval_metrics_plan: bad shape {(B, S, maxH, maxW, h, w)}")
    return dict(build.ops().eval_metrics_plan(B, S, maxH, maxW, h, w))


def eval_metrics_launch_shape() -> dict:
    """The grid of the last launch in this process: blocks, cluster, threads,
    smem_bytes, staged and map_load_bytes."""
    if build.launches["eval_metrics"] == 0:
        raise RuntimeError("eval_metrics_launch_shape: no launch of eval_metrics counted")
    return dict(build.ops().eval_metrics_launch_shape())


def eval_metrics(cams, tables, targets=None, boxes=None, want_norm: bool = False):
    """K4 on CUDA tensors; the plain version on CPU tensors.

    cams [B, S, h, w] f32; tables from :func:`eval_tables`; targets
    [B, maxH, maxW] uint8 (zero-padded gt masks) and boxes [B, 4] f32 x1y1x2y2
    for the metrics. Returns ``(I, U, hit, hitm)`` each [B, S] f32, or with
    ``want_norm`` the normalised maps [B, S, maxH, maxW]."""
    if cams.device.type == "cpu":
        return eval_metrics_plain(cams, tables, targets, boxes, want_norm)
    ylo, yhi, wy0, wy1 = tables["y"]
    xlo, xhi, wx0, wx1 = tables["x"]
    build.require_cuda("eval_metrics", cams, wy0, wx0, boxes)
    B, S = cams.shape[:2]
    maxh, maxw = ylo.shape[1], xlo.shape[1]
    if tables["orig_hw"].shape != (B, 2) or wy0.shape[0] != B or wx0.shape[0] != B:
        raise ValueError(f"eval_metrics: tables for {B} images expected")
    if want_norm:
        targets = boxes = None
    else:
        if targets.dtype != torch.uint8 or targets.shape != (B, maxh, maxw) or boxes.shape != (B, 4):
            raise ValueError(f"eval_metrics: targets [B, maxH, maxW] uint8 and boxes [B, 4] "
                             f"(got {tuple(targets.shape)} {targets.dtype}, {tuple(boxes.shape)})")
        targets, boxes = targets.contiguous(), boxes.contiguous()
    out = build.ops().eval_metrics(cams.contiguous(), list(tables["y"]), list(tables["x"]),
                                   tables["orig_hw"], targets, boxes)
    build.count("eval_metrics")
    return out if want_norm else out.unbind(-1)
