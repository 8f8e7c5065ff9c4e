"""K3: the stage-1 response head (``csrc/response_head.cu``) and its plain
PyTorch version.

Replaces ``tris_tpu/models/stage1.py`` lines 168-179 (and 97-113): per
pair ``i`` of image ``b = i // S``, ``relu(upsample(scale * <vis_p, lan[i]>))``
with ``vis_p = vis_new[i] * alpha + vis_base[b]`` (just ``vis_base[b]`` when
``vis_new`` is None), upsampled ``align_corners=False`` from the [h, w] score
plane to [H, W]. Returns ``[N*S, H, W]``.

The kernel takes a cluster of blocks a pair: each rank forms the scores of
its share of the pixels, the ranks exchange them through distributed shared
memory, and each writes its band of output rows; the cluster's size is
``csrc/launchers.h::response_head_plan``'s rule, which
:func:`response_head_plan` reads back from the extension and
``tris_tpu_torch/tools/response_head_schedule.py`` emulates on the host;
:func:`response_head_launch_shape` gives the last launch's grid.

``--bf16``: bfloat16 ``vis_base`` and ``lan`` with ``vis_new`` float32 (the
fusion on float32 leaves), bfloat16 or None launch ``response_head_bf16``
(counted as ``response_head.bf16``; D even); the maps are float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.ops.dtypes import promote
from tris_tpu_torch.ops.resize import interp_taps


@functools.lru_cache(maxsize=64)
def taps_on(in_size: int, out_size: int, align_corners: bool, device: torch.device):
    """:func:`interp_taps` as four tensors on ``device`` (cached)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in interp_taps(in_size, out_size, align_corners))


@functools.lru_cache(maxsize=64)
def adjoint_taps_on(in_size: int, out_size: int, align_corners: bool, device: torch.device):
    """The resize's adjoint as a gather, on ``device`` (cached): for each
    input index ``i``, the output indices whose ``lo`` tap is ``i`` are
    ``[lo_begin[i], lo_end[i])`` and those whose ``hi`` tap is ``i`` are
    ``[hi_begin[i], hi_end[i])`` (four int32 tensors of ``in_size``). The
    taps never decrease along the output, so each set is one range."""
    lo, hi, _, _ = interp_taps(in_size, out_size, align_corners)
    if np.any(np.diff(lo) < 0) or np.any(np.diff(hi) < 0):
        raise ValueError(f"taps {in_size} -> {out_size} are not monotone")
    idx = np.arange(in_size)
    ranges = (np.searchsorted(lo, idx, "left"), np.searchsorted(lo, idx, "right"),
              np.searchsorted(hi, idx, "left"), np.searchsorted(hi, idx, "right"))
    return tuple(torch.as_tensor(r.astype(np.int32), device=device) for r in ranges)


def upsample_taps_plain(x, ty, tx):
    """``[..., h, w]`` -> ``[..., H, W]`` with taps, rows first, each product
    and sum rounded on its own: the kernels' sampling, written out."""
    ylo, yhi, wy0, wy1 = ty
    xlo, xhi, wx0, wx1 = tx
    r = wy0[:, None] * x[..., ylo.long(), :] + wy1[:, None] * x[..., yhi.long(), :]
    return wx0 * r[..., xlo.long()] + wx1 * r[..., xhi.long()]


def response_head_plain(vis_new, vis_base, lan, S: int, scale, alpha: float, hw_shape, out_hw):
    """The plain version: the JAX einsum and the resize written out, with
    jnp's dtypes: the residual ``vis_new * alpha + vis_base`` in the two's
    promoted dtype (``alpha`` is given in vis_new's), the dot in that and
    lan's promoted dtype (a bfloat16 dot rounded to bfloat16), then times the
    float32 ``scale`` in float32; the resize and the maps float32."""
    (h, w), (H, W) = hw_shape, out_hw
    N, HW, D = vis_base.shape
    base = vis_base.reshape(N, 1, HW, D)
    v = base if vis_new is None else vis_new.reshape(N, S, HW, D) * alpha + base
    dt = promote(v, lan)
    dot = torch.einsum("nspc,nsc->nsp", v.to(dt), lan.reshape(N, S, D).to(dt))
    score = scale * dot.to(promote(dot, scale))
    ty = taps_on(h, H, False, vis_base.device)
    tx = taps_on(w, W, False, vis_base.device)
    return torch.relu(upsample_taps_plain(score.reshape(N * S, h, w), ty, tx))


MAX_PAIRS = 65535  # the grid's second dimension
F32, BF16 = torch.float32, torch.bfloat16
# (vis_new, vis_base, lan, scale): float32; bfloat16 vis_base and lan with vis_new float32,
# bfloat16 or None
DTYPES = ((F32, F32, F32, F32), (None, F32, F32, F32), (F32, BF16, BF16, F32),
          (BF16, BF16, BF16, F32), (None, BF16, BF16, F32))


def response_head_plan(P: int, S: int, h: int, w: int, D: int, H: int, W: int) -> dict:
    """The launch for ``P`` pairs of ``[h, w]`` score planes of ``D`` channels to
    ``[H, W]`` maps (``launchers.h``'s rule, from the extension): ranks, threads,
    pixels, band_rows, vec, blocks and smem_bytes. Refuses, before any launch,
    a shape the kernel does not take."""
    if (not 0 <= P <= MAX_PAIRS or min(S, h, w, D, H, W) < 1 or h * w >= 2 ** 31
            or H * W >= 2 ** 31 or D >= 2 ** 31):
        raise ValueError(f"response_head_plan: bad shape {(P, S, h, w, D, H, W)}")
    plan = dict(build.ops().response_head_plan(P, S, h, w, D, H, W))
    if plan["smem_bytes"] > build.MAX_SMEM:
        raise ValueError(f"response_head: h*w = {h * w} scores and {plan['band_rows']} rows of "
                         f"{w} must fit shared memory")
    return plan


def response_head_launch_shape() -> dict:
    """The grid of the last launch in this process: blocks, cluster, threads,
    vec and smem_bytes."""
    if build.launches["response_head"] + build.launches["response_head.bf16"] == 0:
        raise RuntimeError("response_head_launch_shape: no launch of response_head counted")
    return dict(build.ops().response_head_launch_shape())


def response_head(vis_new, vis_base, lan, S: int, scale, alpha: float, hw_shape, out_hw):
    """K3 on CUDA tensors; the plain version on CPU tensors. ``scale`` is a
    0-d tensor (``exp(logit_scale)``) that the kernel reads on the device."""
    if vis_base.device.type == "cpu":
        return response_head_plain(vis_new, vis_base, lan, S, scale, alpha, hw_shape, out_hw)
    combo = build.require_cuda("response_head", vis_new, vis_base, lan, scale, accepted=DTYPES)
    (h, w), (H, W) = hw_shape, out_hw
    N, HW, D = vis_base.shape
    P = lan.shape[0]
    if HW != h * w or P != N * S or lan.shape[1] != D or (
            vis_new is not None and vis_new.shape != (P, HW, D)):
        raise ValueError(f"response_head: bad shapes vis_base{tuple(vis_base.shape)} "
                         f"lan{tuple(lan.shape)} S={S} hw={hw_shape}")
    response_head_plan(P, S, h, w, D, H, W)
    vis_base, lan = vis_base.contiguous(), lan.contiguous()
    vis_new = None if vis_new is None else vis_new.contiguous()
    ty = taps_on(h, H, False, vis_base.device)
    tx = taps_on(w, W, False, vis_base.device)
    if DTYPES[combo][1] == BF16:
        if D % 2:
            raise ValueError(f"response_head: bfloat16 takes an even D, got {D}")
        out = build.ops().response_head_bf16(vis_new, vis_base, lan,
                                             scale.reshape(()).contiguous(), list(ty), list(tx),
                                             S, h, w, float(alpha))
        build.count("response_head.bf16")
        return out
    out = build.ops().response_head(vis_new, vis_base, lan, scale.reshape(()).contiguous(),
                                    list(ty), list(tx), S, h, w, float(alpha))
    build.count("response_head")
    return out
