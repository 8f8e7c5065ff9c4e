"""K3, training half: the stage-1 classification head, forward and backward
(``csrc/stage1_head.cu``), and its plain PyTorch version.

Replaces ``tris_tpu/models/stage1.py::TRISStage1.__call__`` lines 100-131
with ``train=True``: per image ``b``, the scores of its pixels against all
``T`` texts, ``scale * <vis_p[b, p], lan_p[b, q]>``; over the ``1 + T``
channels (a constant bg logit 1 first) the softmax, GAP + GMP and the focal
term ``(1 - x)^p * log(c + x)`` of the mean mask give ``cls_out [B, T]`` (bg
dropped) and ``cls_fg [B]``; the score plane of image b's own text ``b +
offset``, upsampled ``align_corners=False`` to ``[H, W]``, gives the relu
and sigmoid maps. On one process ``T = B`` and the offset is 0; across the
ranks of a process group each rank scores its ``B`` images against the
global batch's ``T`` texts, its own at ``rank * B``. On CUDA tensors it is
a ``torch.autograd.Function`` whose backward is the hand-written kernel,
from ``d cls_out``, ``d sig_map`` and
``d relu_map`` to ``d vis_p`` and ``d lan_p``. ``cls_fg`` is a metric and
gets no gradient; nor does ``scale`` (``logit_scale`` is frozen in stage 1,
``tris_tpu/train/state.py:85-86``), though the plain version, being
autograd's, computes one that the optimizer ignores.

Each way is one launch, a cluster of blocks an image: the ranks form the
scores of their shares of the pixels and exchange them through distributed
shared memory, and the backward forms dscore in shared memory; the
cluster's size is ``csrc/launchers.h::stage1_head_plan``'s rule, which
:func:`stage1_head_plan` reads back from the extension and
``tris_tpu_torch/tools/stage1_head_schedule.py`` emulates on the host;
:func:`stage1_head_launch_shape` gives the last launch's grid.

``--bf16``: lan_p bfloat16 with vis_p bfloat16 (the seeded init, and
``--clip_weights``) or float32 (``--pretrain`` of a float32 checkpoint), the
scale float32, as jnp promotes them: the dot in the promoted dtype with
float32 sums (rounded to bfloat16 when both are), times the scale in float32,
the head and the maps float32; GMP's gradient split evenly among tied maxima.
``csrc/stage1_head_bf16.cu``, a block an image, one launch each way (counted
as ``stage1_head.bf16`` and ``stage1_head_bwd.bf16``); the gradients in their
operands' dtypes. The float32 route keeps its kernels (GMP's gradient to the
first argmax).
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.kernels.response_head import adjoint_taps_on, taps_on, upsample_taps_plain
from tris_tpu_torch.ops.dtypes import promote


def stage1_head_plain(vis_p, lan_p, scale, hw_shape, out_hw, focal_p: float, focal_lambda: float,
                      offset: int = 0):
    """The plain version: the JAX head written out, the upsample with the
    kernel's taps in its order. vis_p [B, h*w, D], lan_p [B, T, D], scale a
    0-d float32 tensor -> (cls_out [B, T], cls_fg [B], relu_map, sig_map [B,
    H, W]), all float32. With jnp's dtypes (``--bf16``): the dot in the
    operands' promoted dtype, float32 sums rounded to it (bfloat16 when both
    are), then times ``scale`` in float32, and everything after in float32.
    GMP's gradient is amax's, split evenly among tied maxima, as JAX's max
    splits it."""
    (h, w), (H, W) = hw_shape, out_hw
    B, T = vis_p.shape[0], lan_p.shape[1]
    if not 0 <= offset <= T - B:
        raise ValueError(f"stage1_head: the own texts [{offset}, {offset + B}) of {B} images "
                         f"must lie in the {T} texts")
    dt = promote(vis_p, lan_p)
    dot = torch.einsum("bpc,bqc->bpq", vis_p.to(dt), lan_p.to(dt))
    score = scale * dot.to(promote(dot, scale))                      # [B, hw, T]
    own = torch.diagonal(score[:, :, offset:offset + B], dim1=0, dim2=2).T  # [b, :, b + offset]
    ty = taps_on(h, H, False, vis_p.device)
    tx = taps_on(w, W, False, vis_p.device)
    seg = upsample_taps_plain(own.reshape(B, h, w), ty, tx)
    feats = torch.cat([score.new_ones(B, 1, h * w), score.transpose(1, 2)], dim=1)
    masks = torch.softmax(feats, dim=1)                              # [B, 1+B, hw]
    mbar = masks.mean(dim=-1)
    cls = feats.mean(dim=-1) + feats.amax(dim=-1) \
        + torch.pow(1.0 - mbar, focal_p) * torch.log(focal_lambda + mbar)
    cls_fg = torch.diagonal(mbar[:, 1 + offset:1 + offset + B]).detach()
    return cls[:, 1:], cls_fg, torch.relu(seg), torch.sigmoid(seg)


MAX_IMAGES = 65535  # the grid's second dimension
F32, BF16 = torch.float32, torch.bfloat16
# (vis_p, lan_p, scale): float32; or bfloat16 text with bfloat16 or float32 vision (--bf16)
DTYPES = ((F32, F32, F32), (BF16, BF16, F32), (F32, BF16, F32))


def stage1_head_plan(B: int, h: int, w: int, D: int, H: int, W: int,
                     backward: bool = False, T: int = None) -> dict:
    """The launch for ``B`` images and ``T`` texts (default ``B``), ``[h, w]``
    score planes of ``D`` channels and ``[H, W]`` maps, forward or backward
    (``launchers.h``'s rule, from the extension): ranks, threads, pixels,
    band_rows, vec, passes, stages, groups, blocks and smem_bytes. Refuses,
    before any launch, a shape the kernels do not take."""
    T = B if T is None else T
    if (not 1 <= B <= MAX_IMAGES or T < B or min(h, w, D, H, W) < 1 or h * w * T >= 2 ** 31
            or H * W >= 2 ** 31 or D >= 2 ** 31):
        raise ValueError(f"stage1_head_plan: bad shape {(B, T, h, w, D, H, W)}")
    if D % 4:
        raise ValueError(f"stage1_head: D = {D} channels must be a multiple of 4 (16-byte copies)")
    plan = dict(build.ops().stage1_head_plan(B, T, h, w, D, H, W, backward))
    if plan["smem_bytes"] > build.MAX_SMEM:
        raise ValueError(f"stage1_head: the [h*w, T] = [{h * w}, {T}] score plane and the "
                         f"{'backward' if backward else 'forward'}'s stages must fit shared memory")
    return plan


def stage1_head_launch_shape(backward: bool = False) -> dict:
    """The grid of the last launch in this process, forward or backward:
    blocks, cluster, threads, vec and smem_bytes."""
    name = "stage1_head_bwd" if backward else "stage1_head"
    if build.launches[name] == 0:
        raise RuntimeError(f"stage1_head_launch_shape: no launch of {name} counted")
    return dict(build.ops().stage1_head_launch_shape(backward))


def _aligned(t):
    """``t`` contiguous on 16 bytes, as the kernels' float4 loads read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Stage1Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vis_p, lan_p, scale, h, w, H, W, focal_p, focal_lambda, offset, save):
        ty = taps_on(h, H, False, vis_p.device)
        tx = taps_on(w, W, False, vis_p.device)
        score, stats, cls_out, cls_fg, relu_map, sig_map = build.ops().stage1_head(
            vis_p, lan_p, scale, list(ty), list(tx), h, w, focal_p, focal_lambda, offset)
        build.count("stage1_head")
        ctx.mark_non_differentiable(cls_fg)
        ctx.set_materialize_grads(False)
        ctx.shape, ctx.focal, ctx.offset = (h, w, H, W), (focal_p, focal_lambda), offset
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(vis_p, lan_p, scale, score, stats)
        return cls_out, cls_fg, relu_map, sig_map

    @staticmethod
    def backward(ctx, g_cls, _g_fg, g_relu, g_sig):
        vis_p, lan_p, scale, score, stats = ctx.saved_tensors
        h, w, H, W = ctx.shape
        dev = vis_p.device
        if g_cls is None:
            g_cls = torch.zeros(score.shape[0], score.shape[2], device=dev)
        d_vis, d_lan = build.ops().stage1_head_bwd(
            g_cls.contiguous(), None if g_relu is None else _aligned(g_relu),
            None if g_sig is None else _aligned(g_sig), vis_p, lan_p, scale, score, stats,
            list(taps_on(h, H, False, dev)), list(taps_on(w, W, False, dev)),
            list(adjoint_taps_on(h, H, False, dev)), list(adjoint_taps_on(w, W, False, dev)),
            h, w, *ctx.focal, ctx.offset)
        build.count("stage1_head_bwd")
        return d_vis, d_lan, None, None, None, None, None, None, None, None, None


class _Stage1HeadBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vis_p, lan_p, scale, h, w, H, W, focal_p, focal_lambda, offset, save):
        dev = vis_p.device
        score, stats, cls_out, cls_fg, relu_map, sig_map = build.ops().stage1_head_bf16(
            vis_p, lan_p, scale, list(taps_on(h, H, False, dev)), list(taps_on(w, W, False, dev)),
            h, w, focal_p, focal_lambda, offset)
        build.count("stage1_head.bf16")
        ctx.mark_non_differentiable(cls_fg)
        ctx.set_materialize_grads(False)
        ctx.shape, ctx.focal, ctx.offset = (h, w, H, W), (focal_p, focal_lambda), offset
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(vis_p, lan_p, scale, score, stats)
        return cls_out, cls_fg, relu_map, sig_map

    @staticmethod
    def backward(ctx, g_cls, _g_fg, g_relu, g_sig):
        vis_p, lan_p, scale, score, stats = ctx.saved_tensors
        h, w, H, W = ctx.shape
        dev = vis_p.device
        if g_cls is None:
            g_cls = torch.zeros(score.shape[0], score.shape[2], device=dev)
        d_vis, d_lan = build.ops().stage1_head_bwd_bf16(
            g_cls.contiguous(), None if g_relu is None else g_relu.contiguous(),
            None if g_sig is None else g_sig.contiguous(), vis_p, lan_p, scale, score, stats,
            list(taps_on(h, H, False, dev)), list(taps_on(w, W, False, dev)),
            list(adjoint_taps_on(h, H, False, dev)), list(adjoint_taps_on(w, W, False, dev)),
            h, w, *ctx.focal, ctx.offset)
        build.count("stage1_head_bwd.bf16")
        return d_vis, d_lan, None, None, None, None, None, None, None, None, None


def stage1_head(vis_p, lan_p, scale, hw_shape, out_hw, focal_p: float, focal_lambda: float,
                offset: int = 0):
    """K3's training head on CUDA tensors (one launch forward, one
    backward); the plain version on CPU tensors. ``scale`` is a 0-d tensor
    (``exp(logit_scale)``) that the kernels read on the device. vis_p [B,
    h*w, D] against lan_p [B, T, D], image b's own text ``b + offset``."""
    if vis_p.device.type == "cpu":
        return stage1_head_plain(vis_p, lan_p, scale, hw_shape, out_hw, focal_p, focal_lambda,
                                 offset)
    combo = build.require_cuda("stage1_head", vis_p, lan_p, scale, accepted=DTYPES)
    B, HW, D = vis_p.shape
    T = lan_p.shape[1] if lan_p.dim() == 3 else -1
    (h, w), (H, W) = hw_shape, out_hw
    if HW != h * w or lan_p.shape != (B, T, D) or not 0 <= offset <= T - B:
        raise ValueError(f"stage1_head: bad shapes vis_p{tuple(vis_p.shape)} "
                         f"lan_p{tuple(lan_p.shape)} hw={hw_shape} offset={offset}")
    save = torch.is_grad_enabled() and (vis_p.requires_grad or lan_p.requires_grad)
    if combo > 0:
        if not 1 <= B <= MAX_IMAGES or min(h, w, D, H, W) < 1 or H * W >= 2 ** 31:
            raise ValueError(f"stage1_head: bad shape {(B, T, h, w, D, H, W)}")
        for backward in (False, True) if save else (False,):
            if build.ops().stage1_head_bf16_smem(HW, T, H, w, backward) > build.MAX_SMEM:
                raise ValueError(f"stage1_head: bfloat16's [h*w, T] = [{HW}, {T}] score plane "
                                 f"and its {'backward' if backward else 'forward'}'s buffers "
                                 f"must fit shared memory")
        return _Stage1HeadBf16.apply(vis_p.contiguous(), lan_p.contiguous(),
                                     scale.reshape(()).contiguous(), h, w, H, W, float(focal_p),
                                     float(focal_lambda), int(offset), save)
    stage1_head_plan(B, h, w, D, H, W, T=T)
    if save:  # the backward's shape is refused before the forward runs
        stage1_head_plan(B, h, w, D, H, W, backward=True, T=T)
    return _Stage1Head.apply(_aligned(vis_p), _aligned(lan_p),
                             scale.reshape(()).contiguous(), h, w, H, W, float(focal_p),
                             float(focal_lambda), int(offset), save)
