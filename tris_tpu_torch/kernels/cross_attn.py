"""K2: the BilateralPrompt cross-attention, forward (``csrc/cross_attn.cu``)
and backward (``csrc/cross_attn_bwd.cu``), and its plain PyTorch version.

Replaces the two softmax-matmul pairs of
``tris_tpu/models/fusion.py::BilateralPrompt`` (lines 85-89). The vision
projections ``qv, kv, vv`` are per image ``[N, HW, m]``; the text ones
``qt, kt, vt`` per pair ``[N*S, T, m]``, pair ``i`` belonging to image
``i // S``. Returns ``(new_vis [N*S, HW, m], new_lan [N*S, T, m])`` before
the output projections. On CUDA tensors in float32 it is a ``torch.autograd.Function``
whose backward is the hand-written kernel (with the probabilities the
forward kept, [N, HW, T] and [N, T, HW]), for one sentence per image
(S = 1, training's shape): with S > 1 a pair's gradient would have to be
summed into its image's, and no path differentiates ``response_maps``, so
the wrapper refuses it.

``--bf16``: bfloat16 text projections with float32 vision ones (the fusion on
float32 leaves; every product float32, outputs float32) or all six bfloat16
(bfloat16 leaves; the logits, ``/ div`` and the softmax's ops rounded to
bfloat16, outputs bfloat16, HW and T at most ``KEY_BLOCK``) launch
``cross_attn_bf16`` (counted as ``cross_attn.bf16``); with gradients (one
sentence an image, HW and T at most ``KEY_BLOCK``) it keeps the
probabilities and its backward ``cross_attn_bwd_bf16`` (two launches,
counted as ``cross_attn_bwd.bf16``) returns each gradient in its operand's
dtype.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.ops.dtypes import promote, softmax, weak

F32, BF16 = torch.float32, torch.bfloat16
# (qv, kv, vv, qt, kt, vt): float32; float32 vision and bfloat16 text; bfloat16
DTYPES = ((F32,) * 6, (F32,) * 3 + (BF16,) * 3, (BF16,) * 6)
KEY_BLOCK = 256  # csrc/launchers.h kCrossAttnKeyBlock: the keys a bfloat16 launch takes


def cross_attn_plain(qv, kv, vv, qt, kt, vt, S: int, div: float):
    """The plain version: the JAX einsums, with pairs as [N, S, ...] (its
    gradient is autograd's), with jnp's dtypes: each einsum in its operands'
    promoted dtype. Vision operands float32 and text ones bfloat16 (the
    fusion on float32 leaves) promote to float32 throughout; all bfloat16
    rounds each logit, ``/ bfloat16(div)``, each of the softmax's ops and
    each output to bfloat16."""
    N, HW, m = qv.shape
    T = qt.shape[1]
    qt, kt, vt = (x.reshape(N, S, T, m) for x in (qt, kt, vt))

    def einsum(eq, a, b):
        dt = promote(a, b)
        return torch.einsum(eq, a.to(dt), b.to(dt))

    lv, lt = einsum("npm,nstm->nspt", qv, kt), einsum("nstm,npm->nstp", qt, kv)
    av = softmax(lv / weak(div, lv.dtype), dim=3)
    at = softmax(lt / weak(div, lt.dtype), dim=3)
    new_vis = einsum("nspt,nstm->nspm", av, vt)
    new_lan = einsum("nstp,npm->nstm", at, vv)
    return new_vis.reshape(N * S, HW, m), new_lan.reshape(N * S, T, m)


class _CrossAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qv, kv, vv, qt, kt, vt, S, div, save):
        # with save, the kernel also writes the probabilities the backward needs
        outs = build.ops().cross_attn(qv, kv, vv, qt, kt, vt, S, div, save)
        build.count("cross_attn")
        ctx.div = div
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(qv, kv, vv, qt, kt, vt, *outs[2:])
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, g_vis, g_lan):
        grads = build.ops().cross_attn_bwd(g_vis.contiguous(), g_lan.contiguous(),
                                           *ctx.saved_tensors, ctx.div)
        build.count("cross_attn_bwd", n=2)
        return (*grads, None, None, None)


class _CrossAttnBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qv, kv, vv, qt, kt, vt, S, div, save):
        outs = build.ops().cross_attn_bf16(qv, kv, vv, qt, kt, vt, S, div, save)
        build.count("cross_attn.bf16")
        ctx.div = div
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(qv, kv, vv, qt, kt, vt, *outs[2:])
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, g_vis, g_lan):
        grads = build.ops().cross_attn_bwd_bf16(g_vis.contiguous(), g_lan.contiguous(),
                                                *ctx.saved_tensors, ctx.div)
        build.count("cross_attn_bwd.bf16", n=2)
        return (*grads, None, None, None)


def cross_attn_launch_shape(name: str) -> dict:
    """The grid of the last launch of K2's ``name`` (``cross_attn``,
    ``cross_attn_bwd_a`` or ``cross_attn_bwd_b``, the backward's two passes, and
    their ``_bf16`` counterparts ``cross_attn_bf16``, ``cross_attn_bwd_bf16_a``,
    ``cross_attn_bwd_bf16_b``)
    on the card, as its launcher made it: ``blocks``, ``cluster`` (blocks a
    cluster), ``threads``, ``tile_rows`` (query rows a tile) and
    ``smem_bytes``."""
    return dict(build.ops().cross_attn_launch_shape(name))


def cross_attn(qv, kv, vv, qt, kt, vt, S: int, div: float):
    """K2 on CUDA tensors (one launch forward, two backward); the plain
    version on CPU tensors. The kernels take any HW and T, and m a positive
    multiple of 4 up to 2048 (``csrc/launchers.h::cross_attn_takes``, which
    the extension asks): another m raises ``ValueError``."""
    if qv.device.type == "cpu":
        return cross_attn_plain(qv, kv, vv, qt, kt, vt, S, div)
    combo = build.require_cuda("cross_attn", qv, kv, vv, qt, kt, vt, accepted=DTYPES)
    N, HW, m = qv.shape
    P, T = qt.shape[0], qt.shape[1]
    if P != N * S or kv.shape != qv.shape or vv.shape != qv.shape or \
            kt.shape != qt.shape or vt.shape != qt.shape or qt.shape[2] != m:
        raise ValueError(f"cross_attn: bad shapes qv{tuple(qv.shape)} qt{tuple(qt.shape)} S={S}")
    if not build.ops().cross_attn_takes(m):
        raise ValueError(f"cross_attn: the kernels do not take m = {m} "
                         f"(csrc/launchers.h::cross_attn_takes)")
    inputs = (qv, kv, vv, qt, kt, vt)
    save = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    if combo > 0:
        if (combo == 2 or save) and max(HW, T) > KEY_BLOCK:
            raise ValueError(f"cross_attn: bfloat16 {'with gradients ' if save else ''}takes HW "
                             f"and T up to {KEY_BLOCK} (one key block), got HW = {HW}, T = {T}")
        if save and S != 1:
            raise ValueError(f"cross_attn: the backward takes one sentence per image (S = 1), "
                             f"got S = {S}; run S > 1 without gradients")
        return _CrossAttnBf16.apply(*(x.contiguous() for x in inputs), S, weak(div, qv.dtype),
                                    save)
    if save and S != 1:
        raise ValueError(f"cross_attn: the backward takes one sentence per image (S = 1), "
                         f"got S = {S}; run S > 1 without gradients")
    return _CrossAttn.apply(*(x.contiguous() for x in inputs), S, float(div), save)
