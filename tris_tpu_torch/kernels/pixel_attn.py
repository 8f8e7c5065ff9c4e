"""K11: PixelAttention's pixel-word attention, forward (``csrc/pixel_attn.cu``)
and backward (``csrc/pixel_attn_bwd.cu``), and its plain PyTorch version.

Replaces the two einsums and the softmax between them of
``tris_tpu/models/fusion.py::PixelAttention`` (lines 37-40):
``G = softmax(q Lk^T / sqrt(Ci), over T) Lv``. ``q`` is per image
``[N, HW, Ci]``; ``Lk`` and ``Lv`` per (image, sentence) pair
``[N*S, T, Ci]``, pair ``i`` reading image ``i // S`` as K2 does, so
``response_maps`` never repeats the pixels over sentences. Returns
``G [N*S, HW, Ci]``. Every token attends: neither JAX nor the reference
masks the padding. On CUDA tensors it is a ``torch.autograd.Function``
whose backward (dq summed over an image's pairs, dLk, dLv) is the
hand-written kernel too: it recomputes the probabilities from q and Lk
rather than saving them.

The kernels take 1 to 32 tokens, any C >= 1, S >= 1 and HW, forward and
backward (the forward up to 48: ``csrc/launchers.h::pixel_attn_takes``,
which the extension exposes): another shape raises ``ValueError`` here,
before any launch. ``pixel_attn_launch_shape`` reads back the grid of the
last launch.

``--bf16`` (stage 2's eval forward): bfloat16 Lk and Lv with bfloat16 q
(bfloat16 leaves: the logits, ``/ bfloat16(sqrt(Ci))`` and the softmax's
ops rounded to bfloat16, G bfloat16) or float32 q (a float32 checkpoint's
InstanceNorm scale promotes q: every product float32, G float32) launch
``pixel_attn_bf16`` (counted as ``pixel_attn.bf16``), forward only: with a
gradient, or another dtype mix, it raises before any launch.
"""

from __future__ import annotations

import math

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.ops.dtypes import promote, softmax, weak

F32, BF16 = torch.float32, torch.bfloat16
# (q, Lk, Lv): float32; the --bf16 forward's float32 q (float32 leaves) or bfloat16 q
DTYPES = ((F32,) * 3, (F32, BF16, BF16), (BF16,) * 3)


def pixel_attn_plain(q, Lk, Lv, S: int):
    """The plain version: the JAX einsums with pairs as [N, S, ...] (its
    gradient is autograd's), with jnp's dtypes: each einsum in its operands'
    promoted dtype; below float32 the logits, ``/ sqrt(Ci)`` (the Python
    float taking their dtype), each of the softmax's ops and G rounded to
    that dtype."""
    N, HW, Ci = q.shape
    T = Lk.shape[1]
    Lk, Lv = (x.reshape(N, S, T, Ci) for x in (Lk, Lv))
    dt = promote(q, Lk, Lv)
    if dt.itemsize >= 4:
        q, Lk, Lv = (x.to(dt) for x in (q, Lk, Lv))
        attn = torch.softmax(torch.einsum("npc,nstc->nspt", q, Lk) / math.sqrt(Ci), dim=3)
        return torch.einsum("nspt,nstc->nspc", attn, Lv).reshape(N * S, HW, Ci)
    logits = torch.einsum("npc,nstc->nspt", q, Lk)
    attn = softmax(logits / weak(math.sqrt(Ci), dt), dim=3)
    return torch.einsum("nspt,nstc->nspc", attn, Lv).reshape(N * S, HW, Ci)


class _PixelAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, Lk, Lv, S, save):
        div = math.sqrt(q.shape[2])
        out = build.ops().pixel_attn(q, Lk, Lv, S, div)
        build.count("pixel_attn")
        ctx.S, ctx.div = S, div
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(q, Lk, Lv)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dLk, dLv = build.ops().pixel_attn_bwd(g.contiguous(), *ctx.saved_tensors, ctx.S,
                                                  ctx.div)
        build.count("pixel_attn_bwd", n=2)
        return dq, dLk, dLv, None, None


def pixel_attn_launch_shape(name: str) -> dict:
    """The grid of the last launch of K11's ``name`` (``pixel_attn``,
    ``pixel_attn_bf16``, ``pixel_attn_bwd_probs_dq`` or ``pixel_attn_bwd_dkv``) on the card, as its
    launcher made it: ``blocks``, ``cluster``, ``threads``, ``smem_bytes``, the
    token bucket ``t_bucket``, pixels a ``tile``, channels a rank (``width``),
    the backward's tile ``groups`` and ``load_bytes`` (16, or 4 where a
    pointer or C is not a multiple of 16 bytes)."""
    return dict(build.ops().pixel_attn_launch_shape(name))


def pixel_attn(q, Lk, Lv, S: int = 1):
    """K11 on CUDA tensors (one launch forward, two backward; the bfloat16
    forward one launch); the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return pixel_attn_plain(q, Lk, Lv, S)
    combo = build.require_cuda("pixel_attn", q, Lk, Lv, accepted=DTYPES)
    if q.dim() != 3 or Lk.dim() != 3 or Lv.shape != Lk.shape or Lk.shape[0] != q.shape[0] * S \
            or Lk.shape[2] != q.shape[2]:
        raise ValueError(f"pixel_attn: bad shapes q{tuple(q.shape)} Lk{tuple(Lk.shape)} "
                         f"Lv{tuple(Lv.shape)} S={S}")
    T, C = Lk.shape[1], q.shape[2]
    save = torch.is_grad_enabled() and any(x.requires_grad for x in (q, Lk, Lv))
    if combo > 0 and save:
        raise ValueError("pixel_attn: the bfloat16 forward takes no gradient (no bfloat16 "
                         "backward kernel)")
    if not build.ops().pixel_attn_takes(T, C, S, save):
        raise ValueError(f"pixel_attn: the kernels do not take T={T}, C={C}, S={S} (1 to 48 "
                         f"tokens, 32 with a gradient: csrc/launchers.h::pixel_attn_takes)")
    if combo > 0:
        out = build.ops().pixel_attn_bf16(q.contiguous(), Lk.contiguous(), Lv.contiguous(),
                                          int(S), weak(math.sqrt(C), q.dtype))
        build.count("pixel_attn.bf16")
        return out
    return _PixelAttn.apply(q.contiguous(), Lk.contiguous(), Lv.contiguous(), int(S), save)
