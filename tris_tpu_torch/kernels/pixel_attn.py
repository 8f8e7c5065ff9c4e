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
backward (``csrc/launchers.h::pixel_attn_takes``, which the extension
exposes): another shape raises ``ValueError`` here, before any launch.
``pixel_attn_launch_shape`` reads back the grid of the last launch.
"""

from __future__ import annotations

import math

import torch

from tris_tpu_torch.kernels import build


def pixel_attn_plain(q, Lk, Lv, S: int):
    """The plain version: the JAX einsums with pairs as [N, S, ...] (its
    gradient is autograd's)."""
    N, HW, Ci = q.shape
    T = Lk.shape[1]
    Lk, Lv = (x.reshape(N, S, T, Ci) for x in (Lk, Lv))
    attn = torch.softmax(torch.einsum("npc,nstc->nspt", q, Lk) / math.sqrt(Ci), dim=3)
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
    ``pixel_attn_bwd_probs_dq`` or ``pixel_attn_bwd_dkv``) on the card, as its
    launcher made it: ``blocks``, ``cluster``, ``threads``, ``smem_bytes``, the
    token bucket ``t_bucket``, pixels a ``tile``, channels a rank (``width``),
    the backward's tile ``groups`` and ``load_bytes`` (16, or 4 where a
    pointer or C is not a multiple of 16 bytes)."""
    return dict(build.ops().pixel_attn_launch_shape(name))


def pixel_attn(q, Lk, Lv, S: int = 1):
    """K11 on CUDA tensors (one launch forward, two backward); the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return pixel_attn_plain(q, Lk, Lv, S)
    build.require_cuda("pixel_attn", q, Lk, Lv)
    if q.dim() != 3 or Lk.dim() != 3 or Lv.shape != Lk.shape or Lk.shape[0] != q.shape[0] * S \
            or Lk.shape[2] != q.shape[2]:
        raise ValueError(f"pixel_attn: bad shapes q{tuple(q.shape)} Lk{tuple(Lk.shape)} "
                         f"Lv{tuple(Lv.shape)} S={S}")
    T, C = Lk.shape[1], q.shape[2]
    save = torch.is_grad_enabled() and any(x.requires_grad for x in (q, Lk, Lv))
    if not build.ops().pixel_attn_takes(T, C, S, save):
        raise ValueError(f"pixel_attn: the kernels do not take T={T}, C={C}, S={S} (1 to 48 "
                         f"tokens, 32 with a gradient: csrc/launchers.h::pixel_attn_takes)")
    return _PixelAttn.apply(q.contiguous(), Lk.contiguous(), Lv.contiguous(), int(S), save)
