"""K1: short-sequence multi-head attention, forward (``csrc/mha_short.cu``)
and backward (``csrc/mha_short_bwd.cu``), and its plain PyTorch version.

Replaces ``tris_tpu/models/layers.py::multi_head_attention``: on [N, L, C]
tensors already projected, ``softmax((q * hd^-1/2) . k^T + mask) . v`` per
head, q scaled before the dot, ``attn_mask`` additive ([Lq, Lk] or None).
On CUDA tensors it is a ``torch.autograd.Function`` whose backward is the
hand-written kernel: it recomputes the probabilities from q and k rather
than saving them, and returns dq, dk and dv as three tensors, which
autograd sums into the fused qkv tensor's gradient where q, k and v are its
column views. The mask gets no gradient.

The kernels take 1 <= Lq, Lk <= 128 and 1 <= hd <= 128, forward and
backward (``csrc/launchers.h::mha_short_takes``, which the extension
exposes): another shape raises ``ValueError`` here, before any launch.
``mha_short_launch_shape`` reads back the grid of the last launch.

``--bf16`` (the text tower on bfloat16 leaves): bfloat16 q, k and v with the
float32 causal mask launch ``mha_short_bf16`` (counted as ``mha_short.bf16``),
out float32; its backward ``mha_short_bwd_bf16`` (counted as
``mha_short_bwd.bf16``) takes the float32 cotangent and returns bfloat16 dq,
dk and dv, each rounded where the JAX function's VJP rounds it. The wrapper
takes those dtypes and float32 throughout, and raises on any other before a
launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.ops.dtypes import promote, softmax, weak

F32, BF16 = torch.float32, torch.bfloat16
# (q, k, v, attn_mask): float32 with or without a mask, or bfloat16 with a float32 mask
DTYPES = ((F32, F32, F32, None), (F32, F32, F32, F32), (BF16, BF16, BF16, F32))


def mha_short_plain(q, k, v, n_head: int, attn_mask: Optional[torch.Tensor] = None):
    """The plain version: the JAX function's einsums written out (its
    gradient is autograd's), with jnp's dtypes: on bfloat16 q, k and v,
    ``q * bfloat16(hd^-1/2)`` and the logits are rounded to bfloat16, and a
    float32 mask promotes them, so that the softmax and P V run in float32
    (v exact in it) and the output is float32; without a mask all of it is
    bfloat16, the softmax's ops each rounded."""
    N, Lq, C = q.shape
    Lk = k.shape[1]
    hd = C // n_head
    dt = promote(q, k, v)
    qh = q.to(dt).reshape(N, Lq, n_head, hd).transpose(1, 2)
    kh = k.to(dt).reshape(N, Lk, n_head, hd).transpose(1, 2)
    vh = v.to(dt).reshape(N, Lk, n_head, hd).transpose(1, 2)
    logits = torch.einsum("nhqd,nhkd->nhqk", qh * weak(hd ** -0.5, dt), kh)
    if attn_mask is not None:
        logits = logits + attn_mask   # a float32 mask promotes bfloat16 logits
    weights = softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nhkd->nhqd", weights, vh.to(weights.dtype))
    return out.transpose(1, 2).reshape(N, Lq, C)


class _MhaShort(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, attn_mask, n_head, scale, save):
        out = build.ops().mha_short(q, k, v, attn_mask, n_head, scale)
        build.count("mha_short")
        ctx.n_head, ctx.scale = n_head, scale
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(q, k, v, attn_mask)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, attn_mask = ctx.saved_tensors
        dq, dk, dv = build.ops().mha_short_bwd(grad_out.contiguous(), q, k, v, attn_mask,
                                               ctx.n_head, ctx.scale)
        build.count("mha_short_bwd")
        return dq, dk, dv, None, None, None, None


class _MhaShortBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, attn_mask, n_head, scale, save):
        out = build.ops().mha_short_bf16(q, k, v, attn_mask, n_head, scale)
        build.count("mha_short.bf16")
        ctx.n_head, ctx.scale = n_head, scale
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(q, k, v, attn_mask)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, attn_mask = ctx.saved_tensors
        dq, dk, dv = build.ops().mha_short_bwd_bf16(grad_out.contiguous(), q, k, v, attn_mask,
                                                    ctx.n_head, ctx.scale)
        build.count("mha_short_bwd.bf16")
        return dq, dk, dv, None, None, None, None


def mha_short_launch_shape(name: str) -> dict:
    """The grid of the last launch of K1's ``name`` (``mha_short``,
    ``mha_short_bwd``, ``mha_short_bf16`` or ``mha_short_bwd_bf16``) on the
    card, as its launcher made it: ``blocks``,
    ``threads``, ``smem_bytes``, the buckets ``lp`` and ``hd_bucket``, and
    ``load_bytes`` (16, or 4 where a pointer, a stride or hd is not a
    multiple of 16 bytes)."""
    return dict(build.ops().mha_short_launch_shape(name))


def mha_short(q, k, v, n_head: int, attn_mask: Optional[torch.Tensor] = None):
    """K1 on CUDA tensors; the plain version on CPU tensors.

    q/k/v may be column slices of one fused qkv tensor (each with a unit
    channel stride); the kernels read them in place."""
    if q.device.type == "cpu":
        return mha_short_plain(q, k, v, n_head, attn_mask)
    combo = build.require_cuda("mha_short", q, k, v, attn_mask, accepted=DTYPES)
    N, Lq, C = q.shape
    Lk = k.shape[1]
    hd = C // n_head
    if C % n_head or k.shape != (N, Lk, C) or v.shape != (N, Lk, C):
        raise ValueError(f"mha_short: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} n_head={n_head}")
    for t in (q, k, v):
        if t.stride(2) != 1:
            raise ValueError("mha_short: channels must be contiguous")
    if attn_mask is not None:
        if attn_mask.shape != (Lq, Lk):
            raise ValueError(f"mha_short: mask must be [{Lq}, {Lk}], got {tuple(attn_mask.shape)}")
        attn_mask = attn_mask.contiguous()
    save = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if not build.ops().mha_short_takes(Lq, Lk, hd, save):
        raise ValueError(f"mha_short: the kernels do not take Lq={Lq}, Lk={Lk}, hd={hd} "
                         f"(L <= 128 and head dim <= 128: csrc/launchers.h::mha_short_takes)")
    if DTYPES[combo][0] == BF16:
        return _MhaShortBf16.apply(q, k, v, attn_mask, n_head, weak(hd ** -0.5, BF16), save)
    return _MhaShort.apply(q, k, v, attn_mask, n_head, float(hd ** -0.5), save)
