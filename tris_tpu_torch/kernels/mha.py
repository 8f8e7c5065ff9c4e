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
"""

from __future__ import annotations

from typing import Optional

import torch

from tris_tpu_torch.kernels import build


def mha_short_plain(q, k, v, n_head: int, attn_mask: Optional[torch.Tensor] = None):
    """The plain version: the JAX function's einsums written out (its
    gradient is autograd's)."""
    N, Lq, C = q.shape
    Lk = k.shape[1]
    hd = C // n_head
    qh = q.reshape(N, Lq, n_head, hd).transpose(1, 2)
    kh = k.reshape(N, Lk, n_head, hd).transpose(1, 2)
    vh = v.reshape(N, Lk, n_head, hd).transpose(1, 2)
    logits = torch.einsum("nhqd,nhkd->nhqk", qh * (hd ** -0.5), kh)
    if attn_mask is not None:
        logits = logits + attn_mask
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nhkd->nhqd", weights, vh)
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


def mha_short_launch_shape(name: str) -> dict:
    """The grid of the last launch of K1's ``name`` (``mha_short`` or
    ``mha_short_bwd``) on the card, as its launcher made it: ``blocks``,
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
    build.require_cuda_f32("mha_short", q, k, v, attn_mask)
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
    return _MhaShort.apply(q, k, v, attn_mask, n_head, float(hd ** -0.5), save)
