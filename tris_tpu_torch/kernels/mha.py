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
"""

from __future__ import annotations

from typing import Optional

import torch

from tris_tpu_torch.kernels import build

MAX_LEN = 128
MAX_HEAD_DIM = 128


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


def bwd_smem_bytes(Lq: int, Lk: int, hd: int) -> int:
    """Shared memory of one backward block (as ``csrc/mha_short_bwd.cu``
    lays it out): K and V padded, P and dS, and for each of its 8 warps a q
    and a dO row."""
    return 4 * (2 * Lk * (hd + 1) + 2 * Lq * (Lk + 1) + 8 * 2 * hd)


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
    if max(Lq, Lk) > MAX_LEN or hd > MAX_HEAD_DIM:
        raise ValueError(f"mha_short: L <= {MAX_LEN} and head dim <= {MAX_HEAD_DIM} "
                         f"(got Lq={Lq}, Lk={Lk}, hd={hd})")
    for t in (q, k, v):
        if t.stride(2) != 1:
            raise ValueError("mha_short: channels must be contiguous")
    if attn_mask is not None:
        if attn_mask.shape != (Lq, Lk):
            raise ValueError(f"mha_short: mask must be [{Lq}, {Lk}], got {tuple(attn_mask.shape)}")
        attn_mask = attn_mask.contiguous()
    save = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if save and bwd_smem_bytes(Lq, Lk, hd) > build.MAX_SMEM:
        raise ValueError(f"mha_short: the backward at Lq={Lq}, Lk={Lk}, hd={hd} needs "
                         f"{bwd_smem_bytes(Lq, Lk, hd)} bytes of shared memory (> {build.MAX_SMEM})")
    return _MhaShort.apply(q, k, v, attn_mask, n_head, float(hd ** -0.5), save)
