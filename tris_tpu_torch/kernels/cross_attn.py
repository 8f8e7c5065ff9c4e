"""K2: the BilateralPrompt cross-attention, forward (``csrc/cross_attn.cu``)
and backward (``csrc/cross_attn_bwd.cu``), and its plain PyTorch version.

Replaces the two softmax-matmul pairs of
``tris_tpu/models/fusion.py::BilateralPrompt`` (lines 85-89). The vision
projections ``qv, kv, vv`` are per image ``[N, HW, m]``; the text ones
``qt, kt, vt`` per pair ``[N*S, T, m]``, pair ``i`` belonging to image
``i // S``. Returns ``(new_vis [N*S, HW, m], new_lan [N*S, T, m])`` before
the output projections. On CUDA tensors it is a ``torch.autograd.Function``
whose backward is the hand-written kernel, for one sentence per image
(S = 1, training's shape): with S > 1 a pair's gradient would have to be
summed into its image's, and no path differentiates ``response_maps``, so
the wrapper refuses it.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build


def cross_attn_plain(qv, kv, vv, qt, kt, vt, S: int, div: float):
    """The plain version: the JAX einsums, with pairs as [N, S, ...] (its
    gradient is autograd's)."""
    N, HW, m = qv.shape
    T = qt.shape[1]
    qt, kt, vt = (x.reshape(N, S, T, m) for x in (qt, kt, vt))
    av = torch.softmax(torch.einsum("npm,nstm->nspt", qv, kt) / div, dim=3)
    at = torch.softmax(torch.einsum("nstm,npm->nstp", qt, kv) / div, dim=3)
    new_vis = torch.einsum("nspt,nstm->nspm", av, vt)
    new_lan = torch.einsum("nstp,npm->nstm", at, vv)
    return new_vis.reshape(N * S, HW, m), new_lan.reshape(N * S, T, m)


class _CrossAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qv, kv, vv, qt, kt, vt, S, div, save):
        new_vis, new_lan = build.ops().cross_attn(qv, kv, vv, qt, kt, vt, S, div)
        build.count("cross_attn", n=2)
        ctx.div = div
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(qv, kv, vv, qt, kt, vt)
        return new_vis, new_lan

    @staticmethod
    def backward(ctx, g_vis, g_lan):
        grads = build.ops().cross_attn_bwd(g_vis.contiguous(), g_lan.contiguous(),
                                           *ctx.saved_tensors, ctx.div)
        build.count("cross_attn_bwd", n=4)
        return (*grads, None, None, None)


def cross_attn(qv, kv, vv, qt, kt, vt, S: int, div: float):
    """K2 on CUDA tensors (two launches forward, four backward); the plain
    version on CPU tensors."""
    if qv.device.type == "cpu":
        return cross_attn_plain(qv, kv, vv, qt, kt, vt, S, div)
    build.require_cuda_f32("cross_attn", qv, kv, vv, qt, kt, vt)
    N, HW, m = qv.shape
    P, T = qt.shape[0], qt.shape[1]
    if P != N * S or kv.shape != qv.shape or vv.shape != qv.shape or \
            kt.shape != qt.shape or vt.shape != qt.shape or qt.shape[2] != m:
        raise ValueError(f"cross_attn: bad shapes qv{tuple(qv.shape)} qt{tuple(qt.shape)} S={S}")
    if 4 * (m + HW + 32) > build.MAX_SMEM or 4 * T > build.MAX_SMEM:
        raise ValueError(f"cross_attn: m + HW = {m + HW} and T = {T} must fit shared memory")
    inputs = (qv, kv, vv, qt, kt, vt)
    save = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    if save and S != 1:
        raise ValueError(f"cross_attn: the backward takes one sentence per image (S = 1), "
                         f"got S = {S}; run S > 1 without gradients")
    if save and 4 * 8 * (m + max(HW, T)) > build.MAX_SMEM:
        raise ValueError(f"cross_attn: the backward's tiles of m = {m} channels must fit "
                         f"shared memory")
    return _CrossAttn.apply(*(x.contiguous() for x in inputs), S, float(div), save)
