"""K2: the BilateralPrompt cross-attention, forward (``csrc/cross_attn.cu``)
and backward (``csrc/cross_attn_bwd.cu``), and its plain PyTorch version.

Replaces the two softmax-matmul pairs of
``tris_tpu/models/fusion.py::BilateralPrompt`` (lines 85-89). The vision
projections ``qv, kv, vv`` are per image ``[N, HW, m]``; the text ones
``qt, kt, vt`` per pair ``[N*S, T, m]``, pair ``i`` belonging to image
``i // S``. Returns ``(new_vis [N*S, HW, m], new_lan [N*S, T, m])`` before
the output projections. On CUDA tensors it is a ``torch.autograd.Function``
whose backward is the hand-written kernel (with the probabilities the
forward kept, [N, HW, T] and [N, T, HW]), for one sentence per image
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


def cross_attn_launch_shape(name: str) -> dict:
    """The grid of the last launch of K2's ``name`` (``cross_attn``,
    ``cross_attn_bwd_a`` or ``cross_attn_bwd_b``, the backward's two passes)
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
    build.require_cuda_f32("cross_attn", qv, kv, vv, qt, kt, vt)
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
    if save and S != 1:
        raise ValueError(f"cross_attn: the backward takes one sentence per image (S = 1), "
                         f"got S = {S}; run S > 1 without gradients")
    return _CrossAttn.apply(*(x.contiguous() for x in inputs), S, float(div), save)
