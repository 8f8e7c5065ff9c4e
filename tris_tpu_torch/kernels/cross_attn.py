"""K2: the BilateralPrompt cross-attention (``csrc/cross_attn.cu``) and its
plain PyTorch version.

Replaces the two softmax-matmul pairs of
``tris_tpu/models/fusion.py::BilateralPrompt`` (lines 85-89). The vision
projections ``qv, kv, vv`` are per image ``[N, HW, m]``; the text ones
``qt, kt, vt`` per pair ``[N*S, T, m]``, pair ``i`` belonging to image
``i // S``. Returns ``(new_vis [N*S, HW, m], new_lan [N*S, T, m])`` before
the output projections.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build


def cross_attn_plain(qv, kv, vv, qt, kt, vt, S: int, div: float):
    """The plain version: the JAX einsums, with pairs as [N, S, ...]."""
    N, HW, m = qv.shape
    T = qt.shape[1]
    qt, kt, vt = (x.reshape(N, S, T, m) for x in (qt, kt, vt))
    av = torch.softmax(torch.einsum("npm,nstm->nspt", qv, kt) / div, dim=3)
    at = torch.softmax(torch.einsum("nstm,npm->nstp", qt, kv) / div, dim=3)
    new_vis = torch.einsum("nspt,nstm->nspm", av, vt)
    new_lan = torch.einsum("nstp,npm->nstm", at, vv)
    return new_vis.reshape(N * S, HW, m), new_lan.reshape(N * S, T, m)


def cross_attn(qv, kv, vv, qt, kt, vt, S: int, div: float):
    """K2 on CUDA tensors (two launches); the plain version on CPU tensors."""
    if qv.device.type == "cpu":
        return cross_attn_plain(qv, kv, vv, qt, kt, vt, S, div)
    build.require_cuda_f32("cross_attn", qv, kv, vv, qt, kt, vt)
    N, HW, m = qv.shape
    P, T = qt.shape[0], qt.shape[1]
    if P != N * S or kv.shape != qv.shape or vv.shape != qv.shape or \
            kt.shape != qt.shape or vt.shape != qt.shape or qt.shape[2] != m:
        raise ValueError(f"cross_attn: bad shapes qv{tuple(qv.shape)} qt{tuple(qt.shape)} S={S}")
    if 4 * (m + HW + 32) > 227 * 1024 or 4 * T > 227 * 1024:
        raise ValueError(f"cross_attn: m + HW = {m + HW} and T = {T} must fit shared memory")
    qv, kv, vv, qt, kt, vt = (x.contiguous() for x in (qv, kv, vv, qt, kt, vt))
    new_vis, new_lan = build.ops().cross_attn(qv, kv, vv, qt, kt, vt, S, float(div))
    build.count("cross_attn", n=2)
    return new_vis, new_lan
