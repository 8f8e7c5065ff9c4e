"""Building blocks with the JAX package's numerics, in PyTorch idiom.

Port of ``tris_tpu/models/layers.py``. Modules keep the reference CLIP's
parameter names (``in_proj_weight``, ``ln_1.weight``, ``running_mean``, ...)
so released checkpoints load as they are. Convolution modules are NCHW; the
attention modules work on token tensors [N, L, C], as the JAX package does.

A module's ``dtype`` is the JAX module's: ``Dense``, ``Conv2d`` and
``Conv1x1`` cast their input and parameters to it at use (flax's
``nn.Dense`` and ``nn.Conv``; the stored parameters keep their own dtype),
the leaves the JAX module makes with ``self.param(..., self.dtype)`` are made
in it, and mixed operands promote as jnp promotes them
(``tris_tpu_torch.ops.dtypes``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tris_tpu_torch import kernels
from tris_tpu_torch.ops.dtypes import broadcast_to, low, promote, reduce_sum, weak
from tris_tpu_torch.ops.resize import bilinear_resize


class _QuickGeluLow(torch.autograd.Function):
    """QuickGELU below float32 with JAX's VJP: ``s = logistic(a x)``, ``dx =
    g s + a ((x g) (s (1 - s)))``, each op rounded to x's dtype."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-(weak(1.702, x.dtype) * x)))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + weak(1.702, x.dtype) * ((x * g) * (s * (1 - s)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: ``x * sigmoid(1.702 x)``, 1.702 in x's dtype. Below
    float32 the sigmoid is ``1 / (1 + exp(-t))``, each op rounded to x's
    dtype, as XLA expands ``lax.logistic`` on the CPU, with JAX's VJP."""
    if x.dtype == torch.float32:
        return x * torch.sigmoid(weak(1.702, x.dtype) * x)
    if low(x):
        return _QuickGeluLow.apply(x)
    return x * (1 / (1 + torch.exp(-(weak(1.702, x.dtype) * x))))


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


def multi_head_attention(q, k, v, n_head: int, attn_mask: Optional[torch.Tensor] = None):
    """Scaled dot-product MHA on already-projected [N, L, C] tensors: K1
    (``kernels.mha_short``) on the card, its plain version on the host."""
    return kernels.mha_short(q, k, v, n_head, attn_mask)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """flax's ``nn.Dense(dtype=dtype)`` with the weight in torch's [out, in]
    layout: x, weight and bias cast to ``dtype``; below float32 the product is
    rounded before the bias is added, as flax's two ops round."""
    x, weight = x.to(dtype), weight.to(dtype)
    if dtype == torch.float32 or bias is None:
        return F.linear(x, weight, None if bias is None else bias.to(dtype))
    y = F.linear(x, weight)
    return y + broadcast_to(bias.to(dtype), y.shape)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax's ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax's ``nn.Conv``): the input
    and the parameters rounded to ``dtype``, the sums in float32, the output
    rounded to ``dtype`` (cuDNN on the card; on the host the float32
    convolution of the rounded operands, rounded once, which is XLA's CPU
    convolution and sums in its order at the shapes of the tests, where
    oneDNN's bfloat16 one does not)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if dt == torch.float32 or x.device.type != "cpu":
            return self._conv_forward(x, w, b)
        return self._conv_forward(x.float(), w.float(), None if b is None else b.float()).to(dt)


class TorchMultiheadAttention(nn.Module):
    """Self-attention with ``torch.nn.MultiheadAttention``'s fused qkv
    parameters (``in_proj_weight`` [3C, C] and its bias, made in ``dtype``;
    ``out_proj``)."""

    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, dtype=dtype))
        self.out_proj = Dense(d_model, d_model, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.in_proj_weight.data = self.in_proj_weight.data.to(dtype)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # x @ in_kernel + in_bias, promoted as jnp promotes the three
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias,
                    promote(x, self.in_proj_weight, self.in_proj_bias))
        q, k, v = qkv.chunk(3, dim=-1)          # views; K1 reads them in place
        return self.out_proj(multi_head_attention(q, k, v, self.n_head, attn_mask))


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the input dtype (eps 1e-5)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP."""

    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = TorchMultiheadAttention(d_model, n_head, dtype)
        self.ln_1 = LayerNormFp32(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Dense(d_model, d_model * 4, dtype=dtype)),
            ("gelu", QuickGELU()),
            ("c_proj", Dense(d_model * 4, d_model, dtype=dtype)),
        ]))
        self.ln_2 = LayerNormFp32(d_model)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask)
        return x + self.mlp(self.ln_2(x))


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling for variable input size: the spatial part of
    the positional embedding is resized (align_corners=False) to the input's
    (H, W), a mean token is prepended, and full self-attention runs over
    HW+1 tokens. NCHW in; returns ``(global [N, out], map [N, out, H, W])``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            (torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5).to(dtype))
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.c_proj = Dense(embed_dim, output_dim, dtype=dtype)

    def forward(self, x: torch.Tensor):
        N, C, H, W = x.shape
        tokens = x.flatten(2).transpose(1, 2)                      # [N, HW, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        pos = self.positional_embedding
        spatial = pos[1:].reshape(1, self.spacial_dim, self.spacial_dim, C).permute(0, 3, 1, 2)
        spatial = bilinear_resize(spatial, (H, W), align_corners=False)
        spatial = spatial.reshape(C, H * W).T
        tokens = tokens + torch.cat([pos[:1], spatial], dim=0)[None].to(tokens.dtype)
        out = multi_head_attention(self.q_proj(tokens), self.k_proj(tokens), self.v_proj(tokens),
                                   self.num_heads)
        out = self.c_proj(out)                                     # [N, HW+1, out]
        fmap = out[:, 1:].transpose(1, 2).reshape(N, -1, H, W)
        return out[:, 0], fmap


class InstanceNorm2d(nn.Module):
    """Affine instance norm over the token layout [N, HW, C] (or [N, H, W, C])
    the fusion works in: statistics over every axis but the first and last,
    biased variance, eps 1e-5 (torch ``InstanceNorm2d(affine=True)`` keys;
    weight and bias made in ``dtype``).

    As jnp's ``mean`` and ``var`` on x's dtype: both in float32 from x (the
    variance about the float32 mean), each rounded once to x's dtype; then
    ``(x - mean) * rsqrt(var + eps)`` in x's dtype, times the weight plus the
    bias promoted with theirs."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.dim() - 1))
        if not low(x):
            mean = x.mean(dim=dims, keepdim=True)
            var = (x - mean).square().mean(dim=dims, keepdim=True)
            y = (x - mean) * torch.rsqrt(var + self.eps)
        else:
            y = _InstanceNormLow.apply(x, dims, weak(self.eps, x.dtype))
        y = y.to(promote(y, self.weight))
        return y * broadcast_to(self.weight, y.shape) + broadcast_to(self.bias, y.shape)


class _InstanceNormLow(torch.autograd.Function):
    """The normalisation of :class:`InstanceNorm2d` below float32 and JAX's
    VJP of ``jnp.mean``, ``jnp.var`` and ``(x - mean) * rsqrt(var + eps)`` on
    x's dtype: bfloat16 ops each rounded, the statistics' cotangents in
    float32, rounded where JAX converts them."""

    @staticmethod
    def forward(ctx, x, dims, eps):
        xf = x.float()
        n = torch.tensor(float(xf[0].numel() // xf.shape[-1]))
        mean = xf.mean(dim=dims, keepdim=True)
        t = xf - mean
        var = t.square().mean(dim=dims, keepdim=True).to(x.dtype)
        d = x - mean.to(x.dtype)
        ve = var + eps
        r = torch.rsqrt(ve)
        ctx.dims = dims
        ctx.save_for_backward(d, r, ve, t, n)
        return d * r

    @staticmethod
    def backward(ctx, g):
        d, r, ve, t, n = ctx.saved_tensors
        dims, low = ctx.dims, g.dtype
        dr = reduce_sum(d * g, dims)
        dd = g * r
        dve = dr * (-0.5 * (r / ve))
        dmean = reduce_sum(-dd, dims)
        tt = 2 * t
        cj = (dve.float() / n) * tt
        dvar = (cj + (-cj).sum(dim=dims, keepdim=True) / n).to(low)
        return (dd + dvar) + (dmean.float() / n).to(low), None, None


class PReLU(nn.PReLU):
    """Channel-shared PReLU, one slope initialised to 0.25 (``weight``, made
    in ``dtype`` as the JAX module makes ``alpha``): ``where(x >= 0, x, a *
    x)``, as the JAX package's PReLU."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__(dtype=dtype)


class TorchBatchNorm(nn.Module):
    """BatchNorm2d (NCHW) with a folded eval path, and the activation that
    follows it fused: K13 (``kernels.batch_norm_act``) on the card, its
    plain version on the host.

    Eval: ``(running_mean, running_var, weight, bias)`` fold into one
    per-channel affine ``x * a + b``, exactly as the JAX package computes it
    (``rsqrt`` then two products); ``F.batch_norm`` rounds differently, and
    the difference grows through 16 bottlenecks. Train: batch statistics,
    the running variance updated with the unbiased batch variance (torch's
    rule), eps 1e-5, momentum 0.1. With ``update_stats`` False a train-mode
    forward normalises by the batch statistics and leaves the buffers as
    they are: the stage-2 EMA teacher's (the JAX package discards the
    statistics its teacher forward returns; its buffers move only through
    the EMA). ``forward(x, act, slope, residual)``: ``act`` "none", "relu"
    (after adding ``residual``, where given) or "prelu" (``slope`` its
    weight)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, act: str = "none", slope: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        update = self.training and self.update_stats
        if update:
            self.num_batches_tracked.add_(1)
        return kernels.batch_norm_act(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training=self.training, update_stats=update, momentum=self.momentum, eps=self.eps,
            act=act, slope=slope, residual=residual)


class Conv1x1(nn.Module):
    """A 1x1 convolution kept in the reference's Conv2d layout (``weight``
    [out, in, 1, 1]; with ``dims=1`` its Conv1d layout [out, in, 1]) and
    applied as a Dense layer (computing in ``dtype``) on the channel-last axis."""

    def __init__(self, in_channels: int, out_channels: int, dims: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = (nn.Conv2d if dims == 2 else nn.Conv1d)(in_channels, out_channels, 1)
        self.weight = conv.weight
        self.bias = conv.bias
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight.flatten(1), self.bias, self.compute_dtype)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """``nn.AvgPool2d(window)`` on NCHW (kernel = stride = window). Below
    float32 as flax's ``avg_pool``: the window summed in x's dtype, each add
    rounded (``lax.reduce_window``'s accumulator is x's dtype), rows then
    columns, then divided by the window's size."""
    if x.dtype == torch.float32:
        return F.avg_pool2d(x, window, window)
    H, W = x.shape[-2] // window * window, x.shape[-1] // window * window
    acc = None
    for dy in range(window):
        for dx in range(window):
            t = x[..., dy:H:window, dx:W:window]
            acc = t if acc is None else acc + t
    return acc / window ** 2


def causal_mask(length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Additive upper-triangular -inf mask."""
    return torch.full((length, length), -torch.inf, device=device, dtype=dtype).triu(1)
