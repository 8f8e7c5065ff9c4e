"""Building blocks with the JAX package's numerics, in PyTorch idiom.

Port of ``tris_tpu/models/layers.py``. Modules keep the reference CLIP's
parameter names (``in_proj_weight``, ``ln_1.weight``, ``running_mean``, ...)
so released checkpoints load as they are. Convolution modules are NCHW; the
attention modules work on token tensors [N, L, C], as the JAX package does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tris_tpu_torch import kernels
from tris_tpu_torch.ops.resize import bilinear_resize


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


def multi_head_attention(q, k, v, n_head: int, attn_mask: Optional[torch.Tensor] = None):
    """Scaled dot-product MHA on already-projected [N, L, C] tensors: K1
    (``kernels.mha_short``) on the card, its plain version on the host."""
    return kernels.mha_short(q, k, v, n_head, attn_mask)


class TorchMultiheadAttention(nn.Module):
    """Self-attention with ``torch.nn.MultiheadAttention``'s fused qkv
    parameters (``in_proj_weight`` [3C, C], ``out_proj``)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.chunk(3, dim=-1)          # views; K1 reads them in place
        return self.out_proj(multi_head_attention(q, k, v, self.n_head, attn_mask))


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the input dtype (eps 1e-5)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = TorchMultiheadAttention(d_model, n_head)
        self.ln_1 = LayerNormFp32(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, d_model * 4)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(d_model * 4, d_model)),
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

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

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
    biased variance, eps 1e-5 (torch ``InstanceNorm2d(affine=True)`` keys)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.dim() - 1))
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class PReLU(nn.PReLU):
    """Channel-shared PReLU, one slope initialised to 0.25 (``weight``):
    ``where(x >= 0, x, a * x)``, as the JAX package's PReLU."""


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
    applied as a Dense layer on the channel-last axis."""

    def __init__(self, in_channels: int, out_channels: int, dims: int = 2):
        super().__init__()
        conv = (nn.Conv2d if dims == 2 else nn.Conv1d)(in_channels, out_channels, 1)
        self.weight = conv.weight
        self.bias = conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """``nn.AvgPool2d(window)`` on NCHW (kernel = stride = window)."""
    return F.avg_pool2d(x, window, window)


def causal_mask(length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Additive upper-triangular -inf mask."""
    return torch.full((length, length), -torch.inf, device=device, dtype=dtype).triu(1)
