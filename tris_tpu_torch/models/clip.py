"""Modified CLIP backbone (ResNet and ViT vision towers), NCHW.

Port of ``tris_tpu/models/clip.py`` (the reference's surgically modified
OpenAI CLIP): ``ModifiedResNet`` returns the pyramid ``(c1, c2, c3, c4)``
plus, when asked for, the attention pool's ``(global, map)``;
``VisionTransformer`` (the ViT-B/32 critic) returns the projected CLS
embedding; ``encode_text`` returns the token sequence after ``ln_final`` and
the EOT embedding projected by ``text_projection``, with the causal mask
built at the ids' length. Module tree and ``state_dict`` keys follow the
reference CLIP (``visual.layer1.0.conv1.weight``, ``visual.conv1.weight``,
``transformer.resblocks.0.attn.in_proj_weight``, ...). ``dtype`` is the JAX
module's (``tris_tpu_torch.models.layers``); the ResNet and the text tower
take bfloat16, the ViT float32 only.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tris_tpu_torch.models.layers import (
    AttentionPool2d,
    Conv2d,
    LayerNormFp32,
    ResidualAttentionBlock,
    TorchBatchNorm,
    avg_pool,
    causal_mask,
)
from tris_tpu_torch.ops.dtypes import promote


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    transformer_width: int
    transformer_heads: int
    transformer_layers: int
    context_length: int = 77
    txt_length: int = 20
    vocab_size: int = 49408

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64


CLIP_CONFIGS = {
    "RN50": CLIPConfig(
        embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3), vision_width=64,
        vision_patch_size=None, transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "RN101": CLIPConfig(
        embed_dim=512, image_resolution=224, vision_layers=(3, 4, 23, 3), vision_width=64,
        vision_patch_size=None, transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "ViT-B-32": CLIPConfig(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=32, transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
    "ViT-B-16": CLIPConfig(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=16, transformer_width=512, transformer_heads=8, transformer_layers=12,
    ),
}


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dtype: torch.dtype = torch.float32) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False,
                  dtype=dtype)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: the stride lives in an avgpool after
    conv2, and the downsample path is avgpool -> 1x1 conv -> BN."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, dtype=dtype)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, dtype=dtype)
        self.bn2 = TorchBatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1, dtype=dtype)
        self.bn3 = TorchBatchNorm(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", _AvgPool(stride) if stride > 1 else nn.Identity()),
                ("0", _conv(inplanes, out_ch, 1, dtype=dtype)),
                ("1", TorchBatchNorm(out_ch)),
            ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x), act="relu")
        h = self.bn2(self.conv2(h), act="relu")
        if self.stride > 1:
            h = avg_pool(h, self.stride)
        identity = x if self.downsample is None else self.downsample(x)
        return self.bn3(self.conv3(h), act="relu", residual=identity)


class _AvgPool(nn.Module):
    """:func:`avg_pool` as a module (the downsample path's, no parameters)."""

    def __init__(self, window: int):
        super().__init__()
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(x, self.window)


class ModifiedResNet(nn.Module):
    """CLIP ResNet trunk returning the full pyramid."""

    def __init__(self, layers, output_dim: int, heads: int, input_resolution: int = 224,
                 width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(3, width // 2, 3, 2, dtype=dtype)
        self.bn1 = TorchBatchNorm(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3, dtype=dtype)
        self.bn2 = TorchBatchNorm(width // 2)
        self.conv3 = _conv(width // 2, width, 3, dtype=dtype)
        self.bn3 = TorchBatchNorm(width)
        inplanes = width
        for stage, (planes, blocks, stride) in enumerate(
                [(width, layers[0], 1), (width * 2, layers[1], 2),
                 (width * 4, layers[2], 2), (width * 8, layers[3], 2)], start=1):
            mods = []
            for i in range(blocks):
                mods.append(Bottleneck(inplanes, planes, stride if i == 0 else 1, dtype=dtype))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*mods))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim,
                                        dtype)

    def forward(self, x: torch.Tensor, pool: bool = True):
        """x: NCHW. Returns ``(c1, c2, c3, c4, (global, map))``; with
        ``pool=False`` the attention pool does not run and the last entry is
        None. Both stage-1 paths discard it (XLA drops it as dead code in the
        JAX package; eager PyTorch would compute it)."""
        x = self.bn1(self.conv1(x), act="relu")
        x = self.bn2(self.conv2(x), act="relu")
        x = self.bn3(self.conv3(x), act="relu")
        x = avg_pool(x, 2)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        c4 = self.layer4(c3)
        return c1, c2, c3, c4, (self.attnpool(c4) if pool else None)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads, dtype)
                                        for _ in range(layers)])

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, attn_mask)
        return x


class PatchEmbed(nn.Module):
    """ViT patch embedding: the stride == patch convolution written as one
    product ``A @ weight.reshape(width, -1).T`` over the patch matrix A
    [N*grid^2, 3*ps*ps], as the JAX package's ``PatchEmbed`` does. ``weight``
    keeps the reference's conv layout, OIHW [width, 3, ps, ps] without bias,
    so A's columns run (c, py, px)."""

    def __init__(self, patch_size: int, width: int, in_channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        fan_in = in_channels * patch_size * patch_size
        self.weight = nn.Parameter(
            torch.randn(width, in_channels, patch_size, patch_size) * fan_in ** -0.5)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW image -> the patch matrix A [N*grid^2, C*ps*ps]."""
        N, C, H, W = x.shape
        ps = self.patch_size
        p = x.reshape(N, C, H // ps, ps, W // ps, ps).permute(0, 2, 4, 1, 3, 5)
        return p.reshape(N * (H // ps) * (W // ps), C * ps * ps)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        return a @ self.weight.reshape(self.weight.shape[0], -1).T


class VisionTransformer(nn.Module):
    """Plain CLIP ViT returning the projected CLS embedding; the frozen
    critic (ViT-B/32) of PRMS and of the stage-1 losses."""

    def __init__(self, input_resolution: int, patch_size: int, width: int, layers: int,
                 heads: int, output_dim: int):
        super().__init__()
        self.grid = input_resolution // patch_size
        scale = width ** -0.5
        self.conv1 = PatchEmbed(patch_size, width)
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(scale * torch.randn(self.grid ** 2 + 1, width))
        self.ln_pre = LayerNormFp32(width)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = LayerNormFp32(width)
        self.proj = nn.Parameter(scale * torch.randn(width, output_dim))

    def forward_patches(self, a: torch.Tensor) -> torch.Tensor:
        """Patch matrix A [N*grid^2, 3*ps*ps] (as K5 writes it) -> [N, output_dim]."""
        x = self.conv1(a)
        width = x.shape[-1]
        x = x.reshape(-1, self.grid ** 2, width)
        cls = self.class_embedding.expand(x.shape[0], 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW image at ``input_resolution`` -> [N, output_dim]."""
        return self.forward_patches(self.conv1.patchify(x))


class CLIP(nn.Module):
    """CLIP with the reference's modified outputs; ``dtype`` as the JAX
    module's (bfloat16 for a ResNet CLIP only: the ViT critic stays float32,
    as the JAX package builds it)."""

    def __init__(self, config: CLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.compute_dtype = dtype
        if cfg.is_vit:
            if dtype != torch.float32:
                raise NotImplementedError(f"CLIP: the ViT takes float32, not {dtype}")
            self.visual = VisionTransformer(cfg.image_resolution, cfg.vision_patch_size,
                                            cfg.vision_width, cfg.vision_layers,
                                            cfg.vision_heads, cfg.embed_dim)
        else:
            self.visual = ModifiedResNet(cfg.vision_layers, cfg.embed_dim, cfg.vision_heads,
                                         cfg.image_resolution, cfg.vision_width, dtype)
        self.transformer = Transformer(cfg.transformer_width, cfg.transformer_layers,
                                       cfg.transformer_heads, dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.transformer_width)
        self.positional_embedding = nn.Parameter(
            (torch.randn(cfg.context_length, cfg.transformer_width) * 0.01).to(dtype))
        self.ln_final = LayerNormFp32(cfg.transformer_width)
        self.text_projection = nn.Parameter(
            (torch.randn(cfg.transformer_width, cfg.embed_dim)
             * cfg.transformer_width ** -0.5).to(dtype))
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, image: torch.Tensor, pool: bool = True):
        """image: NCHW float. ResNet: ``(c1, c2, c3, c4, (global, map) or
        None)``; ViT: the global embedding [N, embed_dim] (``pool`` unused)."""
        if self.config.is_vit:
            return self.visual(image)
        return self.visual(image, pool=pool)

    def encode_text(self, text_ids: torch.Tensor):
        """text_ids: [N, L] int -> ``(seq [N, L, width], eot_embed [N, embed_dim])``."""
        L = text_ids.shape[1]
        # flax's nn.Embed(dtype): the rows gathered, then cast; plus the embedding promoted
        emb = F.embedding(text_ids.long(), self.token_embedding.weight).to(self.compute_dtype)
        x = emb + self.positional_embedding[:L]
        x = self.transformer(x, causal_mask(L, device=x.device))
        x = self.ln_final(x)
        # EOT token = the first position of the highest id in each row
        eot = x[torch.arange(x.shape[0], device=x.device), text_ids.argmax(dim=-1)]
        dt = promote(eot, self.text_projection)
        return x, eot.to(dt) @ self.text_projection.to(dt)
