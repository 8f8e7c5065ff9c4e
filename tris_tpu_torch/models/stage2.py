"""Stage-2 TRIS: the pseudo-supervised encoder-decoder segmentation network.

Port of ``tris_tpu/models/stage2.py::TRISStage2`` (the reference's
model/model_stage2.py): the CLIP pyramid fused with the expression by
``PixelAttention`` at c2, c3 and c4 (plus the residual), an FPN-style
top-down decoder and four side outputs upsampled to the input size. The
pixel-word attention is K11 (``kernels.pixel_attn``), the decoder's
bilinear upsamples (``align_corners=False``) K6 (``kernels.bilinear_resize``)
and the text tower K1. Modules keep the reference's keys
(``reduced_c1.{conv,bn,relu}``, ``final_seg1.{0,1}``, ``attention2.Wk``...),
so a released stage-2 ``.pth`` loads as it is.

BatchNorm follows the module's mode, as stage 1's does: ``model.train()``
for batch statistics and the four side outputs (the JAX package's
``train=True``), ``model.eval()`` for running statistics and ``out1``.

``dtype`` is the JAX module's (``tris_tpu_torch.models.layers``): with
bfloat16 (``--bf16``, eval), the convolutions compute in bfloat16, K11, K6's
upsamples and K13's eval fold with PReLU run on bfloat16 operands, and the
PReLU slopes and the InstanceNorms' leaves are made in bfloat16; a float32
checkpoint's leaves promote where jnp promotes (a float32 slope makes its
``ConvBNRelu``'s output float32). The logits are in the dtype the last 1x1
convolution gives, bfloat16; ``validate`` and the demo cast them to float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tris_tpu_torch import kernels
from tris_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, CLIPConfig
from tris_tpu_torch.models.fusion import PixelAttention
from tris_tpu_torch.models.layers import Conv2d, PReLU, TorchBatchNorm


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    backbone: str = "RN50"
    txt_length: int = 20
    clip_override: Optional[CLIPConfig] = None  # for tests / custom backbones

    @property
    def clip_config(self) -> CLIPConfig:
        base = self.clip_override or CLIP_CONFIGS[self.backbone]
        return dataclasses.replace(base, txt_length=self.txt_length)


class ConvBNRelu(nn.Module):
    """3x3 conv without bias, BatchNorm, PReLU (model_stage2.py:11-27); the
    norm and the PReLU are one K13 call (``relu`` keeps the slope)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, padding=(kernel - 1) // 2,
                           bias=False, dtype=dtype)
        self.bn = TorchBatchNorm(out_channels)
        self.relu = PReLU(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the fusion hands reduced_c2..4 a channels-last view, whose convolution cuDNN lays
        # out channels-last too; K13 takes NCHW
        return self.bn(self.conv(x).contiguous(), act="prelu", slope=self.relu.weight)


class SegHead(nn.Sequential):
    """ConvBNRelu, then a 1x1 conv to one channel (the final_seg heads,
    model_stage2.py:74-85)."""

    def __init__(self, in_channels: int, mid: int, dtype: torch.dtype = torch.float32):
        super().__init__(ConvBNRelu(in_channels, mid, dtype=dtype),
                         Conv2d(mid, 1, 1, bias=False, dtype=dtype))


def _up_to(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear NCHW upsample, align_corners=False (model/utils.py:5-10)."""
    return kernels.bilinear_resize(x, hw, align_corners=False)


def _per_pair(pairs: torch.Tensor, images: torch.Tensor, S: int) -> torch.Tensor:
    """``pairs`` [N*S, ...] plus ``images`` [N, ...], image i // S to pair i."""
    rest = pairs.shape[1:]
    return (pairs.reshape(-1, S, *rest) + images[:, None]).reshape(-1, *rest)


class TRISStage2(nn.Module):
    def __init__(self, config: Stage2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        ccfg = config.clip_config
        self.backbone = CLIP(ccfg, dtype)
        lan = ccfg.transformer_width                       # 512 for RN50/RN101
        w = ccfg.vision_width
        v = (w * 4, w * 8, w * 16, w * 32)                 # (256, 512, 1024, 2048) at w = 64
        self.attention2 = PixelAttention(v[1], lan, dtype)
        self.attention3 = PixelAttention(v[2], lan, dtype)
        self.attention4 = PixelAttention(v[3], lan, dtype)
        self.reduced_c1 = ConvBNRelu(v[0], 64, dtype=dtype)
        self.reduced_c2 = ConvBNRelu(v[1], 128, dtype=dtype)
        self.reduced_c3 = ConvBNRelu(v[2], 256, dtype=dtype)
        self.reduced_c4 = ConvBNRelu(v[3], 512, dtype=dtype)
        self.output4 = ConvBNRelu(512, 256, dtype=dtype)
        self.output3 = ConvBNRelu(256, 128, dtype=dtype)
        self.output2 = ConvBNRelu(128, 64, dtype=dtype)
        self.output1 = ConvBNRelu(64, 32, dtype=dtype)
        self.final_seg1 = SegHead(32, 32, dtype)
        self.final_seg2 = SegHead(64, 32, dtype)
        self.final_seg3 = SegHead(128, 64, dtype)
        self.final_seg4 = SegHead(256, 64, dtype)

    def forward(self, image: torch.Tensor, word_ids: torch.Tensor):
        """image [B, 3, H, W], word_ids [B, L] -> logits: in train mode the
        four side outputs ``(out1, out2, out3, out4)``, each [B, 1, H, W];
        in eval mode ``out1``."""
        word_embedding, _ = self.backbone.encode_text(word_ids)       # [B, T, 512]
        c1, c2, c3, c4, _ = self.backbone.encode_image(image, pool=False)
        return self._decode(c1, c2, c3, c4, word_embedding, 1, image.shape[2:],
                            side=self.training)

    def response_maps(self, image: torch.Tensor, word_ids: torch.Tensor) -> torch.Tensor:
        """Per-(image, sentence) eval logits: [B, 3, H, W] x [B, S, L] ->
        [B, S, H, W] (call ``model.eval()`` first, as ``validate`` does).

        The trunk runs once per image; so do ``reduced_c1`` and each
        PixelAttention's per-image half. Everything per pair after them
        (BatchNorm at its running statistics included) is per sample, so this
        equals the reference's batch-1 forward per sentence, and the JAX
        package's pyramid repeated S times."""
        B, S, L = word_ids.shape
        word_embedding, _ = self.backbone.encode_text(word_ids.reshape(B * S, L))
        c1, c2, c3, c4, _ = self.backbone.encode_image(image, pool=False)
        out = self._decode(c1, c2, c3, c4, word_embedding, S, image.shape[2:], side=False)
        return out.reshape(B, S, *image.shape[2:])

    def _fuse(self, attention: PixelAttention, c: torch.Tensor, lan: torch.Tensor, S: int):
        """``attention(c) + c`` per pair, back to NCHW [N*S, C, h, w]."""
        N, C, h, w = c.shape
        v = c.flatten(2).transpose(1, 2)                              # [N, hw, C]
        f = _per_pair(attention(v, lan, S), v, S)
        return f.transpose(1, 2).reshape(N * S, C, h, w)

    def _decode(self, c1, c2, c3, c4, word_embedding, S: int, hw, side: bool):
        f2 = self._fuse(self.attention2, c2, word_embedding, S)
        f3 = self._fuse(self.attention3, c3, word_embedding, S)
        f4 = self._fuse(self.attention4, c4, word_embedding, S)

        dem1 = self.reduced_c1(c1)                                    # per image
        dem2 = self.reduced_c2(f2)
        dem3 = self.reduced_c3(f3)
        dem4 = self.reduced_c4(f4)

        seg4 = _up_to(self.output4(dem4), dem3.shape[2:])
        seg3 = _up_to(self.output3(seg4 + dem3), dem2.shape[2:])
        seg2 = _up_to(self.output2(seg3 + dem2), dem1.shape[2:])
        seg1 = self.output1(_per_pair(seg2, dem1, S))

        out1 = _up_to(self.final_seg1(seg1), hw)
        if not side:
            return out1
        out2 = _up_to(self.final_seg2(seg2), hw)
        out3 = _up_to(self.final_seg3(seg3), hw)
        out4 = _up_to(self.final_seg4(seg4), hw)
        return out1, out2, out3, out4
