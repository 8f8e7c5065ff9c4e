"""K6, normalise half: the u8 image feed to normalised float32 NCHW
(``csrc/normalize_u8.cu``) and its plain PyTorch version.

Replaces ``tris_tpu/ops/normalize.py::image_input_to_f32`` on the u8 feed,
fused with the NHWC -> NCHW layout change the port's convolutions take:
``v * scale + bias`` per channel, with ``ops/normalize.py``'s scale and bias.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.ops.normalize import _BIAS, _SCALE, image_input_to_f32


def normalize_u8_nchw_plain(image):
    """The plain version: the NHWC multiply-add, then the permute."""
    return image_input_to_f32(image).permute(0, 3, 1, 2).contiguous()


def normalize_u8_nchw(image):
    """K6 on a CUDA tensor; the plain version on a CPU tensor.
    uint8 [B, H, W, 3] -> normalised float32 [B, 3, H, W]."""
    if image.device.type == "cpu":
        return normalize_u8_nchw_plain(image)
    if not image.is_cuda:
        raise ValueError(f"normalize_u8: expected a CUDA tensor, got {image.device}")
    if image.dtype != torch.uint8 or image.dim() != 4 or image.shape[-1] != 3:
        raise ValueError(f"normalize_u8: expected uint8 [B, H, W, 3], got {image.dtype} "
                         f"{tuple(image.shape)}")
    out = build.ops().normalize_u8(image.contiguous(), _SCALE.tolist(), _BIAS.tolist())
    build.count("normalize_u8")
    return out
