"""On-device image normalization for the u8 feed.

Images may reach the model as uint8 (1 byte a pixel, 4x less host->device
traffic than normalized float32); ``((v/255) - mean) / std`` then runs on the
device as one multiply-add per channel, the same arithmetic as the JAX
package's ``tris_tpu/ops/normalize.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# ImageNet statistics, as the reference's data pipeline uses them
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# ((v / 255) - mean) / std  ==  v * scale + bias
_SCALE = np.asarray(1.0 / (255.0 * np.asarray(IMAGENET_STD)), np.float32)
_BIAS = np.asarray(-np.asarray(IMAGENET_MEAN) / np.asarray(IMAGENET_STD), np.float32)


def image_input_to_f32(image: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> ImageNet-normalized float32; float input passes
    through unchanged (the f32 feed is already normalized)."""
    if image.dtype == torch.uint8:
        scale = torch.as_tensor(_SCALE, device=image.device)
        bias = torch.as_tensor(_BIAS, device=image.device)
        return image.float() * scale + bias
    return image
