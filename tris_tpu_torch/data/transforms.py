"""Host-side image/mask transforms (PIL + NumPy), matching the reference's
eval/train pipelines (`reference/dataset/transform.py:13-63`).

- Images: square resize to ``size x size`` with PIL bilinear (torchvision's
  ``F.resize`` on PIL images), scale to [0, 1], normalize with ImageNet
  mean/std (transform.py:61-62 — the reference deliberately uses ImageNet
  stats, not CLIP stats).
- Masks: NEAREST-resized only for training; eval keeps the original size
  (transform.py:31-33).
- Output layout is HWC float32 numpy; the model moves batches to the device
  and to NCHW itself.

Copy of the JAX package's module on the PIL path only (the native fused
decoder is not bound by this package). PIL is imported inside the functions
that use it, so importing this module needs numpy alone.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def load_transformed(path: str, size: int, normalize: bool = True) -> np.ndarray:
    """``image_to_array(load_image(path), size)``."""
    return image_to_array(load_image(path), size, normalize=normalize)


def load_transformed_u8(path: str, size: int) -> np.ndarray:
    """Decode + bilinear-resize to [size, size, 3] uint8, WITHOUT normalizing
    (the u8 feed: the model normalizes on device, ops/normalize.py)."""
    from PIL import Image

    return np.asarray(load_image(path).resize((size, size), Image.BILINEAR))


def image_to_array(img, size: int, normalize: bool = True) -> np.ndarray:
    """PIL image -> [size, size, 3] float32, normalized."""
    from PIL import Image

    img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if normalize:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr


def resize_mask_nearest(mask: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W] -> [size, size] via PIL NEAREST (InterpolationMode.NEAREST)."""
    from PIL import Image

    return np.asarray(Image.fromarray(mask.astype(np.uint8)).resize((size, size), Image.NEAREST))


def denormalize(arr: np.ndarray) -> np.ndarray:
    """Inverse of normalization, for visualization."""
    return np.clip(arr * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)
