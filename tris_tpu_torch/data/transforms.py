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

Copy of the JAX package's module. A JPEG goes through the native library's
fused decode (``tris_tpu_torch.native``: one call decodes, resizes and, for
the f32 feed, normalises), bit-identical to the PIL chain; other files, and
a JPEG the decoder declines (its call returns None: CMYK, a corrupt file),
take the PIL chain. Nothing else is caught: a native library that cannot be
built raises, and one built without libjpeg sends every file to PIL, which
the ``Loader`` states once in its log. ``fast=True`` takes libjpeg's
approximate DCT-scaled decode (off by default; the JAX package reads it from
``TRIS_FAST_DECODE``). PIL is imported inside the functions that use it, so
importing this module needs numpy alone.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def native_jpeg():
    """The native binding where it was built against libjpeg, else None."""
    from tris_tpu_torch import native

    return native if native.jpeg_available() else None


def _jpeg_bytes(path: str):
    """The file's bytes where the native decoder takes it (a JPEG, and the
    library built with libjpeg), else None."""
    if not path.lower().endswith((".jpg", ".jpeg")) or native_jpeg() is None:
        return None
    with open(path, "rb") as f:
        return f.read()


def load_transformed(path: str, size: int, normalize: bool = True,
                     fast: bool = False) -> np.ndarray:
    """``image_to_array(load_image(path), size)``, bit for bit; a JPEG in one
    native call."""
    data = _jpeg_bytes(path)
    if data is not None:
        mean, std = (IMAGENET_MEAN, IMAGENET_STD) if normalize else (None, None)
        res = native_jpeg().jpeg_decode_resize_norm(data, size, mean, std, fast=fast)
        if res is not None:  # None: a file the decoder declines, for PIL
            return res[0]
    return image_to_array(load_image(path), size, normalize=normalize)


def load_transformed_u8(path: str, size: int, fast: bool = False) -> np.ndarray:
    """Decode + bilinear-resize to [size, size, 3] uint8, WITHOUT normalizing
    (the u8 feed: the model normalizes on device, ops/normalize.py), byte
    for byte PIL's; a JPEG in one native call."""
    from PIL import Image

    data = _jpeg_bytes(path)
    if data is not None:
        res = native_jpeg().jpeg_decode_resize_u8(data, size, fast=fast)
        if res is not None:  # None: a file the decoder declines, for PIL
            return res[0]
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
