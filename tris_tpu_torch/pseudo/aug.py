"""Image rescaling for the instance pseudo-mask pass: a copy of the parts of
``tris_tpu/pseudo/aug.py`` that ``pipeline._ins_seg_load`` needs (PIL
bicubic / nearest resizes, the multi-scale flip stacks). PIL is imported
where it is used."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pil_resize(img: np.ndarray, size: Tuple[int, int], order: int) -> np.ndarray:
    if size[0] == img.shape[0] and size[1] == img.shape[1]:
        return img
    from PIL import Image

    resample = Image.BICUBIC if order == 3 else Image.NEAREST
    return np.asarray(Image.fromarray(img).resize(size[::-1], resample))


def pil_rescale(img: np.ndarray, scale: float, order: int) -> np.ndarray:
    h, w = img.shape[:2]
    return pil_resize(img, (int(np.round(h * scale)), int(np.round(w * scale))), order)


def multi_scale_flip_stacks(img: np.ndarray, scales=(1.0,)) -> list:
    """Per-scale left-right flip stacks of a raw (uint8) HWC image
    (``ReferClassificationDatasetMSF.__getitem__``, voc12/dataloader.py:304-348
    of the reference, which rescales the raw image and normalises after):
    ``[[2, H_s, W_s, C] float32 per scale]``, index 0 the image at that scale
    (bicubic for s != 1), index 1 its flip."""
    out = []
    for s in scales:
        s_img = (img if s == 1 else pil_rescale(img, s, 3)).astype(np.float32)
        out.append(np.stack([s_img, s_img[:, ::-1]], axis=0))
    return out
