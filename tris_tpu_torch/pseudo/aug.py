"""Joint image and label augmentations of IRN training, the affinity labels
of a quarter-scale ir label map, and the rescaling of the instance
pseudo-mask pass: a copy of ``tris_tpu/pseudo/aug.py`` (the reference's
``misc/imutils.py:8-167`` and ``voc12/dataloader.py:83-109``). Every random
draw comes from an explicit ``np.random.Generator``, in the JAX package's
order, so the same seed gives the same batch. PIL is imported where it is
used."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tris_tpu_torch.kernels.irn_loss import MAX_VALID


def pil_resize(img: np.ndarray, size: Tuple[int, int], order: int) -> np.ndarray:
    if size[0] == img.shape[0] and size[1] == img.shape[1]:
        return img
    from PIL import Image

    resample = Image.BICUBIC if order == 3 else Image.NEAREST
    return np.asarray(Image.fromarray(img).resize(size[::-1], resample))


def pil_rescale(img: np.ndarray, scale: float, order: int) -> np.ndarray:
    h, w = img.shape[:2]
    return pil_resize(img, (int(np.round(h * scale)), int(np.round(w * scale))), order)


def random_scale_pair(img, label, scale_range, rng: np.random.Generator):
    s = scale_range[0] + rng.random() * (scale_range[1] - scale_range[0])
    return pil_rescale(img, s, 3), pil_rescale(label, s, 0)


def random_lr_flip_pair(img, label, rng: np.random.Generator):
    if rng.integers(2):
        return np.fliplr(img), np.fliplr(label)
    return img, label


def _random_crop_box(imgsize, cropsize, rng: np.random.Generator):
    h, w = imgsize
    ch, cw = min(cropsize, h), min(cropsize, w)
    wsp, hsp = w - cropsize, h - cropsize
    if wsp > 0:
        cont_left, img_left = 0, int(rng.integers(wsp + 1))
    else:
        cont_left, img_left = int(rng.integers(-wsp + 1)), 0
    if hsp > 0:
        cont_top, img_top = 0, int(rng.integers(hsp + 1))
    else:
        cont_top, img_top = int(rng.integers(-hsp + 1)), 0
    return cont_top, cont_left, img_top, img_left, ch, cw


def _crop(img: np.ndarray, cropsize: int, default, box):
    cont_top, cont_left, img_top, img_left, ch, cw = box
    out = np.full((cropsize, cropsize) + img.shape[2:], default, dtype=img.dtype)
    out[cont_top:cont_top + ch, cont_left:cont_left + cw] = (
        img[img_top:img_top + ch, img_left:img_left + cw])
    return out


def random_crop_pair(img, label, cropsize: int, rng: np.random.Generator, defaults=(0, 255)):
    box = _random_crop_box(img.shape[:2], cropsize, rng)
    return _crop(img, cropsize, defaults[0], box), _crop(label, cropsize, defaults[1], box)


def top_left_crop(img: np.ndarray, cropsize: int, default) -> np.ndarray:
    box = (0, 0, 0, 0, min(cropsize, img.shape[0]), min(cropsize, img.shape[1]))
    return _crop(img, cropsize, default, box)


def affinity_labels_from_indices(label_map: np.ndarray, indices_from: np.ndarray,
                                 indices_to: np.ndarray, max_valid: int = MAX_VALID
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quarter-scale ir label map -> (bg_pos, fg_pos, neg) affinity labels,
    each [n_dirs, n_pairs] float32 (voc12/dataloader.py:83-109). Labels are
    {0 bg, 1 fg, 255 ignore}; 255 >= max_valid marks invalid pairs."""
    flat = label_map.reshape(-1)
    lab_from = flat[indices_from][None]
    lab_to = flat[indices_to]
    valid = (lab_from < max_valid) & (lab_to < max_valid)
    equal = lab_from == lab_to
    pos = equal & valid
    return ((pos & (lab_from == 0)).astype(np.float32), (pos & (lab_from > 0)).astype(np.float32),
            (~equal & valid).astype(np.float32))


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
