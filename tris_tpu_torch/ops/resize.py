"""Bilinear / nearest resize with the JAX package's semantics.

The JAX package expresses resizes as interpolation matrices
(``tris_tpu/ops/resize.py``) that emulate ``F.interpolate(mode="bilinear",
antialias=False)``; here ``bilinear_resize`` is that call itself. The
matrices' per-row taps (two source indices and their weights, computed in
float64 and cast exactly as the matrices are) are what the hand-written
kernels sample with: :func:`interp_taps`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=512)
def _resize_matrix_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] row-stochastic linear interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (out_idx + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    mat[rows, lo] += (1.0 - frac).astype(np.float32)
    mat[rows, hi] += frac.astype(np.float32)
    return mat


@functools.lru_cache(maxsize=512)
def interp_taps(in_size: int, out_size: int, align_corners: bool):
    """Two-tap form of :func:`_resize_matrix_np`: ``(lo, hi, w_lo, w_hi)``
    numpy arrays of length ``out_size`` (int32, int32, f32, f32) with
    ``out[o] = w_lo[o] * x[lo[o]] + w_hi[o] * x[hi[o]]``.

    Built by the same float64 arithmetic and cast as the matrix; at the edge
    ``lo == hi`` with weights (1, 0), which the matrix holds as 1 + 0."""
    if in_size == out_size:
        idx = np.arange(out_size, dtype=np.int32)
        return idx, idx, np.ones(out_size, np.float32), np.zeros(out_size, np.float32)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), dtype=np.float64)
        else:
            src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        src = (out_idx + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    return (lo.astype(np.int32), hi.astype(np.int32),
            (1.0 - frac).astype(np.float32), frac.astype(np.float32))


def bilinear_resize(x: torch.Tensor, size: tuple, align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing two spatial dims of ``[..., H, W]`` to ``size``
    (``F.interpolate(mode="bilinear", antialias=False)``)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    lead = x.shape[:-2]
    xf = x if x.is_floating_point() else x.float()
    y = F.interpolate(xf.reshape(-1, 1, in_h, in_w), size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners, antialias=False)
    return y.reshape(*lead, out_h, out_w)


def nearest_resize(x: torch.Tensor, size: tuple, exact: bool = True) -> torch.Tensor:
    """Nearest-neighbour resize of ``[..., H, W]``.

    ``exact=True`` matches PIL / ``InterpolationMode.NEAREST`` on PIL images
    (half-pixel centres), which the reference data pipeline uses for masks;
    it is not ``F.interpolate(mode="nearest")``. ``exact=False`` is that
    call's rule (floor of ``i * in/out``)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x

    def src_index(out_size: int, in_size: int) -> np.ndarray:
        idx = np.arange(out_size, dtype=np.float64)
        scale = in_size / out_size
        if exact:
            return np.minimum(((idx + 0.5) * scale).astype(np.int64), in_size - 1)
        return np.minimum(np.floor(idx * scale).astype(np.int64), in_size - 1)

    rows = torch.as_tensor(src_index(out_h, in_h), device=x.device)
    cols = torch.as_tensor(src_index(out_w, in_w), device=x.device)
    return x.index_select(-2, rows).index_select(-1, cols)

