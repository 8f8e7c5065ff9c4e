"""K8: IRNet's affinity and displacement losses as masked sums with the pair
labels built from the label map: the plain PyTorch version, its constants
and its pieces. On the card K8 is fused with K7 (``kernels/irn_affinity.py``,
``csrc/irn_affinity.cu``), so no affinity field is written there.

Replaces ``tris_tpu/pseudo/train_irn.py::affinity_labels_on_device`` and the
masked sums of ``irn_loss`` (lines 91-157), with the loss fields of
``tris_tpu/pseudo/irnet.py::affinity_displacement_losses``. From the
quarter-scale ir label map (uint8: 0 bg, 1 fg, 255 ignore), K7's affinity
``[B, n_dirs, ch, cw]`` and the displacement field ``[B, 2, H, W]`` it
returns the five sums (the bg-positive, fg-positive and negative affinity
losses, the fg and bg displacement losses) and the three pair counts (bg
positive, fg positive, negative) as int64: at B = 24 a mask has 47.7 M
entries, beyond float32's exact integers, where the JAX package's float32
``mask.sum()`` depends on the order of its sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tris_tpu_torch.kernels import build

# the losses' constants as the JAX package's float32 arithmetic rounds them:
# ``aff + 1e-5`` and ``1.0 + 1e-5 - aff``
EPS = float(np.float32(1e-5))
ONE_EPS = float(np.float32(1.0 + 1e-5))
# a pair is valid where both its ir labels are below this (0 bg, 1 fg, 255 ignore): the one
# threshold of the port's pair labels, host (pseudo/aug.py) and card alike
MAX_VALID = 21


def src_window(x, rf: int):
    """``x [..., H, W]`` -> the pairs' source window ``[..., H - rf, W - 2 rf]``."""
    H, W = x.shape[-2:]
    return x[..., :H - rf, rf:W - rf]


def dst_windows(x, search_dst, rf: int):
    """``x [..., H, W]`` -> every direction's destination window
    ``[..., n_dirs, H - rf, W - 2 rf]`` (``search_dst`` [n_dirs, 2] (dy, dx))."""
    H, W = x.shape[-2:]
    ch, cw = H - rf, W - 2 * rf
    return torch.stack([x[..., dy:dy + ch, rf + dx:rf + dx + cw]
                        for dy, dx in np.asarray(search_dst).tolist()], dim=-3)


def pair_labels_plain(labels, search_dst, rf: int):
    """(bg_pos, fg_pos, neg) boolean ``[B, n_dirs, ch, cw]`` from the label
    map ``[B, H, W]``: the JAX package's static-slice build."""
    lab_from = src_window(labels, rf)[:, None]
    lab_to = dst_windows(labels, search_dst, rf)
    valid = (lab_from < MAX_VALID) & (lab_to < MAX_VALID)
    equal = lab_from == lab_to
    pos = equal & valid
    return pos & (lab_from == 0), pos & (lab_from > 0), ~equal & valid


def masked_sums(pos_aff, neg_aff, dp_fg, dp_bg, bg, fg, neg):
    """The five masked sums and the three counts (int64) of ``irn_loss``
    from the loss fields (``pos_aff``, ``neg_aff`` and the masks of one
    shape, ``dp_fg``/``dp_bg`` with the displacement channel at dim 1)."""
    bgf, fgf, negf = (m.to(pos_aff.dtype) for m in (bg, fg, neg))
    sums = torch.stack([(bgf * pos_aff).sum(), (fgf * pos_aff).sum(), (negf * neg_aff).sum(),
                        (dp_fg * fgf.unsqueeze(1)).sum(), (dp_bg * bgf.unsqueeze(1)).sum()])
    return sums, torch.stack([(m != 0).sum() for m in (bg, fg, neg)])


def pair_displacement(dp, search_dst, rf: int):
    """The displacement field ``[B, 2, H, W]`` at each pair's source minus
    at its destination: ``[B, 2, n_dirs, H - rf, W - 2 rf]``."""
    return src_window(dp, rf)[:, :, None] - dst_windows(dp, search_dst, rf)


def loss_fields(aff, dp, search_dst, rf: int):
    """IRN's per-pair loss fields (resnet50_irn.py:204-222 of the reference)
    from the affinity ``[B, n_dirs, ...]`` and the displacement field
    ``[B, 2, H, W]``: (pos_aff_loss, neg_aff_loss) of aff's shape and
    (dp_fg_loss, dp_bg_loss) ``[B, 2, n_dirs, H - rf, W - 2 rf]``. The
    constants are float32's (``EPS``, ``ONE_EPS``) in any dtype, so a float64
    run differs from float32's by the rounding of the arithmetic alone."""
    pair = pair_displacement(dp, search_dst, rf)
    target = torch.as_tensor(np.asarray(search_dst, np.float32).T, device=dp.device)
    return (-torch.log(aff + EPS), -torch.log(ONE_EPS - aff),
            _abs(pair - target[None, :, :, None, None]), _abs(pair))


def _abs(v):
    """``|v|`` with the JAX package's slope: 1 where ``v >= 0``, exact zeros
    included, and -1 below (torch's ``abs`` takes 0 at 0)."""
    return torch.where(v >= 0, v, -v)


def irn_loss_plain(labels, aff, dp, search_dst, rf: int):
    """The plain version: the masks, the loss fields and the pair
    displacement materialised, as the JAX package computes them."""
    return masked_sums(*loss_fields(aff, dp, search_dst, rf),
                       *pair_labels_plain(labels, search_dst, rf))


@functools.lru_cache(maxsize=16)
def _dirs_table(search_dst: tuple, rf: int, device: torch.device):
    """The directions as int32 [n_dirs, 2] on ``device``, once each has been
    checked to lie in the window the kernels read (0 <= dy <= rf, |dx| <= rf):
    a table from another radius would read out of bounds."""
    dirs = np.asarray(search_dst, np.int32).reshape(-1, 2)
    if dirs.size and not ((dirs[:, 0] >= 0) & (dirs[:, 0] <= rf) &
                          (np.abs(dirs[:, 1]) <= rf)).all():
        raise ValueError(f"irn_loss: directions outside the window of radius floor {rf}: "
                         f"dy in [{dirs[:, 0].min()}, {dirs[:, 0].max()}], "
                         f"|dx| <= {np.abs(dirs[:, 1]).max()}")
    return torch.as_tensor(dirs, device=device)


def irn_loss(labels, aff, dp, search_dst, rf: int):
    """The plain version on CPU tensors. labels uint8 ``[B, H, W]``, aff
    ``[B, n_dirs, H - rf, W - 2 rf]`` (K7's output), dp ``[B, 2, H, W]``
    float32 -> (sums [5] float32, counts [3] int64); a pair counts where both
    its labels are below ``MAX_VALID``. On the card the loss takes the edge
    map instead (``irn_affinity_loss``): no kernel reads an affinity field."""
    if aff.device.type == "cpu":
        return irn_loss_plain(labels, aff, dp, search_dst, rf)
    build.require_cuda("irn_loss", aff, dp, labels)
    raise ValueError("irn_loss: no kernel takes the affinity on the card; call "
                     "kernels.irn_affinity_loss(labels, edge, dp, path_index) with the edge map")
