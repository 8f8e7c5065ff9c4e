"""ReferIt evaluation.

Port of ``tris_tpu/eval/validate_referit.py`` (the reference's
``validate_referit.py:133-191``). Per image, every kept (> 5 % area)
expression is evaluated on its own: one forward of all of them at
``size`` px, bilinear resize to the original size (``align_corners=True``),
per-map max-normalise, threshold ``> 1e-9``; a ref hits where the peak lies
in any of its boxes. Returns mIoU, oIoU, hit, hitm and Prec@0.5-0.9.

- On the card, K4 (``kernels.eval_metrics`` with ``want_norm``, its tables
  at the image's own original size) upsamples and max-normalises the maps;
  the host thresholds them and accumulates.
- With ``device_resize=False`` the host resizes and normalises with numpy,
  as the JAX package does.

The JAX loop pads the expressions of an image to a power of two so that
``jit`` compiles once a bucket; eager PyTorch has nothing to compile, so
each image runs its own count (the maps of the kept expressions are the
same either way: ``tests/test_torch_referit.py``). Pipelined one image
deep: image k+1's forward is queued before image k's host work runs.
"""

from __future__ import annotations

import numpy as np
import torch

from tris_tpu_torch import kernels
from tris_tpu_torch.device import HostFetch
from tris_tpu_torch.eval.metrics import SegEvalAccumulator
from tris_tpu_torch.eval.validate import (make_eval_forward, normalize_threshold,
                                          resize_to_original_np)


@torch.no_grad()
def validate_referit(model, dataset, print_freq: int = 100, log=print,
                     device_resize: bool = True) -> dict:
    """Evaluate a ``TRISStage1`` or ``TRISStage2`` (its ``response_maps``) on
    a ``ReferItTestDataset``, on the device its parameters live on."""
    model.eval()
    device = next(model.parameters()).device
    forward = make_eval_forward(model)
    acc = SegEvalAccumulator(with_boxes=False)
    step = 0

    def process(fetch, refs, oh, ow):
        (maps,) = fetch.numpy()  # waits for this image's copies only
        for j, ref in enumerate(refs):
            if device_resize:  # normalised at the original size on the card
                cam_norm = maps[j]
                pred = cam_norm > 1e-9
            else:
                cam_norm, pred = normalize_threshold(resize_to_original_np(maps[j], oh, ow))
                cam_norm = cam_norm.astype(np.float32)
            acc.add(ref["mask"], pred, cam_norm, np.asarray(ref["bbox"], np.float64).reshape(-1, 4),
                    weight=1)

    pending = None
    for ex in dataset.iter_examples():
        refs = ex["refs"]
        if not refs:
            continue
        oh, ow = ex["orig_size"]
        ids = np.stack([r["word_ids"] for r in refs])[None]  # [1, S, L]
        cams = forward(ex["image"][None], ids)               # [1, S, h, w]
        if device_resize:
            tables = kernels.eval_tables(cams.shape[2], cams.shape[3], [(oh, ow)], (oh, ow),
                                         device)
            out = kernels.eval_metrics(cams, tables, want_norm=True)[0]
        else:
            out = cams[0]
        fetch = HostFetch([out])
        if pending is not None:
            process(*pending)
            step += 1
            if step % print_freq == 0:
                r = acc.results()
                log(f"referit [{step}] mIoU {r['mIoU']:.3f} oIoU {r['oIoU']:.3f} "
                    f"P@0.5 {r['prec@0.5']:.3f}")
        pending = (fetch, refs, oh, ow)
    if pending is not None:
        process(*pending)
    return acc.results()
