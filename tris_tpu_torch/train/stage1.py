"""Stage-1 training step: the text-supervised contrastive objective.

Port of ``tris_tpu/train/stage1.py`` (the reference's train_stage1.py:301-372):

- ``l1``: the CLIP-critic foreground loss. The sigmoid response map
  modulates the image at the critic's size (K5, both resized
  ``align_corners=True``) and the frozen ViT-B/32 scores it against the
  expression (train_stage1.py:327-340, 263-284).
- ``l4``: batch-contrastive classification, ``multilabel_soft_margin(cls, I)``
  (train_stage1.py:354).
- ``l5``: the CBS negative-expression loss, all ``B*S`` negatives encoded in
  one text pass with the positives (train_stage1.py:345-353 loops).

The critic's parameters get no gradient (``requires_grad_(False)``), but the
gradient flows through its vision tower's activations into the response
map. Its text tower has no trainable input, so it runs without autograd.

Across the ranks of a process group (``tris_tpu_torch.parallel``), with the
model under DDP: each rank's loss is the mean over its own images against
the global batch's texts, the ``l4`` target the identity offset by ``rank *
B``; DDP averages the gradients, so the step is the JAX package's one step
on the global batch (``l1``, ``l4`` and ``l5`` are means over images). The
metrics returned are the ranks' mean, the global batch's.

The JAX package's ``chain > 1`` (a ``lax.scan`` of several steps in one XLA
program, to amortise TPU dispatch for ``bench.py``) has no counterpart in
eager PyTorch and is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tris_tpu_torch import kernels, losses, parallel
from tris_tpu_torch.device import to_device
from tris_tpu_torch.eval.validate import image_to_nchw
from tris_tpu_torch.train.state import apply_gradients


@dataclasses.dataclass(frozen=True)
class Stage1LossWeights:
    w1: float = 1.0
    w4: float = 5.0
    w5: float = 2.0


def batch_to_device(batch: dict, device) -> dict:
    """The train step's inputs of a ``Loader`` batch on ``device``: the
    image (u8 or normalised f32, NHWC), ``word_ids`` [B, L] and, when the
    loader samples negatives, ``neg_word_ids`` [B, S, L]."""
    keys = ("image", "word_ids", "neg_word_ids")
    return {k: to_device(np.asarray(batch[k]), device) for k in keys if k in batch}


def stage1_loss(model, critic, batch: dict, weights: Stage1LossWeights):
    """``(loss, metrics)`` of one batch of device tensors; ``model`` must be
    in train mode (BatchNorm's batch statistics, which this updates)."""
    image = image_to_nchw(batch["image"])              # K6 on the u8 feed
    word_ids = batch["word_ids"]
    B = image.shape[0]
    cls_out, cls_fg, _, sig_map, _ = model(image, word_ids, train=True)

    cfg = critic.config
    a = kernels.critic_input(sig_map[:, 0], image, 1, cfg.image_resolution,
                             cfg.vision_patch_size)
    img_feat = critic.visual.forward_patches(a)
    neg_ids = batch.get("neg_word_ids")
    with torch.no_grad():
        # one fused text pass for the positives and the CBS negatives: every
        # op of encode_text is row-independent
        if neg_ids is not None:
            S, L = neg_ids.shape[1], neg_ids.shape[2]
            _, all_txt = critic.encode_text(torch.cat([word_ids, neg_ids.reshape(B * S, L)]))
            txt_feat, neg_txt = all_txt[:B], all_txt[B:]
        else:
            _, txt_feat = critic.encode_text(word_ids)
    if neg_ids is not None:
        l5 = losses.cbs_loss(img_feat, neg_txt.reshape(B, S, -1))
    else:
        l5 = img_feat.new_zeros(())
    l1 = losses.max_loss(losses.clip_similarity(img_feat, txt_feat))
    target = torch.zeros_like(cls_out)                  # [B, T]: image b's own text rank * B + b
    target[torch.arange(B), parallel.rank_world()[0] * B + torch.arange(B)] = 1.0
    l4 = losses.multilabel_soft_margin_loss(cls_out, target)
    loss = weights.w1 * l1 + weights.w4 * l4 + weights.w5 * l5
    metrics = {"loss": loss, "l1": l1, "l4": l4, "l5": l5, "cls_fg": cls_fg.mean()}
    return loss, {k: v.detach() for k, v in metrics.items()}


def train_step(model, critic, optimizer, scheduler, batch: dict,
               weights: Stage1LossWeights = Stage1LossWeights()) -> dict:
    """One optimizer step on a batch of device tensors; returns the metrics
    as 0-d device tensors (reading them waits for the step). The gradients
    stay in ``p.grad`` until the next step. ``model`` may be under DDP
    (``parallel.wrap_ddp``)."""
    model.train()
    critic.eval()
    model.zero_grad(set_to_none=True)      # logit_scale's too, which no group holds
    loss, metrics = stage1_loss(model, critic, batch, weights)
    loss.backward()
    apply_gradients(optimizer, scheduler)
    return parallel.mean_over_ranks(metrics)
