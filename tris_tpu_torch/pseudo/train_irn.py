"""IRNet's affinity and displacement training (pass 2 of the pseudo-label
pipeline), on the card.

Port of ``tris_tpu/pseudo/train_irn.py``: the frozen-trunk forward, the
affinity and displacement losses, and SGD with a per-step poly learning
rate ``(1 - t/T)^0.9``, the displacement heads at 10x the rate of the edge
heads (train_irn.py:33-36 of the reference). On the device-label feed the
pair affinities (K7) and the masked losses (K8) are one fused kernel from
the edge map to the sums, whose backward kernel gives the gradients; the
host-mask feed, which reads the reference's precomputed masks, has no
kernel and runs on the CPU only.

The reference's quirk is kept: its ``PolyOptimizer`` passes
``weight_decay`` into SGD's momentum slot (IRNet/misc/torchutils.py:9-11),
so it trains with momentum 1e-4 and no weight decay. After training,
:func:`calibrate_mean_shift` estimates the displacement field's mean over
the train images (train_irn.py:94-107), which inference subtracts.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from tris_tpu_torch import kernels as K
from tris_tpu_torch import parallel
from tris_tpu_torch.kernels.irn_loss import masked_sums, pair_labels_plain
from tris_tpu_torch.pseudo.irnet import IRNet, affinity_displacement_losses


@dataclasses.dataclass(frozen=True)
class IRNTrainConfig:
    crop_size: int = 512
    radius: int = 10
    lr: float = 0.1
    sgd_momentum: float = 1e-4  # the reference's misrouted weight_decay
    epochs: int = 3
    batch_size: int = 24
    poly_power: float = 0.9


def label_irn_params(model: IRNet) -> dict:
    """``{name: "edge" | "dp" | "frozen"}`` for every parameter: the edge
    heads, the displacement heads, and the trunk (out of the optimizer)."""
    return {name: "edge" if name.startswith("fc_edge") else
            "dp" if name.startswith("fc_dp") else "frozen"
            for name, _ in model.named_parameters()}


def make_irn_optimizer(model: IRNet, cfg: IRNTrainConfig, max_step: int):
    """(SGD, LambdaLR): the edge heads at ``cfg.lr``, the displacement heads
    at 10x, momentum ``cfg.sgd_momentum``, no weight decay; the schedule
    ``clip(1 - t / max_step, 0, 1) ** poly_power``, stepped after the
    optimizer. The trunk is frozen: no gradient, not in the optimizer."""
    labels = label_irn_params(model)
    groups = {"edge": [], "dp": []}
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
        if labels[name] != "frozen":
            groups[labels[name]].append(p)
    opt = torch.optim.SGD([{"params": groups["edge"], "lr": cfg.lr},
                           {"params": groups["dp"], "lr": 10 * cfg.lr}],
                          lr=cfg.lr, momentum=cfg.sgd_momentum, weight_decay=0.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: float(np.clip(1.0 - t / max_step, 0.0, 1.0)) ** cfg.poly_power)
    return opt, sched


def affinity_labels_on_device(reduced_label: torch.Tensor, path_index):
    """Quarter-scale ir label maps [B, h4, w4] (or [B, h4 * w4]) -> (bg_pos,
    fg_pos, neg) float32 [B, n_dirs, n_pairs], from static windows of the
    map: the device twin of ``aug.affinity_labels_from_indices``. The
    training step's K8 builds the same masks inside its sums."""
    B = reduced_label.shape[0]
    lab = reduced_label.reshape(B, *path_index.size)
    masks = pair_labels_plain(lab, path_index.search_dst, path_index.radius_floor)
    return tuple(m.reshape(B, m.shape[1], -1).float() for m in masks)


def losses_from_sums(sums: torch.Tensor, counts: torch.Tensor) -> dict:
    """IRN's loss and its four terms from the five masked sums and the three
    integer counts (bg positive, fg positive, negative)."""
    n_bg, n_fg, n_neg = counts.to(sums.dtype)
    pos = (sums[0] / (n_bg + 1e-5)) / 2 + (sums[1] / (n_fg + 1e-5)) / 2
    neg = sums[2] / (n_neg + 1e-5)
    dp_fg = sums[3] / (2 * n_fg + 1e-5)
    dp_bg = sums[4] / (2 * n_bg + 1e-5)
    return {"loss": (pos + neg) / 2 + (dp_fg + dp_bg) / 2, "pos_aff": pos, "neg_aff": neg,
            "dp_fg": dp_fg, "dp_bg": dp_bg}


def irn_loss(model: IRNet, path_index, batch: dict) -> dict:
    """The loss and its terms for a batch on the model's device: ``image``
    [B, 3, H, W] and either ``reduced_label`` uint8 [B, h4, w4] (the
    device-label feed: K7 and K8 fused, from the edge map to the masked
    sums, the affinity never written) or the host
    masks ``aff_bg_pos``, ``aff_fg_pos``, ``aff_neg`` [B, n_dirs, n_pairs]
    (the loss fields, then the masked sums: the plain version, so on CPU
    tensors only)."""
    if "reduced_label" not in batch and batch["image"].device.type != "cpu":
        raise ValueError("irn_loss: the host-mask feed has no kernel; on "
                         f"{batch['image'].device} feed reduced_label (labels='device')")
    edge_out, dp_out = model(batch["image"])
    if "reduced_label" in batch:
        lab = batch["reduced_label"].reshape(edge_out.shape[0], *path_index.size)
        sums, counts = K.irn_affinity_loss(lab, torch.sigmoid(edge_out[:, 0]), dp_out, path_index)
    else:
        pos_aff, neg_aff, dp_fg, dp_bg = affinity_displacement_losses(edge_out, dp_out,
                                                                      path_index)
        masks = [batch[k].reshape(pos_aff.shape) for k in ("aff_bg_pos", "aff_fg_pos", "aff_neg")]
        sums, counts = masked_sums(pos_aff, neg_aff, dp_fg.flatten(2), dp_bg.flatten(2), *masks)
    if parallel.distributed():
        # the global batch's pair counts; the sums scaled by the ranks, so that DDP's average
        # of the ranks' losses is the global batch's sum over its count, as the JAX step's
        counts = parallel.all_reduce_sum(counts)
        sums = sums * parallel.rank_world()[1]
    return losses_from_sums(sums, counts)


def batch_to_device(batch: dict, device) -> dict:
    """A batch of ``pipeline.irn_train_batches`` on ``device``: the NHWC
    image as NCHW float32, the label map or masks as they are."""
    out = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
    out["image"] = out["image"].permute(0, 3, 1, 2).contiguous()
    return out


def train_step(model: IRNet, opt, sched, path_index, batch: dict) -> dict:
    """One SGD step on a batch already on the device; returns the loss
    terms as 0-d tensors (detached; across the ranks of a group, the global
    batch's). ``model`` may be under DDP (``parallel.wrap_ddp``)."""
    opt.zero_grad(set_to_none=True)
    metrics = irn_loss(model, path_index, batch)
    metrics["loss"].backward()
    opt.step()
    sched.step()
    return parallel.mean_over_ranks({k: v.detach() for k, v in metrics.items()})


@torch.no_grad()
def calibrate_mean_shift(model: IRNet, batches: Iterable[torch.Tensor]) -> IRNet:
    """The displacement field's mean over the train images
    (train_irn.py:94-107): the per-channel mean of each batch's field, then
    the mean over batches, into ``model.mean_shift.running_mean``. Like the
    JAX function, raises when there is no batch."""
    means = [model(image)[1].mean(dim=(0, 2, 3)).cpu().numpy() for image in batches]
    mean = np.mean(np.stack(means), axis=0)
    model.mean_shift.running_mean.copy_(torch.as_tensor(mean))
    return model
