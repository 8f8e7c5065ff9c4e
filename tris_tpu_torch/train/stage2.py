"""Stage-2 training step: pseudo-supervised BCE and the EMA teacher's
consistency.

Port of ``tris_tpu/train/stage2.py`` (the reference's
train_stage2.py:271-374):

- ``l1``-``l4``: ``bce_with_logits`` of each of the four side outputs
  against the IRNet pseudo-mask.
- ``l5``: with the EMA teacher, the sum over the four outputs of the
  sigmoid-MSE (``consistency="mse"``) or Bernoulli-KL (``"kl"``) against
  the teacher's outputs. The teacher runs in train mode without gradients:
  its BatchNorms normalise by the batch's statistics and, as in JAX, leave
  their buffers alone.
- The teacher follows ema_pytorch's gate (train_stage2.py:57-64 of the
  reference, ``tris_tpu/train/stage2.py:91-121``): after the optimizer step
  the 0-based counter is ``step - 1``; on ``counter % update_every == 0``
  the teacher is updated with decay 0 (a copy) while ``epoch = max(counter
  - update_after - 1, 0)`` is 0, else ``min(ema_decay, 1 - (1 + epoch) **
  (-2/3))``, computed in float32 as JAX does, the power by the C library's
  ``powf``, which XLA's CPU ``pow`` equals (numpy's float32 power differs
  from it by an ulp at one epoch in five). The counter lives on the host,
  so the gate is a host ``if``: on skipped steps K12 is not launched and
  neither tree is read, as JAX's ``lax.cond`` skips them.

Across the ranks of a process group, the student runs under DDP
(``state.ddp``) and every BatchNorm in train mode, the teacher's included,
takes the global batch's statistics (``kernels/batch_norm.py``), as the JAX
package's one program over the global batch does; each rank's losses are
means over its own equal share, so DDP's average of the gradients is the
global mean's, and the teacher, updated from the same student on every
rank, stays the same on every rank. The metrics returned are the ranks'
mean.

The JAX package's ``chain > 1`` has no counterpart here, as in stage 1.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from tris_tpu_torch import losses, parallel
from tris_tpu_torch.device import to_device
from tris_tpu_torch.eval.validate import image_to_nchw
from tris_tpu_torch.train.state import TrainState, apply_gradients, ema_update


@dataclasses.dataclass(frozen=True)
class Stage2TrainConfig:
    use_ema: bool = False
    consistency: str = "mse"  # 'mse' | 'kl'
    ema_decay: float = 0.9999
    ema_update_every: int = 10
    ema_update_after: int = 100


def batch_to_device(batch: dict, device) -> dict:
    """The train step's inputs of a ``Loader`` batch on ``device``: the
    image (u8 or normalised f32, NHWC), ``word_ids`` [B, L] and the
    pseudo-mask ``pseudo`` [B, H, W, 1]."""
    return {k: to_device(np.asarray(batch[k]), device) for k in ("image", "word_ids", "pseudo")}


@functools.lru_cache(maxsize=None)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return libm.powf


def ema_decay(counter: int, cfg: Stage2TrainConfig) -> Optional[float]:
    """The teacher's decay after the optimizer step with 0-based
    ``counter``, or None when the gate skips the update."""
    if counter % cfg.ema_update_every != 0:
        return None
    epoch = np.float32(max(counter - cfg.ema_update_after - 1, 0))
    if epoch <= 0:
        return 0.0
    power = np.float32(_powf()(float(np.float32(1.0) + epoch), float(np.float32(-2.0 / 3.0))))
    return float(min(np.float32(cfg.ema_decay), np.float32(1.0) - power))


def stage2_loss(model, teacher, batch: dict, cfg: Stage2TrainConfig):
    """``(loss, metrics)`` of one batch of device tensors; ``model`` (and
    ``teacher``, when given with ``cfg.use_ema``) in train mode."""
    image = image_to_nchw(batch["image"])              # K6 on the u8 feed
    word_ids = batch["word_ids"]
    pseudo = batch["pseudo"].permute(0, 3, 1, 2)       # [B, 1, H, W]
    outs = model(image, word_ids)
    l1, l2, l3, l4 = (losses.bce_with_logits(o, pseudo) for o in outs)
    if cfg.use_ema and teacher is not None:
        with torch.no_grad():
            t_outs = teacher(image, word_ids)
        cons = (losses.sigmoid_mse_consistency if cfg.consistency == "mse"
                else losses.sigmoid_kl_consistency)
        l5 = sum(cons(s, t) for s, t in zip(outs, t_outs))
    else:
        l5 = outs[0].new_zeros(())
    loss = l1 + l2 + l3 + l4 + l5
    metrics = {"loss": loss, "l1": l1, "l2": l2, "l3": l3, "l4": l4, "l5": l5}
    return loss, {k: v.detach() for k, v in metrics.items()}


def update_teacher(state: TrainState, cfg: Stage2TrainConfig) -> Optional[float]:
    """The gate and, when it opens, the EMA update (K12); returns the decay
    applied, or None on a skipped step."""
    decay = ema_decay(state.step - 1, cfg)
    if decay is not None:
        ema_update(state, decay)
    return decay


def train_step(state: TrainState, batch: dict, cfg: Stage2TrainConfig = Stage2TrainConfig()
               ) -> dict:
    """One optimizer step on a batch of device tensors, then the teacher's
    gate; returns the metrics as 0-d device tensors (reading them waits for
    the step). The gradients stay in ``p.grad`` until the next step."""
    model, teacher = state.model, state.ema
    net = model if state.ddp is None else state.ddp
    net.train()
    if teacher is not None:
        teacher.train()
    model.zero_grad(set_to_none=True)
    loss, metrics = stage2_loss(net, teacher, batch, cfg)
    loss.backward()
    apply_gradients(state.optimizer, state.scheduler)
    state.step += 1
    if cfg.use_ema and teacher is not None:
        update_teacher(state, cfg)
    return parallel.mean_over_ranks(metrics)
