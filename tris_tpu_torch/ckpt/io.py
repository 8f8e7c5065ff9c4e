"""Training checkpoints in a torch-native format, and the best-checkpoint
bookkeeping of the stage-1 and stage-2 trainers.

Port of ``tris_tpu/ckpt/io.py``'s training part. A training checkpoint is a
``torch.save`` of ``{"model": state_dict, "optimizer", "scheduler",
"step", "extra"}`` (and the stage-2 EMA teacher's ``state_dict`` under
``"ema"``); ``"model"`` keeps the reference TRIS keys, so
``cli/common.py::load_pretrained`` (``--pretrain``) reads the file as it is.
Files are written to a temporary name and renamed, so a crash mid-write
never leaves a broken checkpoint. The JAX package writes asynchronously on
a thread; here the write is synchronous.

:class:`BestCheckpointKeeper` keeps the best-by-mIoU and best-by-hit
checkpoints (``ckpt_320_epoch_{e}_best.pth`` / ``_hit.pth``), removing the
previous best (train_stage1.py:192-217 of the reference), and writes on
rank 0 alone. The JAX package's keeper writes from every process
(``tris_tpu/ckpt/io.py:183-196``); that is a fault the port does not copy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from tris_tpu_torch.ckpt.convert import load_torch_checkpoint


def save_train_checkpoint(path: str, model, optimizer, scheduler,
                          extra: Optional[dict] = None, ema=None) -> str:
    """Write model, optimizer and schedule state (and ``extra``, e.g. the
    epoch, and the EMA teacher ``ema``) to ``path``; the step is the
    schedule's count."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
               "scheduler": scheduler.state_dict(), "step": scheduler.last_epoch,
               "extra": dict(extra or {})}
    if ema is not None:
        payload["ema"] = ema.state_dict()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def is_train_checkpoint(path: str) -> bool:
    """Whether ``path`` is a training checkpoint (it holds an optimizer),
    which ``--resume`` continues, rather than a plain ``state_dict``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return isinstance(payload, dict) and "optimizer" in payload


def load_state(module, state_dict) -> None:
    """``module.load_state_dict(state_dict, strict=True)`` with each floating
    tensor keeping the dtype it is loaded in: a float32 checkpoint into a
    leaf that a bfloat16 module made gives a float32 leaf, as the JAX
    package's loaders replace the init's leaves (``load_state_dict`` alone
    would round it into the leaf's dtype). The parameters stay the same
    objects."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    for key, value in state_dict.items():
        t = own.get(key)
        if t is not None and value.is_floating_point() and t.dtype != value.dtype:
            t.data = torch.empty(t.shape, dtype=value.dtype, device=t.device)
    module.load_state_dict(state_dict, strict=True)


def load_params_only(path: str, model):
    """Model-only restore (strict): a training checkpoint's ``"model"`` or a
    plain ``state_dict``, e.g. the reference's ``.pth``."""
    load_state(model, load_torch_checkpoint(path))
    return model


def resume_train_state(path: str, model, optimizer, scheduler,
                       ema=None) -> Tuple[int, Optional[int]]:
    """Full resume (model, optimizer, schedule, and the EMA teacher ``ema``
    when the file holds one) when ``path`` is a training checkpoint (the
    reference's load_checkpoint, utils/util.py:81-96); the model alone for a
    plain ``state_dict``. Returns ``(step, the epoch to start at, or None
    when the file names none)``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(payload, dict) and "optimizer" in payload):
        load_params_only(path, model)
        return scheduler.last_epoch, None
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
    if ema is not None and "ema" in payload:
        ema.load_state_dict(payload["ema"], strict=True)
    epoch = payload.get("extra", {}).get("epoch")
    return int(payload["step"]), (int(epoch) + 1 if epoch is not None else None)


class BestCheckpointKeeper:
    """Best-by-metric checkpoints (train_stage1.py:172-217 of the reference),
    written by rank 0 alone; every rank keeps the same record."""

    def __init__(self, output_dir: str, rank: int = 0):
        self.output_dir = output_dir
        self.rank = rank
        if rank == 0:
            os.makedirs(output_dir, exist_ok=True)
        self.best = {"val_acc": -1.0, "val_hit": -1.0, "epoch": -1, "path": "",
                     "hit": -1.0, "hit_path": ""}

    def _replace(self, old: str, path: str, save) -> None:
        if self.rank != 0:
            return
        if old and os.path.exists(old):
            os.remove(old)
        save(path)

    def update(self, epoch: int, miou: float, hit: float, save) -> dict:
        """``save(path)`` writes the checkpoint (on rank 0 only)."""
        if miou > self.best["val_acc"]:
            path = os.path.join(self.output_dir, f"ckpt_320_epoch_{epoch}_best.pth")
            self._replace(self.best["path"], path, save)
            self.best.update(val_acc=miou, val_hit=hit, epoch=epoch, path=path)
        if hit > self.best["hit"]:
            path = os.path.join(self.output_dir, f"ckpt_320_epoch_{epoch}_hit.pth")
            self._replace(self.best["hit_path"], path, save)
            self.best.update(hit=hit, hit_path=path)
        return dict(self.best)
