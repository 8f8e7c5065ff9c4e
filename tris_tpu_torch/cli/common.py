"""Shared CLI helpers: model construction, weight loading, eval loaders.

Port of the stage-1 eval and PRMS parts of ``tris_tpu/cli/common.py``.
Models live on ``args.device`` (``cuda`` unless the caller asks for
``cpu``); random init is seeded (stage 1 from ``--seed``) without touching
the global RNG.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tris_tpu_torch.config import backbone_name
from tris_tpu_torch.device import resolve_device
from tris_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

CRITIC_SEED = 7  # the critic's random init, fixed as in the JAX package


def resolve_dataset(args) -> Tuple[str, str]:
    """Map CLI dataset names to (refer dataset, splitBy)."""
    name = args.dataset
    if name == "refcocog_umd":
        return "refcocog", "umd"
    if name == "refcocog_google":
        return "refcocog", "google"
    if name == "refcocog":
        return "refcocog", args.splitBy or "umd"
    if name == "refcoco+":
        return "refcoco+", "unc"
    return name, args.splitBy


def dist_rank_world() -> Tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_stage1(args, device=None) -> TRISStage1:
    """A ``TRISStage1`` in eval mode on ``device`` (default ``args.device``,
    else ``"cuda"``), randomly initialised from ``args.seed``."""
    if device is None:
        device = getattr(args, "device", "cuda")
    dev = resolve_device(device)
    if getattr(args, "bf16", False):
        raise NotImplementedError("bf16 is not ported yet: the kernels take float32")
    cfg = Stage1Config(
        backbone=backbone_name(args),
        hidden_dim=args.hidden_dim,
        txt_length=args.max_query_len,
        attn_multi=args.attn_multi,
        focal_p=args.FOCAL_P,
        focal_lambda=args.FOCAL_LAMBDA,
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = TRISStage1(cfg)
    return model.to(dev).eval()


def build_critic(args, device=None) -> CLIP:
    """The frozen ViT-B/32 critic of PRMS (train_stage1.py:164-168,
    validate.py:279-284 of the reference) in eval mode on ``device``
    (default ``args.device``, else ``"cuda"``): OpenAI's released weights
    from ``--critic_weights`` (a TorchScript ``.pt`` or a ``state_dict``,
    loaded strictly), else a seeded random init."""
    if device is None:
        device = getattr(args, "device", "cuda")
    dev = resolve_device(device)
    cfg = dataclasses.replace(CLIP_CONFIGS["ViT-B-32"], txt_length=args.max_query_len)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(CRITIC_SEED)
        critic = CLIP(cfg)
    path = getattr(args, "critic_weights", None)
    if path:
        from tris_tpu_torch.ckpt.convert import load_torch_checkpoint

        sd = {k: v for k, v in load_torch_checkpoint(path).items()
              if k not in ("input_resolution", "context_length", "vocab_size")}
        critic.load_state_dict(sd, strict=True)
    return critic.to(dev).eval()


def load_pretrained(args, model: TRISStage1) -> TRISStage1:
    """--pretrain: a reference TRIS ``.pth`` or this package's ``torch.save``
    of a ``state_dict`` (plain or under ``"model"``); both carry the
    reference's keys and load with ``strict=True``."""
    path = args.pretrain
    if not path:
        return model
    if not path.endswith((".pth", ".pt")):
        raise SystemExit(
            f"--pretrain {path}: this package reads torch checkpoints (.pth/.pt); "
            "convert JAX variables with tris_tpu_torch.ckpt.from_jax first")
    from tris_tpu_torch.ckpt.convert import load_torch_checkpoint

    model.load_state_dict(load_torch_checkpoint(path), strict=True)
    return model


def build_eval_loaders(args, splits):
    """One eval ``Loader`` per split, refs sharded over the
    ``torch.distributed`` ranks when a group is initialised."""
    from tris_tpu_torch.data.dataset import Loader, ReferSegDataset

    dataset, split_by = resolve_dataset(args)
    rank, world = dist_rank_world()
    loaders = {}
    for split in splits:
        ds = ReferSegDataset(
            args.refer_data_root, dataset, split_by, split, size=args.size,
            max_tokens=args.max_query_len, eval_mode=True,
        )
        loaders[split] = Loader(ds, args.eval_batch, shuffle=False, drop_last=False,
                                process_index=rank, process_count=world)
    return loaders
