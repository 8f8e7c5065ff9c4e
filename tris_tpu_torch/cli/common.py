"""Shared CLI helpers: model construction, weight loading, data loaders.

Port of ``tris_tpu/cli/common.py``. Models live on ``args.device``
(``cuda`` unless the caller asks for ``cpu``); random init is seeded (the
stage models from ``--seed``) without touching the global RNG, and
``--clip_weights`` loads OpenAI's released CLIP into their backbone.
``--bf16`` builds stage 1 in bfloat16 (the JAX package's
``TRISStage1(cfg, dtype=bfloat16)``) for eval, PRMS, ReferIt and training on
one process, and stage 2 (``TRISStage2(cfg, dtype=bfloat16)``) for eval and
the demo; elsewhere it raises, naming what it covers (:data:`BF16_SCOPE`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from tris_tpu_torch.ckpt.io import load_state
from tris_tpu_torch.config import backbone_name
from tris_tpu_torch.device import resolve_device
from tris_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1
from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2
from tris_tpu_torch.parallel import init_process_group, rank_world

CRITIC_SEED = 7  # the critic's random init, fixed as in the JAX package
# what --bf16 covers in this package; the JAX package's bf16 stage-2 training and bf16
# training over several processes are not ported
BF16_SCOPE = ("stage-1 eval, PRMS and ReferIt eval (cli.validate --stage 1), stage-2 eval "
              "and the demo (cli.validate --stage 2, cli.demo) and stage-1 training on one "
              "process (cli.train_stage1)")


def refuse_bf16(args, what: str) -> None:
    """Raise if ``--bf16`` asks for ``what``, which it does not cover."""
    if getattr(args, "bf16", False):
        raise NotImplementedError(f"--bf16 covers {BF16_SCOPE}; {what} with --bf16 is not "
                                  f"ported yet")


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


def start_distributed(args) -> int:
    """``--multihost``: join the process group torchrun describes (its
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``; without them this raises), ``args.device`` becoming the
    rank's own (``cuda:LOCAL_RANK``, or the CPU over gloo). Returns the rank
    (0 without the flag)."""
    if getattr(args, "multihost", False):
        _, _, dev = init_process_group(getattr(args, "device", "cuda"))
        args.device = str(dev)
    return rank_world()[0]


class StepProfiler:
    """``--profile DIR``: a ``torch.profiler`` trace (CPU and CUDA activity)
    of the train steps ``[start, stop)``, written as
    ``DIR/trace_rank{r}.json`` when step ``stop`` begins; nothing without a
    directory."""

    def __init__(self, out_dir, rank: int = 0, start: int = 10, stop: int = 20):
        self.out_dir, self.rank, self.start, self.stop = out_dir, rank, start, stop
        self.prof = None
        self.path = None

    def step(self, iteration: int, log=print) -> None:
        """Call before train step ``iteration`` (0-based)."""
        if not self.out_dir:
            return
        if iteration == self.start and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        elif iteration == self.stop and self.prof is not None:
            self.close(log)

    def close(self, log=print) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(self.out_dir, f"trace_rank{self.rank}.json")
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        log(f"profiler trace written to {self.path}")


def build_stage1(args, device=None, train: bool = False) -> TRISStage1:
    """A ``TRISStage1`` on ``device`` (default ``args.device``, else
    ``"cuda"``), randomly initialised from ``args.seed`` (the backbone from
    ``--clip_weights`` when given), in train mode (BatchNorm's batch
    statistics) when ``train``, else in eval mode; with ``--bf16`` in
    bfloat16 (training on one process only)."""
    if train and rank_world()[1] > 1:
        refuse_bf16(args, f"stage-1 training over {rank_world()[1]} processes")
    cfg = Stage1Config(
        backbone=backbone_name(args),
        hidden_dim=args.hidden_dim,
        txt_length=args.max_query_len,
        attn_multi=args.attn_multi,
        focal_p=args.FOCAL_P,
        focal_lambda=args.FOCAL_LAMBDA,
    )
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
    return _build(args, device, train, lambda: TRISStage1(cfg, dtype))


def build_stage2(args, device=None, train: bool = False) -> TRISStage2:
    """A ``TRISStage2`` as :func:`build_stage1` builds stage 1; with
    ``--bf16`` in bfloat16 for eval only (stage-2 training raises)."""
    if train:
        refuse_bf16(args, "stage-2 training")
    cfg = Stage2Config(backbone=backbone_name(args), txt_length=args.max_query_len)
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
    return _build(args, device, train, lambda: TRISStage2(cfg, dtype))


def _build(args, device, train: bool, make):
    if device is None:
        device = getattr(args, "device", "cuda")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = make()
    return load_clip_weights(args, model).to(dev).train(train)


_CLIP_META = ("input_resolution", "context_length", "vocab_size")


def load_clip_weights(args, model):
    """``--clip_weights``: OpenAI's released CLIP (a TorchScript ``.pt`` or a
    ``state_dict``) into ``model.backbone``, strictly (the reference builds
    both stages on ``clip.load``; the JAX package's ``_maybe_load_clip``).
    The release's metadata entries are dropped, and of its positional
    embedding the first rows, at least the ``txt_length`` the text tower
    reads, replace the model's."""
    path = getattr(args, "clip_weights", None)
    if not path:
        return model
    from tris_tpu_torch.ckpt.convert import load_torch_checkpoint

    sd = {k: v for k, v in load_torch_checkpoint(path).items() if k not in _CLIP_META}
    own = model.backbone.positional_embedding.detach().float().clone()
    pe = sd.get("positional_embedding")
    txt = model.backbone.config.txt_length
    if pe is None or pe.shape[0] < txt or pe.shape[1] != own.shape[1]:
        raise ValueError(f"--clip_weights {path}: positional_embedding "
                         f"{None if pe is None else tuple(pe.shape)} does not cover "
                         f"{txt} tokens of width {own.shape[1]}")
    n = min(pe.shape[0], own.shape[0])
    own[:n] = pe[:n]
    sd["positional_embedding"] = own
    load_state(model.backbone, sd)
    return model


def build_critic(args, device=None) -> CLIP:
    """The frozen ViT-B/32 critic of PRMS and of stage-1 training
    (train_stage1.py:164-168, validate.py:279-284 of the reference) in eval
    mode on ``device`` (default ``args.device``, else ``"cuda"``), its
    parameters without gradients: OpenAI's released weights from
    ``--critic_weights`` (a TorchScript ``.pt`` or a ``state_dict``, loaded
    strictly), else a seeded random init."""
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
    return critic.requires_grad_(False).to(dev).eval()


def load_pretrained(args, model):
    """--pretrain: a reference TRIS ``.pth`` (stage 1 or stage 2, as
    ``model``) or this package's ``torch.save`` of a ``state_dict`` (plain or
    under ``"model"``); both carry the reference's keys and load with
    ``strict=True``."""
    path = args.pretrain
    if not path:
        return model
    if not path.endswith((".pth", ".pt")):
        raise SystemExit(
            f"--pretrain {path}: this package reads torch checkpoints (.pth/.pt); "
            "convert JAX variables with tris_tpu_torch.ckpt.from_jax first")
    from tris_tpu_torch.ckpt.convert import load_torch_checkpoint

    load_state(model, load_torch_checkpoint(path))
    return model


def build_eval_loaders(args, splits):
    """One eval ``Loader`` per split, refs sharded over the
    ``torch.distributed`` ranks when a group is initialised."""
    from tris_tpu_torch.data.dataset import Loader, ReferSegDataset

    dataset, split_by = resolve_dataset(args)
    rank, world = rank_world()
    loaders = {}
    for split in splits:
        ds = ReferSegDataset(
            args.refer_data_root, dataset, split_by, split, size=args.size,
            max_tokens=args.max_query_len, eval_mode=True,
        )
        loaders[split] = Loader(ds, args.eval_batch, shuffle=False, drop_last=False,
                                process_index=rank, process_count=world)
    return loaders


def build_train_loader(args):
    """The training ``Loader``: one sampled sentence per ref plus
    ``--negative_samples`` negatives, shuffled from ``--seed``, refs sharded
    over the ``torch.distributed`` ranks when a group is initialised."""
    from tris_tpu_torch.data.dataset import Loader, ReferSegDataset

    dataset, split_by = resolve_dataset(args)
    rank, world = rank_world()
    ds = ReferSegDataset(
        args.refer_data_root, dataset, split_by, "train", size=args.size,
        max_tokens=args.max_query_len, eval_mode=False,
        negative_samples=args.negative_samples, pseudo_path=args.pseudo_path,
    )
    return Loader(ds, args.batch_size, shuffle=True, seed=args.seed, process_index=rank,
                  process_count=world)
