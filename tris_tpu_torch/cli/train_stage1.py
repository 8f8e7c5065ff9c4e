"""Stage-1 training entry point, on the card by default.

    python -m tris_tpu_torch.cli.train_stage1 --dataset refcocog --splitBy umd \\
        --batch_size 48 --size 320 --epoch 15 --negative_samples 3 \\
        --output ./output [--critic_weights ViT-B-32.pt] [--device cuda|cpu]

Port of ``tris_tpu/cli/train_stage1.py``: RN50 stage 1 against the frozen
ViT-B/32 critic, one ``train_step`` per batch (AdamW, poly LR per step),
the print-freq log line, a ``validate`` per epoch on each ``--test_split``,
best-by-mIoU and best-by-hit checkpoints (``ckpt_320_epoch_{e}_{best,hit}.pth``,
written by rank 0), and at the end the best checkpoint reloaded and
validated on the train split. ``--fast_eval`` makes both validations
scalars only (K4 on the card, no box metrics); the JAX trainer applies it
to the per-epoch one alone. ``--resume --pretrain F`` continues a training
checkpoint (model, optimizer, schedule, epoch) or starts from a plain
``state_dict``; ``--eval`` only validates. ``--multihost`` trains data
parallel over the processes torchrun starts, one a card
(``torchrun --nproc_per_node N -m tris_tpu_torch.cli.train_stage1
--multihost ...``): ``--batch_size`` per process, the model under DDP, K13's
statistics and the head's texts over the global batch, the refs and the
validation sharded over the ranks. ``--profile DIR`` writes a
``torch.profiler`` trace of steps 10-20.
"""

from __future__ import annotations

import datetime
import time

import numpy as np

from tris_tpu_torch.ckpt.io import (
    BestCheckpointKeeper,
    is_train_checkpoint,
    load_params_only,
    resume_train_state,
    save_train_checkpoint,
)
from tris_tpu_torch.cli.common import (
    build_critic,
    build_eval_loaders,
    build_stage1,
    build_train_loader,
    load_pretrained,
    start_distributed,
    StepProfiler,
)
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.parallel import rank_world, wrap_ddp
from tris_tpu_torch.eval.validate import validate
from tris_tpu_torch.train.stage1 import Stage1LossWeights, batch_to_device, train_step
from tris_tpu_torch.train.state import create_train_state
from tris_tpu_torch.utils.logging import MetricsWriter, create_logger


def main(args):
    rank = start_distributed(args)
    logger = create_logger(rank)
    writer = MetricsWriter(args.board_folder)
    model = build_stage1(args, train=True)
    device = next(model.parameters()).device
    critic = build_critic(args)

    resume_from = None
    if args.resume and args.pretrain:
        if is_train_checkpoint(args.pretrain) and not args.eval:
            resume_from = args.pretrain    # full resume once the optimizer exists
        else:
            load_pretrained(args, model)

    eval_splits = args.test_split.split(",")
    eval_loaders = build_eval_loaders(args, eval_splits)
    vkw = dict(log=logger.info, host_threads=args.host_threads,
               device_resize=not args.no_device_resize)
    if args.eval:
        results = {}
        for split in eval_splits:
            results[split] = validate(model, eval_loaders[split], **vkw)
            logger.info(f"[{split}] {results[split]}")
        return results

    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"number of params: {n_params / 1e6:.2f}M")
    loader = build_train_loader(args)
    steps_per_epoch = len(loader)
    total_steps = steps_per_epoch * args.epoch
    state = create_train_state(model, total_steps=total_steps, base_lr=args.lr,
                               lr_multi=args.lr_multi, weight_decay=args.weight_decay)
    start_epoch = args.start_epoch
    if resume_from:
        _, resumed_epoch = resume_train_state(resume_from, model, state.optimizer, state.scheduler)
        if resumed_epoch is not None:
            start_epoch = resumed_epoch
        logger.info(f"resumed from {resume_from} at epoch {start_epoch}")
    weights = Stage1LossWeights(w1=args.w1, w4=args.w4, w5=args.w5)
    net = wrap_ddp(model, device)
    if rank_world()[1] > 1:
        logger.info(f"DP over {rank_world()[1]} processes "
                    f"(global batch {args.batch_size * rank_world()[1]})")
    profiler = StepProfiler(args.profile, rank)

    keeper = BestCheckpointKeeper(args.output or "./output", rank)
    iteration = start_epoch * steps_per_epoch
    t_start = time.time()
    results = {}
    for epoch in range(start_epoch, args.epoch):
        ep_start = time.time()
        batch_times = []
        for batch in loader.epoch(epoch):
            t0 = time.time()
            profiler.step(iteration, logger.info)
            metrics = train_step(net, critic, state.optimizer, state.scheduler,
                                 batch_to_device(batch, device), weights)
            iteration += 1
            if iteration % args.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                writer.scalars(m, iteration, prefix="train/")
                eta = np.mean(batch_times[-50:] or [0]) * (total_steps - iteration)
                logger.info(
                    f"Train:[{epoch:2d}/{args.epoch}][{iteration % steps_per_epoch:4d}/"
                    f"{steps_per_epoch}] | loss {m['loss']:.4f} | l1 {m['l1']:.4f} "
                    f"| l4 {m['l4']:.4f} | l5 {m['l5']:.4f} "
                    f"| eta {datetime.timedelta(seconds=int(eta))}")
            batch_times.append(time.time() - t0)
        logger.info(f"EPOCH {epoch} took {datetime.timedelta(seconds=int(time.time() - ep_start))}")

        for split in eval_splits:
            results[split] = validate(model, eval_loaders[split], with_boxes=not args.fast_eval,
                                      **vkw)
            logger.info(f"[epoch {epoch}] {split}: {results[split]}")
        model.train()
        primary = results[eval_splits[0]]
        best = keeper.update(epoch, primary["mIoU"], primary["hit"], lambda path: (
            save_train_checkpoint(path, model, state.optimizer, state.scheduler,
                                  extra={"epoch": epoch})))
        writer.scalars({"mIoU": primary["mIoU"], "oIoU": primary["oIoU"], "hit": primary["hit"]},
                       epoch, prefix="test/")
        logger.info(f"best: {best}")

    profiler.close(logger.info)
    # final: reload the best checkpoint, validate on the train split
    # (train_stage1.py:226-242 of the reference)
    if keeper.best["path"]:
        load_params_only(keeper.best["path"], model)
    train_eval = build_eval_loaders(args, ["train"])["train"]
    results["train"] = validate(model, train_eval, with_boxes=not args.fast_eval, **vkw)
    logger.info(f"validate on train split: {results['train']}")
    logger.info(f"total time {datetime.timedelta(seconds=int(time.time() - t_start))}")
    writer.close()
    return results


if __name__ == "__main__":
    main(get_parser().parse_args())
