"""Stage-2 training entry point, on the card by default.

    python -m tris_tpu_torch.cli.train_stage2 --dataset refcocog --splitBy umd \\
        --pseudo_path ./ins_seg --batch_size 48 --size 320 --epoch 15 \\
        --model_ema --consistency_type mse --output ./output \\
        [--clip_weights RN50.pt] [--ema_eval] [--device cuda|cpu]

Port of ``tris_tpu/cli/train_stage2.py``: the encoder-decoder trained on
IRNet's pseudo-masks (``--pseudo_path``, the ``{index}_{img_id}.npy``
dicts ``cli.irnet --make_ins_seg_pass`` writes), with the EMA teacher's
consistency under ``--model_ema``. The scheduler branch is the
reference's (train_stage2.py:128-140): per-step poly for CLIP backbones,
the epoch-level ``poly_epoch_schedule`` (``--end_lr``, ``--power``,
``--max_decay_steps``) otherwise. A ``validate`` per epoch on each
``--test_split`` (of the teacher with ``--ema_eval``), best-by-mIoU and
best-by-hit checkpoints written by rank 0 (the JAX keeper writes from every
process), and at the end the best checkpoint reloaded and validated on the
train split. ``--fast_eval`` drops the box metrics from both validations,
as ``cli.train_stage1`` does. ``--resume --pretrain F`` continues a
training checkpoint (with its teacher) or starts from a plain
``state_dict``; ``--eval`` only validates. ``--multihost`` trains data
parallel over the processes torchrun starts, as ``cli.train_stage1`` does
(the teacher's batch statistics over the global batch too); ``--profile
DIR`` writes a ``torch.profiler`` trace of steps 10-20.
"""

from __future__ import annotations

import datetime
import time

from tris_tpu_torch.ckpt.io import (
    BestCheckpointKeeper,
    is_train_checkpoint,
    load_params_only,
    resume_train_state,
    save_train_checkpoint,
)
from tris_tpu_torch.cli.common import (
    build_eval_loaders,
    build_stage2,
    build_train_loader,
    load_pretrained,
    start_distributed,
    StepProfiler,
)
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.parallel import rank_world, wrap_ddp
from tris_tpu_torch.eval.validate import validate
from tris_tpu_torch.train.stage2 import Stage2TrainConfig, batch_to_device, train_step
from tris_tpu_torch.train.state import create_train_state, poly_epoch_schedule
from tris_tpu_torch.utils.logging import MetricsWriter, create_logger


def main(args):
    rank = start_distributed(args)
    logger = create_logger(rank)
    writer = MetricsWriter(args.board_folder)
    model = build_stage2(args, train=True)
    device = next(model.parameters()).device

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
    logger.info(f"pseudo-masks from {args.pseudo_path}: {len(loader.ds)} train refs")
    steps_per_epoch = len(loader)
    total_steps = steps_per_epoch * args.epoch
    schedule_factory = None
    if "clip" not in args.backbone:
        schedule_factory = lambda lr: poly_epoch_schedule(  # noqa: E731
            lr, args.end_lr, args.power, args.max_decay_steps, steps_per_epoch)
    state = create_train_state(model, total_steps=total_steps, base_lr=args.lr,
                               lr_multi=args.lr_multi, weight_decay=args.weight_decay,
                               schedule_factory=schedule_factory, stage="stage2",
                               with_ema=args.model_ema)
    start_epoch = args.start_epoch
    if resume_from:
        state.step, resumed_epoch = resume_train_state(resume_from, model, state.optimizer,
                                                       state.scheduler, ema=state.ema)
        if resumed_epoch is not None:
            start_epoch = resumed_epoch
        logger.info(f"resumed from {resume_from} at epoch {start_epoch}")
    tcfg = Stage2TrainConfig(use_ema=args.model_ema, consistency=args.consistency_type)
    state.ddp = wrap_ddp(model, device) if rank_world()[1] > 1 else None
    profiler = StepProfiler(args.profile, rank)

    keeper = BestCheckpointKeeper(args.output or "./output", rank)
    iteration = start_epoch * steps_per_epoch
    t_start = time.time()
    results = {}
    for epoch in range(start_epoch, args.epoch):
        ep_start = time.time()
        for batch in loader.epoch(epoch):
            profiler.step(iteration, logger.info)
            metrics = train_step(state, batch_to_device(batch, device), tcfg)
            iteration += 1
            if iteration % args.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                writer.scalars(m, iteration, prefix="train/")
                logger.info(
                    f"Train:[{epoch:2d}/{args.epoch}][{iteration:6d}/{total_steps}] "
                    f"| loss {m['loss']:.4f} | l1 {m['l1']:.4f} | l5 {m['l5']:.4f}")
        logger.info(f"EPOCH {epoch} took {datetime.timedelta(seconds=int(time.time() - ep_start))}")

        evaluated = state.ema if args.ema_eval and state.ema is not None else model
        for split in eval_splits:
            results[split] = validate(evaluated, eval_loaders[split],
                                      with_boxes=not args.fast_eval, **vkw)
            logger.info(f"[epoch {epoch}] {split}: {results[split]}")
        primary = results[eval_splits[0]]
        best = keeper.update(epoch, primary["mIoU"], primary["hit"], lambda path: (
            save_train_checkpoint(path, model, state.optimizer, state.scheduler,
                                  extra={"epoch": epoch}, ema=state.ema)))
        writer.scalars({"mIoU": primary["mIoU"], "oIoU": primary["oIoU"], "hit": primary["hit"]},
                       epoch, prefix="test/")
        logger.info(f"best: {best}")

    profiler.close(logger.info)
    # final: reload the best checkpoint, validate on the train split
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
