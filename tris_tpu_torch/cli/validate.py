"""Evaluation and PRMS entry point, on the card by default.

    python -m tris_tpu_torch.cli.validate --dataset refcoco --splitBy unc \\
        --refer_data_root ./data --test_split val --size 320 \\
        --pretrain stage1.pth [--stage 2] [--device cuda|cpu]

PRMS CAM dump for IRNet: add ``--prms --save_cam --cam_save_dir ...
--name_save_dir ...`` (and ``--critic_weights ViT-B-32.pt``).

Port of ``tris_tpu/cli/validate.py``. ``--stage 2`` evaluates the stage-2
encoder-decoder (the reference switches validate.py between its two models
by editing an import); ``--prms`` scores stage-1 maps and exits with
``--stage 2``, as the JAX CLI does. ``--dataset referit`` evaluates the
flicker-pickle test protocol on ``--refer_data_root`` (``annotations/`` and
``images/``) for the split ``--test_split``. ``--fast_eval`` skips the box
metrics, so that the eval reduces to per-sentence scalars on the card.
``--multihost``: the refs sharded over the processes torchrun starts, the
metrics gathered (ReferIt's split runs whole on every rank). ``--bf16``:
stage 1 in bfloat16 (eval, ``--prms`` and ReferIt; the critic stays float32).
"""

from __future__ import annotations

from tris_tpu_torch.cli.common import (
    build_critic,
    build_eval_loaders,
    build_stage1,
    build_stage2,
    load_pretrained,
    start_distributed,
)
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.eval.validate import validate, validate_prms
from tris_tpu_torch.utils.logging import create_logger


def main(args):
    stage = int(getattr(args, "stage", 1))
    if stage == 2 and args.prms:
        raise SystemExit("--prms scores stage-1 response maps; use --stage 1")
    logger = create_logger(start_distributed(args))
    model = load_pretrained(args, build_stage2(args) if stage == 2 else build_stage1(args))
    if args.dataset == "referit":
        from tris_tpu_torch.data.referit import ReferItTestDataset
        from tris_tpu_torch.eval.validate_referit import validate_referit

        ds = ReferItTestDataset(args.refer_data_root, split=args.test_split, size=args.size,
                                max_tokens=args.max_query_len)
        res = validate_referit(model, ds, log=logger.info,
                               device_resize=not args.no_device_resize)
        logger.info(f"[referit/{args.test_split}] {res}")
        return res
    critic = build_critic(args) if args.prms else None
    splits = args.test_split.split(",")
    loaders = build_eval_loaders(args, splits)
    results = {}
    for split in splits:
        kw = dict(save_cam=args.save_cam, cam_save_dir=args.cam_save_dir,
                  name_save_dir=args.name_save_dir, dataset_name=args.dataset,
                  log=logger.info, host_threads=args.host_threads,
                  device_resize=not args.no_device_resize)
        if args.prms:
            res = validate_prms(model, critic, loaders[split], **kw)
        else:
            res = validate(model, loaders[split], with_boxes=not args.fast_eval, **kw)
        results[split] = res
        logger.info(f"[{split}] {res}")
    return results


if __name__ == "__main__":
    main(get_parser().parse_args())
