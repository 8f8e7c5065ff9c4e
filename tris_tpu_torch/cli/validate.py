"""Stage-1 evaluation and PRMS entry point, on the card by default.

    python -m tris_tpu_torch.cli.validate --dataset refcoco --splitBy unc \\
        --refer_data_root ./data --test_split val --size 320 \\
        --pretrain stage1.pth [--device cuda|cpu]

PRMS CAM dump for IRNet: add ``--prms --save_cam --cam_save_dir ...
--name_save_dir ...`` (and ``--critic_weights ViT-B-32.pt``).

Port of ``tris_tpu/cli/validate.py`` for stage 1. ``--stage 2`` and
``--dataset referit`` are not ported yet and exit with an error.
``--fast_eval`` skips the box metrics, so that the eval reduces to
per-sentence scalars on the card.
"""

from __future__ import annotations

from tris_tpu_torch.cli.common import (
    build_critic,
    build_eval_loaders,
    build_stage1,
    dist_rank_world,
    load_pretrained,
)
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.eval.validate import validate, validate_prms
from tris_tpu_torch.utils.logging import create_logger

_NOT_PORTED = "is not ported to the PyTorch package yet; use tris_tpu.cli.validate"


def main(args):
    if int(getattr(args, "stage", 1)) != 1:
        raise SystemExit(f"--stage {args.stage} {_NOT_PORTED}")
    if args.dataset == "referit":
        raise SystemExit(f"--dataset referit {_NOT_PORTED}")
    logger = create_logger(dist_rank_world()[0])
    model = load_pretrained(args, build_stage1(args))
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
