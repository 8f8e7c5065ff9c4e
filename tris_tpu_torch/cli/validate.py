"""Stage-1 evaluation entry point (non-PRMS), on the card by default.

    python -m tris_tpu_torch.cli.validate --dataset refcoco --splitBy unc \\
        --refer_data_root ./data --test_split val --size 320 \\
        --pretrain stage1.pth [--device cuda|cpu]

Port of ``tris_tpu/cli/validate.py`` for stage 1. ``--prms``, ``--stage 2``
and ``--dataset referit`` are not ported yet and exit with an error.
``--fast_eval`` skips the box metrics, so that the eval reduces to
per-sentence scalars on the card.
"""

from __future__ import annotations

from tris_tpu_torch.cli.common import (
    build_eval_loaders,
    build_stage1,
    dist_rank_world,
    load_pretrained,
)
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.eval.validate import validate
from tris_tpu_torch.utils.logging import create_logger

_NOT_PORTED = "is not ported to the PyTorch package yet; use tris_tpu.cli.validate"


def main(args):
    if args.prms:
        raise SystemExit(f"--prms {_NOT_PORTED}")
    if int(getattr(args, "stage", 1)) != 1:
        raise SystemExit(f"--stage {args.stage} {_NOT_PORTED}")
    if args.dataset == "referit":
        raise SystemExit(f"--dataset referit {_NOT_PORTED}")
    logger = create_logger(dist_rank_world()[0])
    model = load_pretrained(args, build_stage1(args))
    splits = args.test_split.split(",")
    loaders = build_eval_loaders(args, splits)
    results = {}
    for split in splits:
        res = validate(
            model, loaders[split], with_boxes=not args.fast_eval,
            save_cam=args.save_cam, cam_save_dir=args.cam_save_dir,
            name_save_dir=args.name_save_dir, dataset_name=args.dataset,
            log=logger.info, host_threads=args.host_threads,
            device_resize=not args.no_device_resize,
        )
        results[split] = res
        logger.info(f"[{split}] {res}")
    return results


if __name__ == "__main__":
    main(get_parser().parse_args())
