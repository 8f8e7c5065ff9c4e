"""IRNet pseudo-label entry point, on the card by default.

    python -m tris_tpu_torch.cli.irnet --train_list out/names/refcoco_train_names.json \\
        --data_root data/train2014 --cam_dir out/cam --ir_label_out_dir out/ir_label \\
        --ins_seg_out_dir out/ins_seg --irn_weights out/res50_irn.pth \\
        --cam_to_ir_label_pass --train_irn_pass --make_ins_seg_pass [--device cuda|cpu]

Port of ``tris_tpu/cli/irnet.py`` with the same options and ``--device``.
The passes run in order: ``--cam_to_ir_label_pass`` writes the ir label
PNGs from the PRMS CAMs (``cli.validate --prms --save_cam``) with the CRF
on the host; ``--train_irn_pass`` trains IRNet on them
(``--irn_batch_size``, ``--irn_num_epoches``, ``--irn_learning_rate``) and
saves a torch checkpoint to ``--irn_weights``; ``--make_ins_seg_pass``
writes the instance pseudo-masks from the CAMs and that checkpoint.
``--multihost`` runs the
passes over the processes torchrun starts: the names strided over the
ranks in the first and third, IRN training data parallel in the second.
"""

from __future__ import annotations

import argparse

from tris_tpu_torch.cli.common import start_distributed
from tris_tpu_torch.pseudo.pipeline import (
    PseudoConfig, run_cam_to_ir_label, run_make_ins_seg, run_train_irn)


def get_irn_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TRIS IRNet pseudo-label pipeline (PyTorch)")
    p.add_argument("--train_list", required=True, help="names json from PRMS CAM dump")
    p.add_argument("--data_root", default="./data/train2014")
    p.add_argument("--cam_out_dir", "--cam_dir", dest="cam_dir", default="./out/cam")
    p.add_argument("--ir_label_out_dir", "--ir_label_dir", dest="ir_label_dir",
                   default="./out/ir_label")
    p.add_argument("--ins_seg_out_dir", "--ins_seg_dir", dest="ins_seg_dir",
                   default="./out/ins_seg")
    p.add_argument("--irn_weights_name", "--irn_weights", dest="irn_weights",
                   default="./out/res50_irn.pth", help="a torch IRNet checkpoint (.pth)")
    # thresholds (run_sample_refer.py:55-93 of the reference)
    p.add_argument("--conf_fg_thres", default=0.3, type=float)
    p.add_argument("--conf_bg_thres", default=0.1, type=float)
    p.add_argument("--irn_crop_size", default=512, type=int)
    p.add_argument("--irn_radius", default=10, type=int,
                   help="affinity path radius; crop_size/4 must exceed 2*(radius-1)")
    p.add_argument("--irn_batch_size", default=24, type=int)
    p.add_argument("--irn_num_epoches", default=3, type=int)
    p.add_argument("--irn_learning_rate", default=0.1, type=float)
    p.add_argument("--beta", default=10, type=float)
    p.add_argument("--exp_times", default=8, type=int)
    p.add_argument("--ins_seg_bg_thres", default=0.25, type=float)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--multihost", action="store_true",
                   help="run over the processes torchrun starts (one a card)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    # pass gates
    p.add_argument("--cam_to_ir_label_pass", action="store_true")
    p.add_argument("--train_irn_pass", action="store_true")
    p.add_argument("--make_ins_seg_pass", action="store_true")
    return p


def main(args):
    cfg = PseudoConfig(
        train_list=args.train_list,
        data_root=args.data_root,
        cam_dir=args.cam_dir,
        ir_label_dir=args.ir_label_dir,
        ins_seg_dir=args.ins_seg_dir,
        irn_weights=args.irn_weights,
        conf_fg_thres=args.conf_fg_thres,
        conf_bg_thres=args.conf_bg_thres,
        crop_size=args.irn_crop_size,
        radius=args.irn_radius,
        beta=args.beta,
        exp_times=args.exp_times,
        ins_seg_bg_thres=args.ins_seg_bg_thres,
        num_workers=args.num_workers,
    )
    start_distributed(args)
    if args.cam_to_ir_label_pass:
        print("== cam_to_ir_label ==")
        run_cam_to_ir_label(cfg)
    if args.train_irn_pass:
        print("== train_irn ==")
        run_train_irn(cfg, epochs=args.irn_num_epoches, batch_size=args.irn_batch_size,
                      lr=args.irn_learning_rate, device=args.device)
    if args.make_ins_seg_pass:
        print("== make_ins_seg ==")
        run_make_ins_seg(cfg, device=args.device)


if __name__ == "__main__":
    main(get_irn_parser().parse_args())
