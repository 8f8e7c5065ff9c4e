"""Argument parser shared by the CLI entry points.

Copy of the JAX package's parser. It mirrors the reference's ``args.py``
flag surface (same names/defaults, `reference/args.py:3-98`) so shell
scripts written against the reference work unchanged, plus those of the JAX
package's additions that this package implements (``--bf16`` for stage-1
eval, PRMS, ReferIt and training on one process, refused by name
elsewhere) and its own ``--device``. ``--multihost`` joins the process
group torchrun describes (``tris_tpu_torch.parallel``) and ``--profile DIR``
writes a ``torch.profiler`` trace of the trainers' steps 10-20. The JAX
package's tensor-parallel ``--tp`` and its unread ``--scales`` are not here:
passing one is an argparse error, not a silent no-op.
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="TRIS referring segmentation (PyTorch)")
    # dataset
    parser.add_argument("--dataset", default="refcoco",
                        help="refcoco | refcoco+ | refcocog | refcocog_umd | referit")
    parser.add_argument("--max_query_len", default=20, type=int)
    parser.add_argument("--negative_samples", default=0, type=int)
    parser.add_argument("--positive_samples", default=1, type=int)
    parser.add_argument("--bert_tokenizer", default="clip")
    parser.add_argument("--refer_data_root", default="./data", help="REFER dataset root")
    parser.add_argument("--splitBy", default="unc")
    parser.add_argument("--spilt", default="val")  # kept for script compat (sic)
    parser.add_argument("--pretrained_checkpoint", default=None, type=str)
    # optimizer
    parser.add_argument("--lr", default=0.00005, type=float)
    parser.add_argument("--weight-decay", "--weight_decay", dest="weight_decay",
                        default=0.01, type=float)
    parser.add_argument("--lr_multi", default=0.1, type=float)
    parser.add_argument("--end_lr", default=1e-5, type=float)
    parser.add_argument("--power", default=1.0, type=float)
    parser.add_argument("--max_decay_steps", default=40, type=int)
    # training
    parser.add_argument("--batch_size", default=1, type=int,
                        help="per-process training batch")
    parser.add_argument("--epoch", default=30, type=int)
    parser.add_argument("--print-freq", dest="print_freq", default=100, type=int)
    parser.add_argument("--size", default=384, type=int)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--pseudo_path", default=None, type=str)
    # eval
    parser.add_argument("--pretrain", default=None, type=str)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--test_split", default="val", type=str)
    parser.add_argument("--prms", action="store_true", default=False)
    parser.add_argument("--eval_mode", default="cat", type=str)
    parser.add_argument("--visualize", action="store_true", default=False)
    parser.add_argument("--model_ema", action="store_true", default=False)
    parser.add_argument("--consistency_type", default="mse", type=str)
    # output
    parser.add_argument("--output", default=None, type=str)
    parser.add_argument("--board_folder", default=None, type=str)
    parser.add_argument("--pooling", default="gmp_gap", type=str)
    # loss weights
    parser.add_argument("--attn_multi", default=0.1, type=float)
    parser.add_argument("--w1", default=1, type=float)
    parser.add_argument("--w2", default=0, type=float)
    parser.add_argument("--w3", default=0, type=float)
    parser.add_argument("--w4", default=5, type=float)
    parser.add_argument("--w5", default=2, type=float)
    parser.add_argument("--FOCAL_P", default=3, type=float)
    parser.add_argument("--FOCAL_LAMBDA", default=0.01, type=float)
    # model
    parser.add_argument("--backbone", default="clip-RN50", type=str)
    parser.add_argument("--hidden_dim", default=1024, type=int)
    parser.add_argument("--stage", default=1, type=int, choices=(1, 2),
                        help="which model cli/validate evaluates (the reference "
                             "switches validate.py between model_stage1/2 by "
                             "editing the import, validate.py:23-24)")
    # CAM dump (PRMS -> IRNet)
    parser.add_argument("--cam_save_dir", default=None, type=str)
    parser.add_argument("--name_save_dir", default=None, type=str)
    parser.add_argument("--save_cam", action="store_true", default=False)
    parser.add_argument("--mode", default="clip", type=str)
    # demo
    parser.add_argument("--img", default=None, type=str)
    parser.add_argument("--text", default=None, type=str)
    # additions over the reference
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute, as the JAX package's flax dtype: stage-1 eval, "
                             "PRMS and ReferIt (cli.validate --stage 1) and stage-1 training "
                             "on one process; stage 2, the demo and training over several "
                             "processes refuse it (not ported yet)")
    parser.add_argument("--seed", default=1234, type=int)
    parser.add_argument("--clip_weights", default=None, type=str,
                        help="OpenAI CLIP RN50/RN101 .pt for the backbone's init "
                             "(default: random init)")
    parser.add_argument("--ema_eval", action="store_true",
                        help="stage 2: validate the EMA teacher (with --model_ema)")
    parser.add_argument("--critic_weights", default=None, type=str,
                        help="OpenAI ViT-B-32.pt for the PRMS critic (default: random init)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device the model runs on (cuda or cpu)")
    parser.add_argument("--multihost", action="store_true",
                        help="data parallel over the processes torchrun starts (one a card: "
                             "nccl on cuda:LOCAL_RANK; gloo with --device cpu); "
                             "--batch_size stays per process")
    parser.add_argument("--profile", default=None, type=str,
                        help="write a torch.profiler trace of train steps 10-20 to this dir")
    parser.add_argument("--eval_batch", default=8, type=int, help="refs per eval batch")
    parser.add_argument("--host_threads", default=0, type=int,
                        help="threads for per-ref host metric work (0 = cpu_count)")
    parser.add_argument("--no_device_resize", action="store_true",
                        help="keep the eval original-size upsample+normalize on "
                             "the host (numpy). Note: when maps must reach the host "
                             "anyway (--save_cam, or box metrics on), device resize "
                             "fetches padded [maxH, maxW] maps (~4x the bytes of the "
                             "raw 320px maps); with --fast_eval only per-sentence "
                             "scalars are fetched")
    parser.add_argument("--fast_eval", action="store_true",
                        help="eval without box metrics: I/U/hit reduce on the card "
                             "(K4) and only per-sentence scalars are fetched; the "
                             "reference logs box metrics, so this is off by default")
    return parser


def backbone_name(args) -> str:
    """'clip-RN50' -> 'RN50' (model_stage1.py:28)."""
    return args.backbone.split("-")[-1]
