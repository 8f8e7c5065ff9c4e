"""Where the stage-1 eval forward, the PRMS step, the stage-1 train step, one
image of IRNet's instance pseudo-mask pass, one IRN training step or one
stage-2 training step spends its time on the card.

    python -m tris_tpu_torch.tools.profile_eval [--prms | --train | --ins_seg | --train_irn |
        --train_stage2 | --eval_stage2] [--bf16] [--batch 8] [--sents 4] [--negatives 3] \\
        [--size 320] [--iters 5] [--out PATH]

Builds RN50 stage 1 at full width with seeded random weights (as
``chip_smoke.py`` does), times ``response_maps`` on the host clock (with
``--prms``: ``make_prms_forward``'s step, which adds the u8 upload and its
normalisation, and the ViT-B/32 critic with seeded random weights; with
``--train``: one ``train_step`` of stage 1 against that critic on a u8
batch of ``--batch`` images with ``--negatives`` negatives each, forward,
backward and AdamW update; with ``--ins_seg``: one 480x640 image of the
pass, a seeded full-width IRNet's forward, K9, the host clustering, the
walk, the upsample and the host detection, on a synthetic image and CAM;
with ``--train_irn``: one IRN ``train_step`` at crop 512, radius 10 and
``--batch`` (24 unless given) of a seeded full-width IRNet on a synthetic
batch, forward, the loss fused with K7 (K7 + K8), backward and SGD update;
with ``--train_stage2``: one stage-2 ``train_step`` of seeded full-width
RN50 stage 2 with the EMA teacher at the default gate (an update every 10
steps, after 100) and consistency mse on a u8 batch of ``--batch`` (48
unless given) images and random 0/1 pseudo-masks, student and teacher
forward, backward, AdamW; with ``--eval_stage2``: seeded full-width RN50
stage 2's ``response_maps`` in eval mode on ``--batch`` x ``--sents`` pairs, the
eval forward of ``cli.validate --stage 2``), then
traces ``--iters`` calls with ``torch.profiler`` and prints one JSON line:
wall ms per forward, the card's busy ms per forward (the sum of its kernels'
times, the ranges the trace also spans on the device left out; one stream,
so they do not overlap) and its idle share, and the
device time by kernel class (the hand-written kernels by name, K13's
summed and by design, cuDNN convolutions, cuDNN's layout transposes, GEMMs,
everything else), by kernel name, and ``InstanceNorm2d``'s (the kernels its
forwards and their backward launched); ``--out`` also writes it to a file.
``--bf16``: stage 1 in bfloat16 (its seeded init), eval, ``--prms`` or
``--train`` (the critic float32), or stage 2 in bfloat16 with ``--eval_stage2``.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

# matched as substrings of the profiler's names, so every instantiation of a
# templated kernel (K1's mha_short_kernel<56, 64, true>, ...) files under its own
HAND_KERNELS = ("mha_short_kernel", "mha_short_bf16_kernel", "mha_short_bwd_kernel",
                "cross_attn_kernel",
                "cross_attn_probs_bwd_kernel", "cross_attn_grads_bwd_kernel",
                "response_head_kernel", "stage1_head_fwd_kernel", "stage1_head_bwd_kernel",
                "eval_metrics_kernel",
                "critic_input_kernel", "critic_input_bwd_kernel", "normalize_u8_kernel",
                "bilinear_resize_kernel", "bilinear_resize_bwd_kernel",
                "bilinear_resize_bwd_direct_kernel", "path_max_tiled_kernel", "path_max_kernel",
                "path_max_gather_kernel", "irn_affinity_loss_kernel",
                "irn_affinity_loss_final_kernel", "refine_centroids_staged_kernel",
                "refine_centroids_direct_kernel",
                "walk_transition_kernel", "walk_square_kernel", "walk_thin_kernel",
                "walk_tile_occupancy_kernel", "pixel_attn_kernel", "pixel_attn_bwd_probs_dq_kernel", "pixel_attn_bwd_dkv_kernel",
                "ema_update_kernel", "batch_norm_fwd_fused_kernel", "batch_norm_bwd_fused_kernel",
                "batch_norm_bwd_slope_kernel", "batch_norm_stats_partial_kernel",
                "batch_norm_stats_final_kernel", "batch_norm_apply_kernel",
                "batch_norm_bwd_partial_kernel", "batch_norm_bwd_final_kernel",
                "batch_norm_bwd_apply_kernel", "batch_norm_fold_bf16_kernel",
                "batch_norm_apply_bf16_kernel", "batch_norm_bwd_apply_bf16_kernel",
                "mha_short_bwd_bf16_kernel", "cross_attn_probs_bwd_bf16_kernel",
                "cross_attn_grads_bwd_bf16_kernel", "stage1_head_bf16_fwd_kernel",
                "stage1_head_bf16_bwd_kernel")
# K13's kernels by design: the fused (and PReLU's slope sum after the fused backward),
# the rest two-pass (the eval fold's apply among them)
K13_FUSED = ("batch_norm_fwd_fused_kernel", "batch_norm_bwd_fused_kernel",
             "batch_norm_bwd_slope_kernel")


def kernel_class(name: str) -> str:
    for k in HAND_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low:  # cuDNN's layout transposes around a conv
        return "layout"
    if "conv" in low or "cudnn" in low or "implicit" in low or "winograd" in low:
        return "convolution"
    if "gemm" in low or "cutlass" in low or "gemv" in low:
        return "gemm"
    return "other"


def module_device_ms(events, name: str, iters: int) -> dict:
    """Card ms per step of the kernels module ``name`` launched, forward (the
    ops under its ``record_function`` range) and backward (the autograd
    nodes those ops recorded, matched by sequence number), and its calls."""
    def tree(e):
        yield e
        for c in e.cpu_children:
            yield from tree(c)

    def kernel_ms(e):
        return sum(k.duration for k in e.kernels) / 1e3

    ranges = [e for e in events if e.name == name]
    fwd = [d for r in ranges for d in tree(r)]
    seqs = {d.sequence_nr for d in fwd if d.sequence_nr >= 0}
    bwd = [d for e in events if e.name.startswith("autograd::engine::evaluate_function")
           and e.sequence_nr in seqs for d in tree(e)]
    return {"forward_ms": sum(map(kernel_ms, fwd)) / iters,
            "backward_ms": sum(map(kernel_ms, bwd)) / iters, "calls": len(ranges) / iters}


@contextlib.contextmanager
def instance_norm_ranges():
    """Each ``InstanceNorm2d`` forward inside a ``record_function`` range of
    that name, for :func:`module_device_ms`."""
    from tris_tpu_torch.models.layers import InstanceNorm2d

    forward = InstanceNorm2d.forward

    def ranged(self, *a, **kw):
        with torch.profiler.record_function("InstanceNorm2d"):
            return forward(self, *a, **kw)

    InstanceNorm2d.forward = ranged
    try:
        yield
    finally:
        InstanceNorm2d.forward = forward


def ins_seg_step(dev, rng, size=(480, 640), dp_scale=16.0):
    """One image of the instance pseudo-mask pass, its host stages included:
    a u8 image of flat rectangles on noise, a Gaussian CAM on the first, a
    seeded IRNet whose last displacement conv is scaled by ``dp_scale``
    (as ``chip_smoke.py`` builds it)."""
    from tris_tpu_torch.pseudo.irnet import build_irnet, edge_displacement_infer
    from tris_tpu_torch.pseudo.labels import make_instance_masks
    from tris_tpu_torch.pseudo.pipeline import normalize_image

    h, w = size
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    for y0, x0, bh, bw in ((60, 80, 200, 240), (250, 380, 180, 200), (20, 400, 120, 160)):
        img[y0:y0 + bh, x0:x0 + bw] = rng.integers(80, 256, 3)
    yy, xx = np.mgrid[:h, :w]
    cam = np.exp(-0.5 * (((yy - 160) / 120) ** 2 + ((xx - 200) / 144) ** 2)).astype(np.float32)
    model = build_irnet(None, dev, seed=0)
    with torch.no_grad():
        model.fc_dp7[3].weight.mul_(dp_scale)
    img_d = torch.as_tensor(normalize_image(img), device=dev)

    def step():
        edge, disp = edge_displacement_infer(model, img_d)
        return make_instance_masks(edge, disp, cam, size, device=dev)

    return step


def train_irn_step(dev, rng, batch_size=24, crop=512, radius=10):
    """One IRN training step at full width: a seeded IRNet, SGD as
    ``pipeline.run_train_irn`` builds it, and a synthetic batch (normalised
    noise with flat rectangles, a blocky {0, 1, 255} label map at quarter
    scale)."""
    from tris_tpu_torch.pseudo.indexing import PathIndex
    from tris_tpu_torch.pseudo.irnet import IRNet
    from tris_tpu_torch.pseudo.train_irn import (
        IRNTrainConfig, batch_to_device, make_irn_optimizer, train_step)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = IRNet().to(dev).train()
    opt, sched = make_irn_optimizer(model, IRNTrainConfig(crop_size=crop, radius=radius), 1000)
    image = rng.standard_normal((batch_size, crop, crop, 3)).astype(np.float32)
    image[:, crop // 4:crop // 2, crop // 4:3 * crop // 4] = 1.0
    q = crop // 4
    blocks = rng.choice(np.array([0, 1, 255], np.uint8), (batch_size, q // 8, q // 8))
    label = blocks.repeat(8, 1).repeat(8, 2)
    batch = batch_to_device({"image": image, "reduced_label": label}, dev)
    path_index = PathIndex(radius, (q, q))
    return lambda: train_step(model, opt, sched, path_index, batch)


def train_stage2_step(dev, rng, batch_size=48, size=320):
    """One stage-2 training step at full width: seeded RN50 stage 2, its EMA
    teacher and AdamW groups as ``cli.train_stage2`` builds them, and a
    synthetic u8 batch with random 0/1 pseudo-masks (blocks of 8 pixels)."""
    from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2
    from tris_tpu_torch.train.stage2 import Stage2TrainConfig, batch_to_device, train_step
    from tris_tpu_torch.train.state import create_train_state

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TRISStage2(Stage2Config(backbone="RN50", txt_length=20)).to(dev)
    state = create_train_state(model, total_steps=1000, stage="stage2", with_ema=True)
    ids = np.zeros((batch_size, 20), np.int32)
    ids[:, 0], ids[:, 1:6], ids[:, 6] = 49406, rng.integers(1, 49000, (batch_size, 5)), 49407
    blocks = rng.random((batch_size, size // 8, size // 8, 1)) > 0.6
    batch = batch_to_device({
        "image": rng.integers(0, 256, (batch_size, size, size, 3), dtype=np.uint8),
        "word_ids": ids, "pseudo": blocks.repeat(8, 1).repeat(8, 2).astype(np.float32)}, dev)
    cfg = Stage2TrainConfig(use_ema=True)
    return lambda: train_step(state, batch, cfg)


def main(argv=None) -> dict:
    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser
    from tris_tpu_torch.device import resolve_device
    from tris_tpu_torch.eval.validate import image_to_nchw, make_prms_forward
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--prms", action="store_true", help="profile the PRMS step instead")
    mode.add_argument("--train", action="store_true", help="profile one stage-1 train step")
    mode.add_argument("--ins_seg", action="store_true",
                      help="profile one 480x640 image of the instance pseudo-mask pass")
    mode.add_argument("--train_irn", action="store_true",
                      help="profile one IRN training step (crop 512, radius 10)")
    mode.add_argument("--train_stage2", action="store_true",
                      help="profile one stage-2 training step with the EMA teacher")
    mode.add_argument("--eval_stage2", action="store_true",
                      help="profile stage 2's eval forward (response_maps)")
    p.add_argument("--batch", type=int, default=None,
                   help="default 8 (24 with --train_irn, 48 with --train_stage2)")
    p.add_argument("--sents", type=int, default=4)
    p.add_argument("--negatives", type=int, default=3, help="negatives per image (--train)")
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--iters", type=int, default=None, help="default 5 (1 with --ins_seg)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 (--bf16): stage 1 (eval, --prms and --train) or stage 2 "
                        "(--eval_stage2)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if args.bf16 and (args.ins_seg or args.train_irn or args.train_stage2):
        p.error("--bf16 covers stage-1 eval, --prms, --train and --eval_stage2")
    if args.iters is None:
        args.iters = 1 if args.ins_seg else 5
    if args.batch is None:
        args.batch = 24 if args.train_irn else 48 if args.train_stage2 else 8

    dev = resolve_device("cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TRISStage1(Stage1Config(backbone="RN50", hidden_dim=1024, txt_length=20),
                           torch.bfloat16 if args.bf16 else torch.float32)
    model = model.to(dev).train(args.train)
    rng = np.random.default_rng(0)
    image_u8 = rng.integers(0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
    ids = np.zeros((args.batch, args.sents, 20), np.int32)
    ids[..., 0], ids[..., 1:6], ids[..., 6] = 49406, rng.integers(1, 49000, 5), 49407
    grad = False
    if args.ins_seg:
        step = ins_seg_step(dev, rng)
    elif args.train_irn:
        del model
        step = train_irn_step(dev, rng, args.batch)
        grad = True
    elif args.train_stage2:
        del model
        step = train_stage2_step(dev, rng, args.batch, args.size)
        grad = True
    elif args.train:
        from tris_tpu_torch.train.stage1 import batch_to_device, train_step
        from tris_tpu_torch.train.state import make_optimizer

        critic = build_critic(get_parser().parse_args([]), dev)
        optimizer, scheduler = make_optimizer(model, total_steps=1000)
        neg = np.zeros((args.batch, args.negatives, 20), np.int32)
        neg[..., 0], neg[..., 1:4], neg[..., 4] = 49406, rng.integers(1, 49000, 3), 49407
        batch = batch_to_device({"image": image_u8, "word_ids": ids[:, 0], "neg_word_ids": neg},
                                dev)
        step = lambda: train_step(model, critic, optimizer, scheduler, batch)  # noqa: E731
        grad = True
    elif args.eval_stage2:
        from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2

        del model
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = TRISStage2(Stage2Config(backbone="RN50", txt_length=20),
                               torch.bfloat16 if args.bf16 else torch.float32)
        model = model.to(dev).eval()
        image = image_to_nchw(torch.as_tensor(image_u8, device=dev))
        ids_d = torch.as_tensor(ids, device=dev)
        step = lambda: model.response_maps(image, ids_d)  # noqa: E731
    elif args.prms:
        forward = make_prms_forward(model, build_critic(get_parser().parse_args([]), dev))
        valid = np.ones((args.batch, args.sents), bool)
        step = lambda: forward(image_u8, ids, valid)  # noqa: E731
    else:
        image = image_to_nchw(torch.as_tensor(image_u8, device=dev))
        ids_d = torch.as_tensor(ids, device=dev)
        step = lambda: model.response_maps(image, ids_d)  # noqa: E731

    with torch.set_grad_enabled(grad):
        for _ in range(1 if args.ins_seg else 3):   # warm-up (cuDNN, cuBLAS, allocator)
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with instance_norm_ranges(), torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                step()
            torch.cuda.synchronize()

    by_name = {}
    # the trace's ranges (record_function's, the optimizer's step) also have a device span:
    # they are no kernels, and they share their names with host events
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {evt.name for evt in prof.events() if evt.device_type != cuda}
    for evt in prof.events():
        if evt.device_type == cuda and evt.name not in ranges:
            t = by_name.setdefault(evt.name, [0.0, 0])
            t[0] += evt.time_range.elapsed_us() / 1e3 / args.iters   # ms per forward
            t[1] += 1
    busy = sum(t for t, _ in by_name.values())
    classes = {}
    for name, (t, _) in by_name.items():
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    res = {
        "device": torch.cuda.get_device_name(0),
        "dtype": "bfloat16" if args.bf16 else "float32",
        "step": ("train_step" if args.train else "make_prms_forward" if args.prms else
                 "ins_seg_image" if args.ins_seg else "irn_train_step" if args.train_irn else
                 "stage2_train_step" if args.train_stage2 else
                 "stage2_response_maps" if args.eval_stage2 else "response_maps"),
        "shape": ({"image": [480, 640]} if args.ins_seg else
                  {"batch": args.batch, "crop": 512, "radius": 10} if args.train_irn else
                  {"batch": args.batch, "size": args.size, "ema": "default gate"}
                  if args.train_stage2 else
                  {"batch": args.batch, "sents": args.sents, "size": args.size,
                   **({"negatives": args.negatives} if args.train else {})}),
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy,
        "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
        "kernel_launches_per_forward": sum(n for _, n in by_name.values()) / args.iters,
        "device_ms_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        "k13_batch_norm_ms": sum(t for c, t in classes.items() if c.startswith("batch_norm_")),
        "k13_fused_ms": sum(t for c, t in classes.items() if c in K13_FUSED),
        "k13_two_pass_ms": sum(t for c, t in classes.items()
                               if c.startswith("batch_norm_") and c not in K13_FUSED),
        "instance_norm_ms": module_device_ms(prof.events(), "InstanceNorm2d", args.iters),
        "top_kernels_ms": [[name[:120], t, n // args.iters] for name, (t, n) in top],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
