#!/usr/bin/env python3
"""Drive the PyTorch port of TRIS (``tris_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Phases, in order; an error stops the run,
and a failed check of phases 3-15 exits 1 once all have run (so the report
holds every number):

1. device  - the card's name and ``nvidia-smi`` name / power limit;
2. build   - the hand-written kernels from ``tris_tpu_torch/kernels/csrc``
             (``torch.utils.cpp_extension``, ``nvcc``, ``sm_90a``; ninja
             compiles the sources in parallel);
3. kernels - each kernel against its plain PyTorch version on the card at
             the main paths' shapes (K1 at the text towers', the ViT
             critic's and attnpool's; K3's eval head with its plan and
             cluster; K4 at stage-1 eval's, on PRMS's
             selected maps and writing the normalised planes PRMS saves,
             each with its plan and launch shape; the backward kernels and K3's training head at
             the stage-1 train step's, K1's and K2's backward twice, bit for
             bit, with K1's and K2's forward-plus-backward times and the
             grids their launchers made; K6's bilinear
             half (each forward row with its plan and launch shape), K7, K9
             and K10 at a 480x640 image's IRNet pass; K6's
             bilinear backward (each row with its plan and launch shape, as
             at stage 2's shapes), K7's forward, K7's backward (ties planted)
             and the loss fused with K7 (K7 + K8: sums, counts and
             gradients, each twice bit for bit, the peak memory of forward
             and backward) at IRN training's B=24, crop 512, radius 10, the
             tiled rows with their plans and shared-memory loads; K11
             forward at stage 2's
             c2, c3 and c4 for B=48 and for eval's 8 images x 4 pairs, its
             backward at the train levels, each also against float64 and with
             its launches' grids, the c2 backward twice, bit for bit, and
             its two launches timed alone; K12 over the whole stage-2 tree,
             bit for bit; K6 bilinear forward and backward at the stage-2
             decoder's align_corners=False taps; K10's products also on a
             dense random operand against cuBLAS DGEMM and as the chain on a
             closed-region edge map, with the share of k-tiles skipped, banded
             equal to dense and skip to no skip bit for bit; K10's occupancy
             maps; K13's BatchNorm with its activation at the RN50 trunk's
             and stage 2's shapes, train forward and backward, the teacher's
             batch statistics and the eval fold, against the JAX package's
             arithmetic and float64); the four bfloat16 kernels of ``--bf16``
             (K1 at the text tower's bfloat16 q, k, v; K2 and K3's eval head at
             response_maps' shapes on both leaf regimes' operands; K13's eval
             fold at the B=8 stem, layer1's and layer4's tails and a
             downsample), each one's and its plain version's distance from a
             float64 evaluation of the same bfloat16 inputs, and the
             bfloat16 kernels of ``--bf16`` training at the train step's
             shapes (K13's train forward and backward at the stem, layer1's
             and layer4's tails and layer3; K1's backward at the text tower;
             K2's forward keeping its probabilities and its backward, K3's
             training head forward and backward, each on both mixes), and the
             bfloat16 kernels of ``--bf16`` stage-2 eval and the demo (K11's
             forward at c2, c3 and c4 of an 8 x 4 eval batch on both leaf
             regimes' q and at the demo's 40 tokens; K6's bilinear forward at
             the decoder's x2 upsamples and the head's to 320 px, bit for
             bit; K13's eval fold with PReLU at the decoder's norms with a
             bfloat16 and a float32 slope, bit for bit), the
             kernel's within one bfloat16 ulp of the output's scale of the plain
             version's (and, where the plain version lies past a tenth of the
             scale from float64, within 4 such ulps of the plain version);
             device times of kernel, plain version and, where one exists, the
             one PyTorch call computing the same thing; the least time the card
             could take (bytes or operations over the published peak: FP32, and
             the FP64 tensor cores' for K10's products);
4. stage-1 eval - RN50 stage 1 at full width (hidden 1024, 20 tokens,
             320 px, B=8 refs x S=4 sentences, seeded random weights):
             ``response_maps``, ``forward(train=False)`` and
             ``validate(with_boxes=False)`` over a synthetic in-memory u8
             loader, with every kernel launch counter set to 0 just before
             and read just after (K13's exactly: 55 a trunk forward); then
             the same three with the models routed
             to the plain versions, which the outputs must agree with; then
             host step times of both routes, alternating, over ``ROUNDS``
             (here and in every phase, the plain route's times and peak
             memory take K13's plain version, the JAX package's arithmetic;
             its comparisons take ``batch_norm_act_reference``, the plain
             version on the kernels' statistics);
5. PRMS    - the same stage 1 plus the ViT-B/32 critic at full width
             (224 px, patch 32, width 768 x 12 layers; text 512 x 12;
             seeded random weights): ``validate_prms(save_cam=True)`` into a
             temporary directory and ``validate_prms()`` with the counters
             set to 0 just before and read just after; then both, and
             ``make_prms_forward`` on every batch, with the plain versions,
             which scores, best maps, metrics and dumped maps must agree
             with; then ``validate_prms`` per batch for both routes,
             alternating, over ``ROUNDS``;
6. stage-1 train - 3 steps at B=48 (3 negatives, 320 px, u8) against the
             critic, with the exact launch count of every kernel per step,
             held against the plain route (loss terms, gradients, later
             losses); step times of both routes over ``ROUNDS``, peak
             memory;
7. ins_seg - IRNet's instance pseudo-mask pass at full width (seeded
             ResNet-50 IRNet) on three COCO-sized JPEGs and CAMs written to
             a temporary directory: ``run_make_ins_seg`` with the counters
             set to 0 just before and read just after (the exact launches
             per image of K6, K7, K9 and K10's kernels, the transition, the
             occupancy maps and the products), then with the plain versions,
             whose npy dicts (keys, masks, cam) must agree; each image's
             stages one by one on both routes (IRNet and K9 outputs exact,
             the walk within 1e-4 of its max) with the host time of each
             stage; the pass on one image per route over
             ``INS_SEG_ROUNDS``, alternating;
8. irn_train - IRNet's pass 1 (the CRF, on the host, timed per image) on
             phase 7's images, then IRN training at the JAX recipe's shape
             (B=24, crop 512, radius 10, the full-width frozen trunk,
             seeded heads) on batches built from them by
             ``irn_train_batches``: ``IRN_STEPS`` steps with the counters
             set to 0 just before and read just after (the exact launches
             per step of K6 forward and backward and the fused loss, and
             none of K7 alone), the same steps
             on the plain route from the same weights (step-1 loss terms
             and every head gradient, nonzero), step times of both routes
             over ``ROUNDS``; then the user's chain as CLI processes on a
             fake RefCOCO tree: ``cli.train_stage1`` (one epoch) ->
             ``cli.validate --prms --save_cam`` -> ``cli.irnet`` with its
             three passes (after ``cli.validate --prms --bf16`` on the same
             checkpoint) -> ``cli.train_stage2 --model_ema`` (one epoch, on
             the pseudo-masks the chain wrote) -> ``cli.validate --stage 2``
             and ``--stage 2 --bf16``, and the files each leaves;
9. stage 2 - full-width RN50 stage 2 (seeded) at B=48, 320 px, u8, random
             0/1 pseudo-masks: ``TRAIN2_STEPS`` steps with the EMA teacher
             updated every step (update_after 0: two copies, then decay
             steps; the last step's consistency term is live) under reset
             counters (the
             exact launches per step of K1, K6, K11 and K12), the same on the
             plain route (step-1 loss terms, every gradient, the teacher after
             the last step), step times of both routes at the default gate
             over ``ROUNDS``, peak memory; then ``validate`` of the trained
             model on phase 4's batches on both routes;
10. referit - ``validate_referit`` at full width (RN50 stage 1, seeded) on a
             synthetic flicker-pickle split written with PIL and the port's
             ``mask_ops`` (8 JPEGs of 480x360 and 360x480, 1-6 refs each, a
             box under 5 % skipped, a ref with two boxes) under reset
             counters (the exact launches per image of K1, K2, K3's eval
             head, K4 and K13), against K4's plain version on the same maps
             (each ref's I and U equal) and the plain route (metrics 1e-4),
             each image's host ms on both routes, and once with ``--bf16`` on
             the same weights (K2, K3's eval head and K13's fold in bfloat16,
             none in float32) against the plain bfloat16 route (the first
             image's maps and the refs' I and U within ``BF16_MAPS_SHARE``
             of the gap to the float32 run); then
             the demo's compute at full-width stage 2 on a 480x640 image with
             two comma-separated phrases against the plain route (the map
             within 1e-4 of its scale, norm_cam within that bar carried
             through its normalisation);
11. native - the port's native host library built with g++ (and whether
             libjpeg was found): on phase 7's three JPEGs the CRF's native
             lattice against the numpy lattice (ir-label agreement, max
             |dQ|) with ms per image for both, the native one at 1 thread
             and at the host's cores, and the ir-label pass's images/s by
             design (``tris_tpu_torch.tools.crf_threads``); the fused u8 and
             f32 decodes against the PIL chains with ms per image; the RLE
             codec and polygon fill against the numpy codec;
12. dp     - K3's rectangular training head (a rank's 24 images against 48
             texts) and K13's cross-rank route (the wrapper's own stages, with
             ReLU and PReLU) on the card against their plain versions, timed
             beside the one-process calls; then
             ``tris_tpu_torch.tools.dp_check``: two processes on this card in
             a gloo group (K13's statistics, outputs and running buffers bit
             for bit against one process, its gradients against one process
             and the reference; stage-1, stage-2 and IRN steps at full width,
             2 x half the batch, against one process on the whole batch:
             losses, gradients against their measured noise, launches), then
             a one-process NCCL group;
13. bf16   - ``--bf16`` at full width on phase 4's batches: stage 1 in
             bfloat16 on its seeded init (the 15 leaf kinds bfloat16) and on
             the float32 model's weights loaded (every leaf float32);
             ``validate`` and ``validate_prms`` under reset counters (K13's,
             K2's and K3's bfloat16 kernels launched, K1's on bfloat16
             leaves, K13's eval fold at every norm), the maps of a batch
             against the plain bfloat16 route within ``BF16_MAPS_SHARE`` of
             the float32-bfloat16 gap of the same run, the metrics beside
             float32's, PRMS's selection against float32's, and one run
             each of ``validate``'s host ms a batch, bfloat16 and float32;
14. bf16 train - ``--bf16`` stage-1 training at full width (B=48, 3
             negatives, the ViT-B/32 critic float32): ``train_step``, 3 steps
             under reset counters in three leaf regimes (the seeded init; the
             float32 model's weights loaded, as ``--pretrain``; a float32
             backbone, as ``--clip_weights``): the bfloat16 kernels launched
             and K2's, K3's and K13's float32 ones never, step 1's losses and
             each gradient against the plain bfloat16 route within
             ``BF16_TRAIN_TAIL`` times the larger of the bf16-f32 gap and the
             plain route's own spread (the step on the batch reversed), their
             median within ``BF16_TRAIN_MEDIAN`` times the spread's, the GMP
             channels with a tied maximum, the bfloat16 leaves' moments, and
             the step's host ms in bfloat16 and float32 over ``ROUNDS``;
15. bf16 stage 2 - ``--bf16`` stage-2 eval and the demo at full width (RN50
             stage 2, text 512 x 12, 20 tokens, 320 px) on phase 4's batches
             of 8 x 4, on the seeded bfloat16 init and on the float32 model's
             weights loaded: ``validate`` under reset counters (each route's
             launches by name and dtype, exactly: K1, K11, K6 bilinear,
             K13's 55 folds and 9 with PReLU a batch, the slopes the regime's
             dtype), ``response_maps`` of a batch against the plain bfloat16
             route (chaotic in bfloat16: within ``BF16_SPREAD_SHARE`` of the
             plain route's spread, the farthest of its re-evaluations with
             cuDNN off and with K1's, then K11's, sums in float64, and at
             least ``BF16_MAPS_SHARE`` of the bf16-f32 gap from the float32
             maps, which fail these bars as a control; each kernel's share of
             the gap, launched alone, reported), the metrics beside float32's,
             ``validate``'s host ms a batch in bfloat16 and float32 over
             ``ROUNDS``; then ``demo_cam`` on phase 10's 480 x 640 image with
             two phrases (K1 12, K6 4, K11 3, K13 55 + 9 launches) at the same
             bars.

Prints the kernels line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. ``--report`` writes a fuller JSON report
(every number). Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

B, S, SIZE, TXT_LEN = 8, 4, 320, 20
CRITIC = "ViT-B-32"
N_EVAL_BATCHES = 8
ROUNDS = 7  # host step times: median and range over this many rounds per route
# the forward kernels of stage-1 eval (PRMS adds critic_input)
EVAL_KERNELS = ("mha_short", "cross_attn", "response_head", "eval_metrics", "normalize_u8")
# the stage-1 train step (bench.py:266-270 of the JAX package): B=48, 3 negatives
TRAIN_B, TRAIN_NEG, TRAIN_STEPS, N_TRAIN_BATCHES = 48, 3, 3, 4
# kernel launches per train step at that shape: K1 forward in the stage-1
# text tower, the critic's vision tower and its text tower (12 layers each),
# its backward in the first two; K2 1 + 2; K3's head 1 + 1; K5 1 + 1; K6 1;
# K13 at the RN50 trunk's 55 norms (bn_launches())
TRAIN_LAUNCHES_PER_STEP = {"mha_short": 36, "mha_short_bwd": 24, "cross_attn": 1,
                           "cross_attn_bwd": 2, "stage1_head": 1, "stage1_head_bwd": 1,
                           "critic_input": 1, "critic_input_bwd": 1, "normalize_u8": 1,
                           "response_head": 0, "eval_metrics": 0}
# phase 7: IRNet's instance pseudo-masks on COCO-sized originals (each grid
# buckets to 128x160 or 160x128: HW = 20480), the reference walk (radius 5,
# beta 10, 8 squarings); one image per route timed over a few rounds (each
# walk is seconds of matrix products)
INS_SEG_SIZES = ((480, 640), (427, 640), (640, 480))
INS_SEG_ROUNDS = 3
INS_SEG_DP_SCALE = 16.0  # the seeded IRNet's last displacement conv, scaled: a few instances
INS_SEG_KERNELS = ("bilinear_resize", "path_max_affinity", "refine_centroids", "walk_transition",
                   "walk_matmul", "walk_tile_occupancy")
# the walk's products on an edge map of a few closed regions: 2-px edges at 1.0 around
# rectangles (top, left, bottom, right, as fractions of the bucket's grid), noise up to
# 0.02 elsewhere
REGION_BOXES = ((0.05, 0.05, 0.45, 0.45), (0.11, 0.52, 0.88, 0.95), (0.52, 0.09, 0.95, 0.49),
                (0.23, 0.19, 0.38, 0.38))
REGION_NOISE = 0.02
# phase 8: IRN training at the JAX recipe's shape (IRNTrainConfig,
# train_irn.py:35-42 of the JAX package): crop 512, radius 10 (152
# directions, 119x110 windows), B=24, lr 0.1 (the displacement heads 1.0),
# the full-width trunk frozen; batches from phase 7's three images, their
# ir labels from pass 1, 24 names cycling them
IRN_B, IRN_CROP, IRN_RADIUS, IRN_STEPS, IRN_LR = 24, 512, 10, 3, 0.1
# kernel launches per IRN step: K6 at IRNet's six upsamples, forward and
# backward; the loss fused with K7 two forward (the tiles, then the sum of their
# partials), one backward; K7 alone none
IRN_LAUNCHES_PER_STEP = {"bilinear_resize": 6, "bilinear_resize_bwd": 6, "path_max_affinity": 0,
                         "path_max_affinity_bwd": 0, "irn_affinity_loss": 2,
                         "irn_affinity_loss_bwd": 1}
# phase 9: stage 2 at bench.py::bench_train2's shape (RN50, text 512 x 12,
# 20 tokens, 320 px, B=48, the EMA teacher on, consistency mse, AdamW with
# the stage-2 groups); 4 counted steps with the teacher updated at every
# step (update_after 0: copies at counters 0 and 1, so the teacher equals
# the student at the first three forwards and l5 is 0 there; decays
# 1 - 2^-2/3 at 2 and 1 - 3^-2/3 at 3, so step 4's l5 is live)
TRAIN2_B, TRAIN2_STEPS, N_TRAIN2_BATCHES = 48, 4, 3
# kernel launches per stage-2 step there: K1 in the student's and the
# teacher's text towers (12 layers each), its backward in the student's;
# K11 at c2, c3 and c4 in both forwards, its backward (two kernels) in the
# student's; K6 bilinear at the decoder's three x2 taps and the four heads'
# upsamples in both forwards, backward in the student's; K6 normalise once
# (one u8 batch feeds both); K12 once; K13 at the trunk's and the decoder's
# norms in both train-mode forwards, backward in the student's (bn_launches())
TRAIN2_LAUNCHES_PER_STEP = {"mha_short": 24, "mha_short_bwd": 12, "normalize_u8": 1,
                            "bilinear_resize": 14, "bilinear_resize_bwd": 7, "pixel_attn": 6,
                            "pixel_attn_bwd": 6, "ema_update": 1}
# and per eval batch of stage 2's validate: the text tower, K11 at 3 levels,
# K6 at the decoder's 3 taps and out1's upsample, the u8 feed, K4, K13's eval
# fold at the trunk's norms and the decoder's without the side heads
EVAL2_LAUNCHES_PER_BATCH = {"mha_short": 12, "pixel_attn": 3, "bilinear_resize": 4,
                            "normalize_u8": 1, "eval_metrics": 1}
# phase 10: ReferIt eval on a synthetic flicker-pickle tree (8 JPEGs, 480 x 360 and 360 x
# 480, 1-6 refs each, one box under 5 % skipped, one ref with two boxes over a stack of two
# RLEs) at full width, then the demo's compute on a 480 x 640 image with two phrases; a
# kept expression's forward launches, per image: K1 in the text tower (12 layers), K2 and
# K3's eval head once, K4 once, K13's eval fold at the trunk's norms
REFERIT_SIZES = ((360, 480), (480, 360))
REFERIT_IMAGES, REFERIT_ROUNDS = 8, 3
REFERIT_LAUNCHES_PER_IMAGE = {"mha_short": 12, "cross_attn": 1, "response_head": 1,
                              "eval_metrics": 1}
DEMO_SIZE, DEMO_TEXT = (480, 640), "the man on the left, a red umbrella"
# the kernels ReferIt eval with --bf16 launches on float32 leaves (K1 and K4 in float32)
REFERIT_BF16_KERNELS = ("cross_attn.bf16", "response_head.bf16", "batch_norm.bf16", "mha_short",
                        "eval_metrics")
# K13's rows in phase 3: (name, shape, activation, residual, mode) at the paths' shapes:
# the stem's third norm (two-pass), a bottleneck's tail in layer1, layer2 and layer4,
# layer3's first norms, layer1's first (the forward's widest cluster), stage 2's output1
# block (PReLU), the teacher's reduced_c2 (batch statistics, buffers left alone) and the
# eval fold at the stem of a stage-1 eval batch; the train rows' backward. The stem's and
# layer3's backward run twice, bit for bit; layer1's rows time both designs.
BN_ROWS = (("batch_norm", (TRAIN_B, 64, 160, 160), "relu", False, "train"),
           ("batch_norm@layer1_tail", (TRAIN_B, 256, 80, 80), "relu", True, "train"),
           ("batch_norm@layer3", (TRAIN_B, 1024, 20, 20), "relu", False, "train"),
           ("batch_norm@layer4_tail", (TRAIN_B, 2048, 10, 10), "relu", True, "train"),
           ("batch_norm@stage2_output1", (TRAIN2_B, 32, 80, 80), "prelu", False, "train"),
           ("batch_norm@teacher_reduced_c2", (TRAIN2_B, 128, 40, 40), "prelu", False, "teacher"),
           ("batch_norm@eval_stem", (B, 64, 160, 160), "relu", False, "eval"),
           ("batch_norm@layer2_tail", (TRAIN_B, 512, 40, 40), "relu", True, "train"),
           ("batch_norm@layer1", (TRAIN_B, 64, 80, 80), "relu", False, "train"))
BN_REPEATED = ("batch_norm", "batch_norm@layer3")
BN_BOTH_DESIGNS = ("batch_norm@layer1",)
# H100 SXM published peaks: HBM3 bytes/s and FP32 (non-tensor-core) FLOP/s, which
# is also the FP64 tensor cores' peak (67 TFLOP/s both): the rate of K10's products
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12  # the bfloat16 tensor cores' dense peak: the bound of --bf16's rows
SLEEP_CYCLES = 200_000_000  # ~0.1 s of card time queued ahead of a timed run


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, n: int = 20, repeats: int = 3) -> float:
    """Card time of one ``fn()``: the card is first held busy so the host has
    queued all ``n`` calls before the first one runs, and CUDA events around
    them time the card, not the host's launch overhead. Median of repeats."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def kernel_times(fn, names, n: int = 10) -> dict:
    """Card ms per call of each kernel ``fn`` launches whose name holds one of
    ``names``, from ``torch.profiler`` over ``n`` calls (CUDA events time the
    call as a whole)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in names:
            if name + "_kernel" in ev.key:
                out[name] += us / n / 1e3
    return out


def host_ms(fn) -> float:
    """Host clock around one ``fn()`` ending in a synchronise (step time)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def spread(times) -> dict:
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "n": len(times)}


def bound_ms(nbytes: float, flops: float, peak_ops: float = PEAK_F32_S):
    """The least time the card could take: bytes over the memory rate or
    operations over their type's peak (FP32 unless given), whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@functools.lru_cache(maxsize=1)
def sm_clock_hz() -> float:
    """The SM clock's maximum (``nvidia-smi``)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def smem_rate() -> float:
    """4-byte shared-memory loads a second the card issues at most: a warp's
    32 a clock on each SM, at the SM clock's maximum."""
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count * 32 * sm_clock_hz()


def smem_ms(loads: int) -> float:
    """The least time ``loads`` shared-memory loads take at :func:`smem_rate`."""
    return loads / smem_rate() * 1e3


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def measure_row(failures, name, err, tol, ms, plain_ms, nbytes, flops, library_ms, **extra):
    """A kernel's numbers, logged; a failure noted when ``err`` exceeds ``tol``."""
    b_ms, b_by = bound_ms(nbytes, flops)
    row = {"name": name, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, **extra}
    log(f"kernel {name}: max_abs_err {err:.3g} (tol {tol:.3g}) ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {library_ms}")
    if not err <= tol:
        failures.append(f"{name}: max_abs_err {err} > {tol}")
    return row


def kernel_row(name, source, replaces, row, shapes=()):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, **{k: v for k, v in row.items() if k != "name"},
            "shapes": list(shapes)}


def sdpa(q, k, v, H, mask):
    """The library's attention on [N, L, C] tensors, output in heads layout."""
    import torch.nn.functional as F

    n, _, c = q.shape
    heads = [x.view(n, x.shape[1], H, c // H).transpose(1, 2) for x in (q, k, v)]
    return F.scaled_dot_product_attention(*heads, attn_mask=mask)


def k2_sdpa(qv, kv, vv, qt, kt, vt, S, div):
    """K2's function as two ``F.scaled_dot_product_attention`` calls, ``Av``
    and ``At`` of ``tris_tpu/models/fusion.py:85-89`` (timed as the library
    call, never used by the port)."""
    import torch.nn.functional as F

    rep = (lambda x: x) if S == 1 else (lambda x: x.repeat_interleave(S, 0))  # noqa: E731
    return (F.scaled_dot_product_attention(rep(qv), kt, vt, scale=1 / div),
            F.scaled_dot_product_attention(qt, rep(kv), rep(vv), scale=1 / div))


def k2_launch_shapes(*launches):
    """The grid of K2's last launch of each name, as its launcher gave it to
    CUDA: blocks, blocks a cluster, threads, query rows a tile, shared memory."""
    from tris_tpu_torch import kernels as K

    return {"launch_shape": {k: K.cross_attn_launch_shape(k) for k in launches}}


def _outs_cots(fn, inputs, cots):
    """``fn(*inputs)``'s outputs that have a cotangent, and those cotangents."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
    return [o for o, _ in pairs], [c for _, c in pairs]


def input_grads(fn, inputs, cots):
    """The gradients of ``inputs`` from ``fn``'s outputs and cotangents."""
    import torch

    outs, cs = _outs_cots(fn, inputs, cots)
    return torch.autograd.grad(outs, inputs, cs)


def bwd_ms(fn, inputs, cots, n: int = 20, repeats: int = 3):
    """Card time of the backward alone, on a retained graph."""
    import torch

    outs, cs = _outs_cots(fn, inputs, cots)
    return device_ms(lambda: torch.autograd.grad(outs, inputs, cs, retain_graph=True), n, repeats)


def fwd_bwd_ms(fn, inputs, cots):
    return device_ms(lambda: input_grads(fn, inputs, cots))


def leaves(*ts):
    return [t.detach().requires_grad_() for t in ts]


def resize_row(K, failures, name, x, size, align_corners):
    """K6 bilinear forward on ``x`` [..., h, w]: exact against its plain
    version (the same taps in the same order); ``F.interpolate`` as the
    library."""
    import torch.nn.functional as F

    got = K.bilinear_resize(x, size, align_corners)
    launch = K.bilinear_resize_launch_shape()
    lib = lambda: F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=size,  # noqa: E731
                                mode="bilinear", align_corners=align_corners)
    n_out = got.numel()
    planes = math.prod(x.shape[:-2])
    return measure_row(failures, name,
                       max_err(got, K.bilinear_resize_plain(x, size, align_corners)), 0.0,
                       device_ms(lambda: K.bilinear_resize(x, size, align_corners)),
                       device_ms(lambda: K.bilinear_resize_plain(x, size, align_corners)),
                       4 * (x.numel() + n_out), 9 * n_out, device_ms(lib),
                       shape=[*x.shape, *size], align_corners=align_corners,
                       library_max_abs_err=max_err(got, lib().reshape(got.shape)),
                       plan=K.bilinear_resize_plan(planes, *x.shape[-2:], *size),
                       launch_shape=launch)


def resize_bwd_row(K, failures, name, x, cot):
    """K6 bilinear backward (align_corners=False) from ``x`` to the size of
    the cotangent ``cot``: 1e-5 of the gradient's scale (the plain version's
    index backward adds with atomics, in another order); ``F.interpolate``'s
    backward as the library; with the plan the extension gave and the launch
    it made."""
    import torch.nn.functional as F

    (x,) = leaves(x)
    size, cot = tuple(cot.shape[-2:]), [cot]
    kern = lambda t: K.bilinear_resize(t, size, False)  # noqa: E731
    plain = lambda t: K.bilinear_resize_plain(t, size, False)  # noqa: E731
    lib = lambda t: F.interpolate(t, size=size, mode="bilinear", align_corners=False)  # noqa: E731
    got, want = input_grads(kern, [x], cot)[0], input_grads(plain, [x], cot)[0]
    launch = K.bilinear_resize_bwd_launch_shape()
    scale = float(want.abs().max())
    planes = math.prod(x.shape[:-2])
    return measure_row(failures, name, max_err(got, want), 1e-5 * scale,
                       bwd_ms(kern, [x], cot), bwd_ms(plain, [x], cot, 5),
                       4 * (cot[0].numel() + x.numel()), 8 * cot[0].numel(),
                       bwd_ms(lib, [x], cot), shape=[*x.shape, *size], scale=scale,
                       library_max_abs_err=max_err(got, input_grads(lib, [x], cot)[0]),
                       plan=K.bilinear_resize_bwd_plan(planes, *x.shape[-2:], *size),
                       launch_shape=launch)


# ---- phase 3: each kernel against its plain version -------------------------


def check_kernels(K, dev):
    """One row per kernel at its stage-1 eval shape (K5 at PRMS's), and
    under ``shapes`` the same numbers at its other main-path shapes."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.models.clip import CLIP_CONFIGS
    from tris_tpu_torch.models.layers import causal_mask

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    failures = []

    def measure(*args, **kw):
        return measure_row(failures, *args, **kw)

    def mha(name, N, L, C, H, causal):
        # q/k/v read in place from one fused qkv tensor; the plain einsums
        # may round exactly as the kernel does, so float64 shows the
        # kernel's own error (2e-5: f32 sums of 64 products)
        q, k, v = randn(N, L, 3 * C).chunk(3, dim=-1)
        mask = causal_mask(L, device=dev) if causal else None
        got = K.mha_short(q, k, v, H, mask)
        err = max_err(got, K.mha_short_plain(q, k, v, H, mask))
        err64 = max_err(got, K.mha_short_plain(q.double(), k.double(), v.double(), H,
                                               None if mask is None else mask.double()))
        if not err64 <= 2e-5:
            failures.append(f"{name}: max_abs_err vs float64 {err64} > 2e-5")
        return measure(name, err, 2e-5,
                       device_ms(lambda: K.mha_short(q, k, v, H, mask)),
                       device_ms(lambda: K.mha_short_plain(q, k, v, H, mask)),
                       4 * (4 * N * L * C + (L * L if causal else 0)),
                       4 * N * H * L * L * (C // H),
                       device_ms(lambda: sdpa(q, k, v, H, mask)),
                       shape=[N, L, C, H], causal=causal, max_abs_err_f64=err64,
                       launch_shape=K.mha_short_launch_shape("mha_short"))

    vit = CLIP_CONFIGS[CRITIC]
    n_vit = (vit.image_resolution // vit.vision_patch_size) ** 2 + 1
    rows = [kernel_row(
        "mha_short", "tris_tpu_torch/kernels/csrc/mha_short.cu", "tris_tpu/models/layers.py:25",
        # the text towers (stage 1's and the critic's): N = B*S, L = 20 causal
        mha("mha_short", B * S, TXT_LEN, 512, 8, True),
        [mha("mha_short@vit", B * S, n_vit, vit.vision_width, vit.vision_heads, False),
         # attnpool at 320 px: 10x10 + 1 tokens, 32 heads (not on a main path)
         mha("mha_short@attnpool", B, (SIZE // 32) ** 2 + 1, 2048, 32, False)])]

    # K2 at response_maps' shape: per image 10x10 pixels of m = 1024, per pair
    # T = 1 text token; relu'd like the projections that feed it
    hw, m, P = (SIZE // 32) ** 2, 1024, B * S
    qv, kv, vv = (torch.relu(randn(B, hw, m)) for _ in range(3))
    qt, kt, vt = (torch.relu(randn(P, 1, m)) for _ in range(3))
    div = math.sqrt(m)
    args = (qv, kv, vv, qt, kt, vt, S, div)
    got, want = K.cross_attn(*args), K.cross_attn_plain(*args)
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    exact_vt = bool(torch.equal(got[0], vt.expand(P, hw, m)))  # T = 1: softmax over one key is 1
    if not exact_vt:
        failures.append("cross_attn: with T = 1 the vision->text output is not exactly Vt")
    lib = k2_sdpa(*args)
    lib_err = max(max_err(lib[0], want[0]), max_err(lib[1], want[1]))
    rows.append(kernel_row(
        "cross_attn", "tris_tpu_torch/kernels/csrc/cross_attn.cu", "tris_tpu/models/fusion.py:78",
        measure("cross_attn", err, 1e-4,
                device_ms(lambda: K.cross_attn(*args)), device_ms(lambda: K.cross_attn_plain(*args)),
                4 * (3 * B * hw * m + 3 * P * m + P * hw * m + P * m),
                2 * 2 * P * hw * 1 * m * 2, device_ms(lambda: k2_sdpa(*args)),
                shape=[B, S, hw, m, 1], t1_exactly_vt=exact_vt,
                library="two F.scaled_dot_product_attention calls", library_max_abs_err=lib_err,
                **k2_launch_shapes("cross_attn"))))

    # K3 at response_maps' shape: 32 pairs, D = 1024, 10x10 -> 320x320
    D = 1024
    vis_base = F.normalize(randn(B, hw, D), dim=-1)
    vis_new = randn(P, hw, D)
    lan = F.normalize(randn(P, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    hs = SIZE // 32
    args = (vis_new, vis_base, lan, S, scale, 0.1, (hs, hs), (SIZE, SIZE))
    err = max_err(K.response_head(*args), K.response_head_plain(*args))
    launch = K.response_head_launch_shape()
    rows.append(kernel_row(
        "response_head", "tris_tpu_torch/kernels/csrc/response_head.cu",
        "tris_tpu/models/stage1.py:158",
        measure("response_head", err, 1e-4,
                device_ms(lambda: K.response_head(*args)),
                device_ms(lambda: K.response_head_plain(*args)),
                4 * (P * hw * D + B * hw * D + P * D + P * SIZE * SIZE),
                P * hw * D * 4 + P * SIZE * SIZE * 7, None, shape=[B, S, hw, D, SIZE],
                plan=K.response_head_plan(P, S, hs, hs, D, SIZE, SIZE), launch_shape=launch)))

    # K4 at one eval batch's shape: [8, 4] relu maps of 320x320 to mixed
    # original sizes up to 640x640; and on PRMS's selected maps [8, 1]
    batch = make_eval_batches(1, seed=3)[0]
    sizes = [t.shape for t in batch["target"]]
    tables = K.eval_tables(SIZE, SIZE, sizes, (640, 640), dev)
    tgt = np.zeros((B, 640, 640), np.uint8)
    for b, t in enumerate(batch["target"]):
        tgt[b, :t.shape[0], :t.shape[1]] = t
    tgt = torch.as_tensor(tgt, device=dev)
    boxes = torch.as_tensor(np.stack(batch["bbox"]).astype(np.float32), device=dev)
    n_valid = sum(h * w for h, w in sizes)

    def metrics(name, n_maps):
        # exact: the kernel samples with the plain version's taps in its order;
        # with the plan the extension gave and the launch it made
        cams = torch.relu(randn(B, n_maps, SIZE, SIZE))
        got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
        launch = K.eval_metrics_launch_shape()
        err = max_err(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
        err_norm = max_err(K.eval_metrics(cams, tables, want_norm=True),
                           K.eval_metrics_plain(cams, tables, want_norm=True))
        if not err_norm <= 0.0:
            failures.append(f"{name} (normalised maps): max_abs_err {err_norm} > 0")
        return measure(name, err, 0.0,
                       device_ms(lambda: K.eval_metrics(cams, tables, tgt, boxes)),
                       device_ms(lambda: K.eval_metrics_plain(cams, tables, tgt, boxes)),
                       4 * B * n_maps * SIZE * SIZE + n_valid + 4 * B * n_maps * 4
                       + 16 * B * (640 + 640),
                       n_maps * n_valid * 2 * 6 + n_maps * n_valid * 4, None,
                       shape=[B, n_maps, SIZE, 640, 640], norm_max_abs_err=err_norm,
                       norm_tol=0.0, plan=K.eval_metrics_plan(B, n_maps, 640, 640, SIZE, SIZE),
                       launch_shape=launch), cams

    def norm_row(name, cams):
        # the normalised planes PRMS saves: the maps read, the padded planes written
        n_maps = cams.shape[1]
        got = K.eval_metrics(cams, tables, want_norm=True)
        launch = K.eval_metrics_launch_shape()
        return measure(name, max_err(got, K.eval_metrics_plain(cams, tables, want_norm=True)),
                       0.0, device_ms(lambda: K.eval_metrics(cams, tables, want_norm=True)),
                       device_ms(lambda: K.eval_metrics_plain(cams, tables, want_norm=True)),
                       4 * B * n_maps * (SIZE * SIZE + 640 * 640) + 16 * B * (640 + 640),
                       n_maps * n_valid * (2 * 6 + 1), None, shape=[B, n_maps, SIZE, 640, 640],
                       plan=K.eval_metrics_plan(B, n_maps, 640, 640, SIZE, SIZE),
                       launch_shape=launch)

    eval_row, _ = metrics("eval_metrics", S)
    prms_row, prms_cams = metrics("eval_metrics@prms", 1)
    rows.append(kernel_row(
        "eval_metrics", "tris_tpu_torch/kernels/csrc/eval_metrics.cu",
        "tris_tpu/eval/validate.py:102", eval_row,
        [prms_row, norm_row("eval_metrics@norm", prms_cams)]))

    # K5 at PRMS's shape: 32 pairs' relu maps and 8 images, 320 -> 224,
    # patches of 32 -> A [32*49, 3072]. Same taps, same order: exact, and
    # held at 1e-6 of A's scale
    n, ps = vit.image_resolution, vit.vision_patch_size
    cams = torch.relu(randn(P, SIZE, SIZE))
    image = randn(B, 3, SIZE, SIZE)
    got = K.critic_input(cams, image, S, n, ps)
    want = K.critic_input_plain(cams, image, S, n, ps)
    a_scale = float(want.abs().max())
    rows.append(kernel_row(
        "critic_input", "tris_tpu_torch/kernels/csrc/critic_input.cu",
        "tris_tpu/eval/validate.py:276",
        measure("critic_input", max_err(got, want), 1e-6 * a_scale,
                device_ms(lambda: K.critic_input(cams, image, S, n, ps)),
                device_ms(lambda: K.critic_input_plain(cams, image, S, n, ps)),
                4 * (P * SIZE * SIZE + B * 3 * SIZE * SIZE + got.numel()),
                6 * n * n * (P + 3 * B) + 3 * P * n * n, None,
                shape=[P, S, SIZE, n, ps], exact=bool(torch.equal(got, want)),
                a_scale=a_scale)))

    # K6 on one u8 batch [8, 320, 320, 3]: a rounded multiply and a rounded
    # add, as the plain version: exact
    u8 = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=g, device=dev, dtype=torch.uint8)
    err = max_err(K.normalize_u8_nchw(u8), K.normalize_u8_nchw_plain(u8))
    rows.append(kernel_row(
        "normalize_u8", "tris_tpu_torch/kernels/csrc/normalize_u8.cu",
        "tris_tpu/ops/normalize.py:24",
        measure("normalize_u8", err, 0.0,
                device_ms(lambda: K.normalize_u8_nchw(u8)),
                device_ms(lambda: K.normalize_u8_nchw_plain(u8)),
                u8.numel() * (1 + 4), 2 * u8.numel(), None, shape=[B, SIZE, SIZE, 3])))
    return rows, failures


def check_train_kernels(K, dev):
    """One row per backward kernel and for K3's training head, at the
    stage-1 train step's shapes (B=48, T=48 texts, 320 px), each against
    autograd of its plain version on the same inputs. A backward row's
    ``ms``, ``plain_ms`` and ``library_ms`` time the backward alone (on a
    retained graph); K1's also carry forward-plus-backward times, the SDPA
    comparison. K2's forward at T=48 is a sub-row of ``cross_attn``."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.models.clip import CLIP_CONFIGS
    from tris_tpu_torch.models.layers import causal_mask

    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    failures, rows, extra_rows = [], [], {}

    def compare(name, fn, plain, inputs, cots, rel_tol):
        """max error of the kernel's input gradients against the plain
        version's, and the tolerance (rel_tol of the largest gradient)."""
        got, want = input_grads(fn, inputs, cots), input_grads(plain, inputs, cots)
        scale = max(float(w.abs().max()) for w in want)
        err = max(max_err(a, b) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        if not finite:
            failures.append(f"{name}: non-finite gradient")
        return err, rel_tol * max(scale, 1.0), scale

    def row(name, source, replaces, *args, **extra):
        return kernel_row(name, source, replaces, measure_row(failures, name, *args, **extra))

    # K1 backward: the stage-1 text tower and the critic's vision tower, q/k/v
    # the strided column views of one fused qkv tensor, as on the path; 2e-5
    # of the gradient's scale (f32 sums of up to 50 products, both routes),
    # against the plain version in float32 and in float64; the ViT's
    # backward bit for bit over two runs (no atomics, every sum in a fixed order)
    vit = CLIP_CONFIGS[CRITIC]
    n_vit = (vit.image_resolution // vit.vision_patch_size) ** 2 + 1
    mha_rows = []
    for name, (N, L, C, H, causal) in (
            ("mha_short_bwd", (TRAIN_B, TXT_LEN, 512, 8, True)),
            ("mha_short_bwd@vit", (TRAIN_B, n_vit, vit.vision_width, vit.vision_heads, False))):
        mask = causal_mask(L, device=dev) if causal else None
        (qkv,) = leaves(randn(N, L, 3 * C))
        cot, cot_lib = [randn(N, L, C)], [randn(N, H, L, C // H)]   # SDPA's heads layout
        kern = lambda x: K.mha_short(*x.chunk(3, dim=-1), H, mask)  # noqa: E731
        plain = lambda x: K.mha_short_plain(*x.chunk(3, dim=-1), H, mask)  # noqa: E731
        lib = lambda x: sdpa(*x.chunk(3, dim=-1), H, mask)  # noqa: E731
        err, tol, _ = compare(name, kern, plain, [qkv], cot, 2e-5)
        mask64 = None if mask is None else mask.double()
        got = input_grads(kern, [qkv], cot)[0]
        want64 = input_grads(lambda x: K.mha_short_plain(*x.chunk(3, dim=-1), H, mask64),
                             leaves(qkv.double()), [cot[0].double()])[0]
        err64 = max_err(got, want64)
        tol64 = 2e-5 * max(float(want64.abs().max()), 1.0)
        if not err64 <= tol64:
            failures.append(f"{name}: max_abs_err vs float64 {err64} > {tol64}")
        bitwise = bool(torch.equal(got, input_grads(kern, [qkv], cot)[0]))
        if not bitwise:
            failures.append(f"{name}: two runs differ")
        hd = C // H
        # the backward kernel alone, through its op (no autograd, not counted):
        # the row's ms less this is autograd's sum of dq, dk, dv into qkv's gradient
        views = qkv.detach().chunk(3, dim=-1)
        kernel_ms = device_ms(lambda: build.ops().mha_short_bwd(cot[0], *views, mask, H,
                                                                 hd ** -0.5))
        mha_rows.append(row(
            name, "tris_tpu_torch/kernels/csrc/mha_short_bwd.cu", "tris_tpu/models/layers.py:25",
            err, tol, bwd_ms(kern, [qkv], cot), bwd_ms(plain, [qkv], cot),
            4 * (7 * N * L * C + (L * L if causal else 0)), 8 * N * H * L * L * hd,
            bwd_ms(lib, [qkv], cot_lib), shape=[N, L, C, H], causal=causal,
            max_abs_err_f64=err64, tol_f64=tol64, bit_for_bit_run_to_run=bitwise,
            kernel_ms=kernel_ms, launch_shape=K.mha_short_launch_shape("mha_short_bwd"),
            fwd_bwd_ms=fwd_bwd_ms(kern, [qkv], cot), plain_fwd_bwd_ms=fwd_bwd_ms(plain, [qkv], cot),
            library_fwd_bwd_ms=fwd_bwd_ms(lib, [qkv], cot_lib)))
    mha_rows[0]["shapes"] = [mha_rows.pop()]
    rows += mha_rows

    # K2 at T=48 (every text of the batch), S=1: the forward, timed, and the
    # backward; relu'd inputs like the projections that feed it; 1e-4 of the
    # gradient's scale (1024-long f32 dot products on both routes)
    hw, m, T = (SIZE // 32) ** 2, 1024, TRAIN_B
    ins = leaves(*(torch.relu(randn(TRAIN_B, hw, m)) for _ in range(3)),
                 *(torch.relu(randn(TRAIN_B, T, m)) for _ in range(3)))
    div = math.sqrt(m)
    with torch.no_grad():
        got, want = K.cross_attn(*ins, 1, div), K.cross_attn_plain(*ins, 1, div)
        fwd_err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        fwd = {"name": "cross_attn@train", "shape": [TRAIN_B, 1, hw, m, T], "max_abs_err": fwd_err,
               "tol": 1e-4, "ms": device_ms(lambda: K.cross_attn(*ins, 1, div)),
               "plain_ms": device_ms(lambda: K.cross_attn_plain(*ins, 1, div)),
               "library_ms": device_ms(lambda: k2_sdpa(*ins, 1, div)),
               **k2_launch_shapes("cross_attn")}
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(4 * (3 * TRAIN_B * hw * m + 3 * TRAIN_B * T * m
                                                     + TRAIN_B * (hw + T) * m),
                                                8 * TRAIN_B * hw * T * m)
    if not fwd_err <= 1e-4:
        failures.append(f"cross_attn@train: max_abs_err {fwd_err} > 1e-4")
    extra_rows["cross_attn"] = fwd
    cot = [randn(TRAIN_B, hw, m), randn(TRAIN_B, T, m)]
    kern = lambda *x: K.cross_attn(*x, 1, div)  # noqa: E731
    plain = lambda *x: K.cross_attn_plain(*x, 1, div)  # noqa: E731
    lib = lambda *x: k2_sdpa(*x, 1, div)  # noqa: E731
    err, tol, _ = compare("cross_attn_bwd", kern, plain, ins, cot, 1e-4)
    # no atomics, every sum in a fixed order: a second backward is the first bit for bit
    bitwise = all(bool(torch.equal(a, b)) for a, b in
                  zip(input_grads(kern, ins, cot), input_grads(kern, ins, cot)))
    if not bitwise:
        failures.append("cross_attn_bwd: two runs differ")
    fwd_bwd = {"fwd_bwd_ms": fwd_bwd_ms(kern, ins, cot),
               "plain_fwd_bwd_ms": fwd_bwd_ms(plain, ins, cot),
               "library_fwd_bwd_ms": fwd_bwd_ms(lib, ins, cot)}
    fwd.update(fwd_bwd)
    log(f"kernel cross_attn@train: {json.dumps(fwd)}")
    rows.append(row(
        "cross_attn_bwd", "tris_tpu_torch/kernels/csrc/cross_attn_bwd.cu",
        "tris_tpu/models/fusion.py:85", err, tol, bwd_ms(kern, ins, cot), bwd_ms(plain, ins, cot),
        4 * 7 * TRAIN_B * (hw + T) * m, 16 * TRAIN_B * hw * T * m, bwd_ms(lib, ins, cot),
        shape=[TRAIN_B, hw, T, m], library="two F.scaled_dot_product_attention calls, backward",
        bit_for_bit_run_to_run=bitwise, **fwd_bwd,
        **k2_launch_shapes("cross_attn_bwd_a", "cross_attn_bwd_b")))

    # K3's training head: vis_p [48, 100, 1024], lan_p [48, 48, 1024] -> cls
    # [48, 48] and maps [48, 320, 320], a cluster an image each way; forward
    # outputs within 1e-5 and the gradients within 1e-4 of their scale
    # (1024-long dots, 4800-long sums); the backward bit for bit run to run
    # (the ranks' partials added in rank order, no atomics)
    D, hs = 1024, SIZE // 32
    vis, lan = leaves(F.normalize(randn(TRAIN_B, hw, D), dim=-1),
                      F.normalize(randn(TRAIN_B, T, D), dim=-1))
    scale = torch.tensor(1 / 0.07, device=dev)
    args = (scale, (hs, hs), (SIZE, SIZE), 3.0, 0.01)
    with torch.no_grad():
        got, want = K.stage1_head(vis, lan, *args), K.stage1_head_plain(vis, lan, *args)
    out_scale = max(float(w.abs().max()) for w in want)
    err = max(max_err(a, b) for a, b in zip(got, want))
    maps_bytes = 2 * TRAIN_B * SIZE * SIZE
    rows.append(row(
        "stage1_head", "tris_tpu_torch/kernels/csrc/stage1_head.cu", "tris_tpu/models/stage1.py:100",
        err, 1e-5 * max(out_scale, 1.0),
        device_ms(lambda: K.stage1_head(vis.detach(), lan.detach(), *args)),
        device_ms(lambda: K.stage1_head_plain(vis.detach(), lan.detach(), *args)),
        4 * (TRAIN_B * hw * D + TRAIN_B * T * D + TRAIN_B * T + TRAIN_B + maps_bytes),
        2 * TRAIN_B * hw * T * D + 20 * TRAIN_B * hw * T + 10 * maps_bytes, None,
        shape=[TRAIN_B, hw, T, D, SIZE],
        plan=K.stage1_head_plan(TRAIN_B, hs, hs, D, SIZE, SIZE),
        launch_shape=K.stage1_head_launch_shape()))
    cot = [randn(TRAIN_B, T), None, None, randn(TRAIN_B, SIZE, SIZE)]   # the loss's: cls and sig
    kern = lambda v, l: K.stage1_head(v, l, *args)  # noqa: E731
    plain = lambda v, l: K.stage1_head_plain(v, l, *args)  # noqa: E731
    err, tol, _ = compare("stage1_head_bwd", kern, plain, [vis, lan], cot, 1e-4)
    bitwise = all(bool(torch.equal(a, b)) for a, b in
                  zip(input_grads(kern, [vis, lan], cot), input_grads(kern, [vis, lan], cot)))
    if not bitwise:
        failures.append("stage1_head_bwd: two runs differ")
    rows.append(row(
        "stage1_head_bwd", "tris_tpu_torch/kernels/csrc/stage1_head.cu",
        "tris_tpu/models/stage1.py:100", err, tol, bwd_ms(kern, [vis, lan], cot),
        bwd_ms(plain, [vis, lan], cot),
        4 * (2 * (TRAIN_B * hw * D + TRAIN_B * T * D) + TRAIN_B * T + TRAIN_B * hw * T
             + TRAIN_B * SIZE * SIZE),
        4 * TRAIN_B * hw * T * D + 30 * TRAIN_B * hw * T + 12 * TRAIN_B * SIZE * SIZE, None,
        shape=[TRAIN_B, hw, T, D, SIZE], bit_for_bit_run_to_run=bitwise,
        plan=K.stage1_head_plan(TRAIN_B, hs, hs, D, SIZE, SIZE, backward=True),
        launch_shape=K.stage1_head_launch_shape(backward=True)))

    # K5 backward: 48 sigmoid maps and images, 320 -> 224, patch 32; the
    # plain version's index backward scatters with atomics (its sums' order
    # changes from run to run), so 1e-5 of the gradient's scale; the kernel
    # bit for bit run to run (a gather in a fixed order, no atomics)
    n, ps = vit.image_resolution, vit.vision_patch_size
    (cams,) = leaves(torch.sigmoid(randn(TRAIN_B, SIZE, SIZE)))
    image = randn(TRAIN_B, 3, SIZE, SIZE)
    cot = [randn(TRAIN_B * (n // ps) ** 2, 3 * ps * ps)]
    kern = lambda c: K.critic_input(c, image, 1, n, ps)  # noqa: E731
    plain = lambda c: K.critic_input_plain(c, image, 1, n, ps)  # noqa: E731
    err, tol, _ = compare("critic_input_bwd", kern, plain, [cams], cot, 1e-5)
    bitwise = bool(torch.equal(input_grads(kern, [cams], cot)[0],
                               input_grads(kern, [cams], cot)[0]))
    if not bitwise:
        failures.append("critic_input_bwd: two runs differ")
    rows.append(row(
        "critic_input_bwd", "tris_tpu_torch/kernels/csrc/critic_input_bwd.cu",
        "tris_tpu/train/stage1.py:70", err, tol, bwd_ms(kern, [cams], cot),
        bwd_ms(plain, [cams], cot),
        4 * (cot[0].numel() + image.numel() + cams.numel()),
        TRAIN_B * n * n * 3 * 8 + TRAIN_B * (n * SIZE + SIZE * SIZE) * 4, None,
        shape=[TRAIN_B, SIZE, n, ps], bit_for_bit_run_to_run=bitwise,
        plan=K.critic_input_bwd_plan(TRAIN_B, SIZE, SIZE, n),
        launch_shape=K.critic_input_bwd_launch_shape()))
    return rows, extra_rows, failures


def check_ins_seg_kernels(K, dev):
    """One row per kernel of the IRNet instance pseudo-mask path at a
    480x640 image's shapes (K6's bilinear half at the heads' largest
    upsample, its other shapes as sub-rows), each against its plain version:
    exact (K10's T: the same powf, column sums in the same order), K10's
    products within one float32 rounding."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.pseudo.indexing import _padded_path_index, transition_band

    g = torch.Generator(device=dev).manual_seed(4)
    failures = []

    def measure(*args, **kw):
        return measure_row(failures, *args, **kw)

    def resize(name, shape, size, align_corners):
        return resize_row(K, failures, name, torch.randn(*shape, generator=g, device=dev), size,
                          align_corners)

    oh, ow = INS_SEG_SIZES[0]
    gh, gw = oh // 4, ow // 4
    rows = [kernel_row(
        "bilinear_resize", "tris_tpu_torch/kernels/csrc/bilinear_resize.cu",
        "tris_tpu/ops/resize.py:57",
        # the displacement head's dp6 tap: [2, 256, 60, 80] -> x2
        resize("bilinear_resize", (2, 256, gh // 2, gw // 2), (gh, gw), False),
        [resize("bilinear_resize@edge_x4", (2, 32, gh // 4, gw // 4), (gh, gw), False),
         resize("bilinear_resize@cam_to_grid", (oh, ow), (gh, gw), True),
         resize("bilinear_resize@walk_x4", (4, gh, gw), (oh, ow), False)])]

    # K7 on the walk's padded edge map of the 128x160 bucket: [133, 170] ->
    # [34, 129, 162]; exact
    H, W, radius = -(-gh // 32) * 32, -(-gw // 32) * 32, 5
    pi = _padded_path_index(radius, (H + radius, W + 2 * radius))
    edge = F.pad(torch.rand(H, W, generator=g, device=dev), (radius, radius, 0, radius), value=1.0)
    paths, rf = pi.paths_by_length, pi.radius_floor
    got = K.path_max_affinity(edge, paths, rf)
    launch = K.path_max.launch_shape()
    n_steps = sum(len(p) for grp in paths for p in grp)
    ch, cw = got.shape[1:]
    rows.append(kernel_row(
        "path_max_affinity", "tris_tpu_torch/kernels/csrc/path_max_affinity.cu",
        "tris_tpu/pseudo/indexing.py:110",
        measure("path_max_affinity", max_err(got, K.path_max_affinity_plain(edge, paths, rf)),
                0.0, device_ms(lambda: K.path_max_affinity(edge, paths, rf)),
                device_ms(lambda: K.path_max_affinity_plain(edge, paths, rf)),
                4 * (edge.numel() + got.numel()), (n_steps + got.shape[0]) * ch * cw, None,
                shape=[*edge.shape, *got.shape], path_steps=n_steps,
                plan=K.path_max.forward_plan(1, *edge.shape, rf, got.shape[0], n_steps),
                launch_shape=launch)))

    # K9 on the 120x160 grid: a smooth field of a few pixels, up to 300 steps
    # (a warp stops at a fixed point); exact. The bound counts the steps each
    # warp took on its live lanes; the latency floor is the steps of the
    # longest warp times a step of one warp alone on the card (a [1, 32] grid
    # on a field that never settles: 300 steps less none, a step apart)
    field = F.avg_pool2d(torch.randn(1, 2, gh + 8, gw + 8, generator=g, device=dev), 9, 1)[0] * 12
    got = K.refine_centroids(field)
    steps = centroid_steps(K, gh, gw)
    lone = torch.zeros(2, 1, 32, device=dev)
    lone[1] = (torch.arange(32, device=dev) % 2 == 0).float() * 2 - 1
    step_ms = (device_ms(lambda: K.refine_centroids(lone, 300))
               - device_ms(lambda: K.refine_centroids(lone, 0))) / 300
    rows.append(kernel_row(
        "refine_centroids", "tris_tpu_torch/kernels/csrc/refine_centroids.cu",
        "tris_tpu/pseudo/labels.py:71",
        measure("refine_centroids", max_err(got, K.refine_centroids_plain(field)), 0.0,
                device_ms(lambda: K.refine_centroids(field)),
                device_ms(lambda: K.refine_centroids_plain(field), n=3), 4 * 4 * gh * gw,
                30 * steps["pixel_steps"], None, shape=[2, gh, gw], iterations=300,
                plan=K.refine_centroids_plan(gh, gw), steps_taken=steps,
                latency_floor_ms=steps["max"] * step_ms,
                step_cycles_alone=step_ms * 1e-3 * sm_clock_hz())))

    # K10 on the bucket from K7's grids: T [20480, 20480]
    dirs = np.asarray(pi.search_dst, np.int64)
    woff = radius - pi.radius_floor
    aff = K.path_max_affinity(edge, paths, rf)
    got = K.walk_transition(aff, dirs, H, W, woff, 10.0)
    want = K.walk_transition_plain(aff, dirs, H, W, woff, 10.0)
    t_scale = float(want.abs().max())
    err = max_err(got, want)
    del want
    band_nnz = int((got != 0).sum())
    rows.append(kernel_row(
        "walk_transition", "tris_tpu_torch/kernels/csrc/walk_transition.cu",
        "tris_tpu/pseudo/indexing.py:441",
        measure("walk_transition", err, 0.0,
                device_ms(lambda: K.walk_transition(aff, dirs, H, W, woff, 10.0), n=5),
                device_ms(lambda: K.walk_transition_plain(aff, dirs, H, W, woff, 10.0), n=3),
                4 * (aff.numel() + got.numel()), 4 * H * W * 2 * len(dirs) + 2 * band_nnz,
                None, shape=[*aff.shape, H, W], t_scale=t_scale, nonzeros=band_nnz)))
    rows += check_walk_matmul(K, dev, got, transition_band(radius, W), failures)
    del got
    torch.cuda.empty_cache()
    # the same products on T from an edge map of a few closed regions
    edge = torch.rand(H, W, generator=g, device=dev) * REGION_NOISE
    for top, left, bottom, right in REGION_BOXES:
        box = edge[int(top * H):int(bottom * H), int(left * W):int(right * W)]
        box[[0, 1, -2, -1], :] = 1.0
        box[:, [0, 1, -2, -1]] = 1.0
    edge = F.pad(edge, (radius, radius, 0, radius), value=1.0)
    trans = K.walk_transition(K.path_max_affinity(edge, paths, rf), dirs, H, W, woff, 10.0)
    rows[-2]["shapes"].append(walk_chain_row(K, dev, "walk_matmul@chain_regions", trans,
                                             transition_band(radius, W), failures))
    del trans
    torch.cuda.empty_cache()
    return rows, failures


def centroid_steps(K, H, W) -> dict:
    """The steps K9's last launch on an [H, W] grid took: the longest warp's,
    the warps' mean, the warps that took all the steps, and the steps summed
    over the live pixels."""
    from tris_tpu_torch.tools.centroids_schedule import live_lanes

    steps = K.refine_centroids_steps().cpu().numpy()
    lanes = live_lanes(H, W, K.refine_centroids_plan(H, W))
    return {"max": int(steps.max()), "mean": float(steps.mean()), "warps": int(len(steps)),
            "warps_at_max": int((steps == steps.max()).sum()),
            "pixel_steps": int((steps.astype(np.int64) * lanes).sum())}


def skipped_share(K, t, band):
    """(k-tiles the square kernel skips for empty tiles, k-tiles in the
    band's range) of ``t @ t``, by the schedule the CPU tests emulate."""
    from tris_tpu_torch.tools.walk_schedule import skipped_share as share

    n = t.shape[0]
    rows, cols = K.walk_tile_occupancy(t)
    return share(rows, cols, n, n, n, band, band)


def nonzero_products(a, b):
    return float(((a != 0).sum(0).double() * (b != 0).sum(1).double()).sum())


def walk_chain(mm, trans, band, x, check=None):
    """The walk's 8 squarings and thin step through ``mm(a, b, band_a,
    band_b)``; ``check(s, a, b, out, band)`` after each product (s = 8: the
    thin step)."""
    n = trans.shape[0]
    t, b = trans, band
    for s in range(8):
        nxt = mm(t, t, b, b)
        if check is not None:
            check(s, t, t, nxt, b)
        t, b = nxt, min(2 * b, n)
    out = mm(x, t, None, b)
    if check is not None:
        check(8, x, t, out, b)
    return out


def walk_chain_row(K, dev, name, trans, band, failures, x=None):
    """The chain per image on T: card time of the kernel route (occupancy
    passes included) against the plain float64 chain (cuBLAS DGEMM) and
    float32 ``torch.mm``, every squaring within one float32 rounding of its
    plain version on the same input, the walk within 1e-4 of the plain
    chain's max, the share of the band's k-tiles skipped for empty tiles.
    Operations: 2 per product of two nonzeros, over the FP64 tensor cores'
    peak."""
    import torch

    n = trans.shape[0]
    if x is None:
        x = torch.rand(16, n, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
        x = x * (torch.rand(16, 1, device=dev) > 0.3)
    flops, skipped, in_band = [], [], []

    def check(s, a, b, out, band_b):
        flops.append(2 * nonzero_products(a, b))
        if s == 8:
            return
        sk, ib = skipped_share(K, a, band_b)
        skipped.append(sk)
        in_band.append(ib)
        want = K.walk_matmul_plain(a, a)
        if not max_err(out, want) <= float(want.abs().max()) * 2.0 ** -23:
            failures.append(f"{name}: squaring {s + 1} beyond one rounding of its plain version")

    out = walk_chain(K.walk_matmul, trans, band, x, check)
    want = walk_chain(K.walk_matmul_plain, trans, band, x)
    rel = max_err(out, want) / max(float(want.abs().max()), 1e-30)
    if not rel <= 1e-4:
        failures.append(f"{name}: the walk {rel} of its max from the plain chain's (> 1e-4)")
    del out, want
    torch.cuda.empty_cache()

    ms = device_ms(lambda: walk_chain(K.walk_matmul, trans, band, x), 1, 1)
    plain_ms = device_ms(lambda: walk_chain(K.walk_matmul_plain, trans, band, x), 1, 1)
    lib_ms = device_ms(lambda: walk_chain(lambda a, b, *bands: torch.mm(a, b), trans, band, x),
                       1, 1)
    b_ms, b_by = bound_ms(4 * (8 * 2 * n * n + n * n + x.numel() + 16 * n), sum(flops))
    share = sum(skipped) / max(sum(in_band), 1)
    log(f"kernel {name}: ms {ms:.2f} plain_ms {plain_ms:.2f} bound_ms {b_ms:.2f} ({b_by}) "
        f"library_ms {lib_ms:.2f} (torch.mm, f32), {sum(flops) / 1e12:.3f} TFLOP of nonzero "
        f"products, k-tiles skipped for empty tiles {share:.4f} "
        f"({sum(skipped)} of {sum(in_band)}), walk vs plain {rel:.3g} of its max")
    return {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "flops": sum(flops),
            "dense_flops": 8 * 2.0 * n ** 3 + 2.0 * 16 * n * n, "skipped_share": share,
            "k_tiles_skipped": skipped, "k_tiles_in_band": in_band, "walk_rel_err": rel}


def check_walk_matmul(K, dev, trans, band, failures):
    """K10's products on the walk's T [20480, 20480]: the main path's 8
    squarings (the band doubling from T's) and the thin step on 16 maps,
    each against its plain version (a float64 product) on the same input,
    within one float32 rounding of the output's largest entry. The row: the
    last (dense) squaring; under ``shapes``: the first squaring, a half-band
    one, the thin step, a dense random positive squaring against cuBLAS
    DGEMM (no zeros: the tensor cores alone) and the whole chain, every
    squaring of it within one rounding of its plain version. Banded
    equals dense and skip equals no skip bit for bit, and a rerun equals the
    first. Operations: 2 per product of two nonzeros of this T's powers,
    over the FP64 tensor cores' peak. A second row: the occupancy maps,
    exact against their plain version."""
    import torch

    n = trans.shape[0]

    def measure(name, a, b, band_a, band_b, flops, got, reps, nbytes=None):
        want = K.walk_matmul_plain(a, b)
        scale = float(want.abs().max())
        err = max_err(got, want)
        del want
        lib = lambda: torch.mm(a, b)  # noqa: E731
        lib_err = max_err(lib(), K.walk_matmul_plain(a, b))
        if nbytes is None:
            nbytes = 4 * ((a.numel() if a is b else a.numel() + b.numel()) + got.numel())
        return measure_row(failures, name, err, scale * 2.0 ** -23,
                           device_ms(lambda: K.walk_matmul(a, b, band_a, band_b), *reps),
                           device_ms(lambda: K.walk_matmul_plain(a, b), *reps), nbytes, flops,
                           device_ms(lib, *reps),
                           shape=[list(a.shape), list(b.shape)], bands=[band_a, band_b],
                           scale=scale, library_max_abs_err=lib_err)

    x = torch.rand(16, n, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    x = x * (torch.rand(16, 1, device=dev) > 0.3)
    powers, flops, t, b = [trans], [], trans, band
    for s in range(8):
        flops.append(2 * nonzero_products(t, t))
        t = K.walk_matmul(t, t, b, b)
        b = min(2 * b, n)
        powers.append(t)
    flops.append(2 * nonzero_products(x, t))
    bands = [min(band * 2 ** s, n) for s in range(9)]
    sub = [measure("walk_matmul@sq1", trans, trans, band, band, flops[0], powers[1], (5, 3)),
           measure("walk_matmul@sq5", powers[4], powers[4], bands[4], bands[4], flops[4],
                   powers[5], (2, 1)),
           # bytes: T read once, x and the output
           measure("walk_matmul@thin", x, powers[8], n, n, flops[8],
                   K.walk_matmul(x, powers[8], None, n), (5, 3))]
    x64, p64 = x.double(), powers[8].double()
    sub[-1]["dgemm_ms"] = device_ms(lambda: torch.mm(x64, p64), 5, 3)
    log(f"kernel walk_matmul@thin: DGEMM on float64 operands {sub[-1]['dgemm_ms']:.4f} ms")
    del x64, p64
    main = measure("walk_matmul", powers[7], powers[7], n, n, flops[7], powers[8], (2, 1))
    # banded = dense, skip = no skip and a rerun = the first run, bit for bit
    # (the chain's row holds every squaring to its plain version)
    exact = {}
    for s in (0, 4):
        rows, cols = K.walk_tile_occupancy(powers[s])
        exact[f"sq{s + 1}_banded_vs_dense"] = torch.equal(
            powers[s + 1], K.walk_matmul(powers[s], powers[s]))
        exact[f"sq{s + 1}_skip_vs_no_skip"] = torch.equal(
            powers[s + 1], K.walk_square(powers[s], powers[s], torch.ones_like(rows),
                                         torch.ones_like(cols), bands[s], bands[s]))
    exact["sq8_rerun"] = torch.equal(powers[8], K.walk_matmul(powers[7], powers[7], n, n))
    exact["thin_banded_vs_dense"] = torch.equal(K.walk_matmul(x, powers[4], None, bands[4]),
                                                K.walk_matmul(x, powers[4]))
    for k, ok in exact.items():
        if not ok:
            failures.append(f"walk_matmul: {k} not bit for bit")
    log(f"walk_matmul bit for bit: {exact}")

    # the occupancy maps of T and of a half-band power, exact; timed on T
    occ_errs = []
    for t in (trans, powers[4]):
        got_maps, want_maps = K.walk_tile_occupancy(t), K.walk_tile_occupancy_plain(t)
        occ_errs += [float((gm != wm).sum()) for gm, wm in zip(got_maps, want_maps)]
    rows, cols = K.walk_tile_occupancy(trans)
    occ = kernel_row(
        "walk_tile_occupancy", "tris_tpu_torch/kernels/csrc/walk_matmul.cu",
        "tris_tpu/pseudo/indexing.py:293",
        measure_row(failures, "walk_tile_occupancy", max(occ_errs), 0.0,
                    device_ms(lambda: K.walk_tile_occupancy(trans), 5, 3),
                    device_ms(lambda: K.walk_tile_occupancy_plain(trans), 2, 1),
                    4 * n * n + rows.numel() + cols.numel(), n * n, None,
                    shape=[n, n], maps=[list(rows.shape), list(cols.shape)],
                    occupied=[float(rows.float().mean()), float(cols.float().mean())]))
    del powers[1:]
    torch.cuda.empty_cache()

    # a dense random positive operand: no zero tile, no band, the tensor cores alone
    dense = torch.rand(n, n, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    dense = dense * 0.5 + 0.5
    dense64 = dense.double()
    dense_flops = 2.0 * n ** 3
    dgemm_ms = device_ms(lambda: torch.mm(dense64, dense64), 2, 1)
    row = measure("walk_matmul@dense_random", dense, dense, n, n, dense_flops,
                  K.walk_matmul(dense, dense), (2, 1))
    row.update(library_f32_ms=row["library_ms"], library_ms=dgemm_ms,
               library="torch.mm float64 (cuBLAS DGEMM)",
               tflops=dense_flops / row["ms"] / 1e9, dgemm_tflops=dense_flops / dgemm_ms / 1e9,
               ratio_to_dgemm=row["ms"] / dgemm_ms)
    log(f"kernel walk_matmul@dense_random: {row['tflops']:.2f} TFLOP/s against DGEMM's "
        f"{row['dgemm_tflops']:.2f} ({row['ms']:.2f} ms against {dgemm_ms:.2f}, "
        f"{row['ratio_to_dgemm']:.3f}x)")
    sub.insert(3, row)
    del dense, dense64
    torch.cuda.empty_cache()

    sub.append(walk_chain_row(K, dev, "walk_matmul@chain", trans, band, failures, x))
    return [kernel_row("walk_matmul", "tris_tpu_torch/kernels/csrc/walk_matmul.cu",
                       "tris_tpu/pseudo/indexing.py:524", main, sub), occ]


def check_irn_train_kernels(K, dev):
    """One row per kernel of IRN training, at the training step's shapes
    (B=24, crop 512, radius 10: the edge map and the displacement field at
    128x128, 152 directions, 119x110 windows), each against its plain
    version on the same inputs: K6's bilinear backward at the heads'
    upsamples (the dp6 tap the row, the others sub-rows), K7's forward at
    this shape (a sub-row of K7's, returned beside the rows) and its
    backward on an edge map with planted ties, and the loss fused with K7
    (K7 + K8), forward (sums and counts) and backward, with the peak memory
    of both. A backward row times the backward alone (on a retained graph).
    The tiled rows carry their plan and their shared-memory yardstick."""
    import torch

    from tris_tpu_torch.pseudo.indexing import PathIndex
    from tris_tpu_torch.tools import irn_affinity_schedule as T

    g = torch.Generator(device=dev).manual_seed(11)
    failures = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def row(name, source, replaces, *args, shapes=(), **extra):
        return kernel_row(name, source, replaces, measure_row(failures, name, *args, **extra),
                          shapes)

    def resize_bwd(name, shape, size):
        return resize_bwd_row(K, failures, name, randn(*shape), randn(*shape[:-2], *size))

    q = IRN_CROP // 4
    rows = [kernel_row(
        "bilinear_resize_bwd", "tris_tpu_torch/kernels/csrc/bilinear_resize_bwd.cu",
        "tris_tpu/ops/resize.py:57",
        resize_bwd("bilinear_resize_bwd", (IRN_B, 256, q // 2, q // 2), (q, q)),
        [resize_bwd("bilinear_resize_bwd@edge_x4", (IRN_B, 32, q // 4, q // 4), (q, q)),
         resize_bwd("bilinear_resize_bwd@edge_x2", (IRN_B, 32, q // 2, q // 2), (q, q)),
         resize_bwd("bilinear_resize_bwd@dp_x2", (IRN_B, 256, q // 4, q // 4), (q // 2, q // 2))])]
    torch.cuda.empty_cache()

    # K7's forward at the training step's shape, where the step no longer calls it (its loss
    # takes the edge map): exact
    pi = PathIndex(IRN_RADIUS, (q, q))
    paths, rf = pi.paths_by_length, pi.radius_floor
    steps = K.path_max.path_steps(paths)
    n_steps = sum(len(p) for p in steps)
    n_dirs, ch, cw = len(pi.search_dst), q - rf, q - 2 * rf
    with torch.no_grad():
        edge = torch.rand(IRN_B, q, q, generator=g, device=dev)
        got = K.path_max_affinity(edge, paths, rf)
        launch = K.path_max.launch_shape()
        k7_irn = measure_row(
            failures, "path_max_affinity@irn",
            max_err(got, K.path_max_affinity_plain(edge, paths, rf)), 0.0,
            device_ms(lambda: K.path_max_affinity(edge, paths, rf)),
            device_ms(lambda: K.path_max_affinity_plain(edge, paths, rf), 3, 1),
            4 * (edge.numel() + got.numel()), IRN_B * (n_steps + n_dirs) * ch * cw, None,
            shape=[IRN_B, q, q, IRN_RADIUS, n_dirs, ch, cw], path_steps=n_steps,
            plan=K.path_max.forward_plan(IRN_B, q, q, rf, n_dirs, n_steps), launch_shape=launch)
    del edge, got
    torch.cuda.empty_cache()

    # K7 backward on an edge map of 4 levels (exact ties along most paths)
    # with noise in its top third, against amax's autograd, which splits
    # ties evenly as JAX does. The kernel adds each pixel's terms (up to 2134)
    # in double and rounds once, so it is held to the plain version run in
    # float64 (edge and cotangent promoted) within 1e-6 of the gradient's
    # scale (8 float32 ulps at the largest value); the float32 plain
    # version, whose sums round at every add, within 1e-5, with its own
    # distance from float64 reported beside it; twice, bit for bit
    edge = torch.randint(0, 4, (IRN_B, q, q), generator=g, device=dev).float() / 4
    edge[:, : q // 3] = torch.rand(IRN_B, q // 3, q, generator=g, device=dev)
    tied = edge.clone()
    (edge,) = leaves(edge)
    cot = [randn(IRN_B, n_dirs, ch, cw)]
    kern = lambda e: K.path_max_affinity(e, paths, rf)  # noqa: E731
    plain = lambda e: K.path_max_affinity_plain(e, paths, rf)  # noqa: E731
    got, want = input_grads(kern, [edge], cot)[0], input_grads(plain, [edge], cot)[0]
    if not torch.equal(got, input_grads(kern, [edge], cot)[0]):
        failures.append("path_max_affinity_bwd: two runs differ")
    want64 = input_grads(plain, leaves(edge.double()), [cot[0].double()])[0]
    scale = float(want64.abs().max())
    err32, tol32 = max_err(got, want), 1e-5 * scale
    if not err32 <= tol32:
        failures.append(f"path_max_affinity_bwd: vs the float32 plain version {err32} > {tol32}")
    torch.cuda.empty_cache()
    with torch.no_grad():
        ties = 0
        for p in steps:
            w = torch.stack([edge[:, dy:dy + ch, rf + dx:rf + dx + cw] for dy, dx in p])
            ties += int(((w == w.amax(0)).sum(0) > 1).sum())
        # the library: one amax over the paths' gathered steps (padded with -inf)
        flat = torch.cat([edge.detach().reshape(IRN_B, -1),
                          torch.full((IRN_B, 1), -math.inf, device=dev)], 1)
        plen = max(len(p) for p in steps)
        rr, cc = np.mgrid[:ch, :cw]
        idx = np.full((n_dirs, plen, ch * cw), q * q, np.int64)
        for d, p in enumerate(steps):
            for k, (dy, dx) in enumerate(p):
                idx[d, k] = ((rr + dy) * q + rf + cc + dx).reshape(-1)
        gathered = flat[:, torch.as_tensor(idx, device=dev)]
    (gathered,) = leaves(gathered)
    lib = lambda t: t.amax(2)  # noqa: E731
    lib_cot = [cot[0].reshape(IRN_B, n_dirs, ch * cw)]
    loads = T.shared_loads(T.MAX_BACKWARD, IRN_B, q, q, rf, steps)
    rows.append(row(
        "path_max_affinity_bwd", "tris_tpu_torch/kernels/csrc/path_max_affinity_bwd.cu",
        "tris_tpu/pseudo/indexing.py:110", max_err(got, want64), 1e-6 * scale,
        bwd_ms(kern, [edge], cot), bwd_ms(plain, [edge], cot, 3, 1),
        4 * (cot[0].numel() + 2 * edge.numel()), 2 * IRN_B * n_steps * ch * cw,
        bwd_ms(lib, [gathered], lib_cot, 5), shape=[IRN_B, q, q, IRN_RADIUS],
        tied_entries=ties, entries=cot[0].numel(), reference="plain in float64", scale=scale,
        f32_plain_max_abs_err=err32, f32_plain_tol=tol32,
        f32_plain_vs_float64=max_err(want, want64),
        plan=K.path_max.tile_plan(T.MAX_BACKWARD, IRN_B, q, q, rf), smem_loads=loads,
        smem_ms=smem_ms(loads)))
    if ties < cot[0].numel() // 4:
        failures.append(f"path_max_affinity_bwd: only {ties} tied entries planted")
    del gathered, flat, got, want, want64, cot, edge
    torch.cuda.empty_cache()

    # K7 + K8 fused on a blocky {0, 1, 255} label map, the tied edge map (ties, and zeros:
    # aff = 1) and a field of a few pixels: the sums within 1e-5 relative and the counts exact
    # (forward); d edge within 1e-6 of the float64 plain gradient's scale and d dp within 1e-5
    # of its (backward); each twice, bit for bit; forward and backward together allocating
    # under 32 MB beyond their inputs (no field of the pairs' size)
    lab = torch.tensor([0, 1, 255], dtype=torch.uint8, device=dev)[
        torch.randint(0, 3, (IRN_B, q // 8, q // 8), generator=g, device=dev)]
    lab = lab.repeat_interleave(8, 1).repeat_interleave(8, 2).contiguous()
    edge, dp = leaves(tied, 3 * randn(IRN_B, 2, q, q))
    kern = lambda e, d: K.irn_affinity_loss(lab, e, d, pi)  # noqa: E731
    plain = lambda e, d: K.irn_affinity_loss_plain(lab, e, d, pi)  # noqa: E731
    with torch.no_grad():
        sums, counts = kern(edge, dp)
        again = kern(edge, dp)
        want_s, want_c = plain(edge, dp)
    rel = float(((sums.double() - want_s.double()).abs() / want_s.double().abs()).max())
    if not (torch.equal(counts, want_c) and rel <= 1e-5):
        failures.append(f"irn_affinity_loss: counts {counts.tolist()} vs {want_c.tolist()}, "
                        f"sums {rel} relative (> 1e-5)")
    if not (torch.equal(again[0], sums) and torch.equal(again[1], counts)):
        failures.append("irn_affinity_loss: two runs differ")
    n_pairs = IRN_B * n_dirs * ch * cw
    path_ops = IRN_B * n_steps * ch * cw
    io_bytes = lab.numel() + 4 * (edge.numel() + dp.numel())
    loads = T.shared_loads(T.LOSS_FORWARD, IRN_B, q, q, rf, steps)
    with torch.no_grad():
        rows.append(row(
            "irn_affinity_loss", "tris_tpu_torch/kernels/csrc/irn_affinity.cu",
            "tris_tpu/pseudo/indexing.py:110 + tris_tpu/pseudo/train_irn.py:91",
            max_err(sums, want_s), 1e-5 * float(want_s.abs().min()),
            device_ms(lambda: kern(edge, dp)), device_ms(lambda: plain(edge, dp), 3, 1),
            io_bytes + 4 * 5 + 8 * 3, path_ops + 16 * int(counts.sum()), None,
            shape=[IRN_B, q, q, n_dirs, ch, cw], pairs=n_pairs, sums=sums.tolist(),
            counts=counts.tolist(), sums_rel_err=rel,
            plan=K.path_max.tile_plan(T.LOSS_FORWARD, IRN_B, q, q, rf), smem_loads=loads,
            smem_ms=smem_ms(loads)))
    cot = [randn(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = input_grads(kern, [edge, dp], cot)
    torch.cuda.synchronize()
    extra_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    if not extra_mb < 32:
        failures.append(f"irn_affinity_loss: forward + backward allocated {extra_mb} MB")
    if not all(torch.equal(a, b) for a, b in zip(got, input_grads(kern, [edge, dp], cot))):
        failures.append("irn_affinity_loss_bwd: two runs differ")
    want = input_grads(plain, [edge, dp], cot)
    want64 = input_grads(plain, leaves(edge.double(), dp.double()), [cot[0].double()])
    scales = [float(w.abs().max()) for w in want64]
    err_dp, tol_dp = max_err(got[1], want64[1]), 1e-5 * scales[1]
    if not err_dp <= tol_dp:
        failures.append(f"irn_affinity_loss_bwd: d dp max_abs_err {err_dp} > {tol_dp}")
    loads = T.shared_loads(T.LOSS_BACKWARD, IRN_B, q, q, rf, steps)
    rows.append(row(
        "irn_affinity_loss_bwd", "tris_tpu_torch/kernels/csrc/irn_affinity.cu",
        "tris_tpu/pseudo/indexing.py:110 + tris_tpu/pseudo/train_irn.py:91",
        max_err(got[0], want64[0]), 1e-6 * scales[0],
        bwd_ms(kern, [edge, dp], cot), bwd_ms(plain, [edge, dp], cot, 3, 1),
        io_bytes + 4 * 5 + 4 * (edge.numel() + dp.numel()), 4 * path_ops, None,
        shape=[IRN_B, q, q, n_dirs, ch, cw], reference="plain in float64", scale=scales[0],
        d_dp_max_abs_err=err_dp, d_dp_tol=tol_dp, d_dp_scale=scales[1],
        f32_plain_d_edge_max_abs_err=max_err(got[0], want[0]),
        f32_plain_d_dp_max_abs_err=max_err(got[1], want[1]), fwd_bwd_extra_mb=extra_mb,
        plan=K.path_max.tile_plan(T.LOSS_BACKWARD, IRN_B, q, q, rf), smem_loads=loads,
        smem_ms=smem_ms(loads)))
    del edge, dp, got, want, want64, tied
    torch.cuda.empty_cache()
    return rows, {"path_max_affinity": [k7_irn]}, failures


def build_stage2(dev):
    """Full-width RN50 stage 2 from seed 0, in train mode."""
    import torch

    from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TRISStage2(Stage2Config(backbone="RN50", txt_length=TXT_LEN))
    return model.to(dev).train()


def check_stage2_kernels(K, dev, model):
    """Stage 2's kernels at its paths' shapes: K11 forward at the train
    step's c2 (the row), c3 and c4 (B=48, one sentence each) and at eval's
    8 images x S=4 pairs, its backward at the train levels; K12 over the
    whole stage-2 tree of ``model``, bit for bit; K6 bilinear forward and
    backward at the decoder's ``align_corners=False`` shapes (returned
    apart, sub-rows of K6's rows). Returns (rows, K6 forward sub-rows, K6
    backward sub-rows, failures)."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.train.stage2 import Stage2TrainConfig, ema_decay
    from tris_tpu_torch.train.state import ema_leaves, make_teacher

    g = torch.Generator(device=dev).manual_seed(12)
    failures = []

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # q InstanceNorm'd (unit scale), keys at half scale so that the softmax
    # over the 20 tokens is neither flat nor one-hot
    levels = [(f"c{i}", (SIZE // 2 ** (i + 1)) ** 2, 64 * 2 ** (i + 1)) for i in (2, 3, 4)]

    def pixel_fwd(name, N, S, hw, c):
        # 1e-5 of the output's scale against the plain version in float32 and
        # in float64; the grid as the launcher gave it to CUDA
        q, lk, lv = randn(N, hw, c), 0.5 * randn(N * S, TXT_LEN, c), randn(N * S, TXT_LEN, c)
        with torch.no_grad():
            got, want = K.pixel_attn(q, lk, lv, S), K.pixel_attn_plain(q, lk, lv, S)
            want64 = K.pixel_attn_plain(q.double(), lk.double(), lv.double(), S)
        launch = K.pixel_attn_launch_shape("pixel_attn")
        scale = float(want.abs().max())
        err64, tol64 = max_err(got, want64), 1e-5 * float(want64.abs().max())
        if not err64 <= tol64:
            failures.append(f"{name}: max_abs_err vs float64 {err64} > {tol64}")
        qs = q.repeat_interleave(S, 0)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs[:, None], lk[:, None], lv[:, None])
        P = N * S
        return measure_row(failures, name, max_err(got, want), 1e-5 * scale,
                           device_ms(lambda: K.pixel_attn(q, lk, lv, S)),
                           device_ms(lambda: K.pixel_attn_plain(q, lk, lv, S)),
                           4 * (N * hw * c + 2 * P * TXT_LEN * c + P * hw * c),
                           4 * P * hw * TXT_LEN * c, device_ms(lib), shape=[N, S, hw, c, TXT_LEN],
                           scale=scale, library_max_abs_err=max_err(got, lib()[:, 0]),
                           max_abs_err_f64=err64, tol_f64=tol64, launch_shape=launch)

    fwd = [pixel_fwd("pixel_attn" if lv == "c2" else f"pixel_attn@{lv}", TRAIN2_B, 1, hw, c)
           for lv, hw, c in levels]
    fwd += [pixel_fwd(f"pixel_attn@eval_{lv}", B, S, hw, c) for lv, hw, c in levels]
    rows = [kernel_row("pixel_attn", "tris_tpu_torch/kernels/csrc/pixel_attn.cu",
                       "tris_tpu/models/fusion.py:20", fwd[0], fwd[1:])]

    # the backward: each gradient within 1e-4 of its max against the plain
    # version in float32 and in float64 (the row reports the gradient nearest
    # its bar); SDPA's backward as the library; c2's bit for bit over two
    # runs (no atomics, every sum in a fixed order); each of its two
    # launches timed alone through the op (torch.profiler, not counted)
    def pixel_bwd(name, hw, c):
        ins = leaves(randn(TRAIN2_B, hw, c), 0.5 * randn(TRAIN2_B, TXT_LEN, c),
                     randn(TRAIN2_B, TXT_LEN, c))
        cot = [randn(TRAIN2_B, hw, c)]
        kern = lambda *x: K.pixel_attn(*x, 1)  # noqa: E731
        plain = lambda *x: K.pixel_attn_plain(*x, 1)  # noqa: E731
        lib = lambda *x: F.scaled_dot_product_attention(  # noqa: E731
            *(t[:, None] for t in x))[:, 0]
        got, want = input_grads(kern, ins, cot), input_grads(plain, ins, cot)
        launch = {k: K.pixel_attn_launch_shape(k)
                  for k in ("pixel_attn_bwd_probs_dq", "pixel_attn_bwd_dkv")}
        err, tol = max(((max_err(a, b), 1e-4 * float(b.abs().max())) for a, b in zip(got, want)),
                       key=lambda et: et[0] / et[1])
        want64 = input_grads(plain, leaves(*(x.double() for x in ins)), [cot[0].double()])
        err64, tol64 = max(((max_err(a, b), 1e-4 * float(b.abs().max()))
                            for a, b in zip(got, want64)), key=lambda et: et[0] / et[1])
        if not err64 <= tol64:
            failures.append(f"{name}: max_abs_err vs float64 {err64} > {tol64}")
        extra = {}
        if hw == levels[0][1]:
            bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, input_grads(kern, ins, cot)))
            if not bitwise:
                failures.append(f"{name}: two runs differ")
            extra["bit_for_bit_run_to_run"] = bitwise
        args = (cot[0], *(x.detach() for x in ins), 1, math.sqrt(c))
        extra["kernel_ms"] = kernel_times(lambda: build.ops().pixel_attn_bwd(*args),
                                          ("pixel_attn_bwd_probs_dq", "pixel_attn_bwd_dkv"))
        P, T = TRAIN2_B, TXT_LEN
        return measure_row(failures, name, err, tol, bwd_ms(kern, ins, cot),
                           bwd_ms(plain, ins, cot), 4 * (3 * P * hw * c + 4 * P * T * c),
                           10 * P * hw * T * c, bwd_ms(lib, ins, cot), shape=[P, 1, hw, c, T],
                           library_max_abs_err=max(max_err(a, b) for a, b in zip(
                               got, input_grads(lib, ins, cot))),
                           max_abs_err_f64=err64, tol_f64=tol64, launch_shape=launch, **extra)

    bwd = [pixel_bwd("pixel_attn_bwd" if lv == "c2" else f"pixel_attn_bwd@{lv}", hw, c)
           for lv, hw, c in levels]
    rows.append(kernel_row("pixel_attn_bwd", "tris_tpu_torch/kernels/csrc/pixel_attn_bwd.cu",
                           "tris_tpu/models/fusion.py:37", bwd[0], bwd[1:]))
    torch.cuda.empty_cache()

    # K12 over the whole tree: two teachers scaled alike, one updated by the
    # kernel, one by the plain version, at the decay of counter 2 (1 - 2^-2/3)
    teachers = [make_teacher(model) for _ in range(2)]
    for t in teachers:
        for leaf in ema_leaves(t):
            if leaf.is_floating_point():
                leaf.mul_(0.75)
    student = ema_leaves(model)
    (ek, ep) = (ema_leaves(t) for t in teachers)
    d = ema_decay(2, Stage2TrainConfig(use_ema=True, ema_update_after=0, ema_update_every=1))
    table = K.EmaTable(ek, student)
    K.ema_update(ek, student, d, table=table)
    K.ema_update_plain(ep, student, d)
    exact = all(torch.equal(a, b) for a, b in zip(ek, ep))
    err = max(max_err(a, b) for a, b in zip(ek, ep))
    floats = [i for i, t in enumerate(student) if t.is_floating_point()]
    n_float = sum(student[i].numel() for i in floats)
    n_int = sum(t.numel() for t in student if not t.is_floating_point())
    fe, fs = [ek[i] for i in floats], [student[i] for i in floats]
    rows.append(kernel_row(
        "ema_update", "tris_tpu_torch/kernels/csrc/ema_update.cu", "tris_tpu/train/state.py:161",
        measure_row(failures, "ema_update", err, 0.0,
                    device_ms(lambda: K.ema_update(ek, student, d, table=table)),
                    device_ms(lambda: K.ema_update_plain(ep, student, d), n=5),
                    3 * 4 * n_float + 2 * 8 * n_int, 3 * n_float,
                    device_ms(lambda: torch._foreach_lerp_(fe, fs, 1.0 - d)),
                    leaves=len(student), float_elements=n_float, int_elements=n_int,
                    bit_exact=exact, decay=d, tree_bytes=4 * n_float + 8 * n_int)))
    if not exact:
        failures.append("ema_update: not bit for bit the plain version")
    del teachers, ek, ep, fe, table
    torch.cuda.empty_cache()

    # K6 at the decoder's shapes: the three x2 taps and the heads' upsamples
    # to 320 px, forward (exact) and backward
    hs = [SIZE // 32, SIZE // 16, SIZE // 8, SIZE // 4]            # 10, 20, 40, 80
    shapes = [("dec_x2_c4", (TRAIN2_B, 256, hs[0], hs[0]), (hs[1], hs[1])),
              ("dec_x2_c3", (TRAIN2_B, 128, hs[1], hs[1]), (hs[2], hs[2])),
              ("dec_x2_c2", (TRAIN2_B, 64, hs[2], hs[2]), (hs[3], hs[3])),
              ("head_x4", (TRAIN2_B, 1, hs[3], hs[3]), (SIZE, SIZE)),
              ("head_x8", (TRAIN2_B, 1, hs[2], hs[2]), (SIZE, SIZE)),
              ("head_x16", (TRAIN2_B, 1, hs[1], hs[1]), (SIZE, SIZE))]
    k6 = [resize_row(K, failures, f"bilinear_resize@{n}", randn(*shape), size, False)
          for n, shape, size in shapes]
    k6_bwd = [resize_bwd_row(K, failures, f"bilinear_resize_bwd@{n}", randn(*shape),
                             randn(*shape[:2], *size)) for n, shape, size in shapes]
    torch.cuda.empty_cache()
    return rows, k6, k6_bwd, failures


def bn_launches(max_ranks=None) -> dict:
    """K13's launches ({"batch_norm": n, "batch_norm_bwd": m}) per stage-1 eval
    forward, per stage-1 and stage-2 train step and per stage-2 eval batch,
    from the plans of tris_tpu_torch/tools/batch_norm_schedule.py at the
    paths' shapes (its tests hold them to the models' calls and
    launchers.h's rule; phase 3 holds them to the extension's). max_ranks:
    the widest cluster the card's plans took (the card's, by default)."""
    import torch

    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.tools import batch_norm_schedule as S

    if max_ranks is None and torch.cuda.is_available():
        max_ranks = build.ops().batch_norm_plan(TRAIN_B, 64, 80 * 80, True, True, 1,
                                                -1)["max_ranks"]

    def fwd(shapes, mode="train"):
        return S.launches_per_forward(shapes, mode, max_ranks)

    def bwd(shapes, act="relu"):
        return S.launches_per_backward(shapes, act, max_ranks)

    trunk1, trunk2 = S.trunk_shapes(TRAIN_B), S.trunk_shapes(TRAIN2_B)
    dec = S.decoder_shapes(TRAIN2_B)
    eval_trunk = fwd(S.trunk_shapes(B), "eval")
    return {"stage1_eval": {"batch_norm": eval_trunk, "batch_norm_bwd": 0},
            "stage1_train": {"batch_norm": fwd(trunk1), "batch_norm_bwd": bwd(trunk1)},
            "stage2_train": {"batch_norm": 2 * (fwd(trunk2) + fwd(dec)),
                             "batch_norm_bwd": bwd(trunk2) + bwd(dec, "prelu")},
            "stage2_eval": {"batch_norm": eval_trunk + fwd(S.decoder_shapes(B, side=False), "eval"),
                            "batch_norm_bwd": 0}}


def bn_reference64(x, w, b, rm, rv, training, update, act, slope, res, eps=1e-5, m=0.1):
    """K13's function in float64 (inputs promoted), an independent reference:
    batch statistics (or the running ones), the affine, the residual and the
    activation; the running buffers (float64 copies) moved in place."""
    import torch

    x, w, b = x.double(), w.double(), b.double()
    if training:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        if update:
            n = x.numel() // x.shape[1]
            rm.mul_(1 - m).add_(m * mean.detach())
            rv.mul_(1 - m).add_(m * var.detach() * (n / max(n - 1, 1)))
    else:
        mean, var = rm, rv
    y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + eps)
    y = y * w[:, None, None] + b[:, None, None]
    if res is not None:
        y = y + res.double()
    if act == "relu":
        return torch.relu(y)
    if act == "prelu":
        return torch.where(y >= 0, y, slope.double() * y)
    return y


def bn_kernels_of(plan, backward):
    """The kernels a K13 call of ``plan`` launches, in order."""
    if plan["design"] == 2:
        return ["batch_norm_apply"]
    if plan["design"] == 1:
        return (["batch_norm_bwd_fused", "batch_norm_bwd_slope"][:plan["launches"]] if backward
                else ["batch_norm_fwd_fused"])
    return (["batch_norm_bwd_partial", "batch_norm_bwd_final", "batch_norm_bwd_apply"] if backward
            else ["batch_norm_stats_partial", "batch_norm_stats_final", "batch_norm_apply"])


def check_bn_plans(ops, failures):
    """The extension's plan at every norm of the RN50 trunk (ReLU) and stage 2's
    decoder (PReLU) at B=48, forward and backward, against the schedule
    tool's (the same rule, launchers.h's constants); returns how many of
    each take the fused design and the widest cluster the card took."""
    from tris_tpu_torch.kernels.batch_norm import ACTS
    from tris_tpu_torch.tools import batch_norm_schedule as S

    calls = ([(s, "relu") for s in S.trunk_shapes(TRAIN_B)]
             + [(s, "prelu") for s in S.decoder_shapes(TRAIN2_B)])
    fused = collections.Counter()
    max_ranks = set()
    for (N, C, H, W), act in calls:
        for backward in (False, True):
            got = dict(ops.batch_norm_plan(N, C, H * W, True, backward, ACTS[act], -1))
            want = S.plan(N, C, H * W, True, backward, act, got["max_ranks"])
            max_ranks.add(got["max_ranks"])
            if got != want:
                failures.append(f"batch_norm_plan{(N, C, H * W, backward, act)}: the "
                                f"extension's {got}, the schedule tool's {want}")
            part = "trunk" if act == "relu" else "decoder"
            fused[f"{part}_{'bwd' if backward else 'fwd'}"] += got["design"] == 1
    log(f"batch_norm plans: fused norms {dict(fused)} of {len(S.trunk_shapes())} trunk and "
        f"{len(S.decoder_shapes())} decoder norms; clusters up to {sorted(max_ranks)}")
    return {"fused_norms": dict(fused), "max_ranks": sorted(max_ranks)}


def check_batch_norm_kernels(K, dev):
    """K13 at ``BN_ROWS``: the forward against its plain version, the JAX
    package's arithmetic (``jax_batch_stats``; 1e-5 of y's scale; the eval
    fold bit for bit), against the route reference (``batch_norm_act_reference``:
    bit for bit, but where a channel's statistics differ from the reference's
    in their last bit, a sample sum within an ulp of a float32 rounding
    boundary: then the row counts those channels and holds y to 1e-5 of its
    scale), and against float64 (y 1e-5 of its scale; the statistics the
    call returned, var, rstd and the running variance within 1e-6 relative,
    element by element; the mean and the running mean within 1e-6 of the
    vector's largest magnitude, since a channel's mean may lie near zero,
    where a float32 batch sum is exact only to the channel's spread; the
    teacher's buffers untouched); the train rows' backward, each gradient
    within 1e-4 of its max against the plain version and float64, the stem's
    and layer3's twice, bit for bit. Each row reports its plans and the
    launches' shapes; ``BN_BOTH_DESIGNS`` rows also time the fused and the
    two-pass design against each other, each way. ``F.batch_norm`` (cuDNN)
    is the library call, timed only: it omits the activation and the
    residual. Returns (rows, plans, failures)."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.kernels.batch_norm import ACTS, batch_stats_plain, jax_batch_stats

    ops = build.ops()
    g = torch.Generator(device=dev).manual_seed(13)
    failures, fwd, bwd = [], [], []
    plans = check_bn_plans(ops, failures)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def rel(a, b):
        """max |a - b| / |b|, element by element"""
        return float(((a.double() - b.double()).abs() / b.double().abs()).max())

    def rel_scale(a, b):
        """max |a - b| over the vector's largest magnitude"""
        return max_err(a, b) / max(float(b.double().abs().max()), 1e-30)

    def shapes_of(plan, backward):
        return {k: dict(ops.batch_norm_launch_shape(k)) for k in bn_kernels_of(plan, backward)}

    for name, shape, act, with_res, mode in BN_ROWS:
        N, C, H, W = shape
        training, update = mode != "eval", mode == "train"
        x = 1.5 * randn(*shape) + randn(1, C, 1, 1)          # channels off zero
        w, b = 1 + 0.3 * randn(C), 0.5 * randn(C)
        rm0, rv0 = randn(C), 0.5 + torch.rand(C, generator=g, device=dev)
        slope = torch.full((1,), 0.25, device=dev) if act == "prelu" else None
        res = randn(*shape) if with_res else None
        kw = dict(training=training, update_stats=update, momentum=0.1, eps=1e-5, act=act,
                  slope=slope, residual=res)
        rm, rv, rmp, rvp = rm0.clone(), rv0.clone(), rm0.clone(), rv0.clone()
        rm64, rv64 = rm0.double(), rv0.double()
        fplan = dict(ops.batch_norm_plan(N, C, H * W, training, False, ACTS[act], -1))
        with torch.no_grad():
            got = K.batch_norm_act(x, w, b, rm, rv, **kw)
            torch.cuda.synchronize()
            extra = {"shape": list(shape), "act": act, "residual": with_res, "mode": mode,
                     "plan": fplan, "launch_shapes": shapes_of(fplan, False)}
            want = K.batch_norm_act_plain(x, w, b, rmp, rvp, **kw)
            want64 = bn_reference64(x, w, b, rm64, rv64, training, update, act, slope, res)
        scale = float(want64.abs().max())
        err64, tol = max_err(got, want64), 1e-5 * scale
        extra.update(scale=scale, max_abs_err_f64=err64, tol_f64=tol)
        if not err64 <= tol:
            failures.append(f"{name}: y vs float64 {err64} > {tol}")
        extra["bit_for_bit_plain"] = bool(torch.equal(got, want))
        if mode == "eval" and not extra["bit_for_bit_plain"]:
            failures.append(f"{name}: the eval fold is not the plain route bit for bit")
        elif mode != "eval":
            with torch.no_grad():
                _, stats = ops.batch_norm_fwd(x, w, b, res, slope, None, None, ACTS[act], 0.1,
                                              1e-5, -1)   # this call's own statistics
                ref = K.batch_norm_act_reference(x, w, b, rm0.clone(), rv0.clone(),
                                                 **{**kw, "update_stats": False})
                ref_stats = torch.stack(batch_stats_plain(x, 1e-5))
            boundary = int((stats != ref_stats).any(dim=0).sum())
            extra["bit_for_bit_reference"] = bool(torch.equal(got, ref))
            extra["boundary_channels"] = boundary
            extra["max_abs_err_reference"] = max_err(got, ref)
            if not extra["bit_for_bit_reference"] and (
                    boundary == 0 or not extra["max_abs_err_reference"] <= tol):
                failures.append(f"{name}: y vs the route reference {max_err(got, ref)} with "
                                f"{boundary} channels' statistics apart (bar: bit for bit, or "
                                f"{tol} where statistics differ)")
            x64 = x.double()
            m64 = x64.mean(dim=(0, 2, 3))
            v64 = ((x64 - m64[:, None, None]) ** 2).mean(dim=(0, 2, 3))
            extra["stats_rel_err_f64"] = {
                "mean_of_scale": rel_scale(stats[0], m64), "var": rel(stats[1], v64),
                "rstd": rel(stats[2], 1 / torch.sqrt(v64 + 1e-5))}
            jx = jax_batch_stats(x, 1e-5)                     # reported beside, no bar
            extra["stats_rel_err_jax"] = {"mean_of_scale": rel_scale(stats[0], jx[0]),
                                          "var": rel(stats[1], jx[1]), "rstd": rel(stats[2], jx[2])}
            if update:
                extra["running_rel_err_f64"] = {"mean_of_scale": rel_scale(rm, rm64),
                                                "var": rel(rv, rv64)}
            elif not (torch.equal(rm, rm0) and torch.equal(rv, rv0)):
                failures.append(f"{name}: update_stats=False moved the running buffers")
            worst = max(list(extra["stats_rel_err_f64"].values())
                        + list(extra.get("running_rel_err_f64", {}).values()))
            if not worst <= 1e-6:
                failures.append(f"{name}: statistics or running buffers {worst} > 1e-6 "
                                f"relative (the means: of their scale) from float64")
            del ref, ref_stats, x64
        n = x.numel()
        if name in BN_BOTH_DESIGNS:
            designs = {}
            for force, design in ((0, "two_pass"), (1, "fused")):
                run_fwd = lambda force=force: ops.batch_norm_fwd(  # noqa: E731
                    x, w, b, res, slope, None, None, ACTS[act], 0.1, 1e-5, force)
                with torch.no_grad():
                    designs[design] = run_fwd()
                    extra[f"{design}_ms"] = device_ms(run_fwd)
            extra["designs_max_abs_diff"] = max_err(designs["two_pass"][0], designs["fused"][0])
            if not extra["designs_max_abs_diff"] <= tol:
                failures.append(f"{name}: the designs' y {extra['designs_max_abs_diff']} apart")
            del designs
        lib = lambda: F.batch_norm(x, rm, rv, w, b, training, 0.1, 1e-5)  # noqa: E731
        fwd.append(measure_row(
            failures, name, max_err(got, want), 1e-5 * float(want.abs().max()),
            device_ms(lambda: K.batch_norm_act(x, w, b, rm, rv, **kw)),
            device_ms(lambda: K.batch_norm_act_plain(x, w, b, rmp, rvp, **kw), n=5),
            4 * (2 * n + (n if with_res else 0)),
            n * (8 * training + 2 + with_res + (act != "none")), device_ms(lib), **extra))
        del got, want, want64
        if mode != "train":
            continue

        # the backward: dx, dweight, dbias (and the slope, the residual) within
        # 1e-4 of each gradient's max against the plain version and float64.
        # Where the activation's input lies within 1e-5 of its scale of the
        # kink (|y| ~ 0), float32 routes and float64 may put it on either side,
        # and each such element moves dweight and dbias by its whole
        # cotangent: the bars take the cotangent zero there (the elements
        # counted), and the full cotangent's distance is reported beside
        ins = leaves(*(t for t in (x, w, b, slope, res) if t is not None))
        full = [randn(*shape)]
        with torch.no_grad():
            pre = bn_reference64(x, w, b, rm.double(), rv.double(), True, False, "none", None,
                                 res)
            kink = (pre.abs() <= 1e-5 * float(pre.abs().max())) if act != "none" else None
        cot = [full[0].masked_fill(kink, 0)] if kink is not None else full

        def grad_err(a, c):
            return max_err(a, c), 1e-4 * float(c.abs().max())

        def call(fn, rmx, rvx):
            def f(x, w, b, *rest):
                sl = rest[0] if act == "prelu" else None
                r = rest[-1] if with_res else None
                return fn(x, w, b, rmx, rvx, **{**kw, "slope": sl, "residual": r})
            return f

        kern = call(K.batch_norm_act, rm.clone(), rv.clone())
        plain = call(K.batch_norm_act_plain, rm.clone(), rv.clone())

        def ref64(x, w, b, *rest):
            sl = rest[0] if act == "prelu" else None
            r = rest[-1] if with_res else None
            return bn_reference64(x, w, b, rm.double(), rv.double(), True, False, act, sl, r)

        bplan = dict(ops.batch_norm_plan(N, C, H * W, True, True, ACTS[act], -1))
        got_g = input_grads(kern, ins, cot)
        torch.cuda.synchronize()
        extra = {"shape": list(shape), "act": act, "residual": with_res, "plan": bplan,
                 "launch_shapes": shapes_of(bplan, True)}
        want_g = input_grads(plain, ins, cot)
        want64_g = input_grads(ref64, ins, cot)
        err, tol = max((grad_err(a, c) for a, c in zip(got_g, want_g)),
                       key=lambda et: et[0] / et[1])
        err64, tol64 = max((grad_err(a, c) for a, c in zip(got_g, want64_g)),
                           key=lambda et: et[0] / et[1])
        full_err = max((grad_err(a, c) for a, c in zip(input_grads(kern, ins, full),
                                                       input_grads(plain, ins, full))),
                       key=lambda et: et[0] / et[1])
        n_kink = int(kink.sum()) if kink is not None else 0
        if n_kink > 1e-3 * n:
            failures.append(f"{name}_bwd: {n_kink} of {n} elements at the activation's kink")
        extra.update(kink_elements=n_kink, full_cotangent_max_abs_err_and_tol=full_err,
                     max_abs_err_f64=err64, tol_f64=tol64,
                     grads=["dx", "dweight", "dbias"] + (["dslope"] if act == "prelu" else [])
                     + (["dresidual"] if with_res else []))
        if not err64 <= tol64:
            failures.append(f"{name}_bwd: max_abs_err vs float64 {err64} > {tol64}")
        if name in BN_REPEATED:
            again = input_grads(kern, ins, cot)
            extra["bit_for_bit_run_to_run"] = all(bool(torch.equal(a, b))
                                                  for a, b in zip(got_g, again))
            if not extra["bit_for_bit_run_to_run"]:
                failures.append(f"{name}_bwd: two runs differ")
            del again
        if name in BN_BOTH_DESIGNS:
            with torch.no_grad():
                y, st = ops.batch_norm_fwd(x, w, b, res, slope, None, None, ACTS[act], 0.1, 1e-5,
                                           -1)
                designs = {}
                for force, design in ((0, "two_pass"), (1, "fused")):
                    call_bwd = lambda force=force: ops.batch_norm_bwd(  # noqa: E731
                        cot[0], x, y if act == "relu" else None, st[0], st[2], w, b, slope,
                        ACTS[act], with_res, force)
                    designs[design] = call_bwd()
                    extra[f"{design}_ms"] = device_ms(call_bwd)
            extra["designs_max_abs_err_and_tol"] = max(
                (grad_err(a, c) for a, c in zip(designs["fused"][:3], designs["two_pass"][:3])),
                key=lambda et: et[0] / et[1])
            d_err, d_tol = extra["designs_max_abs_err_and_tol"]
            if not d_err <= d_tol:
                failures.append(f"{name}_bwd: the designs' gradients {d_err} > {d_tol} apart")
            del y, st, designs
        lib_ins = ins[:3]
        lib = lambda x, w, b: F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5)  # noqa: E731
        bwd.append(measure_row(
            failures, name.replace("batch_norm", "batch_norm_bwd"), err, tol,
            bwd_ms(kern, ins, cot), bwd_ms(plain, ins, cot, 5),
            4 * n * (3 + (act == "relu") + with_res), 14 * n, bwd_ms(lib, lib_ins, cot),
            **extra))
        del ins, cot, full, got_g, want_g, want64_g, pre, kink
        torch.cuda.empty_cache()
    rows = [kernel_row("batch_norm", "tris_tpu_torch/kernels/csrc/batch_norm.cu",
                       "tris_tpu/models/layers.py:181", fwd[0], fwd[1:]),
            kernel_row("batch_norm_bwd", "tris_tpu_torch/kernels/csrc/batch_norm_bwd.cu",
                       "tris_tpu/models/layers.py:219", bwd[0], bwd[1:])]
    torch.cuda.empty_cache()
    return rows, plans, failures


# ---- phase 3: the bfloat16 kernels (--bf16) -------------------------------------


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp at ``scale`` (8 bits of precision)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


# where the plain version lies past this share of the output's scale from float64, the kernel
# is held to BF16_ULPS_VS_PLAIN bfloat16 ulps of the scale from the plain version itself
BF16_PLAIN_FAR, BF16_ULPS_VS_PLAIN = 0.1, 4


def bf16_distances(failures, name, got, plain, want64) -> dict:
    """The kernel's and the plain version's max distance from a float64
    evaluation of the same bfloat16 inputs, and the bars, a failure noted
    when the kernel passes one: the plain version's distance plus one
    bfloat16 ulp of the output's scale; and where that bar is wide, the
    plain version more than a tenth of the scale from float64 (float64 takes
    another branch than bfloat16: a ReLU mask, GMP's maxima among bfloat16
    dots), 4 such ulps from the plain version itself (elsewhere the
    bfloat16 routes' orders of summation alone lie up to 3 ulps apart)."""
    scale = float(want64.abs().max())
    e_k, e_p, e_kp = max_err(got, want64), max_err(plain, want64), max_err(got, plain)
    tol = e_p + bf16_ulp(scale)
    tol_plain = BF16_ULPS_VS_PLAIN * bf16_ulp(scale) if e_p > BF16_PLAIN_FAR * scale else None
    if not e_k <= tol:
        failures.append(f"{name}: {e_k} from float64 > the plain version's {e_p} + one "
                        f"bfloat16 ulp of {scale}")
    if tol_plain is not None and not e_kp <= tol_plain:
        failures.append(f"{name}: {e_kp} from the plain version > {BF16_ULPS_VS_PLAIN} "
                        f"bfloat16 ulps of {scale}")
    return {"max_abs_err": e_k, "tol": tol, "max_abs_err_plain": e_p, "output_scale": scale,
            "max_abs_err_vs_plain": e_kp, "tol_vs_plain": tol_plain}


def bf16_row(name, dists, ms, plain_ms, nbytes, flops, library_ms, peak_ops=PEAK_BF16_S,
             **extra):
    """A bfloat16 kernel's row, logged: its distances, its and the plain
    version's device ms, the bound at bfloat16 widths (the operations at
    ``peak_ops``: the bfloat16 tensor cores', FP32's for a float32 mix) and
    the library ms."""
    b_ms, b_by = bound_ms(nbytes, flops, peak_ops)
    log(f"kernel {name}: float64 distance {dists['max_abs_err']:.3g} (plain "
        f"{dists['max_abs_err_plain']:.3g}, bar {dists['tol']:.3g}), from the plain version "
        f"{dists['max_abs_err_vs_plain']:.3g} (bar {dists['tol_vs_plain']}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {library_ms}")
    return {"name": name, **dists, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, **extra}


def check_bf16_kernels(K, dev):
    """The four bfloat16 kernels of ``--bf16`` (stage-1 eval and PRMS) at
    phase 13's shapes, against their plain versions (which also take
    bfloat16) on the same bfloat16 inputs: each one's and the plain
    version's max distance from a float64 evaluation of those inputs, the
    kernel's no more than one bfloat16 ulp of the output's scale past the
    plain version's (and no more than 4 from the plain version itself where
    that lies past a tenth of the scale from float64; K13's fold also bit
    for bit to its plain version);
    device ms of kernel and plain version, the bound at the inputs' and
    outputs' widths (bytes over the memory rate, or operations over the
    bfloat16 rate), and the library call in bfloat16 (SDPA for K1 and K2,
    ``F.batch_norm`` for K13; none computes K3's). Rows ``mha_short.bf16``
    (the text tower on bfloat16 leaves), ``cross_attn.bf16`` (bfloat16
    leaves; float32 ones as a shape), ``response_head.bf16`` (likewise) and
    ``batch_norm.bf16`` (the stem, a bottleneck's tails, a downsample)."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.models.layers import causal_mask
    from tris_tpu_torch.ops.dtypes import weak

    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(20)
    failures = []

    def randn(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    def row(name, got, plain, want64, *times, **extra):
        return bf16_row(name, bf16_distances(failures, name, got, plain, want64), *times,
                        **extra)

    # K13's eval fold at stage-1 eval's B = 8: the stem's first norm, layer1's and layer4's
    # tails (the residual then ReLU), layer1's downsample (no activation)
    fold_rows = []
    for name, shape, act, with_res in (
            ("batch_norm.bf16", (B, 32, 160, 160), "relu", False),
            ("batch_norm.bf16@layer1_tail", (B, 256, 80, 80), "relu", True),
            ("batch_norm.bf16@layer4_tail", (B, 2048, 10, 10), "relu", True),
            ("batch_norm.bf16@layer1_downsample", (B, 256, 80, 80), "none", False)):
        C = shape[1]
        x = randn(*shape, scale=1.5)
        res = randn(*shape) if with_res else None
        w, b = 1 + 0.3 * randn(C, dtype=f32), 0.5 * randn(C, dtype=f32)
        rm, rv = randn(C, dtype=f32), 0.5 + torch.rand(C, generator=g, device=dev)
        kw = dict(training=False, update_stats=False, momentum=0.1, eps=1e-5, act=act)
        call = lambda x=x, res=res: K.batch_norm_act(x, w, b, rm, rv, residual=res, **kw)  # noqa: E731
        plain = lambda x=x, res=res: K.batch_norm_act_plain(x, w, b, rm, rv, residual=res, **kw)  # noqa: E731
        got, want = call(), plain()
        want64 = K.batch_norm_act_plain(x.double(), w, b, rm, rv, residual=None if res is None
                                        else res.double(), **kw)
        lib = lambda x=x: F.batch_norm(x, rm, rv, w, b, False, 0.1, 1e-5)  # noqa: E731
        n = x.numel()
        exact = bool(torch.equal(got, want))
        if not exact:
            failures.append(f"{name}: not bit for bit its plain version")
        fold_rows.append(row(name, got, want, want64, device_ms(call), device_ms(plain),
                             2 * (n * (2 + with_res) + 2 * C), n * (2 + with_res),
                             device_ms(lib), shape=list(shape), act=act, residual=with_res,
                             exact=exact,
                             launch_shape=dict(build.ops().batch_norm_launch_shape(
                                 "batch_norm_fold_bf16"))))

    # K1 on the text tower's bfloat16 q, k, v (bfloat16 leaves): N = B*S, L = 20, C = 512,
    # 8 heads, the float32 causal mask; out float32
    N, C, H = B * S, 512, 8
    q, k, v = randn(N, TXT_LEN, 3 * C).chunk(3, dim=-1)
    mask = causal_mask(TXT_LEN, device=dev)
    call = lambda: K.mha_short(q, k, v, H, mask)  # noqa: E731
    plain = lambda: K.mha_short_plain(q, k, v, H, mask)  # noqa: E731
    got, want = call(), plain()
    want64 = K.mha_short_plain(q.double(), k.double(), v.double(), H, mask.double())
    mask_bf = mask.to(bf)
    k1 = row("mha_short.bf16", got, want, want64, device_ms(call), device_ms(plain),
             2 * 3 * N * TXT_LEN * C + 4 * TXT_LEN * TXT_LEN + 4 * N * TXT_LEN * C,
             4 * N * TXT_LEN * TXT_LEN * C, device_ms(lambda: sdpa(q, k, v, H, mask_bf)),
             shape=[N, TXT_LEN, C, H], causal=True, out_dtype=str(got.dtype),
             launch_shape=K.mha_short_launch_shape("mha_short_bf16"))

    # K2 at response_maps' shape, 8 images x 4 pairs, T = 1: all bfloat16 (bfloat16 leaves)
    # and float32 vision with bfloat16 text (float32 leaves)
    hw, m, P = (SIZE // 32) ** 2, 1024, B * S
    div = math.sqrt(m)
    k2_rows = []
    for name, vis_dt in (("cross_attn.bf16", bf), ("cross_attn.bf16@f32_leaves", f32)):
        qv, kv, vv = (torch.relu(randn(B, hw, m, dtype=vis_dt)) for _ in range(3))
        qt, kt, vt = (torch.relu(randn(P, 1, m)) for _ in range(3))
        args = (qv, kv, vv, qt, kt, vt, S, div)
        got, want = K.cross_attn(*args), K.cross_attn_plain(*args)
        want64 = K.cross_attn_plain(*(t.double() for t in args[:6]), S, div)
        vis_e = bf16_distances(failures, name + " new_vis", got[0], want[0], want64[0])
        lib_args = tuple(t.to(bf) for t in args[:6]) + (S, div)
        vb, ob = (2 if vis_dt == bf else 4), (2 if vis_dt == bf else 4)
        k2_rows.append(row(name, got[1], want[1], want64[1],
                           device_ms(lambda: K.cross_attn(*args)),
                           device_ms(lambda: K.cross_attn_plain(*args)),
                           vb * 3 * B * hw * m + 2 * 3 * P * m + ob * (P * hw * m + P * m),
                           2 * 2 * P * hw * m * 2, device_ms(lambda: k2_sdpa(*lib_args)),
                           shape=[B, S, hw, m, 1], vision_dtype=str(vis_dt),
                           out_dtype=str(got[0].dtype),
                           new_vis_max_abs_err_f64=vis_e["max_abs_err"],
                           new_vis_max_abs_err_plain_f64=vis_e["max_abs_err_plain"],
                           launch_shape=K.cross_attn_launch_shape("cross_attn_bf16")))

    # K3 at response_maps' shape, 32 pairs, D = 1024, 10x10 -> 320x320: bfloat16 vis_new
    # (bfloat16 leaves) and float32 vis_new (float32 leaves); maps float32
    D, hs = 1024, SIZE // 32
    vis_base = F.normalize(randn(B, hw, D, dtype=f32), dim=-1).to(bf)
    lan = F.normalize(randn(P, D, dtype=f32), dim=-1).to(bf)
    scale = torch.tensor(1 / 0.07, device=dev)
    k3_rows = []
    for name, new_dt in (("response_head.bf16", bf), ("response_head.bf16@f32_leaves", f32)):
        vis_new = randn(P, hw, D, dtype=new_dt, scale=0.03)
        alpha = weak(0.1, new_dt)
        args = (vis_new, vis_base, lan, S, scale, alpha, (hs, hs), (SIZE, SIZE))
        got, want = K.response_head(*args), K.response_head_plain(*args)
        want64 = K.response_head_plain(vis_new.double(), vis_base.double(), lan.double(), S,
                                       scale.double(), alpha, (hs, hs), (SIZE, SIZE))
        nb = 2 if new_dt == bf else 4
        k3_rows.append(row(name, got, want, want64,
                           device_ms(lambda: K.response_head(*args)),
                           device_ms(lambda: K.response_head_plain(*args)),
                           nb * P * hw * D + 2 * (B * hw * D + P * D) + 4 * P * SIZE * SIZE,
                           P * hw * D * 4 + P * SIZE * SIZE * 7, None,
                           shape=[B, S, hw, D, SIZE], vis_new_dtype=str(new_dt),
                           launch_shape=K.response_head_launch_shape()))
    rows = [
        kernel_row("mha_short.bf16", "tris_tpu_torch/kernels/csrc/mha_short.cu",
                   "tris_tpu/models/layers.py:25", k1),
        kernel_row("cross_attn.bf16", "tris_tpu_torch/kernels/csrc/cross_attn.cu",
                   "tris_tpu/models/fusion.py:78", k2_rows[0], k2_rows[1:]),
        kernel_row("response_head.bf16", "tris_tpu_torch/kernels/csrc/response_head.cu",
                   "tris_tpu/models/stage1.py:158", k3_rows[0], k3_rows[1:]),
        kernel_row("batch_norm.bf16", "tris_tpu_torch/kernels/csrc/batch_norm.cu",
                   "tris_tpu/models/layers.py:213", fold_rows[0], fold_rows[1:])]
    torch.cuda.empty_cache()
    return rows, failures


# ---- phase 3: the bfloat16 training kernels (--bf16 stage-1 training) ------------------------

# K13's bfloat16 train rows: the stem's third norm, layer1's and layer4's tails (the residual
# then ReLU) and layer3's first block's last norm, at the train step's B = 48
BN_BF16_TRAIN_ROWS = (("stem", (TRAIN_B, 64, 160, 160), "relu", False),
                      ("layer1_tail", (TRAIN_B, 256, 80, 80), "relu", True),
                      ("layer3", (TRAIN_B, 1024, 20, 20), "relu", False),
                      ("layer4_tail", (TRAIN_B, 2048, 10, 10), "relu", True))
TRAIN_HW = (SIZE // 32) ** 2  # the train step's score plane: 10 x 10 pixels


def check_bf16_train_kernels(K, dev):
    """The bfloat16 kernels of ``--bf16`` stage-1 training at the train step's
    shapes (B = 48, 3 negatives, 320 px), forward and backward, against
    their plain versions on the same bfloat16 inputs and cotangents: each
    output's (each gradient's) max distance from a float64 evaluation of
    those inputs, the kernel's no more than one bfloat16 ulp of the output's
    scale past the plain version's (and no more than 4 from the plain version
    itself where that lies past a tenth of the scale from float64); device ms of the kernel (the backward
    alone, on a retained graph) and of the plain version; the bound at the
    inputs' and outputs' widths over the memory rate (or the operations over
    the bfloat16 rate); the library call in bfloat16 where one computes the
    function (``F.batch_norm`` for K13, SDPA's backward for K1, two SDPA for
    K2; none for K3's head). Returns (new rows, {existing row: its train
    shapes}, failures): rows ``batch_norm_bwd.bf16``, ``mha_short_bwd.bf16``,
    ``cross_attn_bwd.bf16``, ``stage1_head.bf16`` and ``stage1_head_bwd.bf16``
    (each mix or shape beside its first as a shape); K13's and K2's train
    forwards join the rows ``batch_norm.bf16`` and ``cross_attn.bf16``."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.models.layers import causal_mask

    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(21)
    failures = []

    def randn(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    def worst(name, gots, plains, wants, labels):
        """Each output's distances and their bars (failures noted); the
        output nearest a bar gives the row's."""
        dists = [dict(bf16_distances(failures, f"{name} {label}", got, plain, want),
                      output=label)
                 for got, plain, want, label in zip(gots, plains, wants, labels)]
        return max(dists, key=lambda d: max(
            d["max_abs_err"] / d["tol"] if d["tol"] > 0 else 0.0,
            d["max_abs_err_vs_plain"] / d["tol_vs_plain"] if d["tol_vs_plain"] else 0.0))

    row = bf16_row

    # K13 in training on bfloat16 x: forward (y, the statistics) and backward (dx, dweight,
    # dbias, the residual's gradient) against the plain version and float64
    bn_fwd, bn_bwd = [], []
    for label, shape, act, with_res in BN_BF16_TRAIN_ROWS:
        C, n = shape[1], math.prod(shape)
        x = randn(*shape, scale=1.5)
        res = randn(*shape) if with_res else None
        w, b = 1 + 0.3 * randn(C, dtype=f32), 0.5 * randn(C, dtype=f32)
        rm, rv = randn(C, dtype=f32), 0.5 + torch.rand(C, generator=g, device=dev)
        kw = dict(training=True, update_stats=False, momentum=0.1, eps=1e-5, act=act)
        ins = [x, w, b] + ([res] if with_res else [])

        def bn(route, *t):
            return route(t[0], t[1], t[2], rm, rv, residual=t[3] if with_res else None, **kw)

        def bn64(*t):
            return bn_reference64(t[0], t[1], t[2], rm.double(), rv.double(), True, False, act,
                                  None, t[3] if with_res else None)

        kern = functools.partial(bn, K.batch_norm_act)
        plain = functools.partial(bn, K.batch_norm_act_plain)
        with torch.no_grad():
            got, want, want64 = kern(*ins), plain(*ins), bn64(*ins)
        err = worst("batch_norm.bf16@train_" + label, [got], [want], [want64], ["y"])
        lib = lambda x=x: F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5)  # noqa: E731
        with torch.no_grad():
            bn_fwd.append(row(f"batch_norm.bf16@train_{label}", err, device_ms(lambda: kern(*ins)),
                              device_ms(lambda: plain(*ins)), 2 * n * (2 + with_res) + 16 * C,
                              10 * n, device_ms(lib), shape=list(shape), act=act,
                              residual=with_res, mode="train",
                              launch_shape=dict(build.ops().batch_norm_launch_shape(
                                  "batch_norm_apply.bf16"))))
        cot = [randn(*shape)]
        lv = leaves(*ins)
        gk = input_grads(kern, lv, cot)
        gp = input_grads(plain, lv, cot)
        g64 = input_grads(bn64, leaves(*(t.double() for t in ins)), [cot[0].double()])
        names = ["dx", "dweight", "dbias"] + (["dresidual"] if with_res else [])
        if not (gk[0].dtype == bf and gk[1].dtype == f32 and (not with_res or gk[3].dtype == bf)):
            failures.append(f"batch_norm_bwd.bf16@{label}: gradient dtypes "
                            f"{[str(t.dtype) for t in gk]}")
        err = worst("batch_norm_bwd.bf16@" + label, gk, gp, g64, names)
        lib_in = leaves(x, w, b)
        lib_fn = lambda x, w, b: F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5)  # noqa: E731
        bn_bwd.append(row(f"batch_norm_bwd.bf16@{label}", err, bwd_ms(kern, lv, cot),
                          bwd_ms(plain, lv, cot), 2 * n * (3 + 1 + with_res) + 24 * C, 12 * n,
                          bwd_ms(lib_fn, lib_in, cot), shape=list(shape), act=act,
                          residual=with_res,
                          launch_shape=dict(build.ops().batch_norm_launch_shape(
                              "batch_norm_bwd_apply.bf16"))))
        del x, res, lv, gk, gp, g64, lib_in
        torch.cuda.empty_cache()

    # K1's backward in the text tower on the seeded init's bfloat16 leaves: q, k, v column
    # views of one [48, 20, 1536] qkv, 8 heads, the float32 causal mask, a float32 cotangent
    N, C, H = TRAIN_B, 512, 8
    qkv = randn(N, TXT_LEN, 3 * C)
    mask = causal_mask(TXT_LEN, device=dev)
    cot = [randn(N, TXT_LEN, C, dtype=f32)]
    kern = lambda t: K.mha_short(*t.chunk(3, dim=-1), H, mask)  # noqa: E731
    plain = lambda t: K.mha_short_plain(*t.chunk(3, dim=-1), H, mask)  # noqa: E731
    lv = leaves(qkv)
    gk, gp = input_grads(kern, lv, cot), input_grads(plain, lv, cot)
    g64 = input_grads(lambda t: K.mha_short_plain(*t.chunk(3, dim=-1), H, mask.double()),
                      leaves(qkv.double()), [cot[0].double()])
    err = worst("mha_short_bwd.bf16", [t for gr in (gk[0].chunk(3, -1),) for t in gr],
                list(gp[0].chunk(3, -1)), list(g64[0].chunk(3, -1)), ["dq", "dk", "dv"])
    mask_bf = mask.to(bf)
    lib = lambda t: sdpa(*t.chunk(3, dim=-1), H, mask_bf)  # noqa: E731
    lib_cot = [randn(N, H, TXT_LEN, C // H)]
    nl = N * TXT_LEN * C
    k1 = row("mha_short_bwd.bf16", err, bwd_ms(kern, lv, cot), bwd_ms(plain, lv, cot),
             2 * 3 * nl + 4 * nl + 4 * TXT_LEN ** 2 + 2 * 3 * nl,
             5 * 2 * N * TXT_LEN * TXT_LEN * C, bwd_ms(lib, leaves(qkv), lib_cot),
             shape=[N, TXT_LEN, C, H], causal=True, grad_dtype=str(gk[0].dtype),
             launch_shape=K.mha_short_launch_shape("mha_short_bwd_bf16"))

    # K2 at the train step's shape: 48 images x T = 48 texts, HW = 100, m = 1024, S = 1, both
    # mixes (bfloat16 leaves; float32 vision on float32 leaves): the forward keeping the
    # probabilities, and the backward
    m, T = 1024, TRAIN_B
    div = math.sqrt(m)
    k2_fwd, k2_bwd = [], []
    for label, vis_dt in (("bf16", bf), ("f32_vision", f32)):
        vis = [torch.relu(randn(TRAIN_B, TRAIN_HW, m, dtype=vis_dt)) for _ in range(3)]
        txt = [torch.relu(randn(TRAIN_B, T, m)) for _ in range(3)]
        ins = vis + txt
        kern = lambda *t: K.cross_attn(*t, 1, div)  # noqa: E731
        plain = lambda *t: K.cross_attn_plain(*t, 1, div)  # noqa: E731
        lv = leaves(*ins)
        with torch.enable_grad():
            outs_k, outs_p = kern(*lv), plain(*lv)
        with torch.no_grad():
            outs64 = K.cross_attn_plain(*(t.double() for t in ins), 1, div)
        err = worst(f"cross_attn.bf16@train_{label}", outs_k, outs_p, outs64,
                    ["new_vis", "new_lan"])
        vb = 2 if vis_dt == bf else 4
        in_bytes = vb * 3 * TRAIN_B * TRAIN_HW * m + 2 * 3 * TRAIN_B * T * m
        out_bytes = vb * TRAIN_B * (TRAIN_HW + T) * m
        nbytes = in_bytes + out_bytes + 4 * 2 * TRAIN_B * TRAIN_HW * T
        flops = 2 * 2 * 2 * TRAIN_B * TRAIN_HW * T * m
        lib_in = [t.to(bf) for t in ins]
        with torch.enable_grad():
            k2_fwd.append(row(f"cross_attn.bf16@train_{label}", err,
                              device_ms(lambda: kern(*lv)), device_ms(lambda: plain(*lv)),
                              nbytes, flops, device_ms(lambda: k2_sdpa(*lib_in, 1, div)),
                              shape=[TRAIN_B, 1, TRAIN_HW, m, T], vision_dtype=str(vis_dt),
                              mode="train (probabilities kept)",
                              launch_shape=K.cross_attn_launch_shape("cross_attn_bf16")))
        cot = [randn(TRAIN_B, TRAIN_HW, m, dtype=vis_dt), randn(TRAIN_B, T, m, dtype=vis_dt)]
        gk, gp = input_grads(kern, lv, cot), input_grads(plain, lv, cot)
        g64 = input_grads(lambda *t: K.cross_attn_plain(*t, 1, div),
                          leaves(*(t.double() for t in ins)), [c.double() for c in cot])
        if [t.dtype for t in gk] != [t.dtype for t in ins]:
            failures.append(f"cross_attn_bwd.bf16@{label}: gradient dtypes "
                            f"{[str(t.dtype) for t in gk]}")
        err = worst(f"cross_attn_bwd.bf16@{label}", gk, gp, g64,
                    ["dqv", "dkv", "dvv", "dqt", "dkt", "dvt"])
        lib_lv = leaves(*lib_in)
        lib_cot = [c.to(bf) for c in cot]
        # the backward's least bytes: the six inputs read, their gradients written (each in
        # its input's dtype), the two cotangents read; the probabilities can be recomputed
        k2_bwd.append(row(f"cross_attn_bwd.bf16@{label}", err, bwd_ms(kern, lv, cot),
                          bwd_ms(plain, lv, cot), 2 * in_bytes + out_bytes, 2 * flops,
                          bwd_ms(lambda *t: k2_sdpa(*t, 1, div), lib_lv, lib_cot),
                          shape=[TRAIN_B, 1, TRAIN_HW, m, T], vision_dtype=str(vis_dt),
                          **k2_launch_shapes("cross_attn_bwd_bf16_a", "cross_attn_bwd_bf16_b")))
        del vis, txt, ins, lv, gk, gp, g64, lib_in, lib_lv
        torch.cuda.empty_cache()

    # K3's training head at the train step's shape: 48 images x 48 texts, 10 x 10 -> 320 x
    # 320, D = 1024, both mixes; the GMP channels with tied maxima counted on the float64
    # evaluation's bfloat16 dots
    D, hs = 1024, SIZE // 32
    scale = torch.tensor(1 / 0.07, device=dev)
    k3_fwd, k3_bwd = [], []
    for label, vis_dt in (("bf16", bf), ("f32_vision", f32)):
        vis = F.normalize(randn(TRAIN_B, TRAIN_HW, D, dtype=f32), dim=-1).to(vis_dt)
        lan = F.normalize(randn(TRAIN_B, T, D, dtype=f32), dim=-1).to(bf)
        args = (scale, (hs, hs), (SIZE, SIZE), 3.0, 0.01)
        kern = lambda v, l: K.stage1_head(v, l, *args)  # noqa: E731
        plain = lambda v, l: K.stage1_head_plain(v, l, *args)  # noqa: E731
        lv = leaves(vis, lan)
        with torch.no_grad():
            outs_k, outs_p = kern(vis, lan), plain(vis, lan)
            outs64 = K.stage1_head_plain(vis.double(), lan.double(), scale.double(), *args[1:])
            dot = torch.einsum("bpc,bqc->bpq", vis.double(), lan.double())
            score = scale * (dot.to(bf) if vis_dt == bf else dot.float()).float()
            ties = int(((score == score.amax(dim=1, keepdim=True)).sum(dim=1) > 1).sum())
        err = worst(f"stage1_head.bf16@{label}", [outs_k[0], outs_k[2], outs_k[3]],
                    [outs_p[0], outs_p[2], outs_p[3]], [outs64[0], outs64[2], outs64[3]],
                    ["cls_out", "relu_map", "sig_map"])
        vb = 2 if vis_dt == bf else 4
        maps = 2 * 4 * TRAIN_B * SIZE * SIZE
        nbytes = vb * TRAIN_B * TRAIN_HW * D + 2 * TRAIN_B * T * D + maps + 4 * TRAIN_B * T
        flops = 2 * TRAIN_B * TRAIN_HW * T * D
        with torch.no_grad():
            k3_fwd.append(row(f"stage1_head.bf16@{label}", err,
                              device_ms(lambda: kern(vis, lan)), device_ms(lambda: plain(vis, lan)),
                              nbytes, flops, None, shape=[TRAIN_B, T, TRAIN_HW, D, SIZE],
                              vision_dtype=str(vis_dt), gmp_channels_tied=ties,
                              gmp_channels=TRAIN_B * T))
        cot = [randn(TRAIN_B, T, dtype=f32), None,
               randn(TRAIN_B, SIZE, SIZE, dtype=f32, scale=0.01),
               randn(TRAIN_B, SIZE, SIZE, dtype=f32, scale=0.01)]
        gk, gp = input_grads(kern, lv, cot), input_grads(plain, lv, cot)
        g64 = input_grads(lambda v, l: K.stage1_head_plain(v, l, scale.double(), *args[1:]),
                          leaves(vis.double(), lan.double()), [c if c is None else c.double()
                                                               for c in cot])
        if [t.dtype for t in gk] != [vis_dt, bf]:
            failures.append(f"stage1_head_bwd.bf16@{label}: gradient dtypes "
                            f"{[str(t.dtype) for t in gk]}")
        err = worst(f"stage1_head_bwd.bf16@{label}", gk, gp, g64, ["d vis_p", "d lan_p"])
        # the backward's least bytes: vis_p and lan_p read and their gradients written, the
        # cotangents of cls_out and of the two maps read
        in_bytes = vb * TRAIN_B * TRAIN_HW * D + 2 * TRAIN_B * T * D
        k3_bwd.append(row(f"stage1_head_bwd.bf16@{label}", err, bwd_ms(kern, lv, cot),
                          bwd_ms(plain, lv, cot), 2 * in_bytes + maps + 4 * TRAIN_B * T,
                          2 * flops, None,
                          shape=[TRAIN_B, T, TRAIN_HW, D, SIZE], vision_dtype=str(vis_dt)))
        del vis, lan, lv, gk, gp, g64
        torch.cuda.empty_cache()

    rows = [
        kernel_row("batch_norm_bwd.bf16", "tris_tpu_torch/kernels/csrc/batch_norm_bwd.cu",
                   "tris_tpu/models/layers.py:219", bn_bwd[0], bn_bwd[1:]),
        kernel_row("mha_short_bwd.bf16", "tris_tpu_torch/kernels/csrc/mha_short_bwd.cu",
                   "tris_tpu/models/layers.py:25", k1),
        kernel_row("cross_attn_bwd.bf16", "tris_tpu_torch/kernels/csrc/cross_attn_bwd.cu",
                   "tris_tpu/models/fusion.py:78", k2_bwd[0], k2_bwd[1:]),
        kernel_row("stage1_head.bf16", "tris_tpu_torch/kernels/csrc/stage1_head_bf16.cu",
                   "tris_tpu/models/stage1.py:100", k3_fwd[0], k3_fwd[1:]),
        kernel_row("stage1_head_bwd.bf16", "tris_tpu_torch/kernels/csrc/stage1_head_bf16.cu",
                   "tris_tpu/models/stage1.py:100", k3_bwd[0], k3_bwd[1:])]
    extra = {"batch_norm.bf16": bn_fwd, "cross_attn.bf16": k2_fwd}
    return rows, extra, failures


# ---- phase 3: the bfloat16 kernels of stage 2's eval (--bf16 stage 2, the demo) -------------

# stage 2's eval batch: B images x S pairs (phase 4's batches), T tokens; the pyramid's levels
# (pixels, channels) at c2, c3 and c4 of RN50 at 320 px; the decoder's x2 upsamples (channels,
# input side) and the head's upsample to the input size; the ConvBNRelus with PReLU (name,
# shape) whose eval fold phase 15 runs (the trunk's folds are phase 13's rows)
S2_LEVELS = (("c2", 1600, 512), ("c3", 400, 1024), ("c4", 100, 2048))
S2_UPSAMPLES = (("output4", 256, 10), ("output3", 128, 20), ("output2", 64, 40))
S2_PRELU_ROWS = (("reduced_c1", (B, 64, 80, 80)), ("output1", (B * S, 32, 80, 80)),
                 ("reduced_c4", (B * S, 512, 10, 10)), ("output4", (B * S, 256, 10, 10)),
                 ("final_seg1", (B * S, 32, 80, 80)))


def check_bf16_stage2_kernels(K, dev):
    """The three bfloat16 kernels of ``--bf16`` stage-2 eval and the demo at
    phase 15's shapes, on both leaf regimes' operands, against their plain
    versions on the same inputs with phase 3's bfloat16 bars (within one
    bfloat16 ulp of the output's scale of the plain version's distance from a
    float64 evaluation; within 4 of the plain version where that distance
    passes a tenth of the scale; K6 and K13 also bit for bit): K11's forward
    (``pixel_attn.bf16``: q, Lk, Lv bfloat16, or q float32 on a float32
    checkpoint) at c2, c3 and c4 of an eval batch of 8 images x 4 pairs, T =
    20, and the demo's one image at T = 40; K6's bilinear forward
    (``bilinear_resize.bf16``) at the decoder's three x2 upsamples and the
    head's to 320 px, eval and demo; K13's eval fold with PReLU
    (``batch_norm.bf16@prelu``: a bfloat16 or a float32 slope) at the
    decoder's norms, planes of 100 (2-byte accesses) among them. Device ms of
    kernel, plain version and library call (SDPA in bfloat16;
    ``F.interpolate``; ``F.batch_norm`` then ``F.prelu``), the bound at the
    operands' widths. Returns (rows, failures)."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.kernels import build

    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(22)
    failures = []

    def randn(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    def row(name, got, plain, want64, *times, **extra):
        return bf16_row(name, bf16_distances(failures, name, got, plain, want64), *times,
                        **extra)

    # K11: an eval batch's three levels in both mixes, then the demo's image at T = 40
    k11 = []
    cases = [(f"{lvl}@{mix}", B, S, TXT_LEN, hw, C, q_dt) for mix, q_dt in
             (("bf16_leaves", bf), ("f32_leaves", f32)) for lvl, hw, C in S2_LEVELS]
    cases += [(f"demo_{lvl}", 1, 1, 2 * TXT_LEN, hw, C, bf) for lvl, hw, C in S2_LEVELS[:1]]
    for label, N, Sp, T, hw, C, q_dt in cases:
        q = randn(N, hw, C, dtype=q_dt)
        Lk, Lv = randn(N * Sp, T, C), randn(N * Sp, T, C)
        args = (q, Lk, Lv, Sp)
        with torch.no_grad():
            got, plain = K.pixel_attn(*args), K.pixel_attn_plain(*args)
            want64 = K.pixel_attn_plain(q.double(), Lk.double(), Lv.double(), Sp)
        qb = 2 if q_dt == bf else 4
        P = N * Sp
        qs = q.to(bf)[:, None].expand(N, Sp, hw, C)
        ks, vs = (t.reshape(N, Sp, T, C) for t in (Lk, Lv))
        k11.append(row(f"pixel_attn.bf16@{label}", got, plain, want64,
                       device_ms(lambda: K.pixel_attn(*args)),
                       device_ms(lambda: K.pixel_attn_plain(*args)),
                       qb * N * hw * C + 2 * 2 * P * T * C + qb * P * hw * C,
                       4 * P * hw * T * C,
                       device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
                       peak_ops=PEAK_BF16_S if q_dt == bf else PEAK_F32_S,
                       shape=[N, Sp, hw, T, C], q_dtype=str(q_dt), out_dtype=str(got.dtype),
                       launch_shape=K.pixel_attn_launch_shape("pixel_attn_bf16")))
        del q, Lk, Lv, qs, ks, vs, got, plain, want64

    # K6: the decoder's x2 upsamples of an eval batch's pairs, the head's to 320 px, the demo's
    k6 = []
    cases = [(f"{name}", (B * S, C, h, h), (2 * h, 2 * h)) for name, C, h in S2_UPSAMPLES]
    cases += [("head", (B * S, 1, 80, 80), (SIZE, SIZE)), ("demo_head", (1, 1, 80, 80),
                                                             (SIZE, SIZE))]
    for label, shape, size in cases:
        x = randn(*shape)
        with torch.no_grad():
            got, plain = K.bilinear_resize(x, size), K.bilinear_resize_plain(x, size)
            want64 = K.bilinear_resize_plain(x.double(), size)
        exact = bool(torch.equal(got, plain))
        if not exact:
            failures.append(f"bilinear_resize.bf16@{label}: not bit for bit its plain version")
        n_in, n_out = x.numel(), x.numel() // (shape[2] * shape[3]) * size[0] * size[1]
        k6.append(row(f"bilinear_resize.bf16@{label}", got, plain, want64,
                      device_ms(lambda: K.bilinear_resize(x, size)),
                      device_ms(lambda: K.bilinear_resize_plain(x, size)),
                      2 * (n_in + n_out), 6 * n_out,
                      device_ms(lambda: F.interpolate(x, size=size, mode="bilinear",
                                                      align_corners=False)),
                      shape=list(shape), size=list(size), exact=exact,
                      launch_shape=K.bilinear_resize_launch_shape()))
        del x, got, plain, want64

    # K13: the eval fold with PReLU at the decoder's norms, the slope bfloat16 (the seeded
    # init's) and float32 (a float32 checkpoint's: y float32)
    k13 = []
    for (name, shape), slope_dt in [(r, bf) for r in S2_PRELU_ROWS] + \
            [(S2_PRELU_ROWS[1], f32), (S2_PRELU_ROWS[2], f32)]:
        C = shape[1]
        x = randn(*shape, scale=1.5)
        w, b = 1 + 0.3 * randn(C, dtype=f32), 0.5 * randn(C, dtype=f32)
        rm, rv = randn(C, dtype=f32), 0.5 + torch.rand(C, generator=g, device=dev)
        slope = torch.full((1,), 0.25, device=dev).to(slope_dt)
        kw = dict(training=False, update_stats=False, momentum=0.1, eps=1e-5, act="prelu")
        call = lambda x=x, slope=slope: K.batch_norm_act(x, w, b, rm, rv, slope=slope, **kw)  # noqa: E731
        plain = lambda x=x, slope=slope: K.batch_norm_act_plain(x, w, b, rm, rv, slope=slope, **kw)  # noqa: E731
        got, want = call(), plain()
        want64 = K.batch_norm_act_plain(x.double(), w, b, rm, rv, slope=slope.double(), **kw)
        exact = bool(torch.equal(got, want))
        if not exact or got.dtype != slope_dt:
            failures.append(f"batch_norm.bf16@prelu_{name}: {got.dtype}, not bit for bit its "
                            f"plain version ({exact})")
        lib = lambda x=x, slope=slope: F.prelu(F.batch_norm(x, rm, rv, w, b, False, 0.1, 1e-5),  # noqa: E731
                                               slope.to(bf))
        n = x.numel()
        k13.append(row(f"batch_norm.bf16@prelu_{name}_{str(slope_dt)[6:]}", got, want, want64,
                       device_ms(call), device_ms(plain),
                       2 * n + (2 if slope_dt == bf else 4) * n + 2 * 2 * C, 4 * n,
                       device_ms(lib), shape=list(shape), slope_dtype=str(slope_dt),
                       out_dtype=str(got.dtype), exact=exact,
                       launch_shape=dict(build.ops().batch_norm_launch_shape(
                           "batch_norm_fold_bf16"))))
        del x, got, want, want64
    torch.cuda.empty_cache()
    rows = [kernel_row("pixel_attn.bf16", "tris_tpu_torch/kernels/csrc/pixel_attn.cu",
                       "tris_tpu/models/fusion.py:37", k11[0], k11[1:]),
            kernel_row("bilinear_resize.bf16", "tris_tpu_torch/kernels/csrc/bilinear_resize.cu",
                       "tris_tpu/ops/resize.py:57", k6[0], k6[1:]),
            kernel_row("batch_norm.bf16@prelu", "tris_tpu_torch/kernels/csrc/batch_norm.cu",
                       "tris_tpu/models/layers.py:209", k13[0], k13[1:])]
    return rows, failures


# ---- phase 4: the main path ------------------------------------------------


def make_eval_batches(n_batches: int, seed: int):
    """Eval batches with the ``Loader``'s layout (uint8 320 px images, padded
    [B, S, 20] ids, ragged original-size targets and x1y1x2y2 boxes), made
    from a seed: no files."""
    rng = np.random.default_rng(seed)
    orig = [(480, 640), (640, 480), (427, 640), (640, 640), (375, 500), (333, 500),
            (512, 512), (640, 426)]
    batches = []
    for k in range(n_batches):
        n_sents = rng.integers(1, S + 1, B)
        n_sents[0] = S
        ids = np.zeros((B, S, TXT_LEN), np.int32)
        for b in range(B):
            for j in range(n_sents[b]):
                n_tok = int(rng.integers(2, TXT_LEN - 2))
                ids[b, j, 0] = 49406
                ids[b, j, 1:1 + n_tok] = rng.integers(1, 49000, n_tok)
                ids[b, j, 1 + n_tok] = 49407
        targets, boxes = [], []
        for b in range(B):
            oh, ow = orig[(b + k) % len(orig)]
            y0, x0 = int(rng.integers(0, oh // 2)), int(rng.integers(0, ow // 2))
            y1, x1 = int(rng.integers(y0 + 8, oh)), int(rng.integers(x0 + 8, ow))
            t = np.zeros((oh, ow), np.uint8)
            t[y0:y1, x0:x1] = 1
            targets.append(t)
            boxes.append(np.array([x0, y0, x1 - 1, y1 - 1], np.int64))
        batches.append({
            "image": rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8),
            "word_ids": ids, "num_sents": n_sents, "target": targets, "bbox": boxes,
            "index": np.arange(k * B, (k + 1) * B), "img_id": np.arange(k * B, (k + 1) * B),
        })
    return batches


class SyntheticEvalLoader:
    """An in-memory eval loader: ``epoch()`` yields the batches, and ``ds``
    answers ``max_orig_size()`` as a ``ReferSegDataset`` does."""

    def __init__(self, batches):
        self.batches = batches
        self.ds = self

    def max_orig_size(self):
        return (max(t.shape[0] for b in self.batches for t in b["target"]),
                max(t.shape[1] for b in self.batches for t in b["target"]))

    def epoch(self, epoch: int = 0):
        yield from self.batches


@contextlib.contextmanager
def swapped(K, **fns):
    """K's functions ``fns`` in place of its own for the block."""
    saved = {name: getattr(K, name) for name in fns}
    for name, fn in fns.items():
        setattr(K, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


@contextlib.contextmanager
def plain_kernels(K, baseline: bool = False):
    """Route the models' kernel calls to the plain versions. K13 goes to its
    route reference (``batch_norm_act_reference``: the plain version on the
    kernels' statistics, whose rounding the routes' comparisons need), or
    with ``baseline`` to its plain version (the JAX package's arithmetic),
    which the plain route's step times and peak memory measure."""
    plain = {"mha_short": K.mha_short_plain, "cross_attn": K.cross_attn_plain,
             "response_head": K.response_head_plain, "stage1_head": K.stage1_head_plain,
             "eval_metrics": K.eval_metrics_plain, "critic_input": K.critic_input_plain,
             "normalize_u8_nchw": K.normalize_u8_nchw_plain,
             "bilinear_resize": K.bilinear_resize_plain,
             "path_max_affinity": K.path_max_affinity_plain,
             "refine_centroids": K.refine_centroids_plain,
             "walk_transition": K.walk_transition_plain, "walk_matmul": K.walk_matmul_plain,
             "irn_affinity_loss": K.irn_affinity_loss_plain, "pixel_attn": K.pixel_attn_plain,
             "ema_update": K.ema_update_plain,
             "batch_norm_act": K.batch_norm_act_plain if baseline else K.batch_norm_act_reference}
    with swapped(K, **plain):
        yield


@contextlib.contextmanager
def mha_shapes(K):
    """Tally K1's calls by (N, L, C): which shapes a run launched."""
    tally, kernel = collections.Counter(), K.mha_short

    def counted(q, k, v, n_head, attn_mask=None):
        tally["x".join(map(str, q.shape))] += 1
        return kernel(q, k, v, n_head, attn_mask)

    K.mha_short = counted
    try:
        yield tally
    finally:
        K.mha_short = kernel


def build_stage1(dev):
    import torch

    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TRISStage1(Stage1Config(backbone="RN50", hidden_dim=1024, txt_length=TXT_LEN))
    return model.to(dev).eval()


def stage1_path(K, dev, model, batches):
    import torch

    from tris_tpu_torch.eval.validate import image_to_nchw, validate

    loader = SyntheticEvalLoader(batches)
    image = image_to_nchw(torch.as_tensor(batches[0]["image"], device=dev))
    ids = torch.as_tensor(batches[0]["word_ids"], device=dev)
    quiet = lambda *a: None  # noqa: E731

    def run():
        return (model.response_maps(image, ids), model(image, ids[:, 0]),
                validate(model, loader, with_boxes=False, log=quiet))

    steps = {"response_maps": lambda: model.response_maps(image, ids),
             "forward": lambda: model(image, ids[:, 0]),
             "validate_per_batch": lambda: validate(model, loader, with_boxes=False, log=quiet)}
    per = {"response_maps": 1, "forward": 1, "validate_per_batch": len(batches)}
    times = {route: {k: [] for k in steps} for route in ("kernels", "plain")}

    with torch.no_grad():
        run()                                   # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()
        K.reset_launches()
        maps, fwd, res = run()                  # the counted run
        torch.cuda.synchronize()
        launches = dict(K.launches)
        with plain_kernels(K):
            maps_p, fwd_p, res_p = run()
        # the two routes alternate, so a drift of the host or the card's
        # clocks falls on both
        for _ in range(ROUNDS):
            for route, ctx in (("kernels", contextlib.nullcontext),
                               ("plain", lambda: plain_kernels(K, baseline=True))):
                with ctx():
                    for k, fn in steps.items():
                        times[route][k].append(host_ms(fn) / per[k])

    failures = [f"stage-1 eval: {name} launched no time" for name in EVAL_KERNELS
                if launches[name] == 0]
    # K13's eval fold at every norm of the trunk's 2 + len(batches) forwards
    bn_want = {k: (2 + len(batches)) * n for k, n in bn_launches()["stage1_eval"].items()}
    failures += [f"stage-1 eval: {k} launched {launches[k]} times, want {n}"
                 for k, n in bn_want.items() if launches[k] != n]
    for name, t, shape in (("response_maps", maps, (B, S, SIZE, SIZE)), ("forward", fwd, (B, 1, SIZE, SIZE))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()) or bool((t < 0).any()):
            failures.append(f"{name}: want finite non-negative {shape}, got {tuple(t.shape)}")
    scale = float(maps_p.abs().max())
    err_maps = max_err(maps, maps_p)
    err_fwd = max_err(fwd, fwd_p)
    # 1e-5 of the map's scale: K1's and K3's sums run in another order than
    # the plain einsums; everything else is the same PyTorch code
    tol_maps = 1e-5 * max(scale, 1.0)
    if not (err_maps <= tol_maps and err_fwd <= tol_maps):
        failures.append(f"maps vs plain: {err_maps}, forward vs plain {err_fwd} > {tol_maps}")
    metric_err = max(abs(res[k] - res_p[k]) for k in res)
    if not metric_err <= 1e-4:
        failures.append(f"validate vs plain: {res} vs {res_p}")
    if not all(0.0 <= res[k] <= 100.0 for k in ("mIoU", "oIoU", "hit", "hitm")):
        failures.append(f"validate metrics out of range: {res}")
    summary = {
        "model": "RN50 stage 1, hidden 1024, 320 px, random weights (seed 0)",
        "B": B, "S": S, "eval_batches": len(batches), "launches": launches,
        "batch_norm_launches_expected": bn_want,
        "host_ms": {route: {k: spread(t) for k, t in ts.items()} for route, ts in times.items()},
        "maps_max_abs_err": err_maps, "forward_max_abs_err": err_fwd, "maps_tol": tol_maps,
        "map_scale": scale, "metrics": res, "metrics_plain": res_p,
        "metrics_max_abs_diff": metric_err,
    }
    log(f"stage-1 eval: {json.dumps(summary)}")
    return summary, failures


# ---- phase 5: PRMS -----------------------------------------------------------


def prms_path(K, dev, model, batches):
    import torch

    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser
    from tris_tpu_torch.eval.validate import make_prms_forward, validate_prms

    critic = build_critic(get_parser().parse_args(["--max_query_len", str(TXT_LEN)]), dev)
    loader = SyntheticEvalLoader(batches)
    quiet = lambda *a: None  # noqa: E731
    tmp = tempfile.TemporaryDirectory()
    failures = []

    def run(tag):
        """validate_prms with the CAM dump into tmp/<tag>, then without."""
        cam_dir, name_dir = (os.path.join(tmp.name, tag, d) for d in ("cam", "names"))
        dumped = validate_prms(model, critic, loader, save_cam=True, cam_save_dir=cam_dir,
                               name_save_dir=name_dir, log=quiet)
        return dumped, validate_prms(model, critic, loader, log=quiet)

    forward = make_prms_forward(model, critic)

    def forward_all():
        outs = []
        for b in batches:
            valid = np.arange(S)[None] < b["num_sents"][:, None]
            outs.append([t.cpu() for t in forward(b["image"], b["word_ids"], valid)])
        return outs

    times = {"kernels": [], "plain": []}
    with torch.no_grad(), tmp:
        run("warm")                             # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()
        with mha_shapes(K) as k1_shapes:
            K.reset_launches()
            res_dump, res = run("kernels")      # the counted run
            torch.cuda.synchronize()
            launches = dict(K.launches)
        outs = forward_all()
        with plain_kernels(K):
            res_dump_p, res_p = run("plain")
            outs_p = forward_all()
        for _ in range(ROUNDS):
            for route, ctx in (("kernels", contextlib.nullcontext),
                               ("plain", lambda: plain_kernels(K, baseline=True))):
                with ctx():
                    times[route].append(host_ms(lambda: validate_prms(model, critic, loader, log=quiet))
                                        / len(batches))

        failures += [f"PRMS: {name} launched no time" for name in EVAL_KERNELS + ("critic_input",)
                     if launches[name] == 0]
        # K13's eval fold at every norm of one trunk forward a batch, in both validate_prms
        bn_want = {k: 2 * len(batches) * n for k, n in bn_launches()["stage1_eval"].items()}
        failures += [f"PRMS: {k} launched {launches[k]} times, want {n}"
                     for k, n in bn_want.items() if launches[k] != n]
        # scores: within 1e-4 of their scale (K1's, K2's and K3's sums run
        # in another order than the plain einsums; sums of cosines, so the
        # scale may be well below 1); best: equal wherever the top two
        # scores are further apart than that
        valid_all = np.concatenate([np.arange(S)[None] < b["num_sents"][:, None] for b in batches])
        scores = torch.cat([o[2] for o in outs]).numpy()
        scores_p = torch.cat([o[2] for o in outs_p]).numpy()
        best = torch.cat([o[0] for o in outs]).numpy()
        best_p = torch.cat([o[0] for o in outs_p]).numpy()
        score_scale = float(np.abs(scores_p[valid_all]).max())
        tol_s = 1e-4 * score_scale
        err_s = float(np.abs(scores[valid_all] - scores_p[valid_all]).max())
        if not (err_s <= tol_s and np.isfinite(scores[valid_all]).all()
                and np.isneginf(scores[~valid_all]).all()):
            failures.append(f"PRMS scores vs plain: max_abs_err {err_s} > {tol_s}, or "
                            f"not finite where valid and -inf elsewhere")
        top2 = np.sort(np.where(valid_all, scores_p, -np.inf), axis=1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) <= tol_s
        flips = np.flatnonzero(best != best_p)
        if np.any(~near_tie[flips]):
            failures.append(f"PRMS best vs plain differs away from a near tie at refs {flips}")
        maps = torch.cat([o[1] for o in outs])
        maps_p = torch.cat([o[1] for o in outs_p])
        if tuple(maps.shape) != (len(batches) * B, S, SIZE, SIZE) or not bool(torch.isfinite(maps).all()):
            failures.append(f"PRMS maps: want finite {(len(batches) * B, S, SIZE, SIZE)}, "
                            f"got {tuple(maps.shape)}")
        # metrics within 1e-4, and the dumped maps within 1e-5: the bar of
        # the stage-1 maps against their scale, here 1 since each dumped map
        # is divided by its own peak (which makes a low-peak map's rounding
        # differences larger than the raw maps'); compared where best agrees
        names = [f"{int(b['index'][i])}_{int(b['img_id'][i])}" for b in batches for i in range(B)]
        flipped = {names[i] for i in flips}
        metric_err = max(abs(d[k] - e[k]) for d, e in ((res, res_p), (res_dump, res_dump_p))
                         for k in d)
        if not flips.size and not metric_err <= 1e-4:
            failures.append(f"validate_prms vs plain: {res} vs {res_p}")
        if not all(0.0 <= res[k] <= 100.0 for k in ("mIoU", "oIoU", "hit", "hitm")):
            failures.append(f"validate_prms metrics out of range: {res}")
        cam_dirs = [os.path.join(tmp.name, tag, "cam") for tag in ("kernels", "plain")]
        files = [sorted(os.listdir(d)) for d in cam_dirs]
        with open(os.path.join(tmp.name, "kernels", "names", "refcoco_train_names.json")) as f:
            listed = json.load(f)
        if files[0] != files[1] or sorted(f"{n}.npy" for n in listed) != files[0] \
                or len(listed) != len(names):
            failures.append("PRMS CAM files: the routes or the names json disagree")
        cam_err, shapes_ok = 0.0, True
        orig = {n: t.shape for b in batches for n, t in
                zip((f"{int(b['index'][i])}_{int(b['img_id'][i])}" for i in range(B)), b["target"])}
        for f in files[0]:
            a, b = (np.load(os.path.join(d, f)) for d in cam_dirs)
            shapes_ok &= a.shape == b.shape == orig[f[:-4]]
            if f[:-4] not in flipped:
                cam_err = max(cam_err, float(np.abs(a.astype(np.float64) - b).max()))
        if not (shapes_ok and cam_err <= 1e-5):
            failures.append(f"PRMS CAMs vs plain: max_abs_err {cam_err} > 1e-5 or shapes differ "
                            f"from the original sizes")

    summary = {
        "model": f"RN50 stage 1 (hidden 1024, 320 px) + {CRITIC} critic (224 px), random "
                 f"weights (seeds 0 and 7)",
        "B": B, "S": S, "eval_batches": len(batches), "launches": launches,
        "batch_norm_launches_expected": bn_want,
        "mha_short_launches_by_shape": dict(k1_shapes),
        "validate_prms_host_ms_per_batch": {route: spread(t) for route, t in times.items()},
        "scores_max_abs_err": err_s, "scores_tol": tol_s, "score_scale": score_scale,
        "best_flips": flips.tolist(), "near_ties": int(near_tie.sum()),
        "maps_max_abs_err": max_err(maps, maps_p),
        "metrics": res, "metrics_plain": res_p, "metrics_dump": res_dump,
        "metrics_max_abs_diff": metric_err, "cams_dumped": len(files[0]),
        "cams_max_abs_err": cam_err,
    }
    log(f"PRMS: {json.dumps(summary)}")
    return summary, failures


# ---- phase 6: stage-1 training ---------------------------------------------------


def make_train_batches(n_batches: int, seed: int):
    """Train batches with the ``Loader``'s layout: u8 320 px images, [B, 20]
    ids and [B, 3, 20] negatives of 6 to 18 tokens (the EOS position picks
    the text feature), made from a seed."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (TRAIN_B, SIZE, SIZE, 3), dtype=np.uint8),
             "word_ids": token_ids(rng, (TRAIN_B,)),
             "neg_word_ids": token_ids(rng, (TRAIN_B, TRAIN_NEG))}
            for _ in range(n_batches)]


def token_ids(rng, shape):
    """[*shape, 20] CLIP ids of 6 to 18 tokens (the EOS position picks the
    text feature)."""
    out = np.zeros(shape + (TXT_LEN,), np.int32)
    for idx in np.ndindex(*shape):
        n_tok = int(rng.integers(6, 19))
        out[idx][0], out[idx][n_tok - 1] = 49406, 49407
        out[idx][1:n_tok - 1] = rng.integers(1, 49000, n_tok - 2)
    return out


def train_path(K, dev, batches):
    import copy

    import torch

    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser
    from tris_tpu_torch.train.stage1 import batch_to_device, train_step
    from tris_tpu_torch.train.state import label_params, make_optimizer

    critic = build_critic(get_parser().parse_args(["--max_query_len", str(TXT_LEN)]), dev)
    init_model = build_stage1(dev).train()
    init_opt, init_sched = make_optimizer(init_model, total_steps=100)
    data = [batch_to_device(b, dev) for b in batches]
    labels = label_params(init_model)
    failures = []

    def copy_of_init():
        """A deep copy of the initial model, optimizer and schedule (the
        optimizer through its state_dict: a scheduler's step hook holds a
        reference to the optimizer it was made for, which copy.deepcopy
        would share)."""
        model = copy.deepcopy(init_model)
        opt, sched = make_optimizer(model, total_steps=100)
        opt.load_state_dict(init_opt.state_dict())
        sched.load_state_dict(init_sched.state_dict())
        return model, opt, sched

    def steps(state, n, start=0):
        """n train steps from batch ``start`` on; step 1's gradients kept."""
        model, opt, sched = state
        out, grads = [], None
        for i in range(n):
            m = train_step(model, critic, opt, sched, data[(start + i) % len(data)])
            out.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}
        return out, grads

    steps(copy_of_init(), 1)                     # warm-up (cuDNN, allocator), kernel route
    torch.cuda.synchronize()
    state = copy_of_init()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    metrics, grads = steps(state, TRAIN_STEPS)   # the counted run
    torch.cuda.synchronize()
    launches = dict(K.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_kernels(K):
        plain_state = copy_of_init()
        metrics_p, grads_p = steps(plain_state, TRAIN_STEPS)
    torch.cuda.synchronize()

    per_step_want = {**TRAIN_LAUNCHES_PER_STEP, **bn_launches()["stage1_train"]}
    for name, per_step in per_step_want.items():
        if launches[name] != per_step * TRAIN_STEPS:
            failures.append(f"stage-1 train: {name} launched {launches[name]} times, want "
                            f"{per_step} per step x {TRAIN_STEPS}")
    # step 1: the loss and each term within 1e-5 relative; steps 2-3's
    # losses within 1e-3 relative (Adam's first step moves an element whose
    # gradient is rounding noise by +-lr on each route). Each gradient leaf
    # within 1e-4 of its max-abs gradient, or, where the leaf is a residue of
    # cancellation (the biases of the 1x1 convs right before an InstanceNorm
    # are exactly zero in exact arithmetic; the fusion's text values feed a
    # near-uniform softmax whose output the same norm centres), within 4x the
    # plain route's own rounding noise there: the plain route run again on
    # the batch in reversed order, the same gradient in exact arithmetic
    term_err = {k: abs(metrics[0][k] - metrics_p[0][k]) / max(abs(metrics_p[0][k]), 1e-12)
                for k in ("loss", "l1", "l4", "l5")}
    if not max(term_err.values()) <= 1e-5:
        failures.append(f"stage-1 train: step-1 loss terms vs plain {term_err} > 1e-5 relative")
    later = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics[1:], metrics_p[1:])]
    if not max(later) <= 1e-3:
        failures.append(f"stage-1 train: steps 2-3 losses vs plain {later} > 1e-3 relative")
    with plain_kernels(K):
        rev = {k: v.flip(0) for k, v in data[0].items()}
        model_r, opt_r, sched_r = copy_of_init()
        train_step(model_r, critic, opt_r, sched_r, rev)
        grads_r = {k: p.grad.detach().clone() for k, p in model_r.named_parameters()
                   if p.grad is not None}
        del model_r, opt_r, sched_r
    worst, by_floor, noisiest = (0.0, ""), {}, (0.0, "")
    for k, gp in grads_p.items():
        if labels[k] == "frozen":
            continue          # logit_scale: the plain route's d scale, no group holds it
        err, floor = max_err(grads[k], gp), max_err(grads_r[k], gp)
        bar = 1e-4 * float(gp.abs().max())
        noisiest = max(noisiest, (floor / bar * 1e-4 if bar > 0 else 0.0, k))
        if err <= bar:
            worst = max(worst, (err / bar * 1e-4 if bar > 0 else 0.0, k))
        elif err <= 4 * floor:
            by_floor[k] = {"err": err, "plain_noise": floor, "max": float(gp.abs().max())}
        else:
            failures.append(f"stage-1 train: gradient {k} vs plain {err} > 1e-4 of its max "
                            f"({bar}) and > 4x the plain route's noise ({floor})")
            worst = max(worst, (err / bar * 1e-4 if bar > 0 else float("inf"), k))
    if {k for k in grads if labels[k] != "frozen"} != {k for k in grads_p if labels[k] != "frozen"}:
        failures.append("stage-1 train: the routes' gradient leaves differ")
    if not all(np.isfinite(m["loss"]) for m in metrics + metrics_p):
        failures.append("stage-1 train: a loss is not finite")
    if not torch.equal(state[0].logit_scale, init_model.logit_scale):
        failures.append("stage-1 train: logit_scale moved")

    with plain_kernels(K, baseline=True):        # the plain route's peak, at its baseline
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps(plain_state, 1)
        torch.cuda.synchronize()
        peak_plain_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    times = {"kernels": [], "plain": []}
    for i in range(ROUNDS):
        for route, st, ctx in (("kernels", state, contextlib.nullcontext),
                               ("plain", plain_state, lambda: plain_kernels(K, baseline=True))):
            with ctx():
                times[route].append(host_ms(lambda: steps(st, 1, start=i)))
    summary = {
        "model": f"RN50 stage 1 (hidden 1024, 320 px) + {CRITIC} critic (224 px), random "
                 f"weights (seeds 0 and 7), AdamW lr 5e-5 (backbone 0.1x)",
        "B": TRAIN_B, "negatives": TRAIN_NEG, "steps": TRAIN_STEPS, "batches": len(batches),
        "launches": launches, "launches_per_step_expected": per_step_want,
        "metrics": metrics, "metrics_plain": metrics_p, "step1_term_rel_err": term_err,
        "later_loss_rel_err": later, "grad_worst_rel_err": worst[0], "grad_worst_leaf": worst[1],
        "grad_leaves": len(grads), "grad_within_plain_noise": by_floor,
        "plain_noise_worst_rel": noisiest[0], "plain_noise_worst_leaf": noisiest[1],
        "peak_memory_gb": peak_gb, "peak_memory_plain_gb": peak_plain_gb,
        "step_host_ms": {route: spread(t) for route, t in times.items()},
    }
    log(f"stage-1 train: {json.dumps(summary)}")
    return summary, failures


# ---- phase 7: IRNet instance pseudo-masks -------------------------------------------


def make_ins_seg_data(root: str, seed: int):
    """COCO-sized u8 JPEGs (a few flat rectangles on dim noise), smooth CAMs
    at the original sizes peaking on one rectangle, and the names json, as
    ``cli.validate --prms --save_cam`` leaves them. Returns the names."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir, cam_dir = os.path.join(root, "train2014"), os.path.join(root, "cam")
    os.makedirs(img_dir)
    os.makedirs(cam_dir)
    names = []
    for k, (h, w) in enumerate(INS_SEG_SIZES):
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        boxes = []
        for _ in range(3):
            bh, bw = int(rng.integers(h // 6, h // 2)), int(rng.integers(w // 6, w // 2))
            y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            img[y0:y0 + bh, x0:x0 + bw] = rng.integers(80, 256, 3)
            boxes.append((y0 + bh / 2, x0 + bw / 2, bh, bw))
        Image.fromarray(img).save(os.path.join(img_dir, f"COCO_train2014_{k + 1:012d}.jpg"),
                                  quality=90)
        cy, cx, bh, bw = boxes[0]
        yy, xx = np.mgrid[:h, :w]
        cam = np.exp(-0.5 * (((yy - cy) / (0.6 * bh)) ** 2 + ((xx - cx) / (0.6 * bw)) ** 2))
        names.append(f"{k}_{k + 1}")
        np.save(os.path.join(cam_dir, f"{names[-1]}.npy"), cam.astype(np.float32))
    with open(os.path.join(root, "names.json"), "w") as f:
        json.dump(names, f)
    return names


def build_smoke_irnet(dev):
    """The seeded full-width IRNet, its last displacement conv scaled so
    that a random field splits each image into a few instances."""
    import torch

    from tris_tpu_torch.pseudo.irnet import build_irnet as build

    model = build(None, dev, seed=0)
    with torch.no_grad():
        model.fc_dp7[3].weight.mul_(INS_SEG_DP_SCALE)
    return model


def timed(fn):
    """(host ms, result) of ``fn()`` between two synchronises."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def ins_seg_stages(K, cfg, model, name, dev):
    """One image through the pass's stages one after the other, each timed
    on the host clock between synchronises: the intermediates and the times."""
    import torch

    from tris_tpu_torch.pseudo import indexing as idx
    from tris_tpu_torch.pseudo.irnet import edge_displacement_infer
    from tris_tpu_torch.pseudo.labels import (
        cluster_centroids, detect_from_walk, instance_cams, upsample_argmax)
    from tris_tpu_torch.pseudo.pipeline import _ins_seg_load

    t = {}
    _, osize, img, cam = _ins_seg_load(cfg, name)
    with torch.no_grad():
        t["irnet_forward"], (edge, disp) = timed(
            lambda: edge_displacement_infer(model, torch.as_tensor(img, device=dev)))
        t["refine_centroids"], cents = timed(lambda: K.refine_centroids(disp))
        t["host_ccl"], inst = timed(lambda: cluster_centroids(cents.cpu().numpy(),
                                                              disp.cpu().numpy()))
        t["instance_cams"], (x, e) = timed(lambda: idx.bucket_pad(instance_cams(inst, cam, dev),
                                                                  edge))
        t["transition_build"], trans = timed(lambda: idx.transition_matrix(e, 5, cfg.beta))
        t["squarings"], (trans, band) = timed(
            lambda: idx.square(trans, cfg.exp_times, idx.transition_band(5, e.shape[1])))
        n, gh, gw = inst.shape
        t["thin_step"], rw = timed(lambda: idx.thin_step(x, e, trans, band)[:n, :gh, :gw])
        del trans
        t["upsample_argmax"], (rw_up, shape) = timed(
            lambda: upsample_argmax(rw, osize, cfg.ins_seg_bg_thres))
        t["detect"], det = timed(lambda: detect_from_walk(rw_up.cpu().numpy(),
                                                          shape.cpu().numpy(), osize))
    return {"edge": edge, "disp": disp, "cents": cents, "rw": rw, "shape": shape,
            "instances": int(n), "fragments": int(det["mask"].shape[0]),
            "grid": [int(gh), int(gw)], "bucket": list(x.shape), "host_ms": t}


def ins_seg_path(K, dev):
    import torch

    from tris_tpu_torch.pseudo.irnet import IRNet
    from tris_tpu_torch.pseudo.pipeline import PseudoConfig, run_make_ins_seg

    model = build_smoke_irnet(dev)
    tmp = tempfile.TemporaryDirectory()
    quiet = lambda *a: None  # noqa: E731
    failures = []
    with tmp:
        names = make_ins_seg_data(tmp.name, seed=5)

        def cfg(tag):
            return PseudoConfig(train_list=os.path.join(tmp.name, "names.json"),
                                data_root=os.path.join(tmp.name, "train2014"),
                                cam_dir=os.path.join(tmp.name, "cam"),
                                ins_seg_dir=os.path.join(tmp.name, tag))

        def run(tag, subset=None):
            run_make_ins_seg(cfg(tag), model=model, names=subset, log=quiet, device=dev)

        run("warm", names[:1])                   # cuDNN at these shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        run("kernels")                           # the counted run
        torch.cuda.synchronize()
        launches = dict(K.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        with plain_kernels(K):
            run("plain")
        stages = {"kernels": [ins_seg_stages(K, cfg("x"), model, n, dev) for n in names]}
        with plain_kernels(K):
            stages["plain"] = [ins_seg_stages(K, cfg("x"), model, n, dev) for n in names]
        times = {"kernels": [], "plain": []}
        for i in range(INS_SEG_ROUNDS):
            for route, ctx in (("kernels", contextlib.nullcontext),
                               ("plain", lambda: plain_kernels(K, baseline=True))):
                with ctx():
                    times[route].append(host_ms(lambda: run(f"t_{route}_{i}", names[:1])))

        # K6: IRNet's upsamples, the CAM and the walk's x4; K10's products:
        # the squarings and the thin step, and one occupancy pass a squaring
        per_image = {name: IRNet.UP_CALLS + 2 if name == "bilinear_resize" else
                     PseudoConfig.exp_times + 1 if name == "walk_matmul" else
                     PseudoConfig.exp_times if name == "walk_tile_occupancy" else
                     (1 if name in INS_SEG_KERNELS else 0) for name in K.KERNELS}
        for name, n in per_image.items():
            if launches[name] != n * len(names):
                failures.append(f"ins_seg: {name} launched {launches[name]} times, want {n} per "
                                f"image x {len(names)}")
        # the intermediates: IRNet's and K9's outputs exact (the routes differ
        # in K6 alone there, which is exact); the walk within 1e-4 of its max
        # and the argmax at >= 99.9 % (K10 against its plain version)
        exact, rw_err, shape_agree = True, 0.0, 1.0
        for a, b in zip(stages["kernels"], stages["plain"]):
            exact &= all(torch.equal(a[k], b[k]) for k in ("edge", "disp", "cents"))
            if a["rw"].shape == b["rw"].shape:
                rw_err = max(rw_err, max_err(a["rw"], b["rw"]) / max(float(b["rw"].abs().max()),
                                                                     1e-30))
                shape_agree = min(shape_agree, float((a["shape"] == b["shape"]).float().mean()))
            else:
                rw_err = float("inf")
        if not exact:
            failures.append("ins_seg: edge, displacement or centroids differ from the plain route")
        # K9's steps on each image's own field (after the counted run)
        centroid_steps_per_image = []
        for st in stages["kernels"] if torch.device(dev).type == "cuda" else ():
            K.refine_centroids(st["disp"])
            centroid_steps_per_image.append(centroid_steps(K, *st["disp"].shape[1:]))
        if not (rw_err <= 1e-4 and shape_agree >= 0.999):
            failures.append(f"ins_seg: walk vs plain {rw_err} of its max (> 1e-4) or argmax "
                            f"agreement {shape_agree} < 0.999")
        # the npy dicts: same files and keys, masks >= 99.9 %, cam 1e-4 of max
        dict_err, mask_agree, shapes_ok = 0.0, 1.0, True
        dirs = [os.path.join(tmp.name, t) for t in ("kernels", "plain")]
        files = [sorted(os.listdir(d)) for d in dirs]
        if files[0] != files[1] or files[0] != sorted(f"{n}.npy" for n in names):
            failures.append(f"ins_seg: the routes wrote {files}")
        for name, osize in zip(names, INS_SEG_SIZES):
            a, b = (np.load(os.path.join(d, f"{name}.npy"), allow_pickle=True).item() for d in dirs)
            ok = (sorted(a) == sorted(b) == ["cam", "class", "mask", "score"]
                  and a["mask"].shape == b["mask"].shape and a["cam"].shape == b["cam"].shape
                  and a["cam"].shape[1:] == osize and bool(np.isfinite(a["cam"]).all()))
            shapes_ok &= ok
            if ok:
                dict_err = max(dict_err, float(np.abs(a["cam"] - b["cam"]).max())
                               / float(np.abs(b["cam"]).max()))
                mask_agree = min(mask_agree, float((a["mask"] == b["mask"]).mean()))
        if not (shapes_ok and dict_err <= 1e-4 and mask_agree >= 0.999):
            failures.append(f"ins_seg npy vs plain: shapes/keys ok {shapes_ok}, cam {dict_err} "
                            f"of max (> 1e-4) or masks {mask_agree} < 0.999")

    def split(route):
        keys = stages[route][0]["host_ms"]
        return {k: [s["host_ms"][k] for s in stages[route]] for k in keys}

    summary = {
        "model": f"IRNet (ResNet-50 strides 2-2-2-1, edge and displacement heads), seeded "
                 f"random weights (seed 0, fc_dp7.3 x {INS_SEG_DP_SCALE}); radius 5, beta 10, "
                 f"8 squarings, bucket 32",
        "images": [list(s) for s in INS_SEG_SIZES], "launches": launches,
        "launches_per_image_expected": {k: v for k, v in per_image.items() if v},
        "instances_per_image": [s["instances"] for s in stages["kernels"]],
        "fragments_per_image": [s["fragments"] for s in stages["kernels"]],
        "grid": [s["grid"] for s in stages["kernels"]],
        "bucket": [s["bucket"] for s in stages["kernels"]],
        "peak_memory_gb": peak_gb,
        "stage_host_ms_per_image": {route: split(route) for route in stages},
        "pass_host_ms_one_image": {route: spread(t) for route, t in times.items()},
        "centroid_steps": centroid_steps_per_image,
        "intermediates_exact": exact, "rw_rel_err": rw_err, "argmax_agreement": shape_agree,
        "npy_cam_rel_err": dict_err, "npy_mask_agreement": mask_agree,
    }
    log(f"ins_seg: {json.dumps(summary)}")
    return summary, failures


# ---- phase 8: IRN training, pass 1 and the user's chain ------------------------------


def irn_train_path(K, dev):
    """IRNet's pass 1 (the CRF, on the host) on phase 7's three images, then
    IRN training at the recipe's full width on batches built from them:
    ``IRN_STEPS`` steps on the kernel route under reset launch counters,
    the same steps on the plain route from the same weights, held against
    each other; step times of both routes alternating over ``ROUNDS``."""
    import copy

    import torch
    from PIL import Image

    from tris_tpu_torch.pseudo.indexing import PathIndex
    from tris_tpu_torch.pseudo.irnet import IRNet
    from tris_tpu_torch.pseudo.pipeline import PseudoConfig, _ir_label_one, irn_train_batches
    from tris_tpu_torch.pseudo.train_irn import (
        IRNTrainConfig, batch_to_device, label_irn_params, make_irn_optimizer, train_step)

    failures = []
    tmp = tempfile.TemporaryDirectory()
    with tmp:
        names = make_ins_seg_data(tmp.name, seed=5)
        cfg = PseudoConfig(train_list=os.path.join(tmp.name, "names.json"),
                           data_root=os.path.join(tmp.name, "train2014"),
                           cam_dir=os.path.join(tmp.name, "cam"),
                           ir_label_dir=os.path.join(tmp.name, "ir_label"),
                           crop_size=IRN_CROP, radius=IRN_RADIUS)
        os.makedirs(cfg.ir_label_dir)
        crf_ms = [host_ms(lambda: _ir_label_one((cfg, n))) for n in names]   # pass 1, serial
        ir_values = sorted({int(v) for n in names for v in np.unique(np.asarray(
            Image.open(os.path.join(cfg.ir_label_dir, n + ".png"))))})
        if not set(ir_values) <= {0, 1, 255} or len(ir_values) < 2:
            failures.append(f"irn_train: ir labels hold {ir_values}")
        pi = PathIndex(IRN_RADIUS, (IRN_CROP // 4, IRN_CROP // 4))
        t0 = time.perf_counter()
        batches = list(irn_train_batches(cfg, [names[i % len(names)] for i in range(IRN_B)], pi,
                                         IRN_B, IRN_STEPS, num_threads=8))
        batch_build_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    data = [batch_to_device(b, dev) for b in batches]

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = IRNet().to(dev).train()
    tcfg = IRNTrainConfig(crop_size=IRN_CROP, radius=IRN_RADIUS, lr=IRN_LR, batch_size=IRN_B)
    labels = label_irn_params(init)

    def fresh():
        model = copy.deepcopy(init)
        return (model, *make_irn_optimizer(model, tcfg, 100))

    def steps(state, n, start=0):
        """n steps from batch ``start`` on: the loss terms, step 1's gradients."""
        model, opt, sched = state
        out, grads = [], None
        for i in range(n):
            m = train_step(model, opt, sched, pi, data[(start + i) % len(data)])
            out.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}
        return out, grads

    steps(fresh(), 1)                            # warm-up (cuDNN, allocator), kernel route
    torch.cuda.synchronize()
    state = fresh()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    metrics, grads = steps(state, IRN_STEPS)     # the counted run
    torch.cuda.synchronize()
    launches = dict(K.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_kernels(K):
        plain_state = fresh()
        torch.cuda.reset_peak_memory_stats()
        metrics_p, grads_p = steps(plain_state, IRN_STEPS)
        torch.cuda.synchronize()
    peak_plain_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    for name in K.KERNELS:
        want = IRN_LAUNCHES_PER_STEP.get(name, 0) * IRN_STEPS
        if launches[name] != want:
            failures.append(f"irn_train: {name} launched {launches[name]} times, want {want}")
    # step 1: each loss term within 1e-5 relative; every head gradient within
    # 1e-4 of its leaf's max and nonzero on the kernel route; later losses
    # within 1e-3 relative (sign() in the displacement loss and the path
    # max's argmax route gradients discontinuously, so the routes drift
    # apart after step 1 by more than their rounding)
    term_err = {k: abs(metrics[0][k] - metrics_p[0][k]) / max(abs(metrics_p[0][k]), 1e-12)
                for k in metrics[0]}
    if not max(term_err.values()) <= 1e-5:
        failures.append(f"irn_train: step-1 loss terms vs plain {term_err} > 1e-5 relative")
    later = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics[1:], metrics_p[1:])]
    if not max(later, default=0.0) <= 1e-3:
        failures.append(f"irn_train: later losses vs plain {later} > 1e-3 relative")
    heads = sorted(k for k, v in labels.items() if v != "frozen")
    if set(grads) != set(heads) or set(grads_p) != set(heads):
        failures.append(f"irn_train: gradient leaves {sorted(set(heads) ^ set(grads))} differ "
                        f"from the heads")
    worst, zero = (0.0, ""), []
    for k in heads:
        if k not in grads or k not in grads_p:
            continue
        bar = 1e-4 * float(grads_p[k].abs().max())
        err = max_err(grads[k], grads_p[k])
        worst = max(worst, (err / bar * 1e-4 if bar > 0 else float("inf"), k))
        if not err <= bar:
            failures.append(f"irn_train: gradient {k} vs plain {err} > 1e-4 of its max ({bar})")
        if not float(grads[k].abs().max()) > 0:
            zero.append(k)
    if zero:
        failures.append(f"irn_train: zero gradient on the kernel route for {zero}")
    if not all(np.isfinite(m["loss"]) for m in metrics + metrics_p):
        failures.append("irn_train: a loss is not finite")
    param_rel = max(max_err(p.detach(), q.detach()) / max(float(q.abs().max()), 1e-30)
                    for (k, p), q in zip(state[0].named_parameters(),
                                         plain_state[0].parameters()) if labels[k] != "frozen")
    frozen_moved = [k for (k, p), q in zip(state[0].named_parameters(), init.parameters())
                    if labels[k] == "frozen" and not torch.equal(p, q)]
    if frozen_moved:
        failures.append(f"irn_train: frozen trunk parameters moved: {frozen_moved[:3]}")

    times = {"kernels": [], "plain": []}
    for i in range(ROUNDS):
        for route, st, ctx in (("kernels", state, contextlib.nullcontext),
                               ("plain", plain_state, lambda: plain_kernels(K, baseline=True))):
            with ctx():
                times[route].append(host_ms(lambda: steps(st, 1, start=i)))
    del data, state, plain_state
    torch.cuda.empty_cache()
    summary = {
        "model": "IRNet (ResNet-50 strides 2-2-2-1, frozen; edge and displacement heads), "
                 f"seeded torch init (seed 0); SGD lr {IRN_LR} (dp heads x10), momentum 1e-4",
        "B": IRN_B, "crop": IRN_CROP, "radius": IRN_RADIUS, "directions": len(pi.search_dst),
        "steps": IRN_STEPS, "images": [list(s) for s in INS_SEG_SIZES],
        "crf_host_ms_per_image": crf_ms, "ir_label_values": ir_values,
        "batch_build_host_ms": batch_build_ms,
        "launches": launches, "launches_per_step_expected": IRN_LAUNCHES_PER_STEP,
        "metrics": metrics, "metrics_plain": metrics_p, "step1_term_rel_err": term_err,
        "later_loss_rel_err": later, "grad_worst_rel_err": worst[0], "grad_worst_leaf": worst[1],
        "grad_leaves": len(grads), "params_after_steps_max_rel_diff": param_rel,
        "peak_memory_gb": peak_gb, "peak_memory_plain_gb": peak_plain_gb,
        "step_host_ms": {route: spread(t) for route, t in times.items()},
    }
    log(f"irn_train: {json.dumps(summary)}")
    return summary, failures


# ---- phase 9: stage 2 -------------------------------------------------------------------------


def make_train2_batches(n_batches: int, seed: int):
    """Stage-2 train batches with the ``Loader``'s layout: u8 320 px images,
    [B, 20] ids of 6 to 18 tokens and random 0/1 pseudo-masks [B, 320, 320,
    1] (blocks of 8 pixels), made from a seed."""
    rng = np.random.default_rng(seed)

    def pseudo():
        blocks = rng.random((TRAIN2_B, SIZE // 8, SIZE // 8, 1)) > 0.6
        return blocks.repeat(8, 1).repeat(8, 2).astype(np.float32)

    return [{"image": rng.integers(0, 256, (TRAIN2_B, SIZE, SIZE, 3), dtype=np.uint8),
             "word_ids": token_ids(rng, (TRAIN2_B,)), "pseudo": pseudo()}
            for _ in range(n_batches)]


def stage2_path(K, dev, init, eval_batches):
    """Stage 2 at full width from ``init``: ``TRAIN2_STEPS`` train steps on
    the kernel route under reset launch counters with the teacher updated
    every step, the same steps on the plain route from the same weights,
    held against each other (step-1 loss terms, every gradient, the teacher
    after the last step); step times of both routes at the default gate
    over ``ROUNDS``; then ``validate`` of the trained model on phase 4's
    batches on both routes."""
    import copy

    import torch

    from tris_tpu_torch.eval.validate import image_to_nchw, validate
    from tris_tpu_torch.train.stage2 import (
        Stage2TrainConfig, batch_to_device, ema_decay, train_step)
    from tris_tpu_torch.train.state import create_train_state, ema_leaves, label_params

    data = [batch_to_device(b, dev) for b in make_train2_batches(N_TRAIN2_BATCHES, seed=6)]
    counted = Stage2TrainConfig(use_ema=True, ema_update_after=0, ema_update_every=1)
    default = Stage2TrainConfig(use_ema=True)
    labels = label_params(init, "stage2")
    failures = []

    def fresh():
        return create_train_state(copy.deepcopy(init), total_steps=100, stage="stage2",
                                  with_ema=True)

    def steps(state, n, cfg, start=0, keep=False):
        """n steps from batch ``start`` on: the loss terms, step 1's
        gradients, and with ``keep`` the student's leaves after each step."""
        out, grads, students = [], None, []
        for i in range(n):
            m = train_step(state, data[(start + i) % len(data)], cfg)
            out.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()
                         if p.grad is not None}
            if keep:
                students.append([t.detach().clone() for t in ema_leaves(state.model)])
        return out, grads, students

    steps(fresh(), 1, counted)                   # warm-up (cuDNN, allocator), kernel route
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    state = fresh()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    metrics, grads, students = steps(state, TRAIN2_STEPS, counted, keep=True)   # counted
    torch.cuda.synchronize()
    launches = dict(K.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_kernels(K):
        plain_state = fresh()
        metrics_p, grads_p, students_p = steps(plain_state, TRAIN2_STEPS, counted, keep=True)
        rev = {k: v.flip(0) for k, v in data[0].items()}
        st_r = fresh()
        train_step(st_r, rev, counted)
        grads_r = {k: p.grad.detach().clone() for k, p in st_r.model.named_parameters()
                   if p.grad is not None}
        del st_r

    bn = bn_launches()
    per_step_want = {**TRAIN2_LAUNCHES_PER_STEP, **bn["stage2_train"]}
    for name in K.KERNELS:
        want = per_step_want.get(name, 0) * TRAIN2_STEPS
        if launches[name] != want:
            failures.append(f"stage-2 train: {name} launched {launches[name]} times, want {want}")
    # step 1: l1-l4 and the loss within 1e-5 relative; l5 (the teacher is
    # the initial student at step 1, so l5 is 0 or rounding noise) within
    # 1e-5 of the loss; the later losses within 1e-3 relative (Adam's first
    # step moves an element whose gradient is rounding noise by +-lr on each
    # route); the last step's l5 live (> 0) on both routes
    term_err = {k: abs(metrics[0][k] - metrics_p[0][k]) / max(abs(metrics_p[0][k]), 1e-12)
                for k in ("loss", "l1", "l2", "l3", "l4")}
    term_err["l5_of_loss"] = abs(metrics[0]["l5"] - metrics_p[0]["l5"]) / abs(metrics_p[0]["loss"])
    if not max(term_err.values()) <= 1e-5:
        failures.append(f"stage-2 train: step-1 loss terms vs plain {term_err} > 1e-5 relative")
    later = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(metrics[1:], metrics_p[1:])]
    if not max(later) <= 1e-3:
        failures.append(f"stage-2 train: later losses vs plain {later} > 1e-3 relative")
    if not all(np.isfinite(m["loss"]) and m["l5"] >= 0 for m in metrics + metrics_p):
        failures.append("stage-2 train: a loss is not finite")
    if not (metrics[-1]["l5"] > 0 and metrics_p[-1]["l5"] > 0):
        failures.append(f"stage-2 train: the last step's consistency term is not live: "
                        f"{metrics[-1]['l5']}, plain {metrics_p[-1]['l5']}")
    # every gradient within 1e-4 of its leaf's max, or within 4x the plain
    # route's own noise (the batch reversed) where the leaf is a residue of
    # cancellation (the biases a norm or the softmax removes: attention*.W
    # {q,k,v,w}.bias, ln_final.bias); nonzero on the kernel route except on
    # the leaves the step does not use (the attention pool, text_projection,
    # logit_scale), which apply_gradients gives zero gradients so that AdamW
    # decays them, as optax does
    unused = sorted(k for k in grads if "attnpool" in k
                    or k in ("backbone.text_projection", "backbone.logit_scale"))
    zero = sorted(k for k, gk in grads.items() if not float(gk.abs().max()) > 0)
    if set(grads) != set(grads_p) or set(grads) != {k for k, _ in init.named_parameters()}:
        failures.append("stage-2 train: the routes' gradient leaves differ")
    if zero != unused:
        failures.append(f"stage-2 train: zero gradients on the kernel route at {zero}, want "
                        f"exactly the unused leaves {unused}")
    worst, by_floor = (0.0, ""), {}
    for k, gp in grads_p.items():
        if k not in grads:
            continue
        err, floor = max_err(grads[k], gp), max_err(grads_r[k], gp)
        bar = 1e-4 * float(gp.abs().max())
        if err <= bar:
            worst = max(worst, (err / bar * 1e-4 if bar > 0 else 0.0, k))
        elif err <= 4 * floor:
            by_floor[k] = {"err": err, "plain_noise": floor, "max": float(gp.abs().max())}
        else:
            failures.append(f"stage-2 train: gradient {k} vs plain {err} > 1e-4 of its max "
                            f"({bar}) and > 4x the plain route's noise ({floor})")
    # the teacher after the last step: the EMA rule replayed in plain
    # PyTorch from the initial teacher over this route's students after each
    # step (copies at counters 0 and 1, decays at 2 and 3), within 1e-6 of
    # each leaf's scale (K12 is bit for bit); against the plain route's
    # teacher within 1e-6 of the scale plus the routes' own students'
    # distance, which the teacher inherits (the Adam steps above)
    want = [t.detach().clone() for t in ema_leaves(init)]
    for i, snap in enumerate(students):
        d = ema_decay(i, counted)
        if d is not None:
            K.ema_update_plain(want, snap, d)
    names = [k for k, _ in init.named_parameters()] + [k for k, _ in init.named_buffers()]
    teacher, teacher_p = ema_leaves(state.ema), ema_leaves(plain_state.ema)
    self_worst, route_worst, within_1e6 = (0.0, ""), (0.0, ""), 0
    for i, k in enumerate(names):
        scale = max(float(want[i].abs().max()), 1e-30) if want[i].is_floating_point() else 1.0
        err = max_err(teacher[i], want[i])
        self_worst = max(self_worst, (err / scale, k))
        if not err <= 1e-6 * scale:
            failures.append(f"stage-2 teacher: {k} {err} from the EMA of its students")
        route = max_err(teacher[i], teacher_p[i])
        drift = max(max_err(s[i], sp[i]) for s, sp in zip(students, students_p))
        route_worst = max(route_worst, (route / scale, k))
        within_1e6 += route <= 1e-6 * scale
        if not route <= 1e-6 * scale + drift:
            failures.append(f"stage-2 teacher: {k} vs the plain route's {route} > 1e-6 of its "
                            f"scale + the students' distance {drift}")
    del students, students_p, grads_r, want

    with plain_kernels(K, baseline=True):        # the plain route's peak, at its baseline
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps(plain_state, 1, default)
        torch.cuda.synchronize()
        peak_plain_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    times = {"kernels": [], "plain": []}
    for i in range(ROUNDS):
        for route, st, ctx in (("kernels", state, contextlib.nullcontext),
                               ("plain", plain_state, lambda: plain_kernels(K, baseline=True))):
            with ctx():
                times[route].append(host_ms(lambda: steps(st, 1, default, start=i)))

    # validate with the trained stage-2 model on phase 4's batches
    model = state.model
    del plain_state, state, data
    torch.cuda.empty_cache()
    loader = SyntheticEvalLoader(eval_batches)
    quiet = lambda *a: None  # noqa: E731
    image = image_to_nchw(torch.as_tensor(eval_batches[0]["image"], device=dev))
    ids = torch.as_tensor(eval_batches[0]["word_ids"], device=dev)
    eval_times = {"kernels": [], "plain": []}
    with torch.no_grad():
        validate(model, loader, with_boxes=False, log=quiet)            # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        res = validate(model, loader, with_boxes=False, log=quiet)      # counted
        torch.cuda.synchronize()
        eval_launches = dict(K.launches)
        maps = model.response_maps(image, ids)
        with plain_kernels(K):
            res_p = validate(model, loader, with_boxes=False, log=quiet)
            maps_p = model.response_maps(image, ids)
        for _ in range(3):
            for route, ctx in (("kernels", contextlib.nullcontext),
                               ("plain", lambda: plain_kernels(K, baseline=True))):
                with ctx():
                    eval_times[route].append(host_ms(
                        lambda: validate(model, loader, with_boxes=False, log=quiet))
                        / len(eval_batches))
    per_batch_want = {**EVAL2_LAUNCHES_PER_BATCH, **bn["stage2_eval"]}
    for name in K.KERNELS:
        want = per_batch_want.get(name, 0) * len(eval_batches)
        if eval_launches[name] != want:
            failures.append(f"stage-2 eval: {name} launched {eval_launches[name]} times, "
                            f"want {want}")
    map_scale = float(maps_p.abs().max())
    maps_err = max_err(maps, maps_p)
    if tuple(maps.shape) != (B, S, SIZE, SIZE) or not bool(torch.isfinite(maps).all()) \
            or not maps_err <= 1e-4 * map_scale:
        failures.append(f"stage-2 response_maps: shape {tuple(maps.shape)}, vs plain "
                        f"{maps_err} > 1e-4 of {map_scale}")
    metric_err = max(abs(res[k] - res_p[k]) for k in res)
    if not metric_err <= 1e-4:
        failures.append(f"stage-2 validate vs plain: {res} vs {res_p}")
    if not all(0.0 <= res[k] <= 100.0 for k in ("mIoU", "oIoU", "hit", "hitm")):
        failures.append(f"stage-2 validate metrics out of range: {res}")
    del model
    torch.cuda.empty_cache()

    summary = {
        "model": "RN50 stage 2 (text 512 x 12, 20 tokens, 320 px), random weights (seed 0); "
                 "AdamW lr 5e-5 (backbone 0.1x, positional embeddings in head), EMA teacher, "
                 "consistency mse",
        "B": TRAIN2_B, "steps": TRAIN2_STEPS, "batches": N_TRAIN2_BATCHES,
        "launches": launches, "launches_per_step_expected": per_step_want,
        "metrics": metrics, "metrics_plain": metrics_p, "step1_term_rel_err": term_err,
        "later_loss_rel_err": later, "grad_worst_rel_err": worst[0], "grad_worst_leaf": worst[1],
        "grad_leaves": len(grads), "grad_within_plain_noise": by_floor, "unused_leaves": unused,
        "groups": {g: sum(v == g for v in labels.values()) for g in ("backbone", "head")},
        "teacher_decays": [ema_decay(i, counted) for i in range(TRAIN2_STEPS)], "teacher_vs_own_ema_worst_rel": self_worst[0],
        "teacher_vs_own_ema_worst_leaf": self_worst[1],
        "teacher_vs_plain_route_worst_rel": route_worst[0],
        "teacher_vs_plain_route_worst_leaf": route_worst[1],
        "teacher_leaves_within_1e-6_of_plain_route": within_1e6, "teacher_leaves": len(names),
        "peak_memory_gb": peak_gb, "peak_memory_plain_gb": peak_plain_gb,
        "step_host_ms_default_gate": {route: spread(t) for route, t in times.items()},
        "eval": {"launches": eval_launches, "launches_per_batch_expected": per_batch_want,
                 "metrics": res, "metrics_plain": res_p, "metrics_max_abs_diff": metric_err,
                 "maps_max_abs_err": maps_err, "map_scale": map_scale,
                 "validate_host_ms_per_batch": {r: spread(t) for r, t in eval_times.items()}},
    }
    log(f"stage-2: {json.dumps(summary)}")
    return summary, failures


# ---- phase 10: ReferIt eval and the demo --------------------------------------------------


def make_referit_tree(root: str, seed: int) -> int:
    """A flicker-pickle ReferIt test split (``annotations/test.pickle``, ``images/``): JPEGs
    of a few flat rectangles on dim noise, each ref a rectangle's mask (RLE) and box, its
    query a few words. Image 0 also has a ref whose box is under 5 % (skipped) and one whose
    mask is a stack of two RLEs with a box each. Returns the kept refs."""
    import pickle

    from PIL import Image

    from tris_tpu_torch.data import mask_ops

    rng = np.random.default_rng(seed)
    words = ("man", "woman", "left", "right", "red", "blue", "car", "tree", "sky", "dog",
             "the", "big", "small", "building", "water", "top", "bottom", "middle")
    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "images"))
    ann, kept = {}, 0

    def rect(h, w):
        bh, bw = int(rng.integers(h // 4, h // 2)), int(rng.integers(w // 4, w // 2))
        y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
        mask = np.zeros((h, w), np.uint8)
        mask[y0:y0 + bh, x0:x0 + bw] = 1
        return mask, [x0, y0, x0 + bw, y0 + bh]

    for k in range(REFERIT_IMAGES):
        h, w = REFERIT_SIZES[k % 2]
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        refs = []
        for _ in range(int(rng.integers(1, 7))):
            mask, box = rect(h, w)
            img[mask > 0] = rng.integers(80, 256, 3)
            query = " ".join(rng.choice(words, int(rng.integers(2, 7))))
            refs.append({"image_id": str(k), "query": query, "bbox": [box],
                         "segmentation": mask_ops.rle_encode(mask)})
        if k == 0:
            tiny = np.zeros((h, w), np.uint8)
            tiny[:20, :20] = 1
            refs.append({"image_id": "0", "query": "a tiny thing", "bbox": [[0, 0, 20, 20]],
                         "segmentation": mask_ops.rle_encode(tiny)})
            (m1, b1), (m2, b2) = rect(h, w), rect(h, w)
            refs.append({"image_id": "0", "query": "the two big ones", "bbox": [b1, b2],
                         "segmentation": [mask_ops.rle_encode(m1), mask_ops.rle_encode(m2)]})
        kept += len(refs) - (k == 0)
        Image.fromarray(img).save(os.path.join(root, "images", f"{k}.jpg"), quality=90)
        ann[str(k)] = {"annotations": refs}
    with open(os.path.join(root, "annotations", "test.pickle"), "wb") as f:
        pickle.dump(ann, f)
    return kept


def referit_path(K, dev):
    """``validate_referit`` at full width (RN50 stage 1, hidden 1024, 320 px, seeded) on
    :func:`make_referit_tree`'s split with the launch counters set to 0 just before (the
    exact launches per image of K1, K2, K3's eval head, K4 and K13's eval fold), then with
    K4 alone on its plain version (the same maps: each ref's I and U equal, some I nonzero)
    and on the plain route (the metrics within 1e-4); each
    image's host ms on both routes over ``REFERIT_ROUNDS``, alternating; ``--bf16`` on the
    same weights against the plain bfloat16 route (the first image's maps and the refs' I
    and U within ``BF16_MAPS_SHARE`` of the gap to the float32 run). Then the demo's
    compute (``cli/demo.py::demo_cam``) at full-width stage 2 (seeded, eval mode) on a 480 x
    640 image with two comma-separated phrases (40 tokens: K11's forward past 32) against
    the plain route: the map (the logits) within 1e-4 of its scale, norm_cam (nonzero) within
    that bar carried through the min-max normalisation."""
    import torch
    from PIL import Image

    from tris_tpu_torch.ckpt.io import load_state
    from tris_tpu_torch.cli import demo
    from tris_tpu_torch.data.referit import ReferItTestDataset
    from tris_tpu_torch.eval import validate_referit as VR
    from tris_tpu_torch.models.stage1 import TRISStage1
    from tris_tpu_torch.eval.validate import image_to_nchw
    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.tools import batch_norm_schedule as BS

    records = []

    class Recorded(VR.SegEvalAccumulator):
        """The accumulator, each ref's (I, U, hit, hitm) kept."""

        def add_stats(self, I, U, hit, hitm, weight=1):
            records[-1].append((I, U, hit, hitm))
            super().add_stats(I, U, hit, hitm, weight)

    failures = []
    quiet = lambda *a: None  # noqa: E731
    with tempfile.TemporaryDirectory() as root:
        n_refs = make_referit_tree(root, seed=10)
        ds = ReferItTestDataset(root, split="test", size=SIZE, max_tokens=TXT_LEN)
        model = build_stage1(dev)
        # the seeded trunk's pixel features share one direction, so each map would be all
        # zero or all positive: vis_project's bias takes away their mean over the first
        # image, and the scores of a map take both signs
        with torch.no_grad():
            x = image_to_nchw(torch.as_tensor(ds.example(0)["image"][None], device=dev))
            c4 = model.backbone.encode_image(x, pool=False)[3]
            model.vis_project.bias -= model.vis_project(c4.flatten(2).transpose(1, 2))[0].mean(0)
        saved, VR.SegEvalAccumulator = VR.SegEvalAccumulator, Recorded

        def run(route=contextlib.nullcontext, m=None):
            records.append([])
            with route():
                return VR.validate_referit(model if m is None else m, ds, log=quiet), records[-1]

        @contextlib.contextmanager
        def plain_k4():
            """K4 alone on its plain version: the same maps, so I and U must be equal."""
            kernel, K.eval_metrics = K.eval_metrics, K.eval_metrics_plain
            try:
                yield
            finally:
                K.eval_metrics = kernel

        try:
            run()                                   # warm-up (cuDNN, allocator)
            torch.cuda.synchronize()
            K.reset_launches()
            res, refs = run()                       # the counted run
            torch.cuda.synchronize()
            launches = dict(K.launches)
            _, refs_k4 = run(plain_k4)
            res_p, refs_p = run(lambda: plain_kernels(K))
        finally:
            VR.SegEvalAccumulator = saved
        times = {"kernels": [], "plain": []}
        for _ in range(REFERIT_ROUNDS):
            for route in times:
                with plain_kernels(K, baseline=True) if route == "plain" \
                        else contextlib.nullcontext():
                    times[route].append(host_ms(lambda: VR.validate_referit(
                        model, ds, log=quiet)) / REFERIT_IMAGES)
        # --bf16: the same weights in the bfloat16 model (every leaf float32, as --pretrain
        # gives): K2, K3's eval head and K13's eval fold in bfloat16, K1 and K4 float32; the
        # counted run, then the plain bfloat16 route on the same images
        with torch.random.fork_rng(devices=[]):
            model16 = TRISStage1(model.config, torch.bfloat16)
        load_state(model16, model.state_dict())
        model16 = model16.to(dev).eval()
        VR.SegEvalAccumulator = Recorded
        try:
            torch.cuda.synchronize()
            K.reset_launches()
            res16, refs16 = run(m=model16)
            torch.cuda.synchronize()
            launches16 = {k: n for k, n in K.launches.items() if n}
            res16_p, refs16_p = run(lambda: plain_kernels(K), m=model16)
        finally:
            VR.SegEvalAccumulator = saved
        ms16 = host_ms(lambda: VR.validate_referit(model16, ds, log=quiet)) / REFERIT_IMAGES
        failures += [f"referit --bf16: {k} launched no time" for k in REFERIT_BF16_KERNELS
                     if not launches16.get(k)]
        failures += [f"referit --bf16: {k} launched in float32" for k in
                     ("cross_attn", "response_head", "batch_norm") if launches16.get(k)]
        if not all(0.0 <= v <= 100.0 for v in res16.values()):
            failures.append(f"referit --bf16 metrics out of range: {res16}")
        # against the plain bfloat16 route, as phase 13: the first image's maps, and the refs'
        # I and U (pixels summed over the refs), each within BF16_MAPS_SHARE of the gap
        # between the plain bfloat16 route and the float32 run
        ex = next(e for e in ds.iter_examples() if e["refs"])
        ids0 = np.stack([r["word_ids"] for r in ex["refs"]])[None]
        with torch.no_grad():
            maps16 = VR.make_eval_forward(model16)(ex["image"][None], ids0)
            with plain_kernels(K):
                maps16_p = VR.make_eval_forward(model16)(ex["image"][None], ids0)
            maps32 = VR.make_eval_forward(model)(ex["image"][None], ids0)
        maps_gap16, maps_err16 = max_err(maps16_p, maps32), max_err(maps16, maps16_p)
        pixels = lambda a, b: sum(abs(x[j] - y[j]) for x, y in zip(a, b) for j in (0, 1))  # noqa: E731
        iu_gap16, iu_err16 = pixels(refs16_p, refs), pixels(refs16, refs16_p)
        if not (len(refs16) == len(refs16_p) == n_refs and maps_gap16 > 0 and iu_gap16 > 0):
            failures.append(f"referit --bf16: {len(refs16)} and {len(refs16_p)} refs scored "
                            f"(want {n_refs}), gaps {maps_gap16} and {iu_gap16} pixels")
        if not maps_err16 <= BF16_MAPS_SHARE * maps_gap16:
            failures.append(f"referit --bf16: maps {maps_err16} from the plain route, bar "
                            f"{BF16_MAPS_SHARE} of {maps_gap16}")
        if not iu_err16 <= BF16_MAPS_SHARE * iu_gap16:
            failures.append(f"referit --bf16: I and U {iu_err16} pixels from the plain route, "
                            f"bar {BF16_MAPS_SHARE} of {iu_gap16}")
        del model, model16
        torch.cuda.empty_cache()

        max_ranks = build.ops().batch_norm_plan(TRAIN_B, 64, 80 * 80, True, True, 1,
                                                -1)["max_ranks"]
        want = {k: n * REFERIT_IMAGES for k, n in REFERIT_LAUNCHES_PER_IMAGE.items()}
        want["batch_norm"] = REFERIT_IMAGES * BS.launches_per_forward(
            BS.trunk_shapes(1), "eval", max_ranks)
        failures += [f"referit: {k} launched {launches[k]} times, want {n}"
                     for k, n in want.items() if launches[k] != n]
        if len(refs) != n_refs or len(refs_p) != n_refs:
            failures.append(f"referit: {len(refs)} and {len(refs_p)} refs scored, want {n_refs}")
        if not sum(r[0] for r in refs) > 0:
            failures.append("referit: no ref's prediction meets its mask (I = 0 for all)")
        iu_equal = [a[:2] for a in refs] == [b[:2] for b in refs_k4]
        if not iu_equal:
            failures.append("referit: I and U differ from K4's plain version's on the same maps")
        # the plain route's maps round apart: a pixel within rounding of 0 may flip
        iu_diff = max((abs(a[j] - b[j]) / max(b[j], 1.0) for a, b in zip(refs, refs_p)
                       for j in (0, 1)), default=0.0)
        metric_err = max(abs(res[k] - res_p[k]) for k in res)
        if not metric_err <= 1e-4:
            failures.append(f"referit vs plain: {res} vs {res_p}")
        if not all(0.0 <= v <= 100.0 for v in res.values()):
            failures.append(f"referit metrics out of range: {res}")

        # the demo: stage 2 on one image, two phrases
        h, w = DEMO_SIZE
        img_path = os.path.join(root, "demo.jpg")
        rng = np.random.default_rng(11)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(img_path)
        model2 = build_stage2(dev).eval()
        img, ids, _, _, _ = demo.prepare_data(img_path, DEMO_TEXT)
        x, ids = image_to_nchw(torch.as_tensor(img[None], device=dev)), torch.as_tensor(
            ids[None], device=dev)
        with torch.no_grad():
            # the seeded head's map is of one sign; where it is all negative (nothing to
            # normalise), its last 1x1 conv is negated
            if float(model2(x, ids).max()) <= 0:
                model2.final_seg1[-1].weight.neg_()
            demo.demo_cam(model2, img_path, DEMO_TEXT)          # warm-up
            torch.cuda.synchronize()
            K.reset_launches()
            cam = demo.demo_cam(model2, img_path, DEMO_TEXT)
            demo_launches = {k: n for k, n in K.launches.items() if n}
            logits = model2(x, ids)
            with plain_kernels(K):
                cam_p = demo.demo_cam(model2, img_path, DEMO_TEXT)
                logits_p = model2(x, ids)
            demo_ms = {"kernels": host_ms(lambda: demo.demo_cam(model2, img_path, DEMO_TEXT))}
            with plain_kernels(K, baseline=True):
                demo_ms["plain"] = host_ms(lambda: demo.demo_cam(model2, img_path, DEMO_TEXT))
        del model2
        torch.cuda.empty_cache()
    # the map (stage 2's logits) within 1e-4 of its scale, stage 2's bar; its min-max
    # normalisation divides a difference by the relu'd map's range, so norm_cam is held to
    # that bar carried through: 2e-4 of the scale over the range
    cam_scale = float(np.abs(cam_p).max())
    cam_err = float(np.abs(cam.astype(np.float64) - cam_p).max())
    logit_scale = float(logits_p.abs().max())
    logit_err = max_err(logits, logits_p)
    relu = logits_p.clamp(min=0)
    cam_tol = 2e-4 * logit_scale / (float(relu.max() - relu.min()) + 1e-5)
    if cam.shape != (h, w) or not np.isfinite(cam).all() or not cam_scale > 0:
        failures.append(f"demo: want a finite, nonzero [{h}, {w}] map, got {cam.shape}, "
                        f"scale {cam_scale}")
    if not (logit_err <= 1e-4 * logit_scale and cam_err <= cam_tol):
        failures.append(f"demo vs plain: map {logit_err} > {1e-4 * logit_scale} or norm_cam "
                        f"{cam_err} > {cam_tol}")
    summary = {
        "model": "RN50 stage 1, hidden 1024, 320 px, random weights (seed 0); the demo: RN50 "
                 "stage 2, seed 0, eval mode",
        "images": REFERIT_IMAGES, "refs": n_refs, "launches": launches,
        "launches_expected": want, "metrics": res, "metrics_plain": res_p,
        "metrics_max_abs_diff": metric_err, "i_u_equal_k4_plain": iu_equal,
        "i_u_max_rel_diff_plain_route": iu_diff,
        "refs_with_i": sum(r[0] > 0 for r in refs),
        "host_ms_per_image": {route: spread(t) for route, t in times.items()},
        "bf16": {"leaves": "float32 (the float32 model's, loaded)", "metrics": res16,
                 "metrics_plain_bf16": res16_p, "metrics_f32": res, "launches": launches16,
                 "maps_max_abs_err_vs_plain_bf16": maps_err16, "maps_gap_bf16_f32": maps_gap16,
                 "i_u_pixels_vs_plain_bf16": iu_err16, "i_u_pixels_gap_bf16_f32": iu_gap16,
                 "bar_share": BF16_MAPS_SHARE, "host_ms_per_image": ms16},
        "demo": {"size": [h, w], "text": DEMO_TEXT, "launches": demo_launches,
                 "max_abs_err": cam_err, "scale": cam_scale, "tol": cam_tol,
                 "logits_max_abs_err": logit_err, "logits_scale": logit_scale,
                 "logits_tol": 1e-4 * logit_scale,
                 "positive_share": float((cam > 0).mean()), "host_ms": demo_ms},
    }
    log(f"referit and demo: {json.dumps(summary)}")
    return summary, failures


# ---- phase 11: the native host library ------------------------------------------------------


def native_path():
    """The port's native library on the card's host: its build (and whether
    libjpeg was found), the CRF's native lattice against the numpy lattice on
    phase 7's three COCO-sized JPEGs (ir-label agreement >= 0.9999, the JAX
    package's bar, and max |dQ| < 1e-3) with ms per image for both lattices,
    the native one at 1 thread and at the host's cores; the ir-label pass's
    throughput over 8 of them under each way of sharing the host's cores
    (``tris_tpu_torch.tools.crf_threads``: a pool at one thread a call, the
    same pool over a build without OpenMP, the pool at a full team a call,
    one process at a full team); the fused u8 and f32 decodes against the
    PIL chains (byte or bit equal) with ms per image for both; the RLE codec
    and polygon fill against the numpy codec on a seeded mask set."""
    from PIL import Image

    from tris_tpu_torch import native
    from tris_tpu_torch.data import mask_ops, transforms
    from tris_tpu_torch.pseudo.crf import dense_crf_inference_multi, unary_from_labels
    from tris_tpu_torch.pseudo.labels import cam_to_ir_label

    failures = []
    t0 = time.perf_counter()
    lib = native.build_library()
    build_s = time.perf_counter() - t0
    jpeg = native.jpeg_available()
    cores = os.cpu_count() or 1
    log(f"native: built {os.path.basename(str(lib))} in {build_s:.1f} s; libjpeg "
        f"{'found' if jpeg else 'NOT found: the JPEG half is unverified on this host'}")

    def ms(fn, n=1):
        t = time.perf_counter()
        for _ in range(n):
            out = fn()
        return (time.perf_counter() - t) * 1e3 / n, out

    crf = {"agreement": [], "max_dq": [], "native_ms_1": [], f"native_ms_{cores}": [],
           "numpy_ms": []}
    problems = []
    dec = {"u8_equal": [], "f32_equal": [], "u8_native_ms": [], "u8_pil_ms": [],
           "f32_native_ms": [], "f32_pil_ms": []}
    tmp = tempfile.TemporaryDirectory()
    with tmp:
        names = make_ins_seg_data(tmp.name, seed=5)
        for k, name in enumerate(names):
            path = os.path.join(tmp.name, "train2014", f"COCO_train2014_{k + 1:012d}.jpg")
            img = np.asarray(Image.open(path).convert("RGB"))
            cam = np.load(os.path.join(tmp.name, "cam", name + ".npy"))
            h, w = cam.shape
            seeds = np.stack([np.argmax(np.concatenate([np.full((1, h, w), t), cam[None]]), 0)
                              for t in (0.3, 0.1)]).astype(np.int32)
            unaries = np.stack([unary_from_labels(sd, 2) for sd in seeds])
            problems.append((img, unaries))
            t1, q_nat = ms(lambda: dense_crf_inference_multi(img, unaries, threads=1))
            tn, _ = ms(lambda: dense_crf_inference_multi(img, unaries, threads=cores))
            tp, q_np = ms(lambda: dense_crf_inference_multi(img, unaries, backend="numpy"))
            lab = cam_to_ir_label(img, cam)
            lab_np = np.argmax(q_np, axis=1)
            lab_np = _conf_of(lab_np)
            crf["agreement"].append(float((lab == lab_np).mean()))
            crf["max_dq"].append(float(np.abs(q_nat - q_np).max()))
            crf["native_ms_1"].append(t1)
            crf[f"native_ms_{cores}"].append(tn)
            crf["numpy_ms"].append(tp)
            if jpeg:
                u8, u8_ref = (ms(lambda: transforms.load_transformed_u8(path, SIZE), 5),
                              ms(lambda: np.asarray(transforms.load_image(path).resize(
                                  (SIZE, SIZE), Image.BILINEAR)), 5))
                f32, f32_ref = (ms(lambda: transforms.load_transformed(path, SIZE), 5),
                                ms(lambda: transforms.image_to_array(
                                    transforms.load_image(path), SIZE), 5))
                dec["u8_equal"].append(bool(np.array_equal(u8[1], u8_ref[1])))
                dec["f32_equal"].append(bool(np.array_equal(f32[1], f32_ref[1])))
                for key, v in (("u8_native_ms", u8), ("u8_pil_ms", u8_ref),
                               ("f32_native_ms", f32), ("f32_pil_ms", f32_ref)):
                    dec[key].append(v[0])
    from tris_tpu_torch.tools import crf_threads

    crf["pass_throughput"] = crf_threads.run([problems[i % len(problems)] for i in range(8)])
    if not (min(crf["agreement"]) >= 0.9999 and max(crf["max_dq"]) < 1e-3):
        failures.append(f"native: CRF native vs numpy agreement {crf['agreement']}, max |dQ| "
                        f"{crf['max_dq']}")
    if jpeg and not (all(dec["u8_equal"]) and all(dec["f32_equal"])):
        failures.append(f"native: fused decodes vs PIL u8 {dec['u8_equal']} f32 "
                        f"{dec['f32_equal']}")
    rng = np.random.default_rng(9)
    codec_ok = True
    for _ in range(20):
        hh, ww = (int(v) for v in rng.integers(20, 120, 2))
        m = (rng.random((hh, ww)) > rng.random()).astype(np.uint8)
        rle = mask_ops.rle_encode(m)
        poly = (rng.random((int(rng.integers(3, 9)), 2)) * [ww, hh] * 1.1).ravel().tolist()
        codec_ok &= bool(np.array_equal(mask_ops.rle_decode(rle), m)
                         and np.array_equal(mask_ops.rle_decode(rle, backend="numpy"), m)
                         and np.array_equal(native.rle_encode(m),
                                            mask_ops.string_to_counts(rle["counts"]))
                         and mask_ops.polygon_to_rle(poly, hh, ww)
                         == mask_ops.polygon_to_rle(poly, hh, ww, backend="numpy"))
    if not codec_ok:
        failures.append("native: the RLE codec or polygon fill differs from the numpy codec")
    summary = {"library": os.path.basename(str(lib)), "build_s": build_s, "libjpeg": jpeg,
               "host_cores": cores, "host_cpu": _cpu_model(), "load_avg": os.getloadavg(),
               "crf": crf, "decode": dec if jpeg else "unverified: no "
               "libjpeg on this host", "codec_equal": codec_ok,
               "images": [list(sz) for sz in INS_SEG_SIZES]}
    log(f"native: {json.dumps(summary)}")
    return summary, failures


def _cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), or "not read"."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                        "not read")
    except OSError:
        return "not read"


def _conf_of(labels):
    """``cam_to_ir_label``'s map from the fg and bg refinements' argmaxes."""
    fg, bg = labels
    conf = fg.copy().astype(np.uint8)
    conf[fg == 0] = 255
    conf[(bg + fg) == 0] = 0
    return conf


# ---- phase 12: data parallelism on one card ----------------------------------------------------


def check_dp_kernels(K, dev):
    """The kernels the process group's route adds, on the card against their
    plain versions, timed beside the one-process call: K3's training head for
    a rank's 24 images against the 48 texts of the global batch (offset 24),
    forward and backward; K13's cross-rank route (the wrapper's
    ``ranks_forward`` and ``ranks_backward``: partial, final and apply
    launches, the final over two ranks' partials; the gather between them is
    not a kernel's) for a rank's 24 of 48 samples at the layer-1 tail
    (residual, ReLU) and at stage 2's output1 (PReLU), its y, dx, dweight,
    dbias and dslope held against ``batch_norm_act_reference``'s autograd on
    the concatenated batch. Returns ``{row name: shape entry}`` and the
    failures."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    failures, extra = [], {}
    Bl, T, D, hs = TRAIN_B // 2, TRAIN_B, 1024, SIZE // 32
    hw = hs * hs
    vis, lan = leaves(F.normalize(randn(Bl, hw, D), dim=-1), F.normalize(randn(Bl, T, D), dim=-1))
    args = (torch.tensor(1 / 0.07, device=dev), (hs, hs), (SIZE, SIZE), 3.0, 0.01, Bl)
    one = (F.normalize(randn(TRAIN_B, hw, D), dim=-1), F.normalize(randn(TRAIN_B, T, D), dim=-1))
    one_args = args[:-1] + (0,)
    with torch.no_grad():
        got, want = K.stage1_head(vis, lan, *args), K.stage1_head_plain(vis, lan, *args)
    err = max(max_err(a, b) for a, b in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    maps_bytes = 2 * Bl * SIZE * SIZE
    entry = measure_row(
        failures, "stage1_head@rank_of_2", err, 1e-5 * max(scale, 1.0),
        device_ms(lambda: K.stage1_head(vis.detach(), lan.detach(), *args)),
        device_ms(lambda: K.stage1_head_plain(vis.detach(), lan.detach(), *args)),
        4 * (Bl * hw * D + Bl * T * D + Bl * T + Bl + maps_bytes),
        2 * Bl * hw * T * D + 20 * Bl * hw * T + 10 * maps_bytes, None,
        shape=[Bl, hw, T, D, SIZE], offset=Bl,
        plan=K.stage1_head_plan(Bl, hs, hs, D, SIZE, SIZE, T=T),
        launch_shape=K.stage1_head_launch_shape(),
        one_process_ms=device_ms(lambda: K.stage1_head(*one, *one_args)))
    extra["stage1_head"] = entry
    cot = [randn(Bl, T), None, None, randn(Bl, SIZE, SIZE)]
    kern = lambda v, l: K.stage1_head(v, l, *args)  # noqa: E731
    plain = lambda v, l: K.stage1_head_plain(v, l, *args)  # noqa: E731
    got_g, want_g = input_grads(kern, [vis, lan], cot), input_grads(plain, [vis, lan], cot)
    gscale = max(float(w.abs().max()) for w in want_g)
    one_l = leaves(*one)
    cot_one = [randn(TRAIN_B, T), None, None, randn(TRAIN_B, SIZE, SIZE)]
    extra["stage1_head_bwd"] = measure_row(
        failures, "stage1_head_bwd@rank_of_2", max(max_err(a, b) for a, b in zip(got_g, want_g)),
        1e-4 * max(gscale, 1.0), bwd_ms(kern, [vis, lan], cot), bwd_ms(plain, [vis, lan], cot),
        4 * (2 * (Bl * hw * D + Bl * T * D) + Bl * T + Bl * hw * T + Bl * SIZE * SIZE),
        4 * Bl * hw * T * D + 30 * Bl * hw * T + 12 * Bl * SIZE * SIZE, None,
        shape=[Bl, hw, T, D, SIZE], offset=Bl,
        plan=K.stage1_head_plan(Bl, hs, hs, D, SIZE, SIZE, backward=True, T=T),
        launch_shape=K.stage1_head_launch_shape(backward=True),
        one_process_ms=bwd_ms(lambda v, l: K.stage1_head(v, l, *one_args), one_l, cot_one))

    # K13's cross-rank route, the wrapper's own arithmetic (``ranks_forward`` and
    # ``ranks_backward``) on one process, its gather a stand-in for two ranks that hold the same
    # half: the route's statistics are then one process's on [x_l, x_l], and every output is
    # held against ``batch_norm_act_reference``'s autograd on that concatenated batch
    from tris_tpu_torch.kernels.batch_norm import (
        batch_norm_act_reference, ranks_backward, ranks_forward)

    ops = K.build.ops()

    def two_ranks(p):  # [C, N, slices, k]: both ranks' partials, in rank order
        return torch.cat([p, p], 1)

    def route_case(N, C, H, act, residual):
        """The route on a rank's half of [N, C, H, H] against the reference
        on both halves: (errors, bars, tensors for timing)."""
        xl, gy = randn(N // 2, C, H, H), randn(N // 2, C, H, H)
        rl = randn(N // 2, C, H, H) if residual else None
        w_, b_ = torch.rand(C, generator=g, device=dev) + 0.5, randn(C)
        slope = torch.full((1,), 0.25, device=dev) if act == "prelu" else None
        y, mean, rstd = ranks_forward(xl, w_, b_, slope, rl, None, None, 0.1, 1e-5, act,
                                      gather=two_ranks)
        dx, dw, db, dslope, _ = ranks_backward(gy, xl, y if act == "relu" else None, mean, rstd,
                                               w_, b_, slope, act, residual, gather=two_ranks)
        xx = torch.cat([xl, xl]).requires_grad_()
        params = [t.clone().requires_grad_() for t in (w_, b_)]
        sl = slope.clone().requires_grad_() if slope is not None else None
        want = batch_norm_act_reference(
            xx, *params, torch.zeros(C, device=dev), torch.ones(C, device=dev), training=True,
            update_stats=False, momentum=0.1, eps=1e-5, act=act, slope=sl,
            residual=None if rl is None else torch.cat([rl, rl]))
        wants = torch.autograd.grad(want, [xx, *params] + ([sl] if sl is not None else []),
                                    torch.cat([gy, gy]))
        # one rank's dweight, dbias and dslope are half the concatenated batch's
        got = {"y": y, "dx": dx, "dw": dw, "db": db, **({"dslope": dslope} if sl is not None
                                                        else {})}
        ref = {"y": want.detach()[:N // 2], "dx": wants[0][:N // 2], "dw": wants[1] / 2,
               "db": wants[2] / 2, **({"dslope": wants[3] / 2} if sl is not None else {})}
        errs = {k: max_err(got[k].reshape(ref[k].shape), ref[k]) for k in got}
        bars = {k: (1e-5 * float(ref[k].abs().max())) for k in got}
        for k in got:
            if not errs[k] <= bars[k]:
                failures.append(f"batch_norm@rank_of_2 {act}: {k} {errs[k]} > {bars[k]}")
        return errs, bars, (xl, rl, gy, w_, b_, slope, y, mean, rstd)

    N, C, H = TRAIN_B, 256, 80
    errs, bars, (xl, rl, gy, w_, b_, _, y, mean, rstd) = route_case(N, C, H, "relu", True)
    # stage 2's output1 with PReLU: the slope's sums go through the route's own final
    prelu_errs, prelu_bars, _ = route_case(TRAIN2_B, 32, 80, "prelu", False)
    x, res = randn(N, C, H, H), randn(N, C, H, H)
    zeros, ones = torch.zeros(C, device=dev), torch.ones(C, device=dev)

    def route():
        return ranks_forward(xl, w_, b_, None, rl, None, None, 0.1, 1e-5, "relu",
                             gather=two_ranks)[0]

    def route_bwd():
        return ranks_backward(gy, xl, y, mean, rstd, w_, b_, None, "relu", True,
                              gather=two_ranks)

    nbytes = 4 * 3 * xl.numel()
    extra["batch_norm"] = measure_row(
        failures, "batch_norm@rank_of_2", errs["y"], bars["y"],
        device_ms(route), device_ms(lambda: K.batch_norm_act_plain(
            xl, w_, b_, zeros, ones, training=True, update_stats=False, momentum=0.1, eps=1e-5,
            act="relu", residual=rl)),
        nbytes, 8 * xl.numel(), device_ms(lambda: F.relu(F.batch_norm(
            xl, None, None, w_, b_, True) + rl)),
        shape=[N // 2, C, H * H], ranks=2, launches_per_call=3,
        one_process_ms=device_ms(lambda: K.batch_norm_act(
            x, w_, b_, zeros, ones, training=True, update_stats=False, momentum=0.1, eps=1e-5,
            act="relu", residual=res)),
        prelu_stage2_output1={"shape": [TRAIN2_B // 2, 32, 80 * 80], "max_abs_err": prelu_errs,
                              "tol": prelu_bars})
    # the backward's four launches on the rank's half, the coefficients over both ranks' partials
    gy_one, y_one = randn(N, C, H, H), torch.relu(x)
    (x_leaf,) = leaves(xl)
    plain_bwd = bwd_ms(lambda t: K.batch_norm_act_plain(
        t, w_, b_, zeros, ones, training=True, update_stats=False, momentum=0.1, eps=1e-5,
        act="relu", residual=rl), [x_leaf], [gy])
    extra["batch_norm_bwd"] = measure_row(
        failures, "batch_norm_bwd@rank_of_2", errs["dx"], bars["dx"],
        device_ms(route_bwd), plain_bwd, 4 * 4 * xl.numel(), 12 * xl.numel(), None,
        shape=[N // 2, C, H * H], ranks=2, launches_per_call=4,
        dweight_dbias_max_abs_err={k: errs[k] for k in ("dw", "db")},
        dweight_dbias_tol={k: bars[k] for k in ("dw", "db")},
        prelu_stage2_output1={"max_abs_err": {k: v for k, v in prelu_errs.items() if k != "y"},
                              "tol": {k: v for k, v in prelu_bars.items() if k != "y"}},
        one_process_ms=device_ms(lambda: ops.batch_norm_bwd(
            gy_one, x, y_one, mean, rstd, w_, b_, None, 1, True, -1)))
    return extra, failures


def dp_path():
    """Phase 12: ``tris_tpu_torch.tools.dp_check`` (two gloo ranks on this
    card against one process, then a one-process NCCL group)."""
    from tris_tpu_torch.tools import dp_check

    summary, failures = dp_check.run()
    log(f"dp: {json.dumps(summary, default=str)}")
    return summary, failures


# ---- phase 13: --bf16 stage-1 eval and PRMS ---------------------------------------------------

# the bfloat16 kernels every --bf16 eval launches; K1's bfloat16 kernel on bfloat16 leaves only
# (on float32 leaves the text stream is float32 and K1 runs in float32)
BF16_KERNELS = ("batch_norm.bf16", "cross_attn.bf16", "response_head.bf16")
# the maps of the kernel route against the plain bfloat16 route, as a share of the gap between
# the plain bfloat16 route and the float32 model in the same run: the routes differ in K1's,
# K2's and K3's sums before their bfloat16 roundings (K13 is bit for bit), so a rounding may
# flip by one ulp where the sums straddle it, and the flips spread downstream, through the
# bfloat16 text tower most (0.39 and 0.20 of the gap on bfloat16 and float32 leaves, H100
# 80GB HBM3); a route that computed in float32 would sit at the whole gap
BF16_MAPS_SHARE = 0.5


def bf16_path(K, dev, batches):
    """``--bf16`` at full width on phase 4's batches, in both leaf regimes: the
    seeded bfloat16 init (its 15 leaf kinds bfloat16) and the float32
    model's weights loaded into the bfloat16 model (every leaf float32, as a
    checkpoint gives). Per regime: ``validate`` and ``validate_prms`` under
    reset counters (the bfloat16 kernels each launched; K13's eval fold at
    every norm, none in float32); the maps of one batch against the plain
    bfloat16 route within ``BF16_MAPS_SHARE`` of the gap to the float32 maps;
    the metrics beside float32's; PRMS's selection against float32's; the
    host ms a batch of ``validate``, bfloat16 and float32, one run each."""
    import torch

    from tris_tpu_torch.ckpt.io import load_state
    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser
    from tris_tpu_torch.eval.validate import (image_to_nchw, make_prms_forward, validate,
                                              validate_prms)
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

    model32 = build_stage1(dev)
    critic = build_critic(get_parser().parse_args(["--max_query_len", str(TXT_LEN)]), dev)
    cfg = Stage1Config(backbone="RN50", hidden_dim=1024, txt_length=TXT_LEN)
    loader = SyntheticEvalLoader(batches)
    image = image_to_nchw(torch.as_tensor(batches[0]["image"], device=dev))
    ids = torch.as_tensor(batches[0]["word_ids"], device=dev)
    quiet = lambda *a: None  # noqa: E731
    bn_per_forward = sum(bn_launches()["stage1_eval"].values())
    failures, summary = [], {}

    def best_of(model):
        fwd = make_prms_forward(model, critic)
        return np.concatenate([fwd(b["image"], b["word_ids"], np.arange(S)[None]
                                   < b["num_sents"][:, None])[0].cpu().numpy() for b in batches])

    with torch.no_grad():
        validate(model32, loader, with_boxes=False, log=quiet)  # warm-up
        ms32 = host_ms(lambda: validate(model32, loader, with_boxes=False, log=quiet)) / len(batches)
        res32 = validate(model32, loader, with_boxes=False, log=quiet)
        prms32 = validate_prms(model32, critic, loader, log=quiet)
        maps32, best32 = model32.response_maps(image, ids), best_of(model32)
        for leaves in ("bf16_leaves", "f32_leaves"):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = TRISStage1(cfg, torch.bfloat16).to(dev).eval()
            if leaves == "f32_leaves":
                load_state(model, model32.state_dict())
            n_bf16 = sum(t.dtype == torch.bfloat16 for t in model.state_dict().values())
            validate(model, loader, with_boxes=False, log=quiet)  # warm-up
            torch.cuda.synchronize()
            K.reset_launches()
            res = validate(model, loader, with_boxes=False, log=quiet)
            res_prms = validate_prms(model, critic, loader, log=quiet)
            torch.cuda.synchronize()
            launches = {k: n for k, n in K.launches.items() if n}
            want = BF16_KERNELS + ("mha_short.bf16" if leaves == "bf16_leaves" else "mha_short",)
            failures += [f"bf16 {leaves}: {k} launched no time" for k in want
                         if not launches.get(k)]
            bn_want = 2 * len(batches) * bn_per_forward
            if launches.get("batch_norm.bf16") != bn_want or launches.get("batch_norm"):
                failures.append(f"bf16 {leaves}: K13 launched {launches}, want "
                                f"{bn_want} batch_norm.bf16 and no batch_norm")
            maps = model.response_maps(image, ids)
            with plain_kernels(K):
                maps_p = model.response_maps(image, ids)
            gap, err = max_err(maps_p, maps32), max_err(maps, maps_p)
            if not (maps.dtype == torch.float32 and tuple(maps.shape) == (B, S, SIZE, SIZE)
                    and bool(torch.isfinite(maps).all()) and err <= BF16_MAPS_SHARE * gap):
                failures.append(f"bf16 {leaves}: maps {maps.dtype} {tuple(maps.shape)}, "
                                f"{err} from the plain route, bar {BF16_MAPS_SHARE} of {gap}")
            best = best_of(model)
            ms16 = host_ms(lambda: validate(model, loader, with_boxes=False, log=quiet)) / len(batches)
            if not all(0.0 <= res[k] <= 100.0 for k in ("mIoU", "oIoU", "hit", "hitm")):
                failures.append(f"bf16 {leaves}: metrics out of range: {res}")
            summary[leaves] = {
                "bf16_leaves": n_bf16, "launches": launches,
                "batch_norm_bf16_launches_expected": bn_want,
                "maps_max_abs_err_vs_plain_bf16": err, "maps_gap_bf16_f32": gap,
                "maps_share_of_gap": err / gap if gap else None, "maps_bar_share": BF16_MAPS_SHARE,
                "map_scale": float(maps32.abs().max()),
                "metrics": {k: res[k] for k in ("mIoU", "oIoU", "hit", "hitm")},
                "prms_metrics": {k: res_prms[k] for k in ("mIoU", "oIoU", "hit", "hitm")},
                "prms_selection_agreement_with_f32": float((best == best32).mean()),
                "prms_refs": int(best.size),
                "validate_host_ms_per_batch": {"bf16": ms16, "f32": ms32},
            }
            del model
            torch.cuda.empty_cache()
    summary["f32"] = {"metrics": {k: res32[k] for k in ("mIoU", "oIoU", "hit", "hitm")},
                      "prms_metrics": {k: prms32[k] for k in ("mIoU", "oIoU", "hit", "hitm")}}
    summary["model"] = ("RN50 stage 1 in bfloat16, hidden 1024, 320 px, seeded (seed 0) or the "
                        "float32 model's weights loaded; the ViT-B/32 critic float32")
    del model32, critic
    torch.cuda.empty_cache()
    log(f"bf16: {json.dumps(summary)}")
    return summary, failures


# ---- phase 14: --bf16 stage-1 training ------------------------------------------------------

# the bfloat16 kernels a --bf16 train step launches in every leaf regime; K1's bfloat16 kernels
# on the seeded init's leaves only (else the text stream is float32); the float32 counters of
# K2, K3's head and K13 stay at 0 in every regime
BF16_TRAIN_KERNELS = ("batch_norm.bf16", "batch_norm_bwd.bf16", "cross_attn.bf16",
                      "cross_attn_bwd.bf16", "stage1_head.bf16", "stage1_head_bwd.bf16")
BF16_TRAIN_F32_IDLE = ("batch_norm", "batch_norm_bwd", "cross_attn", "cross_attn_bwd",
                       "stage1_head", "stage1_head_bwd")
# step 1's losses and gradients, the kernel route against the plain bfloat16 route, with the
# bf16-f32 gap and the plain route's own spread (the same step on the batch reversed) measured
# in the run: a bfloat16 step is chaotic (one rounding flipped anywhere spreads through the
# ReLU network), so two bfloat16 routes lie about the gap apart (JAX's two CPU compiles: a
# median of 0.83 to 1.10 of it over the losses and leaves, tests/test_torch_bf16_step.py).
# Bars: each loss and leaf within BF16_TRAIN_TAIL times the larger of the gap and the plain
# route's spread, and the median over them within BF16_TRAIN_MEDIAN times the spread's median
BF16_TRAIN_TAIL, BF16_TRAIN_MEDIAN = 4.0, 1.5


def bf16_train_path(K, dev, batches):
    """``--bf16`` stage-1 training at full width (RN50, hidden 1024, 320 px, B =
    48, 3 negatives, the ViT-B/32 critic float32): ``train_step``, 3 steps under
    reset counters, in the three leaf regimes: the seeded bfloat16 init (15
    bfloat16 leaf kinds), the float32 model's weights loaded (every leaf
    float32, as ``--pretrain`` of a float32 checkpoint gives) and the seeded
    init with a float32 backbone (as ``--clip_weights`` gives: the fusion's 8
    InstanceNorm leaves bfloat16). Per regime: the bfloat16 kernels each
    launched and the float32 K2, K3 and K13 never; step 1's losses and each
    leaf's gradient against the plain bfloat16 route at the bars above; the
    GMP channels with a tied maximum in step 1's head; the dtypes of the
    bfloat16 leaves' moments. On the seeded init, the step's host ms in
    bfloat16 and in float32, ``ROUNDS`` rounds alternating."""
    import copy

    import torch

    from tris_tpu_torch.ckpt.io import load_state
    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1
    from tris_tpu_torch.train.stage1 import batch_to_device, train_step
    from tris_tpu_torch.train.state import label_params, make_optimizer

    bf = torch.bfloat16
    critic = build_critic(get_parser().parse_args(["--max_query_len", str(TXT_LEN)]), dev)
    cfg = Stage1Config(backbone="RN50", hidden_dim=1024, txt_length=TXT_LEN)
    data = [batch_to_device(b, dev) for b in batches]
    model32 = build_stage1(dev).train()
    failures, summary = [], {}

    def seeded():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return TRISStage1(cfg, bf).to(dev).train()

    def pretrain():
        model = seeded()
        load_state(model, model32.state_dict())
        return model

    def clip():
        model = seeded()
        load_state(model.backbone, model32.backbone.state_dict())
        return model

    def run(model, n, batch0=None, ties=None):
        """n steps from a copy of ``model`` and a fresh optimizer: the loss
        terms, step 1's gradients, the optimizer"""
        model = copy.deepcopy(model)
        opt, sched = make_optimizer(model, total_steps=100)
        out, grads = [], None
        for i in range(n):
            batch = batch0 if (i == 0 and batch0 is not None) else data[i % len(data)]
            if i == 0 and ties is not None:
                head = K.stage1_head

                def counted(vis_p, lan_p, scale, *a):
                    with torch.no_grad():
                        score = torch.einsum("bpc,bqc->bpq", vis_p.double(), lan_p.double())
                        score = scale * (score.to(bf) if vis_p.dtype == bf else score.float()
                                         ).float()
                        ties.append(int(((score == score.amax(dim=1, keepdim=True)).sum(dim=1)
                                         > 1).sum()))
                    return head(vis_p, lan_p, scale, *a)

                K.stage1_head = counted
            try:
                m = train_step(model, critic, opt, sched, batch)
            finally:
                if i == 0 and ties is not None:
                    K.stage1_head = head
            out.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None}
        return out, grads, opt, model

    def dist(a, b, scale):
        s = float(scale.abs().max()) if torch.is_tensor(scale) else abs(scale)
        return (max_err(a, b) if torch.is_tensor(a) else abs(a - b)) / max(s, 1e-30)

    labels = label_params(model32)
    for regime, make in (("seeded", seeded), ("pretrain", pretrain), ("clip", clip)):
        model = make()
        n_bf16 = sum(t.dtype == bf for t in model.state_dict().values())
        ref32 = TRISStage1(cfg).to(dev).train()     # the regime's weights in float32
        load_state(ref32, {k: v.float() if v.is_floating_point() else v
                           for k, v in model.state_dict().items()})
        run(model, 1)                               # warm-up (cuDNN, allocator), kernel route
        torch.cuda.synchronize()
        K.reset_launches()
        ties = []
        metrics, grads, opt, stepped = run(model, TRAIN_STEPS, ties=ties)    # the counted run
        torch.cuda.synchronize()
        launches = {k: n for k, n in K.launches.items() if n}
        with plain_kernels(K):
            metrics_p, grads_p, _, _ = run(model, 1)
            rev = {k: v.flip(0) for k, v in data[0].items()}
            metrics_r, grads_r, _, _ = run(model, 1, batch0=rev)
        metrics32, grads32, _, _ = run(ref32, 1)
        torch.cuda.synchronize()
        want = BF16_TRAIN_KERNELS + (("mha_short.bf16", "mha_short_bwd.bf16")
                                     if regime == "seeded" else ())
        failures += [f"bf16 train {regime}: {k} launched no time" for k in want
                     if not launches.get(k)]
        failures += [f"bf16 train {regime}: {k} launched in float32" for k in BF16_TRAIN_F32_IDLE
                     if launches.get(k)]
        rows = []
        for k in ("loss", "l1", "l4", "l5"):
            rows.append((k, dist(metrics[0][k], metrics_p[0][k], metrics32[0][k]),
                         dist(metrics_p[0][k], metrics32[0][k], metrics32[0][k]),
                         dist(metrics_r[0][k], metrics_p[0][k], metrics32[0][k])))
        for k, gp in grads_p.items():
            if labels[k] == "frozen" or not float(grads32[k].abs().max()) > 0:
                continue
            rows.append((k, dist(grads[k], gp, grads32[k]), dist(gp, grads32[k], grads32[k]),
                         dist(grads_r[k], gp, grads32[k])))
        shares, floors = [], []
        worst = (0.0, "")
        for name, err, gap, floor in rows:
            bar = BF16_TRAIN_TAIL * max(gap, floor)
            if not err <= bar:
                failures.append(f"bf16 train {regime}: {name} {err} from the plain route > "
                                f"{BF16_TRAIN_TAIL} x max(gap {gap}, spread {floor})")
            if gap > 0:
                shares.append(err / gap)
                floors.append(floor / gap)
            worst = max(worst, (err / max(gap, floor, 1e-30), name))
        med, med_floor = float(np.median(shares)), float(np.median(floors))
        if not med <= BF16_TRAIN_MEDIAN * med_floor:
            failures.append(f"bf16 train {regime}: median {med} of the gap from the plain route > "
                            f"{BF16_TRAIN_MEDIAN} x the plain route's spread {med_floor}")
        low = [p for p in stepped.parameters() if p.dtype == bf]
        moments = [opt.state[p][key].dtype for p in low for key in ("exp_avg", "exp_avg_sq")]
        if len(low) != n_bf16 or any(dt != bf for dt in moments):
            failures.append(f"bf16 train {regime}: {len(low)} bfloat16 leaves (want {n_bf16}), "
                            f"moments {set(map(str, moments))}")
        if not all(np.isfinite(m["loss"]) for m in metrics + metrics_p):
            failures.append(f"bf16 train {regime}: a loss is not finite")
        if not torch.equal(stepped.logit_scale, model.logit_scale):
            failures.append(f"bf16 train {regime}: logit_scale moved")
        summary[regime] = {
            "bf16_leaves": n_bf16, "launches": launches, "metrics": metrics,
            "metrics_plain_bf16": metrics_p[0], "metrics_f32": metrics32[0],
            "losses_and_leaves": len(rows), "median_share_of_gap": med,
            "median_plain_spread_share_of_gap": med_floor, "worst": {"name": worst[1],
                                                                     "of_max_gap_spread": worst[0]},
            "losses": {name: {"vs_plain": err, "gap": gap, "plain_spread": floor}
                       for name, err, gap, floor in rows[:4]},
            "gmp_channels_tied": ties[0] if ties else None, "gmp_channels": TRAIN_B * TRAIN_B,
            "bf16_moments": len(moments)}
        if regime == "seeded":
            times = {"bf16": [], "f32": []}
            model_f32 = copy.deepcopy(ref32)
            states = {"bf16": (stepped, opt, None), "f32": (model_f32, *make_optimizer(
                model_f32, total_steps=100))}
            states["bf16"] = (stepped, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0))
            for i in range(ROUNDS):
                for route in times:
                    mdl, o, sch = states[route]
                    times[route].append(host_ms(lambda: train_step(mdl, critic, o, sch,
                                                                   data[i % len(data)])))
            del model_f32, states
            summary[regime]["step_host_ms"] = {route: spread(t) for route, t in times.items()}
        log(f"bf16 train {regime}: {json.dumps(summary[regime], default=str)}")
        del model, ref32, stepped, opt, grads, grads_p, grads_r, grads32
        torch.cuda.empty_cache()
    summary["model"] = ("RN50 stage 1 in bfloat16, hidden 1024, 320 px, B = 48, 3 negatives, "
                        "seeded (seed 0); the float32 model's weights (seed 0) loaded whole or "
                        "as the backbone; the ViT-B/32 critic float32")
    summary["bars"] = {"tail": BF16_TRAIN_TAIL, "median": BF16_TRAIN_MEDIAN}
    del model32, critic
    torch.cuda.empty_cache()
    return summary, failures


# ---- phase 15: --bf16 stage-2 eval and the demo -----------------------------------------------

# a --bf16 stage-2 eval batch's launches, by leaf regime: the text tower's K1 (bfloat16 on the
# seeded leaves, else the float32 text stream's), K11 at c2, c3 and c4, K6 at the decoder's
# three x2 upsamples (bfloat16, or float32 after a float32 checkpoint's PReLU) and the head's
# to 320 px (bfloat16 in both), K13's eval fold at the trunk's 55 norms and the decoder's 9
# (all bfloat16, the decoder's with PReLU), the u8 feed and K4 in float32
BF16_EVAL2_LAUNCHES_PER_BATCH = {
    "bf16_leaves": {"mha_short.bf16": 12, "pixel_attn.bf16": 3, "bilinear_resize.bf16": 4,
                    "normalize_u8": 1, "eval_metrics": 1},
    "f32_leaves": {"mha_short": 12, "pixel_attn.bf16": 3, "bilinear_resize": 3,
                   "bilinear_resize.bf16": 1, "normalize_u8": 1, "eval_metrics": 1}}
S2_PRELU_PER_FORWARD = 9  # the decoder's ConvBNRelus of an eval forward (no side heads)
# Stage 2's maps in bfloat16 are chaotic. The text tower's float32 softmax and P V (K1: the
# float32 causal mask promotes the bfloat16 logits) differ by a float32 ulp between any two
# evaluations of the same arithmetic; the next Dense rounds them to bfloat16, and the flips
# spread through the tower, the three PixelAttentions and the decoder. Swapping one kernel
# at a time (H100 80GB HBM3): the plain route with K1 alone launched lies 1.40 of the
# bf16-f32 gap from the plain route at its max, with K11 alone 0.30, K6 and K13 0 (bit for
# bit); K1's output lies as near a float64 evaluation of its arithmetic as its plain
# version's, and the plain route with K1's sums in float64 lies 1.0-1.2 from the plain route.
# So the spread is measured on the plain route itself, re-evaluated five ways, each the
# float32 arithmetic with its bfloat16 rounding points and other float32 sums: cuDNN off
# (PyTorch's own convolutions); K1's sums in float64, each result rounded once where jnp
# rounds it (``mha_short_exact``), or its float32 softmax and P V rounded once at the end;
# K1's and K11's (``pixel_attn_exact``), with cuDNN on and off. The kernel route's distance
# from the plain route, max and mean, within BF16_SPREAD_SHARE of the farthest of those; and
# at least BF16_MAPS_SHARE of the
# gap from the float32 maps, max and mean, which a route that computes in float32 does not
# reach: the float32 maps go through the same bars and must fail them.
BF16_SPREAD_SHARE = 1.25


def softmax_exact(x):
    """``jax.nn.softmax`` over the last axis in x's dtype, each op (x - max,
    exp, the sum, the quotient) evaluated in float64 and rounded once to it."""
    dt = x.dtype
    x = x.double()
    e = (x - x.amax(dim=-1, keepdim=True)).to(dt).double().exp().to(dt).double()
    return (e / e.sum(dim=-1, keepdim=True).to(dt).double()).to(dt)


def mha_short_exact(q, k, v, n_head, attn_mask=None, once: bool = False):
    """K1's plain version with every sum in float64, each result rounded once
    where jnp rounds it: the scaled q and the logits to q's dtype, the masked
    logits to the mask's promotion, the softmax's ops, P V. With ``once``,
    the softmax and P V in float64 and only their result rounded (the
    float32 output correctly rounded)."""
    import torch

    from tris_tpu_torch.ops.dtypes import promote, weak

    N, Lq, C = q.shape
    hd = C // n_head
    dt = promote(q, k, v)
    qh, kh, vh = (x.double().reshape(N, -1, n_head, hd).transpose(1, 2) for x in (q, k, v))
    qh = (qh * weak(hd ** -0.5, dt)).to(dt).double()
    logits = torch.einsum("nhqd,nhkd->nhqk", qh, kh).to(dt)
    if attn_mask is not None:
        dt = promote(logits, attn_mask)
        logits = (logits.double() + attn_mask.double()).to(dt)
    p = torch.softmax(logits.double(), dim=-1) if once else softmax_exact(logits).double()
    out = torch.einsum("nhqk,nhkd->nhqd", p, vh).to(dt)
    return out.transpose(1, 2).reshape(N, Lq, C)


def pixel_attn_exact(q, Lk, Lv, S: int):
    """K11's plain version with every sum in float64, each result rounded
    once where jnp rounds it: the logits, ``/ sqrt(Ci)``, the softmax's ops,
    G."""
    import torch

    from tris_tpu_torch.ops.dtypes import promote, weak

    N, HW, Ci = q.shape
    T = Lk.shape[1]
    dt = promote(q, Lk, Lv)
    Lk, Lv = (x.double().reshape(N, S, T, Ci) for x in (Lk, Lv))
    logits = torch.einsum("npc,nstc->nspt", q.double(), Lk).to(dt).double()
    logits = (logits / weak(math.sqrt(Ci), dt)).to(dt)
    G = torch.einsum("nspt,nstc->nspc", softmax_exact(logits).double(), Lv).to(dt)
    return G.reshape(N * S, HW, Ci)


S2_ROUTE_KERNELS = {"K1": "mha_short", "K11": "pixel_attn", "K6": "bilinear_resize",
                    "K13": "batch_norm_act"}


def maps_bars(got, plain, witnesses, ref32) -> dict:
    """``got``'s distances (max and mean) from the plain route, against the
    farthest of the plain route's re-evaluations ``witnesses`` (the spread),
    and from the float32 maps ``ref32``, against the gap (the plain route's
    distance from them); ``ok`` where both bars above hold."""
    dist = lambda a, b: (float((a - b).abs().max()), float((a - b).abs().mean()))  # noqa: E731
    spreads = {name: dist(w, plain) for name, w in witnesses.items()}
    spread, mean_spread = (max(d[i] for d in spreads.values()) for i in (0, 1))
    (gap, mean_gap), (err, mean_err), (away, mean_away) = (
        dist(plain, ref32), dist(got, plain), dist(got, ref32))
    ok = (gap > 0 and err <= BF16_SPREAD_SHARE * spread
          and mean_err <= BF16_SPREAD_SHARE * mean_spread
          and away >= BF16_MAPS_SHARE * gap and mean_away >= BF16_MAPS_SHARE * mean_gap)
    return {"ok": ok, "max_err": err, "mean_err": mean_err, "spread": spread,
            "mean_spread": mean_spread, "spreads": spreads, "away_from_f32": away,
            "mean_away_from_f32": mean_away, "gap": gap, "mean_gap": mean_gap,
            "share_of_gap": err / gap if gap else None,
            "mean_share_of_gap": mean_err / mean_gap if mean_gap else None}


def route_distances(K, what, failures, run, got, ref32):
    """``got`` (the kernel route's ``run()``) at the bars above, against the
    plain bfloat16 route's ``run()`` and its five re-evaluations, and the
    float32 maps ``ref32``, which must fail the same bars (the control); with
    each kernel's share of the gap (the plain route with that kernel alone
    launched). A failure noted where a bar does not hold or the control
    passes. Returns the numbers."""
    import torch

    kernels = {tag: getattr(K, name) for tag, name in S2_ROUTE_KERNELS.items()}
    cpu = lambda t: t.double().cpu()  # noqa: E731
    with torch.no_grad():
        with plain_kernels(K):
            plain = cpu(run())
            with torch.backends.cudnn.flags(enabled=False):
                witnesses = {"cudnn_off": cpu(run())}
            with swapped(K, mha_short=functools.partial(mha_short_exact, once=True)):
                witnesses["exact_K1_once"] = cpu(run())
            with swapped(K, mha_short=mha_short_exact):
                witnesses["exact_K1"] = cpu(run())
                with swapped(K, pixel_attn=pixel_attn_exact):
                    witnesses["exact_K1_K11"] = cpu(run())
                    with torch.backends.cudnn.flags(enabled=False):
                        witnesses["exact_K1_K11_cudnn_off"] = cpu(run())
            alone = {}
            for tag, name in S2_ROUTE_KERNELS.items():
                with swapped(K, **{name: kernels[tag]}):
                    alone[tag] = cpu(run())
    got, ref32 = cpu(got), cpu(ref32)
    d = maps_bars(got, plain, witnesses, ref32)
    d["kernel_alone_share_of_gap"] = {
        tag: [float((m - plain).abs().max()) / d["gap"],
              float((m - plain).abs().mean()) / d["mean_gap"]]
        for tag, m in alone.items()} if d["gap"] and d["mean_gap"] else None
    d["f32_control"] = control = maps_bars(ref32, plain, witnesses, ref32)
    if not d["ok"]:
        failures.append(f"{what}: {d} past the bars (within {BF16_SPREAD_SHARE} x the spread "
                        f"of the plain route, {BF16_MAPS_SHARE} x the gap from the float32 "
                        "maps)")
    if control["ok"]:
        failures.append(f"{what}: the float32 maps pass the bars: {control}")
    return d


def bf16_stage2_path(K, dev, batches):
    """``--bf16`` stage 2 at full width (RN50 stage 2, text 512 x 12, 20 tokens,
    320 px) on phase 4's eval batches of 8 x 4, in both leaf regimes: the seeded
    bfloat16 init (31 + 4 leaf kinds bfloat16 at RN50: the backbone's, the
    InstanceNorms', the PReLU slopes) and the float32 model's weights loaded
    (every leaf float32, as ``--pretrain`` of a float32 checkpoint). Per regime:
    ``validate`` under reset counters (each route's launches by name and dtype,
    exactly: ``BF16_EVAL2_LAUNCHES_PER_BATCH`` and K13's 55 eval folds and 9
    with PReLU a batch in bfloat16, the PReLU slopes in the regime's dtype; no
    float32 K11 or K13); ``response_maps`` of one batch at the bars above
    (:func:`route_distances`); the metrics beside
    float32's; ``validate``'s host ms a batch, bfloat16 against float32,
    alternating over ``ROUNDS``. Then ``demo_cam`` (``cli/demo.py``) on phase
    10's 480 x 640 image with two phrases (40 tokens) under reset counters (K1
    12, K6 4, K11 3, K13 55 + 9 a forward) at the same bars, on the head's sign that gives a nonzero map (phase 10's rule)."""
    import torch
    from PIL import Image

    from tris_tpu_torch.ckpt.io import load_state
    from tris_tpu_torch.cli import demo
    from tris_tpu_torch.eval.validate import image_to_nchw, validate
    from tris_tpu_torch.models.layers import PReLU
    from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2

    model32 = build_stage2(dev).eval()
    cfg = Stage2Config(backbone="RN50", txt_length=TXT_LEN)
    loader = SyntheticEvalLoader(batches)
    image = image_to_nchw(torch.as_tensor(batches[0]["image"], device=dev))
    ids = torch.as_tensor(batches[0]["word_ids"], device=dev)
    quiet = lambda *a: None  # noqa: E731
    bn_per_batch = sum(bn_launches()["stage2_eval"].values())
    failures, summary = [], {}
    with tempfile.TemporaryDirectory() as root:
        h, w = DEMO_SIZE
        img_path = os.path.join(root, "demo.jpg")
        rng = np.random.default_rng(11)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(img_path)
        with torch.no_grad():
            # the seeded head's demo map is of one sign; where it is all negative (nothing to
            # normalise), its last 1x1 conv is negated, as phase 10 does (the bfloat16 models
            # below take the float32 one's sign)
            img, dids, _, _, _ = demo.prepare_data(img_path, DEMO_TEXT)
            negate = float(model32(image_to_nchw(torch.as_tensor(img[None], device=dev)),
                                   torch.as_tensor(dids[None], device=dev)).max()) <= 0
            if negate:
                model32.final_seg1[-1].weight.neg_()
            validate(model32, loader, with_boxes=False, log=quiet)  # warm-up
            res32 = validate(model32, loader, with_boxes=False, log=quiet)
            maps32 = model32.response_maps(image, ids)
            cam32 = demo.demo_cam(model32, img_path, DEMO_TEXT)
            for leaves in ("bf16_leaves", "f32_leaves"):
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(0)
                    model = TRISStage2(cfg, torch.bfloat16).to(dev).eval()
                if leaves == "f32_leaves":
                    load_state(model, model32.state_dict())
                elif negate:
                    model.final_seg1[-1].weight.neg_()
                n_bf16 = sum(t.dtype == torch.bfloat16 for t in model.state_dict().values())
                slope_dt = "bfloat16" if leaves == "bf16_leaves" else "float32"
                validate(model, loader, with_boxes=False, log=quiet)  # warm-up
                torch.cuda.synchronize()
                K.reset_launches()
                res = validate(model, loader, with_boxes=False, log=quiet)
                torch.cuda.synchronize()
                launches = {k: n for k, n in K.launches.items() if n}
                want = {k: n * len(batches)
                        for k, n in BF16_EVAL2_LAUNCHES_PER_BATCH[leaves].items()}
                want["batch_norm.bf16"] = (bn_per_batch - S2_PRELU_PER_FORWARD) * len(batches)
                want["batch_norm.bf16@prelu"] = S2_PRELU_PER_FORWARD * len(batches)
                if launches != want:
                    failures.append(f"bf16 stage 2 {leaves}: launched {launches}, want {want}")
                slopes = sorted({str(m.weight.dtype)[6:] for m in model.modules()
                                 if isinstance(m, PReLU)})
                if slopes != [slope_dt]:
                    failures.append(f"bf16 stage 2 {leaves}: PReLU slopes {slopes}, want "
                                    f"{slope_dt}")
                maps = model.response_maps(image, ids)
                if not (maps.dtype == torch.bfloat16 and tuple(maps.shape) == (B, S, SIZE, SIZE)
                        and bool(torch.isfinite(maps).all())):
                    failures.append(f"bf16 stage 2 {leaves}: maps {maps.dtype} "
                                    f"{tuple(maps.shape)}, finite {bool(torch.isfinite(maps).all())}")
                maps_d = route_distances(K, f"bf16 stage 2 {leaves} maps", failures,
                                         lambda: model.response_maps(image, ids), maps, maps32)
                if not all(0.0 <= res[k] <= 100.0 for k in ("mIoU", "oIoU", "hit", "hitm")):
                    failures.append(f"bf16 stage 2 {leaves}: metrics out of range: {res}")
                times = {"bf16": [], "f32": []}
                for _ in range(ROUNDS):
                    for route, m in (("bf16", model), ("f32", model32)):
                        times[route].append(host_ms(lambda: validate(
                            m, loader, with_boxes=False, log=quiet)) / len(batches))
                summary[leaves] = {
                    "bf16_leaves": n_bf16, "launches": launches, "launches_expected": want,
                    "prelu_slope_dtypes": slopes,
                    "maps_bars": maps_d, "map_scale": float(maps32.abs().max()),
                    "metrics": {k: res[k] for k in ("mIoU", "oIoU", "hit", "hitm")},
                    "validate_host_ms_per_batch": {r: spread(t) for r, t in times.items()}}
                if leaves == "bf16_leaves":
                    # the demo's compute on the seeded bfloat16 model
                    demo.demo_cam(model, img_path, DEMO_TEXT)  # warm-up
                    torch.cuda.synchronize()
                    K.reset_launches()
                    cam = demo.demo_cam(model, img_path, DEMO_TEXT)
                    torch.cuda.synchronize()
                    demo_launches = {k: n for k, n in K.launches.items() if n}
                    # one forward: the float image takes no u8 feed, the map no K4
                    demo_want = {"mha_short.bf16": 12, "pixel_attn.bf16": 3,
                                 "bilinear_resize.bf16": 4,
                                 "batch_norm.bf16": bn_per_batch - S2_PRELU_PER_FORWARD,
                                 "batch_norm.bf16@prelu": S2_PRELU_PER_FORWARD}
                    if demo_launches != demo_want:
                        failures.append(f"bf16 demo: launched {demo_launches}, want {demo_want}")
                    cam_d = route_distances(
                        K, "bf16 demo norm_cam", failures,
                        lambda: torch.from_numpy(demo.demo_cam(model, img_path, DEMO_TEXT)),
                        torch.from_numpy(cam), torch.from_numpy(cam32))
                    summary["demo"] = {"size": [h, w], "text": DEMO_TEXT,
                                       "launches": demo_launches,
                                       "norm_cam_bars": cam_d,
                                       "positive_share": float((cam > 0).mean()),
                                       "host_ms": {"bf16": host_ms(lambda: demo.demo_cam(
                                           model, img_path, DEMO_TEXT)),
                                           "f32": host_ms(lambda: demo.demo_cam(
                                               model32, img_path, DEMO_TEXT))}}
                    if cam.shape != (h, w) or not np.isfinite(cam).all() or not cam.max() > 0:
                        failures.append(f"bf16 demo: want a finite, nonzero [{h}, {w}] norm_cam, "
                                        f"got {cam.shape}, max {cam.max()}")
                    summary["demo"]["launches_expected"] = demo_want
                del model
                torch.cuda.empty_cache()
    summary["f32"] = {"metrics": {k: res32[k] for k in ("mIoU", "oIoU", "hit", "hitm")}}
    summary["model"] = ("RN50 stage 2 in bfloat16 (text 512 x 12, 20 tokens, 320 px), seeded "
                        "(seed 0) or the float32 model's weights loaded; final_seg1's last conv "
                        f"negated: {negate}")
    del model32
    torch.cuda.empty_cache()
    log(f"bf16 stage 2: {json.dumps(summary)}")
    return summary, failures


def run_cli(args, timeout):
    """``python -m <args>`` from the checkout's root: (seconds, return code,
    its output)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=timeout)
    return time.perf_counter() - t0, out.returncode, out.stdout + out.stderr


def cli_chain():
    """The user's chain on a small fake RefCOCO tree, each step a CLI in its
    own process on the card: ``cli.train_stage1`` (one epoch), ``cli.validate
    --prms --save_cam`` on its best checkpoint, ``cli.irnet`` with all three
    passes (CRF ir labels, IRN training at crop 512 and radius 10, the
    instance pseudo-masks), ``cli.train_stage2 --model_ema`` (one epoch) on
    those pseudo-masks and ``cli.validate --stage 2`` on its best
    checkpoint, then ``cli.validate --stage 2 --bf16`` on the same checkpoint
    (after ``cli.validate --prms --bf16`` on stage 1's). Checks the files each
    leaves. The tree is the
    test suite's fixture (``tests/fixtures.py``, numpy and PIL only),
    loaded from its file: another installed package may be named
    ``tests``."""
    import importlib.util

    from PIL import Image

    spec = importlib.util.spec_from_file_location("fixtures", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)

    failures, secs = [], {}
    tmp = tempfile.TemporaryDirectory()
    with tmp:
        data, out = os.path.join(tmp.name, "data"), os.path.join(tmp.name, "out")
        fixtures.make_fake_refcoco(data, n_images=6, img_hw=(48, 64))
        common = ["--dataset", "refcoco", "--splitBy", "unc", "--refer_data_root", data,
                  "--size", "320"]
        cam, names = os.path.join(out, "cam"), os.path.join(out, "names")
        steps = [
            ("train_stage1", ["tris_tpu_torch.cli.train_stage1", *common, "--batch_size", "4",
                              "--negative_samples", "2", "--epoch", "1", "--test_split", "val",
                              "--output", out, "--print-freq", "1", "--eval_batch", "2",
                              "--fast_eval"]),
            ("validate_prms", ["tris_tpu_torch.cli.validate", *common, "--test_split", "train",
                               "--prms", "--save_cam", "--cam_save_dir", cam, "--name_save_dir",
                               names, "--eval_batch", "2", "--pretrain",
                               os.path.join(out, "ckpt_320_epoch_0_best.pth")]),
            ("validate_prms_bf16", ["tris_tpu_torch.cli.validate", *common, "--test_split",
                                    "train", "--prms", "--bf16", "--eval_batch", "2",
                                    "--pretrain",
                                    os.path.join(out, "ckpt_320_epoch_0_best.pth")]),
            ("irnet", ["tris_tpu_torch.cli.irnet", "--train_list",
                       os.path.join(names, "refcoco_train_names.json"), "--data_root",
                       os.path.join(data, "train2014"), "--cam_dir", cam, "--ir_label_out_dir",
                       os.path.join(out, "ir_label"), "--ins_seg_out_dir",
                       os.path.join(out, "ins_seg"), "--irn_weights",
                       os.path.join(out, "res50_irn.pth"), "--irn_batch_size", "2",
                       "--irn_num_epoches", "1", "--num_workers", "2", "--cam_to_ir_label_pass",
                       "--train_irn_pass", "--make_ins_seg_pass"]),
            ("train_stage2", ["tris_tpu_torch.cli.train_stage2", *common, "--pseudo_path",
                              os.path.join(out, "ins_seg"), "--batch_size", "2", "--epoch", "1",
                              "--test_split", "val", "--output", os.path.join(out, "stage2"),
                              "--print-freq", "1", "--eval_batch", "2", "--model_ema",
                              "--fast_eval"]),
            ("validate_stage2", ["tris_tpu_torch.cli.validate", *common, "--test_split", "val",
                                 "--stage", "2", "--eval_batch", "2", "--fast_eval", "--pretrain",
                                 os.path.join(out, "stage2", "ckpt_320_epoch_0_best.pth")]),
            ("validate_stage2_bf16", ["tris_tpu_torch.cli.validate", *common, "--test_split",
                                      "val", "--stage", "2", "--bf16", "--eval_batch", "2",
                                      "--fast_eval", "--pretrain",
                                      os.path.join(out, "stage2", "ckpt_320_epoch_0_best.pth")]),
        ]
        logs = {}
        for name, args in steps:
            secs[name], rc, logs[name] = run_cli(args, 600)
            if rc != 0:
                failures.append(f"chain: {name} exited {rc}: {logs[name][-2000:]}")
                break
        # stage 2 read the masks cli.irnet wrote, and validate --stage 2 ran
        read_pseudo = f"pseudo-masks from {os.path.join(out, 'ins_seg')}:" in logs.get(
            "train_stage2", "")
        s2_files = {f: os.path.getsize(os.path.join(out, "stage2", f)) for f in sorted(
            os.listdir(os.path.join(out, "stage2")))} if os.path.isdir(
            os.path.join(out, "stage2")) else {}
        s2_val = [ln for ln in logs.get("validate_stage2", "").splitlines() if "[val]" in ln]
        s2_bf16_val = [ln for ln in logs.get("validate_stage2_bf16", "").splitlines()
                       if "[val]" in ln]
        if not s2_bf16_val:
            failures.append("chain: validate --stage 2 --bf16 logged no [val] line")
        bf16_val = [ln for ln in logs.get("validate_prms_bf16", "").splitlines()
                    if "[train]" in ln]
        if not bf16_val:
            failures.append("chain: validate --prms --bf16 logged no [train] line")
        if not (read_pseudo and set(s2_files) == {"ckpt_320_epoch_0_best.pth",
                                                  "ckpt_320_epoch_0_hit.pth"} and s2_val):
            failures.append(f"chain: stage 2 read the pseudo-masks {read_pseudo}, left "
                            f"{s2_files}, validate --stage 2 logged {s2_val}")
        files = {d: sorted(os.listdir(os.path.join(out, d))) if os.path.isdir(
            os.path.join(out, d)) else [] for d in ("cam", "ir_label", "ins_seg")}
        n = len(files["cam"])
        values = set()
        for f in files["ir_label"]:
            values |= {int(v) for v in np.unique(np.asarray(Image.open(
                os.path.join(out, "ir_label", f))))}
        dicts_ok = all(sorted(np.load(os.path.join(out, "ins_seg", f), allow_pickle=True).item())
                       == ["cam", "class", "mask", "score"] for f in files["ins_seg"])
        pth = os.path.isfile(os.path.join(out, "res50_irn.pth"))
        if not (n > 0 and len(files["ir_label"]) == n and len(files["ins_seg"]) == n
                and values <= {0, 1, 255} and dicts_ok and pth):
            failures.append(f"chain: files {files}, ir label values {sorted(values)}, "
                            f"dicts ok {dicts_ok}, .pth {pth}")
    summary = {"seconds": secs, "cams": n, "ir_labels": len(files["ir_label"]),
               "ins_seg_dicts": len(files["ins_seg"]), "ir_label_values": sorted(values),
               "irn_weights_written": pth, "stage2_read_pseudo_masks": read_pseudo,
               "stage2_files_bytes": s2_files, "validate_stage2_log": s2_val[-1:],
               "validate_prms_bf16_log": bf16_val[-1:],
               "validate_stage2_bf16_log": s2_bf16_val[-1:]}
    log(f"chain: {json.dumps(summary)}")
    return summary, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Drive the PyTorch port of TRIS on one GPU.")
    p.add_argument("--report", default=None, help="write a fuller JSON report here")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the port on the card",
              file=sys.stderr)
        return 2
    try:
        from tris_tpu_torch import kernels as K
        from tris_tpu_torch.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2

    # 1. device
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {kind} | count {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvidia-smi: {smi}")

    # 2. build
    build_s = K.build_all()
    log(f"build: {len(K.KERNELS)} kernels in {build_s:.1f} s")

    # 3. kernels
    rows, failures = check_kernels(K, dev)
    train_rows, train_extra, train_failures = check_train_kernels(K, dev)
    failures += train_failures
    for r in rows:
        if r["name"] in train_extra:
            r["shapes"].append(train_extra[r["name"]])
    rows[1:1] = [r for r in train_rows if r["name"] == "mha_short_bwd"]
    rows += [r for r in train_rows if r["name"] != "mha_short_bwd"]
    ins_rows, ins_failures = check_ins_seg_kernels(K, dev)
    rows += ins_rows
    failures += ins_failures
    irn_rows, irn_extra, irn_failures = check_irn_train_kernels(K, dev)
    for r in rows:
        r["shapes"] += irn_extra.get(r["name"], [])
    rows += irn_rows
    failures += irn_failures
    stage2_init = build_stage2(dev)
    s2_rows, k6_rows, k6_bwd_rows, s2_failures = check_stage2_kernels(K, dev, stage2_init)
    for r in rows:
        if r["name"] in ("bilinear_resize", "bilinear_resize_bwd"):
            r["shapes"] += k6_rows if r["name"] == "bilinear_resize" else k6_bwd_rows
    rows += s2_rows
    failures += s2_failures
    bn_rows, bn_plans, bn_failures = check_batch_norm_kernels(K, dev)
    rows += bn_rows
    failures += bn_failures
    bf16_rows, bf16_kernel_failures = check_bf16_kernels(K, dev)
    rows += bf16_rows
    failures += bf16_kernel_failures
    bf16_train_rows, bf16_train_extra, bf16_train_kernel_failures = check_bf16_train_kernels(K, dev)
    for r in rows:
        r["shapes"] += bf16_train_extra.get(r["name"], [])
    rows += bf16_train_rows
    failures += bf16_train_kernel_failures
    bf16_s2_rows, bf16_s2_kernel_failures = check_bf16_stage2_kernels(K, dev)
    rows += bf16_s2_rows
    failures += bf16_s2_kernel_failures

    # 4. stage-1 eval and 5. PRMS, on one stage-1 model and one set of batches
    model = build_stage1(dev)
    batches = make_eval_batches(N_EVAL_BATCHES, seed=1)
    stage1, stage1_failures = stage1_path(K, dev, model, batches)
    prms, prms_failures = prms_path(K, dev, model, batches)
    failures += stage1_failures + prms_failures
    del model
    torch.cuda.empty_cache()

    # 6. stage-1 train
    train, train_failures = train_path(K, dev, make_train_batches(N_TRAIN_BATCHES, seed=2))
    failures += train_failures
    torch.cuda.empty_cache()

    # 7. IRNet instance pseudo-masks
    ins_seg, ins_seg_failures = ins_seg_path(K, dev)
    failures += ins_seg_failures
    torch.cuda.empty_cache()

    # 8. IRN training (after IRNet's pass 1), then the user's chain from the CLIs
    irn, irn_failures = irn_train_path(K, dev)
    torch.cuda.empty_cache()
    chain, chain_failures = cli_chain()
    failures += irn_failures + chain_failures

    # 9. stage 2: training with the EMA teacher, then validate
    stage2, stage2_failures = stage2_path(K, dev, stage2_init, batches)
    failures += stage2_failures
    del stage2_init
    torch.cuda.empty_cache()

    # 10. ReferIt eval and the demo
    referit, referit_failures = referit_path(K, dev)
    failures += referit_failures
    torch.cuda.empty_cache()

    # 11. the native host library
    native_summary, native_failures = native_path()
    failures += native_failures

    # 12. data parallelism on one card: the group's kernels, then two ranks against one process
    dp_rows, dp_kernel_failures = check_dp_kernels(K, dev)
    for r in rows:
        if r["name"] in dp_rows:
            r["shapes"].append(dp_rows[r["name"]])
    torch.cuda.empty_cache()
    dp, dp_failures = dp_path()
    failures += dp_kernel_failures + dp_failures

    # 13. --bf16: stage-1 eval and PRMS in bfloat16, both leaf regimes
    bf16, bf16_failures = bf16_path(K, dev, batches)
    failures += bf16_failures

    # 14. --bf16: stage-1 training in bfloat16, three leaf regimes
    bf16_train, bf16_train_failures = bf16_train_path(K, dev,
                                                      make_train_batches(N_TRAIN_BATCHES, seed=2))
    failures += bf16_train_failures
    torch.cuda.empty_cache()

    # 15. --bf16: stage-2 eval and the demo in bfloat16, both leaf regimes
    bf16_s2, bf16_s2_failures = bf16_stage2_path(K, dev, batches)
    failures += bf16_s2_failures

    # launches: on the stage-1 train path for its kernels (all but K3's eval
    # half and K4), else on the PRMS path, else on the ins-seg path, else on
    # the IRN training path, else on the stage-2 train path, else on the bfloat16
    # paths (phases 14, 13, 15); per path beside
    by_shape = prms["mha_short_launches_by_shape"]
    for row in rows:
        name = row["name"]
        paths = {"stage1_eval": stage1["launches"][name], "prms": prms["launches"][name],
                 "stage1_train": train["launches"][name], "ins_seg": ins_seg["launches"][name],
                 "irn_train": irn["launches"][name], "stage2_train": stage2["launches"][name],
                 "stage2_eval": stage2["eval"]["launches"][name],
                 "referit": referit["launches"][name],
                 **{f"dp_{job}_rank0": dp.get(job, {}).get("launches", {}).get(name, 0)
                    for job in ("stage1", "stage2", "irn")},
                 **{f"bf16_{leaves}": bf16[leaves]["launches"].get(name, 0)
                    for leaves in ("bf16_leaves", "f32_leaves")},
                 **{f"bf16_train_{regime}": bf16_train[regime]["launches"].get(name, 0)
                    for regime in ("seeded", "pretrain", "clip")},
                 **{f"bf16_stage2_{leaves}": bf16_s2[leaves]["launches"].get(name, 0)
                    for leaves in ("bf16_leaves", "f32_leaves")},
                 "bf16_demo": bf16_s2["demo"]["launches"].get(name, 0)}
        row["launches"] = (paths["stage1_train"] or paths["prms"] or paths["ins_seg"]
                           or paths["irn_train"] or paths["stage2_train"]
                           or paths["bf16_train_seeded"] or paths["bf16_bf16_leaves"]
                           or paths["bf16_stage2_bf16_leaves"])
        row["launches_by_path"] = paths
        for sub in row["shapes"]:
            if name == "mha_short":
                sub["launches_prms"] = by_shape.get("x".join(map(str, sub["shape"][:3])), 0)
    rows[0]["launches_prms_at_this_shape"] = by_shape.get(f"{B * S}x{TXT_LEN}x512", 0)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s,
                       "kernels": rows, "batch_norm_plans": bn_plans,
                       "stage1_eval": stage1, "prms": prms,
                       "stage1_train": train, "ins_seg": ins_seg, "irn_train": irn,
                       "chain": chain, "stage2": stage2, "referit": referit,
                       "native": native_summary, "dp": dp, "bf16": bf16,
                       "bf16_train": bf16_train, "bf16_stage2": bf16_s2}, f, indent=1,
                      default=str)
    if failures:
        fail("; ".join(failures))

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
