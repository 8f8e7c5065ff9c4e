#!/usr/bin/env python3
"""Drive the PyTorch port of TRIS (``tris_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Phases, in order; an error stops the run,
and a failed check of phases 3-5 exits 1 once all have run (so the report
holds every number):

1. device  - the card's name and ``nvidia-smi`` name / power limit;
2. build   - the six hand-written kernels from
             ``tris_tpu_torch/kernels/csrc`` (``torch.utils.cpp_extension``,
             ``nvcc``, ``sm_90a``);
3. kernels - each kernel against its plain PyTorch version on the card at
             the main paths' shapes (K1 at the text towers', the ViT
             critic's and attnpool's; K4 at stage-1 eval's and on PRMS's
             selected maps), with its stated tolerance; device times of
             kernel, plain version and, where one exists, the one PyTorch
             call computing the same thing; the least time the card could
             take (bytes or FP32 operations over the published peak);
4. stage-1 eval - RN50 stage 1 at full width (hidden 1024, 20 tokens,
             320 px, B=8 refs x S=4 sentences, seeded random weights):
             ``response_maps``, ``forward(train=False)`` and
             ``validate(with_boxes=False)`` over a synthetic in-memory u8
             loader, with every kernel launch counter set to 0 just before
             and read just after; then the same three with the models routed
             to the plain versions, which the outputs must agree with; then
             host step times of both routes, alternating, over ``ROUNDS``;
5. PRMS    - the same stage 1 plus the ViT-B/32 critic at full width
             (224 px, patch 32, width 768 x 12 layers; text 512 x 12;
             seeded random weights): ``validate_prms(save_cam=True)`` into a
             temporary directory and ``validate_prms()`` with the counters
             set to 0 just before and read just after; then both, and
             ``make_prms_forward`` on every batch, with the plain versions,
             which scores, best maps, metrics and dumped maps must agree
             with; then ``validate_prms`` per batch for both routes,
             alternating, over ``ROUNDS``.

Prints the kernels line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. ``--report`` writes a fuller JSON report
(every number). Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
# H100 SXM published peaks: HBM3 bytes/s and FP32 (non-tensor-core) FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
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


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: bytes over the memory rate or
    FP32 operations over the FP32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


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

    def measure(name, err, tol, ms, plain_ms, nbytes, flops, library_ms, **extra):
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"name": name, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, **extra}
        log(f"kernel {name}: max_abs_err {err:.3g} (tol {tol:g}) ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {library_ms}")
        if not err <= tol:
            failures.append(f"{name}: max_abs_err {err} > {tol}")
        return row

    def kernel_row(name, source, replaces, row, shapes=()):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, **{k: v for k, v in row.items() if k != "name"},
                "shapes": list(shapes)}

    def sdpa(q, k, v, H, mask):
        n, l, c = q.shape
        heads = [x.view(n, x.shape[1], H, c // H).transpose(1, 2) for x in (q, k, v)]
        return F.scaled_dot_product_attention(*heads, attn_mask=mask)

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
                       shape=[N, L, C, H], causal=causal, max_abs_err_f64=err64)

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
    rows.append(kernel_row(
        "cross_attn", "tris_tpu_torch/kernels/csrc/cross_attn.cu", "tris_tpu/models/fusion.py:78",
        measure("cross_attn", err, 1e-4,
                device_ms(lambda: K.cross_attn(*args)), device_ms(lambda: K.cross_attn_plain(*args)),
                4 * (3 * B * hw * m + 3 * P * m + P * hw * m + P * m),
                2 * 2 * P * hw * 1 * m * 2, None, shape=[B, S, hw, m, 1],
                t1_exactly_vt=exact_vt)))

    # K3 at response_maps' shape: 32 pairs, D = 1024, 10x10 -> 320x320
    D = 1024
    vis_base = F.normalize(randn(B, hw, D), dim=-1)
    vis_new = randn(P, hw, D)
    lan = F.normalize(randn(P, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    hs = SIZE // 32
    args = (vis_new, vis_base, lan, S, scale, 0.1, (hs, hs), (SIZE, SIZE))
    err = max_err(K.response_head(*args), K.response_head_plain(*args))
    rows.append(kernel_row(
        "response_head", "tris_tpu_torch/kernels/csrc/response_head.cu",
        "tris_tpu/models/stage1.py:158",
        measure("response_head", err, 1e-4,
                device_ms(lambda: K.response_head(*args)),
                device_ms(lambda: K.response_head_plain(*args)),
                4 * (P * hw * D + B * hw * D + P * D + P * SIZE * SIZE),
                P * hw * D * 4 + P * SIZE * SIZE * 7, None, shape=[B, S, hw, D, SIZE])))

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
        # exact: the kernel samples with the plain version's taps in its order
        cams = torch.relu(randn(B, n_maps, SIZE, SIZE))
        got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
        err = max_err(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
        err_norm = max_err(K.eval_metrics(cams, tables, want_norm=True),
                           K.eval_metrics_plain(cams, tables, want_norm=True))
        if not err_norm <= 1e-6:
            failures.append(f"{name} (normalised maps): max_abs_err {err_norm} > 1e-6")
        return measure(name, err, 0.0,
                       device_ms(lambda: K.eval_metrics(cams, tables, tgt, boxes)),
                       device_ms(lambda: K.eval_metrics_plain(cams, tables, tgt, boxes)),
                       4 * B * n_maps * SIZE * SIZE + n_valid + 4 * B * n_maps * 4
                       + 16 * B * (640 + 640),
                       n_maps * n_valid * 2 * 6 + n_maps * n_valid * 4, None,
                       shape=[B, n_maps, SIZE, 640, 640], norm_max_abs_err=err_norm,
                       norm_tol=1e-6)

    rows.append(kernel_row(
        "eval_metrics", "tris_tpu_torch/kernels/csrc/eval_metrics.cu",
        "tris_tpu/eval/validate.py:102", metrics("eval_metrics", S),
        [metrics("eval_metrics@prms", 1)]))

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
def plain_kernels(K):
    """Route the models' kernel calls to the plain versions, for comparison."""
    plain = {"mha_short": K.mha_short_plain, "cross_attn": K.cross_attn_plain,
             "response_head": K.response_head_plain, "eval_metrics": K.eval_metrics_plain,
             "critic_input": K.critic_input_plain, "normalize_u8_nchw": K.normalize_u8_nchw_plain}
    saved = {name: getattr(K, name) for name in plain}
    for name, fn in plain.items():
        setattr(K, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


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
            for route, ctx in (("kernels", contextlib.nullcontext), ("plain", lambda: plain_kernels(K))):
                with ctx():
                    for k, fn in steps.items():
                        times[route][k].append(host_ms(fn) / per[k])

    failures = [f"stage-1 eval: {name} launched no time" for name, n in launches.items()
                if n == 0 and name != "critic_input"]
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
            for route, ctx in (("kernels", contextlib.nullcontext), ("plain", lambda: plain_kernels(K))):
                with ctx():
                    times[route].append(host_ms(lambda: validate_prms(model, critic, loader, log=quiet))
                                        / len(batches))

        failures += [f"PRMS: {name} launched no time" for name, n in launches.items() if n == 0]
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

    # 4. stage-1 eval and 5. PRMS, on one stage-1 model and one set of batches
    model = build_stage1(dev)
    batches = make_eval_batches(N_EVAL_BATCHES, seed=1)
    stage1, stage1_failures = stage1_path(K, dev, model, batches)
    prms, prms_failures = prms_path(K, dev, model, batches)
    failures += stage1_failures + prms_failures
    # launches: on the PRMS path, the one that runs all six; per path beside
    by_shape = prms["mha_short_launches_by_shape"]
    for row in rows:
        row["launches"] = prms["launches"][row["name"]]
        row["launches_by_path"] = {"stage1_eval": stage1["launches"][row["name"]],
                                   "prms": prms["launches"][row["name"]]}
        for sub in row["shapes"]:
            sub["launches_prms"] = (by_shape.get("x".join(map(str, sub["shape"][:3])), 0)
                                    if row["name"] == "mha_short" else row["launches"])
    rows[0]["launches_prms_at_this_shape"] = by_shape.get(f"{B * S}x{TXT_LEN}x512", 0)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s,
                       "kernels": rows, "stage1_eval": stage1, "prms": prms}, f, indent=1)
    if failures:
        fail("; ".join(failures))

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
