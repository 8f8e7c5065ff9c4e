#!/usr/bin/env python3
"""Drive the PyTorch port of TRIS (``tris_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Phases, in order; an error stops the run,
and a failed check of phase 3 or 4 exits 1 once both have run (so the
report holds every number):

1. device  - the card's name and ``nvidia-smi`` name / power limit;
2. build   - the four hand-written kernels from
             ``tris_tpu_torch/kernels/csrc`` (``torch.utils.cpp_extension``,
             ``nvcc``, ``sm_90a``);
3. kernels - each kernel against its plain PyTorch version on the card at
             the stage-1 eval path's shapes (K1 also at attnpool's), with its
             stated tolerance; device times of kernel, plain version and,
             where one exists, the one PyTorch call computing the same thing;
4. main    - RN50 stage 1 at full width (hidden 1024, 20 tokens, 320 px,
             B=8 refs x S=4 sentences, seeded random weights):
             ``response_maps``, ``forward(train=False)`` and
             ``validate(with_boxes=False)`` over a synthetic in-memory loader,
             with every kernel launch counter set to 0 just before and read
             just after; then the same three with the models routed to the
             plain versions, which the outputs must agree with; then host
             step times of both routes, alternating, over ``ROUNDS`` rounds.

Prints the kernels line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. ``--report`` writes a fuller JSON report
(every number). Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

B, S, SIZE, TXT_LEN = 8, 4, 320, 20
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
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.models.layers import causal_mask

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rows, failures = [], []

    def record(name, source, replaces, err, tol, ms, plain_ms, nbytes, flops, library_ms, **extra):
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": None, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, **extra}
        rows.append(row)
        log(f"kernel {name}: max_abs_err {err:.3g} (tol {tol:g}) ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {library_ms}")
        if not err <= tol:
            failures.append(f"{name}: max_abs_err {err} > {tol}")

    # K1 at the text tower's shape: N = B*S sequences, L = 20 causal, 8 heads
    # of 64, q/k/v read in place from one fused qkv tensor
    N, C, H = B * S, 512, 8
    qkv = randn(N, TXT_LEN, 3 * C)
    q, k, v = qkv.chunk(3, dim=-1)
    mask = causal_mask(TXT_LEN, device=dev)
    got = K.mha_short(q, k, v, H, mask)
    err = max_err(got, K.mha_short_plain(q, k, v, H, mask))
    # the plain einsums may round exactly as the kernel does; float64 shows
    # the kernel's own error
    err64 = max_err(got, K.mha_short_plain(q.double(), k.double(), v.double(), H, mask.double()))
    if not err64 <= 2e-5:
        failures.append(f"mha_short: max_abs_err vs float64 {err64} > 2e-5")

    def sdpa(q, k, v, H, mask):
        n, l, c = q.shape
        heads = [x.view(n, x.shape[1], H, c // H).transpose(1, 2) for x in (q, k, v)]
        return F.scaled_dot_product_attention(*heads, attn_mask=mask)

    # K1 at attnpool's shape (320 px: 10x10 + 1 tokens, 32 heads, no mask)
    Na, La, Ca, Ha = B, 101, 2048, 32
    qa, ka, va = randn(Na, La, Ca), randn(Na, La, Ca), randn(Na, La, Ca)
    err_a = max_err(K.mha_short(qa, ka, va, Ha), K.mha_short_plain(qa, ka, va, Ha))
    attnpool = {"shape": [Na, La, Ca, Ha], "max_abs_err": err_a, "tol": 2e-5,
                "ms": device_ms(lambda: K.mha_short(qa, ka, va, Ha)),
                "plain_ms": device_ms(lambda: K.mha_short_plain(qa, ka, va, Ha)),
                "library_ms": device_ms(lambda: sdpa(qa, ka, va, Ha, None))}
    if not err_a <= 2e-5:
        failures.append(f"mha_short@attnpool: max_abs_err {err_a} > 2e-5")
    log(f"kernel mha_short@attnpool: {json.dumps(attnpool)}")
    record("mha_short", "tris_tpu_torch/kernels/csrc/mha_short.cu", "tris_tpu/models/layers.py:25",
           err, 2e-5,
           device_ms(lambda: K.mha_short(q, k, v, H, mask)),
           device_ms(lambda: K.mha_short_plain(q, k, v, H, mask)),
           4 * (3 * N * TXT_LEN * C + TXT_LEN * TXT_LEN + N * TXT_LEN * C),
           4 * N * H * TXT_LEN * TXT_LEN * (C // H),
           device_ms(lambda: sdpa(q, k, v, H, mask)),
           shape=[N, TXT_LEN, C, H], max_abs_err_f64=err64, attnpool=attnpool)

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
    record("cross_attn", "tris_tpu_torch/kernels/csrc/cross_attn.cu",
           "tris_tpu/models/fusion.py:78", err, 1e-4,
           device_ms(lambda: K.cross_attn(*args)), device_ms(lambda: K.cross_attn_plain(*args)),
           4 * (3 * B * hw * m + 3 * P * m + P * hw * m + P * m),
           2 * 2 * P * hw * 1 * m * 2, None, shape=[B, S, hw, m, 1], t1_exactly_vt=exact_vt)

    # K3 at response_maps' shape: 32 pairs, D = 1024, 10x10 -> 320x320
    D = 1024
    vis_base = F.normalize(randn(B, hw, D), dim=-1)
    vis_new = randn(P, hw, D)
    lan = F.normalize(randn(P, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    hs = SIZE // 32
    args = (vis_new, vis_base, lan, S, scale, 0.1, (hs, hs), (SIZE, SIZE))
    err = max_err(K.response_head(*args), K.response_head_plain(*args))
    record("response_head", "tris_tpu_torch/kernels/csrc/response_head.cu",
           "tris_tpu/models/stage1.py:158", err, 1e-4,
           device_ms(lambda: K.response_head(*args)), device_ms(lambda: K.response_head_plain(*args)),
           4 * (P * hw * D + B * hw * D + P * D + P * SIZE * SIZE),
           P * hw * D * 4 + P * SIZE * SIZE * 7, None, shape=[B, S, hw, D, SIZE])

    # K4 at one eval batch's shape: [8, 4] relu maps of 320x320 to mixed
    # original sizes up to 640x640
    batch = make_eval_batches(1, seed=3)[0]
    cams = torch.relu(randn(B, S, SIZE, SIZE))
    sizes = [t.shape for t in batch["target"]]
    tables = K.eval_tables(SIZE, SIZE, sizes, (640, 640), dev)
    tgt = np.zeros((B, 640, 640), np.uint8)
    for b, t in enumerate(batch["target"]):
        tgt[b, :t.shape[0], :t.shape[1]] = t
    tgt = torch.as_tensor(tgt, device=dev)
    boxes = torch.as_tensor(np.stack(batch["bbox"]).astype(np.float32), device=dev)
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    want = torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes))
    err = max_err(got, want)
    err_norm = max_err(K.eval_metrics(cams, tables, want_norm=True),
                       K.eval_metrics_plain(cams, tables, want_norm=True))
    if not err_norm <= 1e-6:
        failures.append(f"eval_metrics (normalised maps): max_abs_err {err_norm} > 1e-6")
    n_valid = sum(h * w for h, w in sizes)
    record("eval_metrics", "tris_tpu_torch/kernels/csrc/eval_metrics.cu",
           "tris_tpu/eval/validate.py:102", err, 0.0,
           device_ms(lambda: K.eval_metrics(cams, tables, tgt, boxes)),
           device_ms(lambda: K.eval_metrics_plain(cams, tables, tgt, boxes)),
           4 * B * S * SIZE * SIZE + n_valid + 4 * B * S * 4 + 16 * B * (640 + 640),
           S * n_valid * 2 * 6 + S * n_valid * 4, None,
           shape=[B, S, SIZE, 640, 640], norm_max_abs_err=err_norm, norm_tol=1e-6)
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
             "response_head": K.response_head_plain, "eval_metrics": K.eval_metrics_plain}
    saved = {name: getattr(K, name) for name in plain}
    for name, fn in plain.items():
        setattr(K, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def main_path(K, dev):
    import torch

    from tris_tpu_torch.eval.validate import validate
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1
    from tris_tpu_torch.ops.normalize import image_input_to_f32

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TRISStage1(Stage1Config(backbone="RN50", hidden_dim=1024, txt_length=TXT_LEN))
    model = model.to(dev).eval()
    batches = make_eval_batches(N_EVAL_BATCHES, seed=1)
    loader = SyntheticEvalLoader(batches)
    image = image_input_to_f32(torch.as_tensor(batches[0]["image"], device=dev))
    image = image.permute(0, 3, 1, 2).contiguous()
    ids = torch.as_tensor(batches[0]["word_ids"], device=dev)
    quiet = lambda *a: None  # noqa: E731

    def run():
        return (model.response_maps(image, ids), model(image, ids[:, 0]),
                validate(model, loader, with_boxes=False, log=quiet))

    steps = {"response_maps": lambda: model.response_maps(image, ids),
             "forward": lambda: model(image, ids[:, 0]),
             "validate_per_batch": lambda: validate(model, loader, with_boxes=False, log=quiet)}
    per = {"response_maps": 1, "forward": 1, "validate_per_batch": N_EVAL_BATCHES}
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

    failures = [f"{name}: launched no time on the main path" for name, n in launches.items() if n == 0]
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
        "B": B, "S": S, "eval_batches": N_EVAL_BATCHES, "launches": launches,
        "host_ms": {route: {k: spread(t) for k, t in ts.items()} for route, ts in times.items()},
        "maps_max_abs_err": err_maps, "forward_max_abs_err": err_fwd, "maps_tol": tol_maps,
        "map_scale": scale, "metrics": res, "metrics_plain": res_p,
        "metrics_max_abs_diff": metric_err,
    }
    log(f"main path: {json.dumps(summary)}")
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

    # 4. main path
    summary, main_failures = main_path(K, dev)
    failures += main_failures
    for row in rows:
        row["launches"] = summary["launches"][row["name"]]
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s,
                       "kernels": rows, "main_path": summary}, f, indent=1)
    if failures:
        fail("; ".join(failures))

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
