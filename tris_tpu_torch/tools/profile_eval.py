"""Where the stage-1 eval forward, or the PRMS step, spends its time on the card.

    python -m tris_tpu_torch.tools.profile_eval [--prms] [--batch 8] [--sents 4] \\
        [--size 320] [--iters 5] [--out PATH]

Builds RN50 stage 1 at full width with seeded random weights (as
``chip_smoke.py`` does), times ``response_maps`` on the host clock (with
``--prms``: ``make_prms_forward``'s step, which adds the u8 upload and its
normalisation, and the ViT-B/32 critic with seeded random weights), then
traces ``--iters`` calls with ``torch.profiler`` and prints one JSON line:
wall ms per forward, the card's busy ms per forward (the sum of its kernels'
times; one stream, so they do not overlap) and its idle share, and the
device time by kernel class (the hand-written kernels by name, cuDNN
convolutions, GEMMs, everything else) and by kernel name; ``--out`` also
writes it to a file. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

HAND_KERNELS = ("mha_short_kernel", "vis_to_text_kernel", "text_to_vis_kernel",
                "response_head_kernel", "eval_metrics_kernel", "critic_input_kernel",
                "normalize_u8_kernel")


def kernel_class(name: str) -> str:
    for k in HAND_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "conv" in low or "cudnn" in low or "implicit" in low or "winograd" in low:
        return "convolution"
    if "gemm" in low or "cutlass" in low or "gemv" in low:
        return "gemm"
    return "other"


def main(argv=None) -> dict:
    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser
    from tris_tpu_torch.device import resolve_device
    from tris_tpu_torch.eval.validate import image_to_nchw, make_prms_forward
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prms", action="store_true", help="profile the PRMS step instead")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--sents", type=int, default=4)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = TRISStage1(Stage1Config(backbone="RN50", hidden_dim=1024, txt_length=20))
    model = model.to(dev).eval()
    rng = np.random.default_rng(0)
    image_u8 = rng.integers(0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8)
    ids = np.zeros((args.batch, args.sents, 20), np.int32)
    ids[..., 0], ids[..., 1:6], ids[..., 6] = 49406, rng.integers(1, 49000, 5), 49407
    if args.prms:
        forward = make_prms_forward(model, build_critic(get_parser().parse_args([]), dev))
        valid = np.ones((args.batch, args.sents), bool)
        step = lambda: forward(image_u8, ids, valid)  # noqa: E731
    else:
        image = image_to_nchw(torch.as_tensor(image_u8, device=dev))
        ids_d = torch.as_tensor(ids, device=dev)
        step = lambda: model.response_maps(image, ids_d)  # noqa: E731

    with torch.no_grad():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                step()
            torch.cuda.synchronize()

    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
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
        "step": "make_prms_forward" if args.prms else "response_maps",
        "shape": {"batch": args.batch, "sents": args.sents, "size": args.size},
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy,
        "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
        "kernel_launches_per_forward": sum(n for _, n in by_name.values()) / args.iters,
        "device_ms_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
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
