"""Times K6's bilinear backward at the ten shapes of the IRN and stage-2
training steps (group ``k6_bwd``), K3's eval head at the stage-1 eval batch's
shape (``k3_eval``), K3's training head, forward and backward, and K5's
backward at the stage-1 train step's (``k3_train``, ``k5_bwd``), K9 on
the 120 x 160 grid of a 480 x 640 image (``k9``) and K7's forward at radius
5 on that image's padded edge map and at radius 10 on IRN training's batch
(``k7_fwd``), in the checkout at
``--root``: its kernels, timed by its own ``chip_smoke.py``
(``resize_bwd_row``, ``measure_row``, ``device_ms``, ``bwd_ms``), so that two
commits are timed in one call on one card, in turns (parent, change, change,
parent).

    python tris_tpu_torch/tools/kernel_ab.py --root PATH --tag NAME \
        [--groups k6_bwd,k3_eval,k3_train,k5_bwd,k9,k7_fwd] [--out FILE] [--save DIR]

Each row holds the kernel against its plain version at chip_smoke's bars
(K6's and K5's backward 1e-5 of the gradient's scale, K3's eval head 1e-4,
its training head 1e-5 of the outputs' scale forward and 1e-4 of the
gradients' backward, K9 and K7 exact). K3's training rows, K5's backward, K9
and K7's forward also
give each launch of a call apart (from ``torch.profiler``, by position in the
call: ``launches``), K9 on chip_smoke's smooth field and on a two-cycle field
that never settles (every step taken), with the steps its warps took where
the checkout's kernel counts them; K3's training rows, as a yardstick of the
score product alone, ``torch.bmm`` of [48, 100, 1024] by [48, 1024, 48] in
full float32 (``bmm_score_ms``); K7's rows, where the checkout plans its
forward, the plan, the launch and, at radius 5, the tiled kernel at each
count of direction groups (``groups_ms``). With ``--save``, the gradients at
IRNet's dp6 tap and stage 2's x16 head, K3's eval maps, its training head's
outputs and gradients, K5's gradient, K9's centroids and K7's affinities, on
the same seeded inputs in
every checkout, go to ``DIR/<tag>.pt``, and each file of another tag already
there is compared with them bit for bit. Prints one JSON line (``--out`` also
writes it). Needs a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

# (name, x's shape, the output size): IRN training's six upsamples (B = 24, crop 512) and
# stage 2's decoder taps and heads (B = 48, 320 px)
K6_SHAPES = [("dp6", (24, 256, 64, 64), (128, 128)),
             ("dp4_dp5", (24, 256, 32, 32), (64, 64)),
             ("edge_e3", (24, 32, 64, 64), (128, 128)),
             ("edge_e4_e5", (24, 32, 32, 32), (128, 128)),
             ("dec_x2_c4", (48, 256, 10, 10), (20, 20)),
             ("dec_x2_c3", (48, 128, 20, 20), (40, 40)),
             ("dec_x2_c2", (48, 64, 40, 40), (80, 80)),
             ("head_x4", (48, 1, 80, 80), (320, 320)),
             ("head_x8", (48, 1, 40, 40), (320, 320)),
             ("head_x16", (48, 1, 20, 20), (320, 320))]
SAVED = ("dp6", "head_x16")
GROUPS = ("k6_bwd", "k3_eval", "k3_train", "k5_bwd", "k9", "k7_fwd")


def launch_times(fn, n: int = 10) -> list:
    """Card ms of each kernel one ``fn()`` launches, in launch order, the
    mean over ``n`` calls traced by ``torch.profiler``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not evs or len(evs) % n:
        return [{"error": f"{len(evs)} device events over {n} calls"}]
    k = len(evs) // n
    out = []
    for i in range(k):
        calls = evs[i::k]
        name = re.search(r"(\w+_kernel)", calls[0].name)
        out.append({"name": name.group(1) if name else calls[0].name[:60],
                    "ms": sum(e.time_range.elapsed_us() for e in calls) / n / 1e3})
    return out


def k3_train_rows(cs, K, randn, failures, outs) -> list:
    """K3's training head at the stage-1 train step's shape (chip_smoke's
    check_train_kernels): vis_p [48, 100, 1024], lan_p [48, 48, 1024] -> cls
    [48, 48] and maps [48, 320, 320], the loss's cotangents (cls and sig)."""
    import torch
    import torch.nn.functional as F

    B, hs, D, size = 48, 10, 1024, 320
    hw = hs * hs
    vis, lan = cs.leaves(F.normalize(randn(B, hw, D), dim=-1), F.normalize(randn(B, B, D), dim=-1))
    scale = torch.tensor(1 / 0.07, device=vis.device)
    args = (scale, (hs, hs), (size, size), 3.0, 0.01)
    with torch.no_grad():
        got, want = K.stage1_head(vis, lan, *args), K.stage1_head_plain(vis, lan, *args)
    out_scale = max(float(w.abs().max()) for w in want)
    err = max(cs.max_err(a, b) for a, b in zip(got, want))
    fwd = lambda: K.stage1_head(vis.detach(), lan.detach(), *args)  # noqa: E731
    torch.backends.cuda.matmul.allow_tf32 = False
    vd, ld = vis.detach(), lan.detach().transpose(1, 2)
    bmm_ms = cs.device_ms(lambda: torch.bmm(vd, ld))
    rows = [cs.measure_row(
        failures, "stage1_head", err, 1e-5 * max(out_scale, 1.0), cs.device_ms(fwd),
        cs.device_ms(lambda: K.stage1_head_plain(vis.detach(), lan.detach(), *args)),
        4 * (B * hw * D + B * B * D + B * B + B + 2 * B * size * size),
        2 * B * hw * B * D + 20 * B * hw * B + 20 * B * size * size, None,
        shape=[B, hw, B, D, size], launches=launch_times(fwd), bmm_score_ms=bmm_ms)]
    cot = [randn(B, B), None, None, randn(B, size, size)]
    kern = lambda v, l: K.stage1_head(v, l, *args)  # noqa: E731
    plain = lambda v, l: K.stage1_head_plain(v, l, *args)  # noqa: E731
    grads = cs.input_grads(kern, [vis, lan], cot)
    want_g = cs.input_grads(plain, [vis, lan], cot)
    g_scale = max(float(w.abs().max()) for w in want_g)
    outs_g, cs_g = cs._outs_cots(kern, [vis, lan], cot)
    rows.append(cs.measure_row(
        failures, "stage1_head_bwd", max(cs.max_err(a, b) for a, b in zip(grads, want_g)),
        1e-4 * max(g_scale, 1.0), cs.bwd_ms(kern, [vis, lan], cot),
        cs.bwd_ms(plain, [vis, lan], cot),
        4 * (2 * (B * hw * D + B * B * D) + B * B + B * hw * B + B * size * size),
        4 * B * hw * B * D + 30 * B * hw * B + 12 * B * size * size, None,
        shape=[B, hw, B, D, size],
        launches=launch_times(lambda: torch.autograd.grad(outs_g, [vis, lan], cs_g,
                                                          retain_graph=True)),
        bit_for_bit_run_to_run=all(bool(torch.equal(a, b)) for a, b in
                                   zip(grads, cs.input_grads(kern, [vis, lan], cot)))))
    names = ("cls_out", "relu_map", "sig_map", "d_vis", "d_lan")
    for k, t in zip(names, (*got[:1], *got[2:], *grads)):
        outs[f"stage1_head.{k}"] = t.cpu()
    return rows


def k5_bwd_row(cs, K, randn, failures, outs) -> dict:
    """K5's backward at the stage-1 train step's shape (chip_smoke's
    check_train_kernels): 48 sigmoid maps and images, 320 -> 224, patch 32 ->
    d cams [48, 320, 320]."""
    import torch

    B, size, n, ps = 48, 320, 224, 32
    (cams,) = cs.leaves(torch.sigmoid(randn(B, size, size)))
    image = randn(B, 3, size, size)
    cot = [randn(B * (n // ps) ** 2, 3 * ps * ps)]
    kern = lambda c: K.critic_input(c, image, 1, n, ps)  # noqa: E731
    plain = lambda c: K.critic_input_plain(c, image, 1, n, ps)  # noqa: E731
    got = cs.input_grads(kern, [cams], cot)[0]
    want = cs.input_grads(plain, [cams], cot)[0]
    outs_g, cots_g = cs._outs_cots(kern, [cams], cot)
    row = cs.measure_row(
        failures, "critic_input_bwd", cs.max_err(got, want),
        1e-5 * max(float(want.abs().max()), 1.0), cs.bwd_ms(kern, [cams], cot),
        cs.bwd_ms(plain, [cams], cot), 4 * (cot[0].numel() + image.numel() + cams.numel()),
        B * n * n * 3 * 8 + B * (n * size + size * size) * 4, None, shape=[B, size, n, ps],
        launches=launch_times(lambda: torch.autograd.grad(outs_g, [cams], cots_g,
                                                          retain_graph=True)),
        bit_for_bit_run_to_run=bool(torch.equal(got, cs.input_grads(kern, [cams], cot)[0])))
    outs["critic_input_bwd"] = got.cpu()
    return row


def k9_rows(cs, K, dev, failures, outs) -> list:
    """K9 on the 120 x 160 grid: chip_smoke's smooth field (check_ins_seg_kernels)
    and a two-cycle field (+1 on even columns, -1 on odd: no warp settles)."""
    import torch
    import torch.nn.functional as F

    gh, gw = 120, 160
    g = torch.Generator(device=dev).manual_seed(4)
    smooth = F.avg_pool2d(torch.randn(1, 2, gh + 8, gw + 8, generator=g, device=dev), 9, 1)[0] * 12
    cycle = torch.zeros(2, gh, gw, device=dev)
    cycle[1] = (torch.arange(gw, device=dev) % 2 == 0).float() * 2 - 1
    rows = []
    for name, field in (("smooth", smooth), ("two_cycle", cycle)):
        got = K.refine_centroids(field)
        extra = {}
        if hasattr(K, "refine_centroids_steps"):
            steps = K.refine_centroids_steps().cpu()
            extra = {"steps_max": int(steps.max()), "steps_mean": float(steps.float().mean())}
        rows.append(cs.measure_row(
            failures, f"refine_centroids@{name}",
            cs.max_err(got, K.refine_centroids_plain(field)), 0.0,
            cs.device_ms(lambda: K.refine_centroids(field)),
            cs.device_ms(lambda: K.refine_centroids_plain(field), n=3), 4 * 4 * gh * gw,
            300 * 30 * gh * gw, None, shape=[2, gh, gw],
            launches=launch_times(lambda: K.refine_centroids(field)), **extra))
        outs[f"refine_centroids@{name}"] = got.cpu()
    return rows


def k7_fwd_rows(cs, K, dev, failures, outs) -> list:
    """K7's forward as chip_smoke's check_ins_seg_kernels and check_irn_train_kernels
    hold it: radius 5 on the 480 x 640 image's bucket [128, 160] padded to [133, 170]
    -> [34, 129, 162], and radius 10 on IRN training's [24, 128, 128] -> [24, 152, 119,
    110]; exact."""
    import torch
    import torch.nn.functional as F

    from tris_tpu_torch.pseudo.indexing import PathIndex

    g = torch.Generator(device=dev).manual_seed(18)
    cases = (("r5", 5, F.pad(torch.rand(128, 160, generator=g, device=dev), (5, 5, 0, 5),
                             value=1.0)),
             ("r10", 10, torch.rand(24, 128, 128, generator=g, device=dev)))
    rows = []
    for name, radius, edge in cases:
        pi = PathIndex(radius, tuple(edge.shape[-2:]))
        paths, rf = pi.paths_by_length, pi.radius_floor
        steps = K.path_max.path_steps(paths)
        n_steps = sum(len(p) for p in steps)
        with torch.no_grad():
            got = K.path_max_affinity(edge, paths, rf)
            run = lambda: K.path_max_affinity(edge, paths, rf)  # noqa: E731
            plain = lambda: K.path_max_affinity_plain(edge, paths, rf)  # noqa: E731
            extra = {}
            if hasattr(K.path_max, "forward_plan"):
                flat = edge.reshape(-1, *edge.shape[-2:])
                extra["plan"] = K.path_max.forward_plan(flat.shape[0], *flat.shape[1:], rf,
                                                        len(steps), n_steps)
                run()
                extra["launch_shape"] = K.path_max.launch_shape()
                if radius == 5:
                    extra["groups_ms"] = {n: cs.device_ms(
                        lambda n=n: K.path_max.forward_kernel(flat, steps, rf, n))
                        for n in (1, 2, 4)}
            n_out = got.numel()
            rows.append(cs.measure_row(
                failures, f"path_max_affinity@{name}", cs.max_err(got, plain()), 0.0,
                cs.device_ms(run), cs.device_ms(plain, 3, 1), 4 * (edge.numel() + n_out),
                (n_steps + len(steps)) * n_out // len(steps), None,
                shape=[*edge.shape, *got.shape], path_steps=n_steps,
                launches=launch_times(run), **extra))
        outs[f"path_max_affinity@{name}"] = got.cpu()
        del got
        torch.cuda.empty_cache()
    return rows


def k3_eval_row(cs, K, randn, failures, rows, outs) -> None:
    """K3's eval head at response_maps' shape, as chip_smoke's check_kernels holds it: 8
    images x 4 pairs, D = 1024, 10 x 10 -> 320 x 320."""
    import torch
    import torch.nn.functional as F

    B, S, hs, D, size = 8, 4, 10, 1024, 320
    P, hw = B * S, hs * hs
    vis_base = F.normalize(randn(B, hw, D), dim=-1)
    vis_new = randn(P, hw, D)
    lan = F.normalize(randn(P, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=vis_base.device)
    head = (vis_new, vis_base, lan, S, scale, 0.1, (hs, hs), (size, size))
    outs["response_head"] = K.response_head(*head)
    rows.append(cs.measure_row(
        failures, "response_head",
        cs.max_err(outs["response_head"], K.response_head_plain(*head)), 1e-4,
        cs.device_ms(lambda: K.response_head(*head)),
        cs.device_ms(lambda: K.response_head_plain(*head)),
        4 * (P * hw * D + B * hw * D + P * D + P * size * size),
        P * hw * D * 4 + P * size * size * 7, None, shape=[B, S, hw, D, size]))
    outs["response_head"] = outs["response_head"].cpu()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="the checkout whose kernels are timed")
    p.add_argument("--tag", required=True, help="this run's name (its saved outputs' file)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--save", default=None, help="directory of the outputs compared bit for bit")
    p.add_argument("--groups", default=",".join(GROUPS),
                   help=f"the rows to time, comma-separated, of {GROUPS}")
    args = p.parse_args(argv)
    groups = args.groups.split(",")
    if not set(groups) <= set(GROUPS):
        raise SystemExit(f"kernel_ab: --groups {args.groups}: not all of {GROUPS}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device: this script times kernels on the card")
    import chip_smoke as cs
    from tris_tpu_torch import kernels as K

    if not os.path.abspath(K.__file__).startswith(root + os.sep):
        raise SystemExit(f"kernel_ab: imported {K.__file__}, not the checkout at {root}")
    build_s = K.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    failures, rows, outs = [], [], {}
    for name, shape, size in K6_SHAPES if "k6_bwd" in groups else ():
        x, cot = randn(*shape), randn(*shape[:-2], *size)
        rows.append(cs.resize_bwd_row(K, failures, f"bilinear_resize_bwd@{name}", x, cot))
        if name in SAVED:
            x = x.requires_grad_()
            outs[name] = torch.autograd.grad(K.bilinear_resize(x, size, False), x, cot)[0].cpu()
        del x, cot
        torch.cuda.empty_cache()

    if "k3_eval" in groups:
        k3_eval_row(cs, K, randn, failures, rows, outs)
    if "k3_train" in groups:
        rows += k3_train_rows(cs, K, randn, failures, outs)
    if "k5_bwd" in groups:
        rows.append(k5_bwd_row(cs, K, randn, failures, outs))
    if "k9" in groups:
        rows += k9_rows(cs, K, dev, failures, outs)
    if "k7_fwd" in groups:
        rows += k7_fwd_rows(cs, K, dev, failures, outs)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {"tag": args.tag, "root": root, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "build_s": build_s, "rows": rows, "failures": failures}
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        mine = os.path.join(args.save, f"{args.tag}.pt")
        result["bit_equal"] = {}
        for other in sorted(glob.glob(os.path.join(args.save, "*.pt"))):
            if other != mine:
                theirs = torch.load(other)
                result["bit_equal"][os.path.basename(other)[:-3]] = {
                    k: bool(torch.equal(v, theirs[k])) for k, v in outs.items() if k in theirs}
        torch.save(outs, mine)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
