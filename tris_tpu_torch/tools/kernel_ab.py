"""Times K6's bilinear backward at the ten shapes of the IRN and stage-2
training steps, and K3's eval head at the stage-1 eval batch's shape, in the
checkout at ``--root``: its kernels, timed by its own ``chip_smoke.py``
(``resize_bwd_row``, ``measure_row``, ``device_ms``), so that two commits are
timed in one call on one card, in turns (parent, change, change, parent).

    python tris_tpu_torch/tools/kernel_ab.py --root PATH --tag NAME [--out FILE] [--save DIR]

Each row holds the kernel against its plain version at chip_smoke's bars
(K6's backward 1e-5 of the gradient's scale, K3 1e-4). With ``--save``, the
gradients at IRNet's dp6 tap and stage 2's x16 head and K3's maps, on the
same seeded inputs in every checkout, go to ``DIR/<tag>.pt``, and each file
of another tag already there is compared with them bit for bit. Prints one
JSON line (``--out`` also writes it). Needs a card.
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="the checkout whose kernels are timed")
    p.add_argument("--tag", required=True, help="this run's name (its saved outputs' file)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--save", default=None, help="directory of the outputs compared bit for bit")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

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
    for name, shape, size in K6_SHAPES:
        x, cot = randn(*shape), randn(*shape[:-2], *size)
        rows.append(cs.resize_bwd_row(K, failures, f"bilinear_resize_bwd@{name}", x, cot))
        if name in SAVED:
            x = x.requires_grad_()
            outs[name] = torch.autograd.grad(K.bilinear_resize(x, size, False), x, cot)[0].cpu()
        del x, cot
        torch.cuda.empty_cache()

    # K3 at response_maps' shape, as chip_smoke's check_kernels holds it: 8 images x 4 pairs,
    # D = 1024, 10 x 10 -> 320 x 320
    B, S, hs, D, size = 8, 4, 10, 1024, 320
    P, hw = B * S, hs * hs
    vis_base = F.normalize(randn(B, hw, D), dim=-1)
    vis_new = randn(P, hw, D)
    lan = F.normalize(randn(P, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
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
