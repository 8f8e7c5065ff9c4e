"""Where K4's clusters spend a call, measured inside them on the card.

Builds ``csrc/eval_metrics.cu`` once more with ``nvcc -DTRIS_EVAL_STAMPS`` (a
shared library beside the extension's build, called through ctypes; the
extension itself never has the stamps), launches K4 as its launcher does
(the card's plan) on seeded relu maps at the main paths' shapes, and reads
the stamps thread 0 of every block wrote (``eval_metrics.cu``): per block
the band's t-rows formed, pass 1 and the block's max, the max exchange (the
cluster's barrier), the cuts, pass 2 (or the plane's writes) and the block's
reductions, and the partials' barrier, in ns (clock64 cycles scaled by each
block's %globaltimer lifetime); the call's span, the spread of the blocks'
starts (a second wave shows as a spread near a block's lifetime) and how
many clusters of the plan's blocks the card holds at once
(``cudaOccupancyMaxActiveClusters``). Needs a card and nvcc::

    python -m tris_tpu_torch.tools.eval_metrics_phases [--out FILE]

prints one JSON line per row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from tris_tpu_torch.kernels.eval_metrics import eval_tables

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "kernels" / "build" / "phases"
STAMPS = 9  # eval_metrics.cu's kEvalStamps
PHASES = ("t_rows", "pass1", "exchange", "cuts", "pass2", "final")
# COCO originals, 320 px maps padded to 640 x 640: (name, maps an image, normalised plane)
SIZES = [(640, 480), (427, 640), (480, 640), (640, 640), (375, 500), (612, 612), (333, 500),
         (640, 427)]
ROWS = (("eval_metrics", 4, False), ("eval_metrics@prms", 1, False),
        ("eval_metrics@norm", 1, True))
MAP, PAD = 320, 640

SHIM = r'''
#include "launchers.h"
extern "C" cudaError_t eval_set_stamps(unsigned long long*);
extern "C" int eval_resident_clusters(int ranks, int staged, long long smem);
extern "C" int eval_phases(const float* cams, int B, int S, int h, int w, int maxH, int maxW,
                           const int* const* y, const float* const* yw, const int* const* x,
                           const float* const* xw, const int* orig_hw,
                           const unsigned char* targets, const float* boxes, float* norm_out,
                           float* stats, unsigned long long* stamps, void* stream) {
  cudaError_t e = eval_set_stamps(stamps);
  tris::EvalMetricsLaunchShape shape;
  if (e == cudaSuccess)
    e = tris::eval_metrics(cams, B, S, h, w, maxH, maxW, y[0], y[1], yw[0], yw[1], x[0], x[1],
                           xw[0], xw[1], orig_hw, targets, boxes, norm_out, stats,
                           (cudaStream_t)stream, &shape);
  return (int)e;
}
extern "C" int eval_plan(int B, int S, int maxH, int maxW, int h, int w, long long* out) {
  const tris::EvalMetricsPlan p = tris::eval_metrics_device_plan(B, S, maxH, maxW, h, w);
  out[0] = p.ranks;
  out[1] = p.staged;
  out[2] = p.smem;
  out[3] = p.blocks;
  return eval_resident_clusters(p.ranks, p.staged, p.smem);
}
'''


def build() -> ctypes.CDLL:
    """The stamped kernel and its C entry points, compiled with nvcc."""
    BUILD.mkdir(parents=True, exist_ok=True)
    shim = BUILD / "eval_phases_shim.cu"
    shim.write_text(SHIM)
    lib = BUILD / "libeval_phases.so"
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    done = subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                           "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC",
                           "-DTRIS_EVAL_STAMPS", f"-I{CSRC}", "-o", str(lib),
                           str(CSRC / "eval_metrics.cu"), str(shim)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"eval_metrics_phases: nvcc failed:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.eval_phases.argtypes = [p, i, i, i, i, i, i] + [p] * 11
    so.eval_plan.argtypes = [i] * 6 + [p]
    return so


def phases(stamps: np.ndarray) -> dict:
    """The stamps of one call [blocks, STAMPS] summarised: each phase's ns, the median over the
    blocks (cycles scaled by each block's %globaltimer lifetime over its cycles), the span, the
    blocks' lifetime and the spread of their starts."""
    s = stamps.astype(np.float64)
    life_ns = s[:, 7] - s[:, 0]
    cycles = s[:, 1:7]
    ns_per_cycle = life_ns / np.maximum(cycles.sum(axis=1), 1)
    out = {f"{k}_ns": float(np.median(cycles[:, j] * ns_per_cycle)) for j, k in enumerate(PHASES)}
    out.update(blocks=int(len(s)), sms=int(len(np.unique(s[:, 8]))),
               span_ns=float(s[:, 7].max() - s[:, 0].min()),
               block_life_ns=float(np.median(life_ns)),
               start_spread_ns=float(s[:, 0].max() - s[:, 0].min()))
    return out


def _ptrs(ts):
    """A C array of the tensors' data pointers, and the array (kept alive by the caller)."""
    arr = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eval_metrics_phases: needs a CUDA device")
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = len(SIZES)
    tables = eval_tables(MAP, MAP, SIZES, (PAD, PAD), dev)
    tgt = torch.zeros(B, PAD, PAD, dtype=torch.uint8, device=dev)
    for b, (oh, ow) in enumerate(SIZES):
        tgt[b, :oh, :ow] = torch.rand(oh, ow, generator=gen, device=dev) > 0.5
    boxes = torch.tensor([[ow // 5, oh // 4, ow // 2, oh // 2] for oh, ow in SIZES],
                         dtype=torch.float32, device=dev)
    (ylo, yhi, wy0, wy1), (xlo, xhi, wx0, wx1) = tables["y"], tables["x"]
    (y, k1), (yw, k2) = _ptrs([ylo, yhi]), _ptrs([wy0, wy1])
    (x, k3), (xw, k4) = _ptrs([xlo, xhi]), _ptrs([wx0, wx1])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    results = []
    for name, S, norm in ROWS:
        cams = torch.relu(torch.randn(B, S, MAP, MAP, generator=gen, device=dev))
        plan = (ctypes.c_longlong * 4)()
        resident = so.eval_plan(B, S, PAD, PAD, MAP, MAP, ctypes.cast(plan, ctypes.c_void_p))
        ranks, staged, smem, blocks = list(plan)
        out = torch.empty(B, S, PAD, PAD, device=dev) if norm else torch.empty(B, S, 4, device=dev)
        stamps = torch.zeros(blocks * STAMPS, dtype=torch.int64, device=dev)
        rows = []
        for _ in range(5):
            stamps.zero_()  # a block that did not run keeps 0
            err = so.eval_phases(cams.data_ptr(), B, S, MAP, MAP, PAD, PAD, y, yw, x, xw,
                                 tables["orig_hw"].data_ptr(), None if norm else tgt.data_ptr(),
                                 None if norm else boxes.data_ptr(),
                                 out.data_ptr() if norm else None,
                                 None if norm else out.data_ptr(), stamps.data_ptr(), stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"eval_metrics_phases: {name} launch returned {err}")
            st = stamps.view(-1, STAMPS).cpu().numpy().view(np.uint64)
            rows.append(phases(st[st[:, 7] > 0]))
        row = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        row.update(name=name, shape=[B, S, MAP, PAD, PAD], ranks=ranks, staged=staged,
                   smem_bytes=smem, plan_blocks=blocks, resident_clusters=resident,
                   clusters=blocks // ranks, device=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
