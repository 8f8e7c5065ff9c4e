"""Where K13's fused kernels spend a call, measured inside them on the card.

Builds ``csrc/batch_norm.cu`` and ``batch_norm_bwd.cu`` once more with
``nvcc -DTRIS_BN_STAMPS`` (a shared library beside the extension's build,
called through ctypes; the extension itself never has the stamps), launches
the fused forward or backward on seeded inputs at the main paths' shapes,
and reads the stamps thread 0 of every block wrote (``batch_norm.cuh``):
per block the copies issued, its own samples summed (waiting for their
copies included), the channel's sums in (the cluster's barrier), the
combine, and every thread's writes issued, in ns (clock64 cycles scaled by
each block's %globaltimer lifetime); the call's span and how many blocks an
SM held on average.
Needs a card and nvcc::

    python -m tris_tpu_torch.tools.batch_norm_phases [--out FILE]

prints one JSON line per shape and direction.
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

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "kernels" / "build" / "phases"
STAMPS = 9  # batch_norm.cuh's kBnStamps
# (name, [N, C, H, W], residual) at the fused rows of chip_smoke.py's BN_ROWS, ReLU
SHAPES = (("layer1_tail", (48, 256, 80, 80), True), ("layer2_tail", (48, 512, 40, 40), True),
          ("layer3", (48, 1024, 20, 20), False), ("layer4_tail", (48, 2048, 10, 10), True),
          ("layer1", (48, 64, 80, 80), False))

SHIM = r'''
#include "launchers.h"
extern "C" cudaError_t bn_set_stamps_fwd(unsigned long long*);
extern "C" cudaError_t bn_set_stamps_bwd(unsigned long long*);
extern "C" int bn_phases_fwd(const float* x, const float* w, const float* b, const float* res,
                             float* y, float* stats, int N, int C, int HW, int act,
                             unsigned long long* stamps, void* stream) {
  const tris::BatchNormPlan plan = tris::batch_norm_device_plan(N, C, HW, true, false, act, -1);
  if (plan.design != tris::kBatchNormFused) return -1;
  cudaError_t e = bn_set_stamps_fwd(stamps);
  tris::BatchNormLaunchShape shapes[3];
  if (e == cudaSuccess)
    e = tris::batch_norm_forward(plan, x, w, b, res, nullptr, y, stats, nullptr, nullptr, nullptr,
                                 N, C, HW, act, 0.1, 1e-5, (cudaStream_t)stream, shapes);
  return (int)e;
}
extern "C" int bn_phases_bwd(const float* g, const float* x, const float* out, const float* mean,
                             const float* rstd, const float* w, const float* b, float* dw,
                             float* db, float* dx, float* dres, int N, int C, int HW, int act,
                             unsigned long long* stamps, void* stream) {
  const tris::BatchNormPlan plan = tris::batch_norm_device_plan(N, C, HW, true, true, act, -1);
  if (plan.design != tris::kBatchNormFused) return -1;
  cudaError_t e = bn_set_stamps_bwd(stamps);
  tris::BatchNormLaunchShape shapes[3];
  if (e == cudaSuccess)
    e = tris::batch_norm_bwd(plan, g, x, out, mean, rstd, w, b, nullptr, nullptr, nullptr, dw, db,
                             nullptr, dx, dres, N, C, HW, act, (cudaStream_t)stream, shapes);
  return (int)e;
}
'''


def build() -> ctypes.CDLL:
    """The stamped kernels and their C entry points, compiled with nvcc."""
    BUILD.mkdir(parents=True, exist_ok=True)
    shim = BUILD / "phases_shim.cu"
    shim.write_text(SHIM)
    lib = BUILD / "libbn_phases.so"
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    done = subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                           "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC",
                           "-DTRIS_BN_STAMPS", f"-I{CSRC}",
                           "-o", str(lib), str(CSRC / "batch_norm.cu"),
                           str(CSRC / "batch_norm_bwd.cu"), str(shim)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"batch_norm_phases: nvcc failed:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.bn_phases_fwd.argtypes = [p] * 6 + [i] * 4 + [p, p]
    so.bn_phases_bwd.argtypes = [p] * 11 + [i] * 4 + [p, p]
    return so


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def phases(stamps: np.ndarray) -> dict:
    """The stamps of one call [blocks, STAMPS] summarised: each phase's ns,
    averaged over the blocks (cycles scaled by each block's %globaltimer
    lifetime over its cycles), the span, the blocks' lifetime and how many
    blocks an SM held on average."""
    s = stamps.astype(np.float64)
    life_ns = s[:, 7] - s[:, 0]
    cycles = s[:, 2:7]
    ns_per_cycle = life_ns / np.maximum(cycles.sum(axis=1), 1)
    span = s[:, 7].max() - s[:, 0].min()
    names = ("issue", "own_sums", "cluster_wait", "combine", "writes")
    out = {f"{k}_ns": float(np.mean(cycles[:, j] * ns_per_cycle)) for j, k in enumerate(names)}
    sms = len(np.unique(s[:, 8]))
    out.update(blocks=int(len(s)), sms=sms, span_ns=float(span),
               block_life_ns=float(life_ns.mean()),
               blocks_per_sm=float(life_ns.sum() / span / sms))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("batch_norm_phases: needs a CUDA device")
    so = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, shape, residual in SHAPES:
        N, C, H, W = shape
        HW = H * W
        x = 1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.5
        w = 1 + 0.3 * torch.randn(C, generator=gen, device="cuda")
        b = 0.5 * torch.randn(C, generator=gen, device="cuda")
        res = torch.randn(shape, generator=gen, device="cuda") if residual else None
        y, stats = torch.empty_like(x), torch.empty(3, C, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        dx, dres = torch.empty_like(x), torch.empty_like(x) if residual else None
        dw, db = torch.empty(C, device="cuda"), torch.empty(C, device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for backward in (False, True):
            blocks = C * 16
            stamps = torch.zeros(blocks * STAMPS, dtype=torch.int64, device="cuda")
            reps, rows = 5, []
            for _ in range(reps):
                stamps.zero_()  # a block that did not run keeps 0
                if backward:
                    err = so.bn_phases_bwd(_ptr(g), _ptr(x), _ptr(y), _ptr(stats[0]),
                                           _ptr(stats[2]), _ptr(w), _ptr(b), _ptr(dw), _ptr(db),
                                           _ptr(dx), _ptr(dres), N, C, HW, 1, _ptr(stamps),
                                           stream)
                else:
                    err = so.bn_phases_fwd(_ptr(x), _ptr(w), _ptr(b), _ptr(res), _ptr(y),
                                           _ptr(stats), N, C, HW, 1, _ptr(stamps), stream)
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"batch_norm_phases: {name} launch returned {err}")
                st = stamps.view(-1, STAMPS).cpu().numpy().view(np.uint64)
                rows.append(phases(st[st[:, 7] > 0]))
            res_row = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
            res_row.update(name=name, shape=list(shape), direction="bwd" if backward else "fwd",
                           device=torch.cuda.get_device_name(0))
            print(json.dumps(res_row), flush=True)
            results.append(res_row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
