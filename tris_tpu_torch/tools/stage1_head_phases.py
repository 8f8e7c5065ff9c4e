"""Where K3's training head spends a call, forward and backward, measured inside
its clusters on the card.

Builds ``csrc/stage1_head.cu`` once more with ``nvcc -DTRIS_S1_STAMPS`` (a
shared library beside the extension's build, called through ctypes; the
extension itself never has the stamps), launches both kernels as their
launchers do (``launchers.h::stage1_head_plan``) on seeded inputs at the
stage-1 train step's shape (B = 48, 100 px × 48 texts, D = 1024 → 320²), and
reads the stamps thread 0 of every block wrote (``stage1_head.cu``): per block
each phase's ns (clock64 cycles scaled by the block's %globaltimer lifetime;
a phase ending in a barrier includes the wait for the block's slowest warp),
the SM clock those give, the call's span, the blocks' lifetime and the spread of their starts (a
second wave shows as a spread near a block's lifetime). Needs a card and
nvcc::

    python -m tris_tpu_torch.tools.stage1_head_phases [--out FILE]

prints one JSON line per kernel.
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
import torch.nn.functional as F

from tris_tpu_torch.kernels.response_head import adjoint_taps_on, taps_on

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "kernels" / "build" / "phases"
STAMPS = 10  # stage1_head.cu's kS1Stamps
PHASES = {"stage1_head": ("scores", "exchange", "head", "t_rows", "maps", "last_barrier"),
          "stage1_head_bwd": ("plane_issue", "seg_partial", "exchange", "stats", "dscore",
                              "grads", "last_barrier")}
B, HS, D, SIZE = 48, 10, 1024, 320

SHIM = r'''
#include "launchers.h"
extern "C" cudaError_t s1_set_stamps(unsigned long long*);
static tris::TapArrays taps(const void* const* t) {
  return {(const int*)t[0], (const int*)t[1], (const float*)t[2], (const float*)t[3]};
}
extern "C" int s1_fwd(const float* vis, const float* lan, const float* scale, float* score,
                      float* stats, float* cls_out, float* cls_fg, float* relu, float* sig, int B,
                      int h, int w, int D, int H, int W, const void* const* ty,
                      const void* const* tx, unsigned long long* stamps, void* stream) {
  cudaError_t e = s1_set_stamps(stamps);
  if (e == cudaSuccess)
    e = tris::stage1_head(vis, lan, scale, score, stats, cls_out, cls_fg, relu, sig, B, B, 0, h,
                          w, D, H, W, 3.f, 0.01f, taps(ty), taps(tx), (cudaStream_t)stream,
                          nullptr);
  return (int)e;
}
extern "C" int s1_bwd(const float* g_cls, const float* g_sig, const float* vis, const float* lan,
                      const float* scale, const float* score, const float* stats, float* d_vis,
                      float* d_lan, int B, int h, int w, int D, int H, int W,
                      const void* const* ty, const void* const* tx, const int* const* ry,
                      const int* const* rx, unsigned long long* stamps, void* stream) {
  cudaError_t e = s1_set_stamps(stamps);
  const tris::TapRanges yr = {ry[0], ry[1], ry[2], ry[3]}, xr = {rx[0], rx[1], rx[2], rx[3]};
  if (e == cudaSuccess)
    e = tris::stage1_head_bwd(g_cls, nullptr, g_sig, vis, lan, scale, score, stats, d_vis, d_lan,
                              B, B, 0, h, w, D, H, W, 3.f, 0.01f, taps(ty), taps(tx), yr, xr,
                              (cudaStream_t)stream, nullptr);
  return (int)e;
}
extern "C" void s1_plan(int B, int h, int w, int D, int H, int W, int backward, long long* out) {
  const tris::Stage1HeadPlan p = tris::stage1_head_plan(B, B, h, w, D, H, W, backward != 0);
  out[0] = p.ranks;
  out[1] = p.blocks;
  out[2] = p.smem;
}
'''


def build() -> ctypes.CDLL:
    """The stamped kernels and their C entry points, compiled with nvcc."""
    BUILD.mkdir(parents=True, exist_ok=True)
    shim = BUILD / "s1_phases_shim.cu"
    shim.write_text(SHIM)
    lib = BUILD / "libs1_phases.so"
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    done = subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                           "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC",
                           "-DTRIS_S1_STAMPS", f"-I{CSRC}", "-o", str(lib),
                           str(CSRC / "stage1_head.cu"), str(shim)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"stage1_head_phases: nvcc failed:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.s1_fwd.argtypes = [p] * 9 + [i] * 6 + [p] * 4
    so.s1_bwd.argtypes = [p] * 9 + [i] * 6 + [p] * 6
    so.s1_plan.argtypes = [i] * 7 + [p]
    return so


def phases(stamps: np.ndarray, names) -> dict:
    """One call's stamps [blocks, STAMPS] summarised: each phase's ns, the median over the
    blocks, the span, the blocks' lifetime and the spread of their starts."""
    s = stamps.astype(np.float64)
    n = len(names)
    life_ns = s[:, 8] - s[:, 0]
    cycles = s[:, 1:1 + n]
    ns_per_cycle = life_ns / np.maximum(cycles.sum(axis=1), 1)
    out = {f"{k}_ns": float(np.median(cycles[:, j] * ns_per_cycle)) for j, k in enumerate(names)}
    out.update(sm_ghz=float(np.median(1 / ns_per_cycle)),
               blocks=int(len(s)), sms=int(len(np.unique(s[:, 9]))),
               span_ns=float(s[:, 8].max() - s[:, 0].min()),
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
        raise SystemExit("stage1_head_phases: needs a CUDA device")
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    hw = HS * HS
    vis = F.normalize(torch.randn(B, hw, D, generator=gen, device=dev), dim=-1)
    lan = F.normalize(torch.randn(B, B, D, generator=gen, device=dev), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    score, cls_out = torch.empty(B, hw, B, device=dev), torch.empty(B, B, device=dev)
    stats = torch.empty(B, 2 * (hw + B), device=dev)
    cls_fg, relu, sig = (torch.empty(B, device=dev), torch.empty(B, SIZE, SIZE, device=dev),
                         torch.empty(B, SIZE, SIZE, device=dev))
    g_cls = torch.randn(B, B, generator=gen, device=dev)
    g_sig = torch.randn(B, SIZE, SIZE, generator=gen, device=dev)
    d_vis, d_lan = torch.empty_like(vis), torch.empty_like(lan)
    t = taps_on(HS, SIZE, False, dev)
    (tp, k1), (rp, k2) = _ptrs(list(t)), _ptrs(list(adjoint_taps_on(HS, SIZE, False, dev)))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda x: x.data_ptr()  # noqa: E731
    calls = {
        "stage1_head": lambda st: so.s1_fwd(
            ptr(vis), ptr(lan), ptr(scale), ptr(score), ptr(stats), ptr(cls_out), ptr(cls_fg),
            ptr(relu), ptr(sig), B, HS, HS, D, SIZE, SIZE, tp, tp, st, stream),
        "stage1_head_bwd": lambda st: so.s1_bwd(
            ptr(g_cls), ptr(g_sig), ptr(vis), ptr(lan), ptr(scale), ptr(score), ptr(stats),
            ptr(d_vis), ptr(d_lan), B, HS, HS, D, SIZE, SIZE, tp, tp, rp, rp, st, stream),
    }
    results = []
    for name, call in calls.items():
        plan = (ctypes.c_longlong * 3)()
        so.s1_plan(B, HS, HS, D, SIZE, SIZE, int(name.endswith("bwd")),
                   ctypes.cast(plan, ctypes.c_void_p))
        ranks, blocks, smem = list(plan)
        stamps = torch.zeros(blocks * STAMPS, dtype=torch.int64, device=dev)
        rows = []
        for _ in range(6):
            stamps.zero_()  # a block that did not run keeps 0
            err = call(stamps.data_ptr())
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"stage1_head_phases: {name} launch returned {err}")
            st = stamps.view(-1, STAMPS).cpu().numpy().view(np.uint64)
            rows.append(phases(st[st[:, 8] > 0], PHASES[name]))
        rows = rows[1:]  # the first call also loads the module
        row = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        row.update(name=name, shape=[B, hw, B, D, SIZE], ranks=ranks, plan_blocks=blocks,
                   smem_bytes=smem, device=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
