"""Where K5's backward spends a call, measured inside its blocks on the card.

Builds ``csrc/critic_input_bwd.cu`` once more with ``nvcc -DTRIS_K5_STAMPS`` (a
shared library beside the extension's build, called through ctypes; the
extension itself never has the stamps), launches it as its launcher does
(``launchers.h::critic_input_bwd_plan``) on seeded inputs at the stage-1 train
step's shape (48 maps, 320 -> 224, patch 32), and reads the stamps thread 0 of
every block wrote: per block each phase's ns (clock64 cycles scaled by the
block's %globaltimer lifetime; a phase ending in a barrier includes the wait
for the block's slowest warp), the SM clock those give, the call's span, the
blocks' lifetime and how many blocks an SM held at once on average (their
lifetimes summed over the span and the SMs). Needs a card and nvcc::

    python -m tris_tpu_torch.tools.critic_input_phases [--out FILE]

prints one JSON line.
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

from tris_tpu_torch.kernels.response_head import adjoint_taps_on, taps_on

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "kernels" / "build" / "phases"
STAMPS = 7  # critic_input_bwd.cu's kK5Stamps
PHASES = ("copies", "dcam", "column_adjoint", "row_adjoint")
P, SIZE, N, PS = 48, 320, 224, 32

SHIM = r'''
#include "launchers.h"
extern "C" cudaError_t k5_set_stamps(unsigned long long*);
extern "C" int k5_bwd(const float* dA, const float* image, float* dcams, int P, int H, int W,
                      int n, int ps, const void* const* t, const int* const* r,
                      unsigned long long* stamps, void* stream) {
  cudaError_t e = k5_set_stamps(stamps);
  const tris::TapArrays ta = {(const int*)t[0], (const int*)t[1], (const float*)t[2],
                              (const float*)t[3]};
  const tris::TapRanges ra = {r[0], r[1], r[2], r[3]};
  if (e == cudaSuccess)
    e = tris::critic_input_bwd(dA, image, dcams, P, 1, H, W, n, ps, ta, ta, ra, ra,
                               (cudaStream_t)stream, nullptr);
  return (int)e;
}
extern "C" long long k5_blocks(int P, int H, int W, int n) {
  return tris::critic_input_bwd_plan(P, H, W, n).blocks;
}
'''


def build() -> ctypes.CDLL:
    """The stamped kernel and its C entry points, compiled with nvcc."""
    BUILD.mkdir(parents=True, exist_ok=True)
    shim = BUILD / "k5_phases_shim.cu"
    shim.write_text(SHIM)
    lib = BUILD / "libk5_phases.so"
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    done = subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                           "--expt-relaxed-constexpr", "-shared", "-Xcompiler", "-fPIC",
                           "-DTRIS_K5_STAMPS", f"-I{CSRC}", "-o", str(lib),
                           str(CSRC / "critic_input_bwd.cu"), str(shim)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"critic_input_phases: nvcc failed:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.k5_bwd.argtypes = [p] * 3 + [i] * 5 + [p] * 4
    so.k5_blocks.argtypes = [i] * 4
    so.k5_blocks.restype = ctypes.c_longlong
    return so


def phases(stamps: np.ndarray) -> dict:
    """One call's stamps [blocks, STAMPS] summarised: each phase's ns (median over the
    blocks), the SM clock, the span, the blocks' lifetime and the blocks an SM held at once."""
    s = stamps.astype(np.float64)
    life_ns = s[:, 5] - s[:, 0]
    cycles = s[:, 1:1 + len(PHASES)]
    ns_per_cycle = life_ns / np.maximum(cycles.sum(axis=1), 1)
    span = float(s[:, 5].max() - s[:, 0].min())
    sms = len(np.unique(s[:, 6]))
    out = {f"{k}_ns": float(np.median(cycles[:, j] * ns_per_cycle)) for j, k in enumerate(PHASES)}
    out.update(sm_ghz=float(np.median(1 / ns_per_cycle)), blocks=int(len(s)), sms=sms,
               span_ns=span, block_life_ns=float(np.median(life_ns)),
               blocks_an_sm_at_once=float(life_ns.sum() / (span * sms)))
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
        raise SystemExit("critic_input_phases: needs a CUDA device")
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dA = torch.randn(P * (N // PS) ** 2, 3 * PS * PS, generator=gen, device=dev)
    image = torch.randn(P, 3, SIZE, SIZE, generator=gen, device=dev)
    dcams = torch.empty(P, SIZE, SIZE, device=dev)
    (tp, k1), (rp, k2) = (_ptrs(list(taps_on(SIZE, N, True, dev))),
                          _ptrs(list(adjoint_taps_on(SIZE, N, True, dev))))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    blocks = so.k5_blocks(P, SIZE, SIZE, N)
    stamps = torch.zeros(blocks * STAMPS, dtype=torch.int64, device=dev)
    rows = []
    for _ in range(6):
        stamps.zero_()  # a block that did not run keeps 0
        err = so.k5_bwd(dA.data_ptr(), image.data_ptr(), dcams.data_ptr(), P, SIZE, SIZE, N, PS,
                        tp, rp, stamps.data_ptr(), stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"critic_input_phases: the launch returned {err}")
        st = stamps.view(-1, STAMPS).cpu().numpy().view(np.uint64)
        rows.append(phases(st[st[:, 5] > 0]))
    rows = rows[1:]  # the first call also loads the module
    row = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    row.update(name="critic_input_bwd", shape=[P, SIZE, N, PS], plan_blocks=int(blocks),
               device=torch.cuda.get_device_name(0))
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return row


if __name__ == "__main__":
    main()
