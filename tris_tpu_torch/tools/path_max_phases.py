"""Where K7's tiled forward spends a call, measured inside its blocks on the card.

Builds ``csrc/path_max_affinity.cu`` once more with ``nvcc -DTRIS_K7_STAMPS`` (a
shared library beside the extension's build, called through ctypes; the
extension itself never has the stamps), launches it as its launcher does
(``launchers.h::path_tile_plan``, ``kPathMaxForward``) on seeded edge maps at
the main paths' shapes (radius 5 on a 480 x 640 image's padded [133, 170] grid,
radius 10 on IRN training's [24, 128, 128]) and, at radius 5, at other counts of
direction groups, and reads the stamps thread 0 of every block wrote: per block
the ns of the staging's issue (cp.async) with the table's copy, of the
staging's wait with the barrier's and of the directions (clock64 cycles scaled
by the block's %globaltimer lifetime), the SM clock those give, the call's
span, the blocks' lifetime, how many blocks an SM held at once on average, and
the directions' shared loads (a warp's: each step's offset and its rows'
values) per clock on each SM. Needs a card and nvcc::

    python -m tris_tpu_torch.tools.path_max_phases [--out FILE]

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
import torch.nn.functional as F

from tris_tpu_torch.kernels import path_max as K7
from tris_tpu_torch.pseudo.indexing import PathIndex
from tris_tpu_torch.tools import irn_affinity_schedule as T

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "kernels" / "build" / "phases"
STAMPS = 6  # path_max_affinity.cu's kK7Stamps
PHASES = ("copy", "stage_wait", "directions")  # copy: the staging issued, the table copied

SHIM = r'''
#include "launchers.h"
extern "C" cudaError_t k7_set_stamps(unsigned long long*);
extern "C" int k7_fwd(const float* edge, float* out, long long B, int H, int W, int rf,
                      const int* steps, const int* offsets, int n_dirs, int groups,
                      unsigned long long* stamps, void* stream) {
  cudaError_t e = k7_set_stamps(stamps);
  tris::PathTilePlan p = tris::path_tile_plan(tris::kPathMaxForward, B, H, W, rf);
  if (groups > 0) {
    p.blocks = p.blocks / p.dir_groups * groups;
    p.dir_groups = groups;
  }
  const tris::PathSteps table = {steps, offsets, n_dirs};
  tris::PathMaxLaunchShape shape;
  if (e == cudaSuccess)
    e = tris::path_max_affinity(&p, table, nullptr, nullptr, edge, out, B, H, W, rf,
                                (cudaStream_t)stream, &shape);
  return (int)e;
}
'''


def build() -> ctypes.CDLL:
    """The stamped kernels and the C entry point, compiled with nvcc."""
    BUILD.mkdir(parents=True, exist_ok=True)
    shim = BUILD / "k7_phases_shim.cu"
    shim.write_text(SHIM)
    lib = BUILD / "libk7_phases.so"
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    done = subprocess.run([nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                           "-shared", "-Xcompiler", "-fPIC", "-DTRIS_K7_STAMPS", f"-I{CSRC}",
                           "-o", str(lib), str(CSRC / "path_max_affinity.cu"), str(shim)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"path_max_phases: nvcc failed:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.k7_fwd.argtypes = [p, p, ctypes.c_longlong, i, i, i, p, p, i, i, p, p]
    return so


def phases(stamps: np.ndarray, warp_loads: int) -> dict:
    """One call's stamps [blocks, STAMPS] summarised: each phase's ns (median over the
    blocks), the SM clock, the span, the blocks' lifetime, the blocks an SM held at once
    and the directions' warp shared loads a clock an SM (over the blocks' direction
    phases, which overlap on an SM)."""
    s = stamps.astype(np.float64)
    life_ns = s[:, 4] - s[:, 0]
    cycles = s[:, 1:1 + len(PHASES)]
    ns_per_cycle = life_ns / np.maximum(cycles.sum(axis=1), 1)
    span = float(s[:, 4].max() - s[:, 0].min())
    sms = len(np.unique(s[:, 5]))
    out = {f"{k}_ns": float(np.median(cycles[:, j] * ns_per_cycle)) for j, k in enumerate(PHASES)}
    # an SM's direction cycles: the union of its blocks' direction phases, as the span from
    # the first one's start to the last one's end (the blocks of an SM start together here)
    end_ns = s[:, 4]
    dir_start_ns = end_ns - cycles[:, 2] * ns_per_cycle
    busy = sum(float(end_ns[s[:, 5] == sm].max() - dir_start_ns[s[:, 5] == sm].min())
               for sm in np.unique(s[:, 5]))
    ghz = float(np.median(1 / ns_per_cycle))
    out.update(sm_ghz=ghz, blocks=int(len(s)), sms=sms, span_ns=span,
               block_life_ns=float(np.median(life_ns)),
               blocks_an_sm_at_once=float(life_ns.sum() / (span * sms)),
               warp_loads_a_clock_an_sm=warp_loads / (busy * ghz))
    return out


def cases(dev):
    g = torch.Generator(device=dev).manual_seed(18)
    yield "r5", 5, F.pad(torch.rand(128, 160, generator=g, device=dev), (5, 5, 0, 5),
                         value=1.0)[None], (0, 1, 4, 8)
    yield "r10", 10, torch.rand(24, 128, 128, generator=g, device=dev), (0,)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_max_phases: needs a CUDA device")
    so = build()
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows = []
    for name, radius, edge, group_counts in cases(dev):
        pi = PathIndex(radius, tuple(edge.shape[-2:]))
        rf, key = pi.radius_floor, K7.path_steps(pi.paths_by_length)
        steps, offsets = K7.tile_table(key, rf)
        want = K7.path_max_affinity_plain(edge, pi.paths_by_length, rf)
        B, H, W = edge.shape
        n_steps = sum(map(len, key))
        for groups in group_counts:
            p = T.plan(T.MAX_FORWARD, B, H, W, rf)
            tiles = p["blocks"] // p["dir_groups"]
            blocks = tiles * (groups or p["dir_groups"])
            out = torch.empty_like(want)
            stamps = torch.zeros(blocks * STAMPS, dtype=torch.int64, device=dev)

            runs = []
            for _ in range(6):
                stamps.zero_()  # a block that did not run keeps 0
                err = so.k7_fwd(edge.data_ptr(), out.data_ptr(), B, H, W, rf, steps.data_ptr(),
                                offsets.data_ptr(), len(key), groups, stamps.data_ptr(), stream)
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"path_max_phases: the launch returned {err}")
                st = stamps.view(-1, STAMPS).cpu().numpy().view(np.uint64)
                warp_loads = tiles * 8 * n_steps * (p["rpt"] + 1)
                runs.append(phases(st[st[:, 4] > 0], warp_loads))
            runs = runs[1:]  # the first call also loads the module
            row = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
            row.update(name=f"path_max_affinity@{name}", radius=radius, shape=list(edge.shape),
                       dir_groups=groups or p["dir_groups"], plan_groups=p["dir_groups"],
                       rpt=p["rpt"], equal=bool(torch.equal(out, want)))
            rows.append(row)
    result = {"device": torch.cuda.get_device_name(0), "rows": rows}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
