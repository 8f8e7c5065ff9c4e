"""The ir-label pass's CRF throughput on this host, one design against another.

    python -m tris_tpu_torch.tools.crf_threads [--problems N] [--out PATH]

The pass (``pseudo/pipeline.py::run_cam_to_ir_label``) labels each image in
a pool of spawned processes, one a core, and each image's CRF runs the
native lattice, whose loops are OpenMP loops. This times the pass's work,
``N`` fused fg/bg CRFs (``cam_to_ir_label``'s two unary sets over one
image), in images per second under each way of sharing the host:

- ``pool_1_thread``: the library as the port builds it (``-fopenmp``), a pool
  of one process a core, each call on one thread (the port's choice);
- ``pool_no_openmp``: the same pool over a build without ``-fopenmp``
  (compiled here into a temporary directory), the other design;
- ``pool_full_team``: the ``-fopenmp`` pool with every call on a team of one
  thread a core, what a pool oversubscribed by default teams does;
- ``serial_full_team``: one process, each call on a team of one thread a core.

Each pool is started and warmed (the library loaded in every worker) before
its clock starts. Without ``--problems``' images from a caller, the images
are seeded photo-like 480x640 frames with blob CAMs. ``chip_smoke.py``'s
phase 11 runs :func:`run` on phase 7's COCO-sized JPEGs.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def build_without_openmp(out_dir: str) -> str:
    """The port's ``native`` sources compiled as the port compiles them but
    without ``-fopenmp`` (and without the JPEG half, which the CRF does not
    use): the path of the library."""
    from tris_tpu_torch import native

    out = os.path.join(out_dir, "libtris_native_no_openmp.so")
    cmd = [f for f in native.build_command([native.CSRC / n for n in native.SOURCES], out,
                                           jpeg=False) if f != "-fopenmp"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"crf_threads: the build without OpenMP failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    return out


def _load(lib_path) -> None:
    """A pool worker's initializer: the binding's library is ``lib_path``."""
    import ctypes

    from tris_tpu_torch import native

    if lib_path is not None:
        native._lib_handle = native._bind(ctypes.CDLL(lib_path))
    native.library_path()


def _label(args) -> float:
    """One image's two CRFs on ``threads``; returns its seconds."""
    from tris_tpu_torch.pseudo.crf import dense_crf_inference_multi

    image, unaries, threads = args
    t0 = time.perf_counter()
    dense_crf_inference_multi(image, unaries, threads=threads)
    return time.perf_counter() - t0


def throughput(problems, procs: int, threads: int, lib_path=None) -> dict:
    """Images per second of ``problems`` ([(image, unaries)]) in a pool of
    ``procs`` spawned processes (``procs`` 1: in this process), each call on
    ``threads``; ``lib_path`` another build of the library."""
    tasks = [(img, un, threads) for img, un in problems]
    if procs == 1:
        if lib_path is not None:
            raise ValueError("crf_threads: another build runs in a pool only")
        _load(None)
        t0 = time.perf_counter()
        per = [_label(t) for t in tasks]
        secs = time.perf_counter() - t0
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(procs, mp_context=ctx, initializer=_load,
                                 initargs=(lib_path,)) as ex:
            list(ex.map(_label, tasks[:1] * procs))   # every worker started and warm
            t0 = time.perf_counter()
            per = list(ex.map(_label, tasks))
            secs = time.perf_counter() - t0
    return {"procs": procs, "threads": threads, "images": len(tasks),
            "images_per_s": len(tasks) / secs, "ms_per_call": [1e3 * s for s in per]}


def run(problems, procs=None) -> dict:
    """Every design of the module docstring on ``problems``."""
    from tris_tpu_torch import native

    procs = procs or os.cpu_count() or 1
    native.build_library()
    out = {"host_cores": os.cpu_count(), "procs": procs}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lib = build_without_openmp(tmp)
        out["no_openmp_build_s"] = time.perf_counter() - t0
        out["pool_1_thread"] = throughput(problems, procs, 1)
        out["pool_no_openmp"] = throughput(problems, procs, 1, lib_path=lib)
    out["pool_full_team"] = throughput(problems, procs, procs)
    out["serial_full_team"] = throughput(problems, 1, procs)
    return out


def synthetic_problems(n: int, seed: int = 0, h: int = 480, w: int = 640):
    """``n`` seeded photo-like frames with blob CAMs, as ``cam_to_ir_label``'s
    two unary sets."""
    from scipy import ndimage

    from tris_tpu_torch.pseudo.crf import unary_from_labels

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.random((h // 16 + 2, w // 16 + 2, 3)) * 255
        img = np.clip(ndimage.zoom(base, (16, 16, 1), order=1)[:h, :w], 0, 255).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        cam = np.exp(-(((yy - cy) / (0.2 * h)) ** 2 + ((xx - cx) / (0.2 * w)) ** 2))
        seeds = [np.argmax(np.concatenate([np.full((1, h, w), t), cam[None]]), 0)
                 for t in (0.3, 0.1)]
        out.append((img, np.stack([unary_from_labels(s.astype(np.int32), 2) for s in seeds])))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--problems", type=int, default=16, help="images to label")
    p.add_argument("--procs", type=int, default=None, help="pool size (default: the cores)")
    p.add_argument("--out", default=None, help="write the result JSON here")
    args = p.parse_args(argv)
    result = run(synthetic_problems(args.problems), args.procs)
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
