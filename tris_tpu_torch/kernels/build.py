"""Build and load the hand-written Hopper kernels.

``torch.utils.cpp_extension.load`` compiles ``csrc/bindings.cpp`` and every
kernel's ``csrc/<name>.cu`` for ``sm_90a`` into one extension module at the
first launch of any kernel, into ``kernels/build/`` (git-ignored); ninja
compiles the sources in parallel and, on a later call, only those that
changed. The ``.cu`` files include no PyTorch header, so only the bindings
take the C++ compiler long. Nothing here runs at import time: importing the
package needs neither ``nvcc`` nor a card.

``csrc/launchers.h`` declares each kernel's launcher once, for the ``.cu``
that defines it and for the bindings that call it. An op raises when its
launch fails. ``launches`` counts, per kernel, the launches its wrapper made.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("mha_short", "cross_attn", "response_head", "eval_metrics", "critic_input",
           "normalize_u8")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-lineinfo"]

launches = {name: 0 for name in KERNELS}

_ops = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def ops():
    """The extension module (one op per kernel), built first if needed.
    Raises with the compiler's output if a source fails to build."""
    global _ops
    with _lock:
        if _ops is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _ops = load(
                name="tris_kernels",
                sources=[str(CSRC / "bindings.cpp")] + [str(CSRC / f"{n}.cu") for n in KERNELS],
                extra_cflags=["-O2"],
                extra_cuda_cflags=NVCC_FLAGS,
                build_directory=str(BUILD_DIR),
            )
        return _ops


def build_all() -> float:
    """Build the kernels if needed; returns the seconds spent."""
    t0 = time.perf_counter()
    ops()
    return time.perf_counter() - t0


def count(name: str, n: int = 1) -> None:
    """Count ``n`` launches of kernel ``name``: called by its wrapper right
    after the op that launched them returned."""
    launches[name] += n


def require_cuda_f32(name: str, *tensors) -> None:
    """Kernel inputs: CUDA float32 on one device (bf16 is a later port)."""
    import torch

    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype.is_floating_point and t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
