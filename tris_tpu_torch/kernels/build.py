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
launch fails. ``launches`` counts, per kernel family and direction
(``KERNELS``; a backward is ``<name>_bwd``, a bfloat16 launch (``--bf16``)
``<name>.bf16``, K13's bfloat16 eval fold with PReLU ``batch_norm.bf16@prelu``),
the kernel launches its wrapper made.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# one csrc/<name>.cu each; stage1_head.cu holds K3's training head and its backward
# (stage1_head_bf16.cu the same on bfloat16 operands),
# irn_affinity.cu the IRN loss fused with K7 (K7 + K8), forward and backward, walk_matmul.cu
# K10's products and occupancy maps
SOURCES = ("mha_short", "mha_short_bwd", "cross_attn", "cross_attn_bwd", "response_head",
           "stage1_head", "eval_metrics", "critic_input", "critic_input_bwd", "normalize_u8",
           "bilinear_resize", "bilinear_resize_bwd", "path_max_affinity", "path_max_affinity_bwd",
           "irn_affinity", "refine_centroids", "walk_transition", "walk_matmul", "pixel_attn",
           "pixel_attn_bwd", "ema_update", "batch_norm", "batch_norm_bwd", "stage1_head_bf16")
# the launch counters: one per kernel family and direction
KERNELS = ("mha_short", "mha_short_bwd", "cross_attn", "cross_attn_bwd", "response_head",
           "stage1_head", "stage1_head_bwd", "eval_metrics", "critic_input", "critic_input_bwd",
           "normalize_u8", "bilinear_resize", "bilinear_resize_bwd", "path_max_affinity",
           "path_max_affinity_bwd", "irn_affinity_loss", "irn_affinity_loss_bwd",
           "refine_centroids", "walk_transition", "walk_matmul", "walk_tile_occupancy",
           "pixel_attn", "pixel_attn_bwd", "ema_update", "batch_norm", "batch_norm_bwd",
           "mha_short.bf16", "cross_attn.bf16", "response_head.bf16", "batch_norm.bf16",
           "batch_norm_bwd.bf16", "mha_short_bwd.bf16", "cross_attn_bwd.bf16",
           "stage1_head.bf16", "stage1_head_bwd.bf16", "pixel_attn.bf16", "bilinear_resize.bf16",
           "batch_norm.bf16@prelu")
# no --use_fast_math or -ftz=true: K10 converts float32 subnormals to double exactly
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-lineinfo"]
MAX_SMEM = 227 * 1024  # shared memory one block may use on Hopper (opt-in above 48 KiB)

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
                sources=[str(CSRC / "bindings.cpp")] + [str(CSRC / f"{n}.cu") for n in SOURCES],
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
    """Count ``n`` kernel launches of ``name``: called by its wrapper right
    after the op that launched them returned."""
    launches[name] += n


def require_cuda(name: str, *tensors, accepted=None) -> int:
    """Kernel inputs: CUDA tensors on one device, in the dtypes the kernel
    takes. ``accepted``: the combinations it takes, a tuple each with one
    dtype (or None: absent) per tensor; without it, every floating tensor
    float32. Returns the index of the combination given (0 without
    ``accepted``); raises ``TypeError`` naming what the kernel takes."""
    import torch

    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
    if accepted is None:
        for t in tensors:
            if t is not None and t.dtype.is_floating_point and t.dtype != torch.float32:
                raise TypeError(f"{name}: expected float32, got {t.dtype}")
        return 0
    given = tuple(None if t is None else t.dtype for t in tensors)
    if given in accepted:
        return accepted.index(given)
    names = lambda combo: "(" + ", ".join("-" if d is None else str(d)[6:] for d in combo) + ")"
    raise TypeError(f"{name}: takes dtypes {' or '.join(names(c) for c in accepted)}, "
                    f"got {names(given)}")
