"""K12: the EMA teacher update (``csrc/ema_update.cu``) and its plain PyTorch
version.

Replaces ``tris_tpu/train/state.py::ema_update`` (line 161): every teacher
leaf ``e`` becomes ``e * d + p * (1 - d)`` in float32 from the student's
leaf ``p``, keeping its dtype; integer buffers (BatchNorm's
``num_batches_tracked``, which the JAX package does not have) are copied,
as ema_pytorch does. The update is in place. ``d`` is rounded to float32
and ``1 - d`` is the float32 difference, as JAX computes them; each product
and the sum are rounded on their own, so the kernel equals the plain
version bit for bit. On the card all leaves go through one launch over a
table of (teacher, student) pointers (:class:`EmaTable`), built once per
train state.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tris_tpu_torch.kernels import build

CHUNK = 4096  # elements a block of the kernel updates


def _factors(decay: float):
    d = np.float32(decay)
    return float(d), float(np.float32(1.0) - d)


def ema_update_plain(ema_tensors: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor],
                     decay: float, table: "EmaTable | None" = None) -> None:
    """The plain version, leaf by leaf, in place (``table``, the kernel's,
    is not read)."""
    d, omd = _factors(decay)
    with torch.no_grad():
        for e, p in zip(ema_tensors, tensors, strict=True):
            if e.is_floating_point():
                e.copy_((e.float() * d + p.float() * omd).to(e.dtype))
            else:
                e.copy_(p)


class EmaTable:
    """The device table of (teacher pointer, student pointer, numel, kind)
    over pairs of CUDA leaves (kind 0: float32, updated; 1: int64, copied),
    with each leaf's first chunk. It holds the tensors, so the pointers stay
    valid; in-place updates of the leaves (the optimizer's, the EMA's) keep
    them."""

    def __init__(self, ema_tensors: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]):
        ema_tensors, tensors = list(ema_tensors), list(tensors)
        if len(ema_tensors) != len(tensors):
            raise ValueError(f"ema_update: {len(ema_tensors)} teacher leaves, {len(tensors)} "
                             f"student leaves")
        rows, starts, n_chunks, dev = [], [], 0, None
        for i, (e, p) in enumerate(zip(ema_tensors, tensors)):
            dev = dev or e.device
            if not (e.is_cuda and p.is_cuda and e.device == dev and p.device == dev):
                raise ValueError(f"ema_update: leaf {i}: expected CUDA tensors on one device, "
                                 f"got {e.device} and {p.device}")
            if e.shape != p.shape or e.dtype != p.dtype or not (e.is_contiguous()
                                                               and p.is_contiguous()):
                raise ValueError(f"ema_update: leaf {i}: teacher {e.dtype}{tuple(e.shape)} and "
                                 f"student {p.dtype}{tuple(p.shape)} must match, contiguous")
            if e.dtype == torch.float32:
                kind = 0
            elif e.dtype == torch.int64:
                kind = 1
            else:
                raise TypeError(f"ema_update: leaf {i}: float32 or int64 leaves, got {e.dtype}")
            if e.numel() == 0:
                continue
            rows.append((e.data_ptr(), p.data_ptr(), e.numel(), kind))
            starts.append(n_chunks)
            n_chunks += -(-e.numel() // CHUNK)
        self.tensors = (ema_tensors, tensors)
        self.n_chunks = n_chunks
        self.table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 4).to(dev)
        self.starts = torch.tensor(starts, dtype=torch.int64).to(dev)


def ema_update(ema_tensors: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor],
               decay: float, table: "EmaTable | None" = None) -> None:
    """K12 on CUDA leaves (one launch; ``table`` the leaves' :class:`EmaTable`,
    built here when not given); the plain version on CPU leaves."""
    ema_tensors, tensors = list(ema_tensors), list(tensors)
    if all(t.device.type == "cpu" for t in ema_tensors + tensors):
        return ema_update_plain(ema_tensors, tensors, decay)
    if table is None:
        table = EmaTable(ema_tensors, tensors)
    d, omd = _factors(decay)
    if table.n_chunks:
        build.ops().ema_update(table.table, table.starts, table.n_chunks, CHUNK, d, omd)
        build.count("ema_update")
