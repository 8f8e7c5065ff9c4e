"""Device resolution and the precision policy, kept in one place.

Entry points run on the card unless the caller asks for the CPU: ``device``
defaults to ``"cuda"``, and without CUDA that default raises instead of
quietly running on the host. Everything runs in float32 with TF32 off for
both matmuls and cuDNN convolutions (cuDNN's TF32 is on by default in
PyTorch), so the port agrees with the JAX package's ``highest`` precision.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> ``torch.device``; raises when
    CUDA is asked for and absent, and sets the precision policy."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (or --device cpu) to run "
            "on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    set_precision()
    return dev


def to_device(arr, device) -> torch.Tensor:
    """numpy -> tensor on ``device``. Host-to-card copies go through pinned
    memory without blocking the host, so work already queued on the card
    keeps running while the host prepares the next batch."""
    import numpy as np

    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostFetch:
    """Copy device tensors to the host asynchronously: the copies are queued
    behind the work that produces them, and :meth:`numpy` waits for those
    copies alone, not for work queued after them."""

    def __init__(self, tensors):
        self.event = None
        if all(t.device.type == "cpu" for t in tensors):
            self.host = list(tensors)
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]
