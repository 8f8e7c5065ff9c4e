"""Loading reference (PyTorch) TRIS / CLIP checkpoints.

Copy of ``tris_tpu/ckpt/convert.py::load_torch_checkpoint``, returning
tensors: this package keeps the reference's own ``state_dict`` keys, so a
released stage-1 ``.pth`` loads with ``load_state_dict(strict=True)`` as it
is, with no conversion.
"""

from __future__ import annotations

from typing import Dict

import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch ``.pt``/``.pth`` file to a float32 CPU state_dict.

    Handles plain state_dicts, TorchScript archives (the OpenAI CLIP release
    format) and the reference's ``{"model": state_dict, ...}`` training
    checkpoints (utils/util.py:50-77)."""
    try:
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):  # nn.Module
        obj = obj.state_dict()
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: (v.float() if v.is_floating_point() else v)
            for k, v in obj.items() if isinstance(v, torch.Tensor)}
