"""Cross-modal attention fusion: ``BilateralPrompt``.

Port of ``tris_tpu/models/fusion.py::BilateralPrompt`` (the reference's
model/attn.py:68-136) in the token layout [N, HW, C]. Submodules keep the
reference's keys (``v_proj1.0`` a 1x1 conv, ``v_proj1.1`` an InstanceNorm,
``t_proj1.0`` a Linear, ``v_output.{0,1}``, ``t_output.0``). The two
cross-attentions are K2 (``kernels.cross_attn``). ``PixelAttention`` comes
with stage 2.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tris_tpu_torch import kernels
from tris_tpu_torch.models.layers import Conv1x1, InstanceNorm2d


class BilateralPrompt(nn.Module):
    """Symmetric cross-attention: vision queries attend the language keys and
    values and vice versa, over InstanceNorm'd projections."""

    def __init__(self, vis_chans: int, lan_chans: int):
        super().__init__()
        m = vis_chans
        for i in (1, 2, 3):
            setattr(self, f"v_proj{i}", nn.Sequential(
                Conv1x1(vis_chans, m), InstanceNorm2d(m), nn.ReLU()))
            setattr(self, f"t_proj{i}", nn.Sequential(nn.Linear(lan_chans, m), nn.ReLU()))
        self.v_output = nn.Sequential(Conv1x1(m, vis_chans), InstanceNorm2d(vis_chans))
        self.t_output = nn.Sequential(nn.Linear(m, lan_chans))

    def forward(self, vis: torch.Tensor, lan: torch.Tensor, S: int = 1):
        """vis [N, HW, C] per image, lan [N*S, T, Ct] per (image, sentence)
        pair, pair i belonging to image i // S ->
        ``(new_vis [N*S, HW, C], new_lan [N*S, T, Ct])``.

        The vision projections run once per image and K2 reads them for each
        of the image's S pairs: the same numbers as repeating ``vis`` S times
        (the JAX package's ``jnp.repeat``), without the S-fold work."""
        div = math.sqrt(lan.shape[-1])
        new_vis, new_lan = kernels.cross_attn(
            self.v_proj1(vis), self.v_proj2(vis), self.v_proj3(vis),
            self.t_proj1(lan), self.t_proj2(lan), self.t_proj3(lan), S, div)
        return self.v_output(new_vis), self.t_output(new_lan)
