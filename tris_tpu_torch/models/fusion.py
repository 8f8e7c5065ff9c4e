"""Cross-modal attention fusion: ``PixelAttention`` and ``BilateralPrompt``.

Port of ``tris_tpu/models/fusion.py`` (the reference's model/attn.py) in the
token layout [N, HW, C]. Submodules keep the reference's keys:

- ``PixelAttention`` (attn.py:9-65): ``Wk``/``Wv`` 1x1 Conv1d, ``Wq``/``Wm``/
  ``Ww``/``Wo`` 1x1 Conv2d, ``ins_q``/``ins_w`` InstanceNorms. Its
  pixel-word attention is K11 (``kernels.pixel_attn``).
- ``BilateralPrompt`` (attn.py:68-136): ``v_proj1.0`` a 1x1 conv,
  ``v_proj1.1`` an InstanceNorm, ``t_proj1.0`` a Linear, ``v_output.{0,1}``,
  ``t_output.0``. The two cross-attentions are K2 (``kernels.cross_attn``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tris_tpu_torch import kernels
from tris_tpu_torch.models.layers import Conv1x1, Dense, InstanceNorm2d


class PixelAttention(nn.Module):
    """Pixel-word attention: every pixel attends over the T language tokens.

    The 1x1 projections are Dense layers on the channel axis (cuBLAS), the
    attention K11; in ``dtype`` as :class:`BilateralPrompt` (the
    InstanceNorms' weights and biases made in it; K11's operands promote as
    the JAX einsums promote theirs)."""

    def __init__(self, visual_channel: int, language_channel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ci, ct = visual_channel, language_channel
        self.Wk = Conv1x1(ct, ci, dims=1, dtype=dtype)
        self.Wv = Conv1x1(ct, ci, dims=1, dtype=dtype)
        self.Wq = Conv1x1(ci, ci, dtype=dtype)
        self.Wm = Conv1x1(ci, ci, dtype=dtype)
        self.Ww = Conv1x1(ci, ci, dtype=dtype)
        self.Wo = Conv1x1(ci, ci, dtype=dtype)
        self.ins_q = InstanceNorm2d(ci, dtype=dtype)
        self.ins_w = InstanceNorm2d(ci, dtype=dtype)

    def forward(self, vis: torch.Tensor, lan: torch.Tensor, S: int = 1) -> torch.Tensor:
        """vis [N, HW, Ci] per image, lan [N*S, T, Ct] per (image, sentence)
        pair, pair i belonging to image i // S -> [N*S, HW, Ci].

        ``Wq``, ``ins_q`` and ``relu(Wm vis)`` run once per image; the
        attention, ``Ww``, ``ins_w`` and ``Wo`` per pair: the same numbers
        as repeating ``vis`` S times, without the S-fold work."""
        N, HW, ci = vis.shape
        G = kernels.pixel_attn(self.ins_q(self.Wq(vis)), self.Wk(lan), self.Wv(lan), S)
        Gi = self.ins_w(self.Ww(G)).reshape(N, S, HW, ci)
        Vo = torch.relu(self.Wm(vis))
        return torch.relu(self.Wo((Vo[:, None] * Gi).reshape(N * S, HW, ci)))


class BilateralPrompt(nn.Module):
    """Symmetric cross-attention: vision queries attend the language keys and
    values and vice versa, over InstanceNorm'd projections, in ``dtype`` (the
    InstanceNorms' weights and biases made in it, as the JAX module makes
    them; K2's operands promote as the JAX einsums promote theirs)."""

    def __init__(self, vis_chans: int, lan_chans: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        m = vis_chans
        for i in (1, 2, 3):
            setattr(self, f"v_proj{i}", nn.Sequential(
                Conv1x1(vis_chans, m, dtype=dtype), InstanceNorm2d(m, dtype=dtype), nn.ReLU()))
            setattr(self, f"t_proj{i}", nn.Sequential(Dense(lan_chans, m, dtype=dtype),
                                                      nn.ReLU()))
        self.v_output = nn.Sequential(Conv1x1(m, vis_chans, dtype=dtype),
                                      InstanceNorm2d(vis_chans, dtype=dtype))
        self.t_output = nn.Sequential(Dense(m, lan_chans, dtype=dtype))

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
