"""Stage-1 TRIS: the text-supervised response-map network.

Port of ``tris_tpu/models/stage1.py::TRISStage1``: ``response_maps`` (the
eval protocol, one fusion per (image, sentence) pair), ``forward(train=False)``
and ``forward(train=True)`` (the batch-contrastive classification head). The
pixel-text score with its upsample is K3 (``kernels.response_head`` for
eval, ``kernels.stage1_head`` for training); the fusion is K2 and the text
tower K1. BatchNorm follows the module's mode: ``model.train()`` for batch
statistics, as the JAX package's ``train=True``.

In a process group of several ranks (``tris_tpu_torch.parallel``), the
training forward scores this rank's images against the texts of the global
batch, gathered in rank order with their gradient, as the JAX package's one
program over the global batch does: ``cls_out`` is this rank's rows of the
global ``[B_global, B_global]``, its own texts at ``rank * B``.

``dtype`` is the JAX module's (``tris_tpu_torch.models.layers``): with
bfloat16, ``response_maps`` and the eval forward run K1, K2, K3's eval head
and K13's eval fold on bfloat16 operands, and the training forward K1, K2,
K3's training head and K13's batch statistics, forward and backward; the
maps, ``cls_out`` and ``scale`` are float32 either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from tris_tpu_torch import kernels, parallel
from tris_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, CLIPConfig
from tris_tpu_torch.models.fusion import BilateralPrompt
from tris_tpu_torch.models.layers import Conv1x1, Dense
from tris_tpu_torch.ops.dtypes import l2_normalize, weak

FUSION_RESIDUAL = 0.1  # fixed residual weight of the fusion (model_stage1.py:73-74)


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    backbone: str = "RN50"  # "RN50" | "RN101"
    hidden_dim: int = 1024
    txt_length: int = 20
    attn_multi: float = 0.1
    focal_p: float = 3.0
    focal_lambda: float = 0.01
    clip_override: Optional[CLIPConfig] = None  # for tests / custom backbones

    @property
    def clip_config(self) -> CLIPConfig:
        base = self.clip_override or CLIP_CONFIGS[self.backbone]
        return dataclasses.replace(base, txt_length=self.txt_length)

    @property
    def text_dim(self) -> int:
        return self.clip_config.embed_dim


class TRISStage1(nn.Module):
    def __init__(self, config: Stage1Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        ccfg = cfg.clip_config
        self.backbone = CLIP(ccfg, dtype)
        self.vis_project = Conv1x1(ccfg.vision_width * 32, cfg.hidden_dim, dtype=dtype)
        self.lan_project = Dense(cfg.text_dim, cfg.hidden_dim, dtype=dtype)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))
        if cfg.attn_multi > 0:
            self.attn_fusion = BilateralPrompt(cfg.hidden_dim, cfg.hidden_dim, dtype)

    def _features(self, image: torch.Tensor, word_ids: torch.Tensor):
        """L2-normalised pixel tokens [B, hw, D] (once per image), text
        embeddings [N, D], and the c4 grid (h, w)."""
        _, hidden = self.backbone.encode_text(word_ids)
        c4 = self.backbone.encode_image(image, pool=False)[3]          # [B, C4, h, w]
        h, w = c4.shape[2], c4.shape[3]
        vis = self.vis_project(c4.flatten(2).transpose(1, 2))          # [B, hw, D]
        lan = self.lan_project(hidden)
        return l2_normalize(vis), l2_normalize(lan), (h, w)

    def forward(self, image: torch.Tensor, word_ids: torch.Tensor, train: bool = False):
        """image [B, 3, H, W], word_ids [B, L], the fusion over all B texts.

        ``train=False``: the relu map [B, 1, H, W] of image b against its own
        text. ``train=True``: ``(cls_out [B, T], cls_fg [B], relu_map,
        sig_map [B, 1, H, W], scale)``, every image scored against every
        text of the global batch (T = B on one process, image b's own text
        at ``rank * B + b``; call ``model.train()`` first for BatchNorm's
        batch statistics, as the JAX package's ``train=True`` takes them)."""
        B, _, H, W = image.shape
        norm_vis, norm_lan, hw = self._features(image, word_ids)
        scale = self.logit_scale.exp()
        cfg = self.config
        if train:
            texts = parallel.all_gather(norm_lan)                      # [T, D], rank order
            lan_p = texts[None].expand(B, texts.shape[0], texts.shape[1])  # every image, all T
            vis_p = norm_vis
            if cfg.attn_multi > 0:
                new_vis, new_lan = self.attn_fusion(norm_vis, lan_p)
                vis_p = new_vis * _residual(new_vis) + norm_vis
                lan_p = new_lan * _residual(new_lan) + lan_p
            cls_out, cls_fg, relu_map, sig_map = kernels.stage1_head(
                vis_p, lan_p, scale, hw, (H, W), cfg.focal_p, cfg.focal_lambda,
                parallel.rank_world()[0] * B)
            return cls_out, cls_fg, relu_map[:, None], sig_map[:, None], scale
        new_vis = None
        lan_p = norm_lan
        if cfg.attn_multi > 0:
            lan_all = norm_lan[None].expand(B, B, norm_lan.shape[-1])  # every image, all B texts
            new_vis, new_lan = self.attn_fusion(norm_vis, lan_all)
            lan_p = new_lan.diagonal(dim1=0, dim2=1).T * _residual(new_lan) + norm_lan
        maps = kernels.response_head(new_vis, norm_vis, lan_p, 1, scale, _residual(new_vis), hw,
                                     (H, W))
        return maps[:, None]

    def response_maps(self, image: torch.Tensor, word_ids: torch.Tensor) -> torch.Tensor:
        """Per-(image, sentence) eval maps: [B, 3, H, W] x [B, S, L] -> [B, S, H, W].

        The reference's eval protocol runs the model at batch 1 per sentence,
        so each pair's fusion and score see only that pair's own text. The
        vision trunk runs once per image and serves its S sentences."""
        B, S, L = word_ids.shape
        H, W = image.shape[2], image.shape[3]
        norm_vis, norm_lan, hw = self._features(image, word_ids.reshape(B * S, L))
        scale = self.logit_scale.exp()
        new_vis = None
        lan_p = norm_lan
        if self.config.attn_multi > 0:
            new_vis, new_lan = self.attn_fusion(norm_vis, norm_lan[:, None], S)
            lan_p = new_lan[:, 0] * _residual(new_lan) + norm_lan
        maps = kernels.response_head(new_vis, norm_vis, lan_p, S, scale, _residual(new_vis), hw,
                                     (H, W))
        return maps.reshape(B, S, H, W)


def _residual(new) -> float:
    """The fusion's residual weight as jnp multiplies ``new`` by it: in new's dtype."""
    return weak(FUSION_RESIDUAL, torch.float32 if new is None else new.dtype)
