"""Hand-written Hopper kernels of the stage-1 eval, PRMS, stage-1 train,
IRN training, IRNet instance pseudo-mask and stage-2 train and eval paths,
each beside its plain PyTorch version; K13, BatchNorm with its activation,
serves every BatchNorm of the CLIP trunk and stage 2's decoder.

A wrapper launches its CUDA kernel when given CUDA tensors and uses the
plain version when given CPU tensors; there is no other switch. On CUDA the
differentiable ones (K1, K2, K3's training head, K5, K6's bilinear resize,
K7, K8, K11 and K13) are ``torch.autograd.Function``s whose backward is a kernel too.
The extension is built from ``csrc/`` at the first launch (``build.py``).
"""

from tris_tpu_torch.kernels.batch_norm import (batch_norm_act, batch_norm_act_plain,
                                               batch_norm_act_reference)
from tris_tpu_torch.kernels.build import KERNELS, build_all, launches, reset_launches
from tris_tpu_torch.kernels.centroids import refine_centroids, refine_centroids_plain
from tris_tpu_torch.kernels.critic_input import critic_input, critic_input_plain
from tris_tpu_torch.kernels.cross_attn import cross_attn, cross_attn_launch_shape, cross_attn_plain
from tris_tpu_torch.kernels.ema import EmaTable, ema_update, ema_update_plain
from tris_tpu_torch.kernels.eval_metrics import (
    eval_metrics, eval_metrics_launch_shape, eval_metrics_plain, eval_metrics_plan, eval_tables)
from tris_tpu_torch.kernels.irn_loss import irn_loss, irn_loss_plain
from tris_tpu_torch.kernels.mha import mha_short, mha_short_launch_shape, mha_short_plain
from tris_tpu_torch.kernels.normalize import normalize_u8_nchw, normalize_u8_nchw_plain
from tris_tpu_torch.kernels.path_max import path_max_affinity, path_max_affinity_plain
from tris_tpu_torch.kernels.pixel_attn import (
    pixel_attn, pixel_attn_launch_shape, pixel_attn_plain)
from tris_tpu_torch.kernels.resize import (
    bilinear_resize, bilinear_resize_launch_shape, bilinear_resize_plain, bilinear_resize_plan)
from tris_tpu_torch.kernels.response_head import response_head, response_head_plain
from tris_tpu_torch.kernels.stage1_head import stage1_head, stage1_head_plain
from tris_tpu_torch.kernels.walk import (
    walk_matmul, walk_matmul_plain, walk_square, walk_tile_occupancy, walk_tile_occupancy_plain,
    walk_transition, walk_transition_plain)

__all__ = [
    "KERNELS", "build_all", "launches", "reset_launches",
    "mha_short", "mha_short_plain", "mha_short_launch_shape",
    "cross_attn", "cross_attn_plain", "cross_attn_launch_shape",
    "response_head", "response_head_plain", "stage1_head", "stage1_head_plain",
    "eval_metrics", "eval_metrics_plain", "eval_tables", "eval_metrics_plan",
    "eval_metrics_launch_shape",
    "critic_input", "critic_input_plain", "normalize_u8_nchw", "normalize_u8_nchw_plain",
    "bilinear_resize", "bilinear_resize_plain", "bilinear_resize_plan",
    "bilinear_resize_launch_shape", "path_max_affinity", "path_max_affinity_plain",
    "refine_centroids", "refine_centroids_plain", "walk_transition", "walk_transition_plain",
    "walk_matmul", "walk_matmul_plain", "walk_square", "walk_tile_occupancy",
    "walk_tile_occupancy_plain", "irn_loss", "irn_loss_plain",
    "pixel_attn", "pixel_attn_plain", "pixel_attn_launch_shape",
    "EmaTable", "ema_update", "ema_update_plain", "batch_norm_act", "batch_norm_act_plain",
    "batch_norm_act_reference",
]
