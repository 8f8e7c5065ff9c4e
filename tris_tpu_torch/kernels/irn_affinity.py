"""K7 + K8: IRN training's loss straight from the edge map, the path-max
affinity never written (``csrc/irn_affinity.cu`` on ``csrc/path_max_tiles.cuh``),
forward and backward, and its plain PyTorch version.

Replaces, fused, ``tris_tpu/pseudo/indexing.py::path_max_affinity_slices``
(K7, ``kernels/path_max.py``), ``tris_tpu/pseudo/train_irn.py::affinity_labels_on_device``
and the masked sums of ``irn_loss`` (K8, ``kernels/irn_loss.py``), with the
loss fields of ``tris_tpu/pseudo/irnet.py::affinity_displacement_losses``:
from the quarter-scale ir label map, the edge map (after its sigmoid) and
the displacement field, the five masked sums and three integer pair counts
that ``irn_loss_plain`` returns for K7's affinity.

On CUDA tensors it is a ``torch.autograd.Function`` that keeps only its
three inputs (5 MB at B = 24, crop 512) where the unfused chain kept and
wrote fields of the affinity's size (191 MB each): the forward (two
launches: the tiles, then a fixed-order sum of their partials) forms each
pair's path max, affinity and loss terms in shared memory; the backward
(one launch) recomputes them per tile of pixels and gathers d edge (in
double, rounded once, the ties split evenly as JAX's ``reduce_max`` VJP
does) and d dp (in float, in K8's order).
"""

from __future__ import annotations

import functools
import importlib

import numpy as np
import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.kernels import path_max as K7

# the module (the package's name irn_loss is K8's function): MAX_VALID is read at each call
K8 = importlib.import_module("tris_tpu_torch.kernels.irn_loss")


def irn_affinity_loss_plain(labels, edge, dp, path_index):
    """The plain version: K7's plain affinity, then K8's plain masked sums."""
    rf = path_index.radius_floor
    aff = K7.path_max_affinity_plain(edge, path_index.paths_by_length, rf)
    return K8.irn_loss_plain(labels, aff, dp, path_index.search_dst, rf)


@functools.lru_cache(maxsize=16)
def _loss_table(steps: tuple, search_dst: tuple, rf: int):
    """The tiled kernels' path table, once each direction's destination has
    been checked to be its path's first step (the kernels read it there)
    and to lie in the window of ``rf``."""
    K8._dirs_table(search_dst, rf, torch.device("cpu"))
    if tuple(p[0] for p in steps) != search_dst:
        raise ValueError("irn_affinity_loss: search_dst is not the paths' first steps")
    return K7.tile_table(steps, rf)


class _IrnAffinityLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge, dp, labels, table, rf, save):
        sums, counts = build.ops().irn_affinity_loss(labels, edge, dp, *table, rf, K8.EPS,
                                                     K8.ONE_EPS, K8.MAX_VALID)
        build.count("irn_affinity_loss", n=2)
        ctx.rf, ctx.table, ctx.max_valid = rf, table, K8.MAX_VALID
        ctx.mark_non_differentiable(counts)
        if save:  # nothing is kept when neither input needs a gradient
            ctx.save_for_backward(edge, dp, labels)
        return sums, counts

    @staticmethod
    def backward(ctx, g_sums, g_counts):
        edge, dp, labels = ctx.saved_tensors
        d_edge, d_dp = build.ops().irn_affinity_loss_bwd(labels, edge, dp, g_sums.contiguous(),
                                                         *ctx.table, ctx.rf, K8.EPS, K8.ONE_EPS,
                                                         ctx.max_valid)
        build.count("irn_affinity_loss_bwd")
        return d_edge, d_dp, None, None, None, None


def irn_affinity_loss(labels, edge, dp, path_index):
    """The IRN loss's sums from the edge map: the fused kernels on CUDA
    tensors (two launches forward, one backward), the plain version on CPU
    tensors. labels uint8 ``[B, H, W]``, edge ``[B, H, W]`` (the sigmoid of
    the edge logits), dp ``[B, 2, H, W]`` float32 -> (sums [5] float32,
    counts [3] int64), as ``irn_loss`` returns for K7's affinity of edge; a
    pair counts where both its labels are below ``irn_loss.MAX_VALID``."""
    if edge.device.type == "cpu":
        return irn_affinity_loss_plain(labels, edge, dp, path_index)
    build.require_cuda("irn_affinity_loss", edge, dp, labels)
    rf = int(path_index.radius_floor)
    if labels.dim() != 3:
        raise ValueError(f"irn_affinity_loss: expected labels [B, H, W], got "
                         f"{tuple(labels.shape)}")
    B, H, W = labels.shape
    if (labels.dtype != torch.uint8 or edge.shape != labels.shape or dp.shape != (B, 2, H, W)
            or H <= rf or W <= 2 * rf):
        raise ValueError(f"irn_affinity_loss: bad inputs labels {labels.dtype} "
                         f"{tuple(labels.shape)}, edge {tuple(edge.shape)}, dp {tuple(dp.shape)}, "
                         f"rf {rf}")
    table = _loss_table(K7.path_steps(path_index.paths_by_length),
                        tuple(map(tuple, np.asarray(path_index.search_dst).tolist())), rf)
    for kind in (K7.LOSS_FORWARD, K7.LOSS_BACKWARD):
        K7.tile_plan(kind, B, H, W, rf)
    save = torch.is_grad_enabled() and (edge.requires_grad or dp.requires_grad)
    return _IrnAffinityLoss.apply(edge.contiguous(), dp.contiguous(), labels.contiguous(), table,
                                  rf, save)
