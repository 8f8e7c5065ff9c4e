"""K7: pixel-pair affinities ``1 - max(edge along the path)``
(``csrc/path_max_affinity.cu``), its backward
(``csrc/path_max_affinity_bwd.cu``) and its plain PyTorch version.

Replaces ``tris_tpu/pseudo/indexing.py::path_max_affinity_slices``: for
every direction of a ``PathIndex`` (its ``paths_by_length``, groups of
equal path length in ascending order), the max over the path's steps
(dy, dx) of the edge map's window ``edge[dy : dy + ch, rf + dx : rf + dx +
cw]`` (ch = H - rf, cw = W - 2 * rf). The result is
``[..., n_dirs, ch, cw]`` with the directions in the groups' concat order,
which the walk's transition build and the IRN loss read. A max is exact:
kernel, plain version and JAX agree bit for bit.

On a CUDA tensor it is a ``torch.autograd.Function``. Its backward sends
each entry's gradient to the pixels of its path that equal the path's max,
split evenly among them where several tie, as the JAX package's
``reduce_max`` VJP does (and ``torch.amax``'s backward, the plain
version's); the forward keeps only the edge map, from which the backward
recomputes each path's max and its tie count. The backward adds each
pixel's terms in double and rounds once: the exact gradient rounded to
float32, whatever the order of the sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tris_tpu_torch.kernels import build


def path_steps(paths_by_length) -> tuple:
    """Each direction's path as a tuple of (dy, dx) steps, directions in the
    groups' concat order (hashable: the key of the device table)."""
    return tuple(tuple(map(tuple, np.asarray(path).tolist()))
                 for group in paths_by_length for path in group)


@functools.lru_cache(maxsize=16)
def _path_table(steps: tuple, device: torch.device):
    """(steps [n_steps, 2], offsets [n_dirs + 1]) int32 on ``device``. The
    backward counts a path's ties in a byte: no path may have more than 255
    steps (radius 10's longest has 22)."""
    if max(map(len, steps), default=0) > 255:
        raise ValueError("path_max_affinity: a path has more than 255 steps")
    flat = np.asarray([s for path in steps for s in path], np.int32).reshape(-1, 2)
    offsets = np.cumsum([0] + [len(path) for path in steps]).astype(np.int32)
    return torch.as_tensor(flat, device=device), torch.as_tensor(offsets, device=device)


def path_max_affinity_plain(edge, paths_by_length, radius_floor: int):
    """The plain version: the JAX package's static slices, max per direction."""
    H, W = edge.shape[-2:]
    rf = radius_floor
    ch, cw = H - rf, W - 2 * rf
    per = [torch.stack([edge[..., dy:dy + ch, rf + dx:rf + dx + cw] for dy, dx in path]).amax(0)
           for path in path_steps(paths_by_length)]
    return 1.0 - torch.stack(per, dim=-3)


class _PathMaxAffinity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge, steps, offsets, rf, save):
        out = build.ops().path_max_affinity(edge, steps, offsets, rf)
        build.count("path_max_affinity")
        ctx.rf = rf
        if save:  # nothing is kept when the edge map needs no gradient
            ctx.save_for_backward(edge, steps, offsets)
        return out

    @staticmethod
    def backward(ctx, g):
        edge, steps, offsets = ctx.saved_tensors
        d_edge = build.ops().path_max_affinity_bwd(edge, g.contiguous(), steps, offsets, ctx.rf)
        build.count("path_max_affinity_bwd", n=2)
        return d_edge, None, None, None, None


def path_max_affinity(edge, paths_by_length, radius_floor: int):
    """K7 on a CUDA tensor (one launch forward, two backward); the plain
    version on a CPU tensor. edge ``[..., H, W]`` float32 -> ``[..., n_dirs,
    H - rf, W - 2 * rf]``."""
    if edge.device.type == "cpu":
        return path_max_affinity_plain(edge, paths_by_length, radius_floor)
    build.require_cuda_f32("path_max_affinity", edge)
    if edge.dtype != torch.float32 or edge.dim() < 2:
        raise TypeError(f"path_max_affinity: expected float32 [..., H, W], got {edge.dtype} "
                        f"{tuple(edge.shape)}")
    H, W = edge.shape[-2:]
    rf = int(radius_floor)
    if H <= rf or W <= 2 * rf:
        raise ValueError(f"path_max_affinity: edge {H}x{W} too small for radius floor {rf}")
    steps, offsets = _path_table(path_steps(paths_by_length), edge.device)
    out = _PathMaxAffinity.apply(edge.reshape(-1, H, W).contiguous(), steps, offsets, rf,
                                 torch.is_grad_enabled() and edge.requires_grad)
    return out.reshape(*edge.shape[:-2], *out.shape[1:])
