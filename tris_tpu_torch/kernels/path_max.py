"""K7: pixel-pair affinities ``1 - max(edge along the path)``
(``csrc/path_max_affinity.cu``), its backward (``csrc/path_max_affinity_bwd.cu``,
the tiled gather of ``csrc/path_max_tiles.cuh``) and its plain PyTorch version.

Replaces ``tris_tpu/pseudo/indexing.py::path_max_affinity_slices``: for
every direction of a ``PathIndex`` (its ``paths_by_length``, groups of
equal path length in ascending order), the max over the path's steps
(dy, dx) of the edge map's window ``edge[dy : dy + ch, rf + dx : rf + dx +
cw]`` (ch = H - rf, cw = W - 2 * rf). The result is
``[..., n_dirs, ch, cw]`` with the directions in the groups' concat order,
which the walk's transition build reads. A max is exact: kernel, plain
version and JAX agree bit for bit. IRN training does not call it: its loss
takes the edge map itself (``kernels/irn_affinity.py``), so the affinity
never reaches device memory there.

On a CUDA tensor it is a ``torch.autograd.Function``. Its backward sends
each entry's gradient to the pixels of its path that equal the path's max,
split evenly among them where several tie, as the JAX package's
``reduce_max`` VJP does (and ``torch.amax``'s backward, the plain
version's); the forward keeps only the edge map, from which the backward,
one launch, recomputes each path's max and its tie count over a tile of
pixels and its halo in shared memory. Each pixel adds its terms in double,
directions in table order and steps in path order, and rounds once: the
exact gradient rounded to float32, whatever the tiling.
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


# the most steps and directions a path table may hold for the tiled kernels (launchers.h
# kPathTableSteps, kPathTableDirs: radius 12 has 3606 steps and 218 directions)
TABLE_STEPS, TABLE_DIRS = 4096, 256
# what a tile plan tiles (launchers.h kPathLossForward, kPathLossBackward, kPathMaxBackward)
LOSS_FORWARD, LOSS_BACKWARD, MAX_BACKWARD = 0, 1, 2


@functools.lru_cache(maxsize=16)
def _path_table(steps: tuple, device: torch.device):
    """(steps [n_steps, 2], offsets [n_dirs + 1]) int32 on ``device``."""
    flat = np.asarray([s for path in steps for s in path], np.int32).reshape(-1, 2)
    offsets = np.cumsum([0] + [len(path) for path in steps]).astype(np.int32)
    return torch.as_tensor(flat, device=device), torch.as_tensor(offsets, device=device)


@functools.lru_cache(maxsize=16)
def tile_table(steps: tuple, rf: int):
    """The path table of the tiled kernels (``csrc/path_max_tiles.cuh``) as
    int32 CPU tensors (steps [n_steps, 2], offsets [n_dirs + 1]): the
    launcher puts it in a kernel parameter. Raises before any launch where a
    step leaves the window of radius floor ``rf`` (0 <= dy <= rf, |dx| <= rf)
    or the table is larger than the kernels take."""
    flat, offsets = _path_table(steps, torch.device("cpu"))
    n_steps, n_dirs = flat.shape[0], offsets.shape[0] - 1
    if n_steps > TABLE_STEPS or n_dirs > TABLE_DIRS:
        raise ValueError(f"path table of {n_dirs} directions and {n_steps} steps: the tiled "
                         f"kernels take at most {TABLE_DIRS} and {TABLE_STEPS} (radius 12)")
    if min(map(len, steps), default=1) < 1:
        raise ValueError("path table: a direction has no step")
    a = flat.numpy()
    if a.size and not ((a[:, 0] >= 0) & (a[:, 0] <= rf) & (np.abs(a[:, 1]) <= rf)).all():
        raise ValueError(f"path table: steps outside the window of radius floor {rf}")
    return flat, offsets


def tile_plan(kind: int, B: int, H: int, W: int, rf: int) -> dict:
    """``launchers.h::path_tile_plan`` as the extension computes it, checked
    to fit one block's shared memory."""
    plan = build.ops().path_tile_plan(kind, B, H, W, rf)
    if plan["smem_bytes"] > build.MAX_SMEM:
        raise ValueError(f"path_max: a tile at radius floor {rf} needs {plan['smem_bytes']} "
                         f"bytes of shared memory, more than a block has")
    return plan


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
    def forward(ctx, edge, steps, offsets, rf, table):
        out = build.ops().path_max_affinity(edge, steps, offsets, rf)
        build.count("path_max_affinity")
        ctx.rf, ctx.table = rf, table
        if table is not None:  # the backward's table: nothing is kept when no gradient is needed
            ctx.save_for_backward(edge)
        return out

    @staticmethod
    def backward(ctx, g):
        (edge,) = ctx.saved_tensors
        d_edge = build.ops().path_max_affinity_bwd(edge, g.contiguous(), *ctx.table, ctx.rf)
        build.count("path_max_affinity_bwd")
        return d_edge, None, None, None, None


def path_max_affinity(edge, paths_by_length, radius_floor: int):
    """K7 on a CUDA tensor (one launch forward, one backward); the plain
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
    key = path_steps(paths_by_length)
    steps, offsets = _path_table(key, edge.device)
    flat = edge.reshape(-1, H, W).contiguous()
    table = None
    if torch.is_grad_enabled() and edge.requires_grad:  # the backward's table and tiles, checked
        table = tile_table(key, rf)
        tile_plan(MAX_BACKWARD, flat.shape[0], H, W, rf)
    out = _PathMaxAffinity.apply(flat, steps, offsets, rf, table)
    return out.reshape(*edge.shape[:-2], *out.shape[1:])
