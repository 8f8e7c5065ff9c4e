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

The forward takes tiles of pairs over a staged edge map, the path table a
kernel parameter (``launchers.h::path_tile_plan``'s ``kPathMaxForward``,
:func:`forward_plan`), where the table fits that parameter (radius 12 and
below); a larger table takes the direct kernel, a thread an output. The plan
chooses, by the table's size alone; both are bit for bit the plain version.

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
# what a tile plan tiles (launchers.h kPathLossForward, kPathLossBackward, kPathMaxBackward,
# kPathMaxForward)
LOSS_FORWARD, LOSS_BACKWARD, MAX_BACKWARD, MAX_FORWARD = 0, 1, 2, 3


@functools.lru_cache(maxsize=16)
def _path_table(steps: tuple, device: torch.device):
    """(steps [n_steps, 2], offsets [n_dirs + 1]) int32 on ``device``."""
    flat = np.asarray([s for path in steps for s in path], np.int32).reshape(-1, 2)
    offsets = np.cumsum([0] + [len(path) for path in steps]).astype(np.int32)
    return torch.as_tensor(flat, device=device), torch.as_tensor(offsets, device=device)


@functools.lru_cache(maxsize=16)
def check_window(steps: tuple, rf: int) -> None:
    """Raises where a direction has no step or a step leaves the window of
    radius floor ``rf`` (0 <= dy <= rf, |dx| <= rf), whose staged rows the
    tiles read."""
    if min(map(len, steps), default=1) < 1:
        raise ValueError("path table: a direction has no step")
    a = _path_table(steps, torch.device("cpu"))[0].numpy()
    if a.size and not ((a[:, 0] >= 0) & (a[:, 0] <= rf) & (np.abs(a[:, 1]) <= rf)).all():
        raise ValueError(f"path table: steps outside the window of radius floor {rf}")


@functools.lru_cache(maxsize=16)
def tile_table(steps: tuple, rf: int):
    """The path table of the tiled backward kernels (``csrc/path_max_tiles.cuh``)
    as int32 CPU tensors (steps [n_steps, 2], offsets [n_dirs + 1]): the
    launcher puts it in a kernel parameter. Raises before any launch where a
    step leaves the window (:func:`check_window`) or the table is larger than
    the kernels take."""
    flat, offsets = _path_table(steps, torch.device("cpu"))
    n_steps, n_dirs = flat.shape[0], offsets.shape[0] - 1
    if n_steps > TABLE_STEPS or n_dirs > TABLE_DIRS:
        raise ValueError(f"path table of {n_dirs} directions and {n_steps} steps: the tiled "
                         f"kernels take at most {TABLE_DIRS} and {TABLE_STEPS} (radius 12)")
    check_window(steps, rf)
    return flat, offsets


def tile_plan(kind: int, B: int, H: int, W: int, rf: int) -> dict:
    """``launchers.h::path_tile_plan`` as the extension computes it, checked
    to fit one block's shared memory."""
    plan = build.ops().path_tile_plan(kind, B, H, W, rf)
    if plan["smem_bytes"] > build.MAX_SMEM:
        raise ValueError(f"path_max: a tile at radius floor {rf} needs {plan['smem_bytes']} "
                         f"bytes of shared memory, more than a block has")
    return plan


def forward_plan(B: int, H: int, W: int, rf: int, n_dirs: int, n_steps: int) -> dict:
    """K7's forward launch as the extension plans it: ``tiled`` (1: the tiles
    of ``path_tile_plan(kPathMaxForward)``, whose fields follow; 0: the direct
    kernel)."""
    return dict(build.ops().path_max_forward_plan(B, H, W, rf, n_dirs, n_steps))


def launch_shape() -> dict:
    """The last forward launch in this process: tiled, blocks, threads, rpt,
    dir_groups, smem_bytes."""
    if build.launches["path_max_affinity"] == 0:
        raise RuntimeError("path_max_affinity: no launch of the forward counted")
    return dict(build.ops().path_max_affinity_launch_shape())


def path_max_affinity_plain(edge, paths_by_length, radius_floor: int):
    """The plain version: the JAX package's static slices, max per direction."""
    H, W = edge.shape[-2:]
    rf = radius_floor
    ch, cw = H - rf, W - 2 * rf
    per = [torch.stack([edge[..., dy:dy + ch, rf + dx:rf + dx + cw] for dy, dx in path]).amax(0)
           for path in path_steps(paths_by_length)]
    return 1.0 - torch.stack(per, dim=-3)


def forward_kernel(edge, key: tuple, rf: int, groups: int = 0):
    """One launch of K7's forward on ``edge`` [B, H, W] (contiguous, on the
    card) for the path table ``key`` (:func:`path_steps`); ``groups > 0``
    overrides the tiled plan's direction groups (to measure them). Not
    counted: :func:`path_max_affinity` counts its own."""
    if not 0 <= groups <= 64:
        raise ValueError(f"path_max_affinity: direction groups {groups} not in [0, 64]")
    host = _path_table(key, torch.device("cpu"))
    return build.ops().path_max_affinity(edge, *host, *_path_table(key, edge.device), rf, groups)


class _PathMaxAffinity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge, key, rf, table):
        out = forward_kernel(edge, key, rf)
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
        return d_edge, None, None, None


def path_max_affinity(edge, paths_by_length, radius_floor: int):
    """K7 on a CUDA tensor (one launch forward, tiled or direct as
    :func:`forward_plan` says, one backward); the plain version on a CPU
    tensor. edge ``[..., H, W]`` float32 -> ``[..., n_dirs,
    H - rf, W - 2 * rf]``."""
    if edge.device.type == "cpu":
        return path_max_affinity_plain(edge, paths_by_length, radius_floor)
    build.require_cuda("path_max_affinity", edge)
    if edge.dtype != torch.float32 or edge.dim() < 2:
        raise TypeError(f"path_max_affinity: expected float32 [..., H, W], got {edge.dtype} "
                        f"{tuple(edge.shape)}")
    H, W = edge.shape[-2:]
    rf = int(radius_floor)
    if H <= rf or W <= 2 * rf:
        raise ValueError(f"path_max_affinity: edge {H}x{W} too small for radius floor {rf}")
    key = path_steps(paths_by_length)
    check_window(key, rf)
    flat = edge.reshape(-1, H, W).contiguous()
    table = None
    if torch.is_grad_enabled() and edge.requires_grad:  # the backward's table and tiles, checked
        table = tile_table(key, rf)
        tile_plan(MAX_BACKWARD, flat.shape[0], H, W, rf)
    out = _PathMaxAffinity.apply(flat, key, rf, table)
    return out.reshape(*edge.shape[:-2], *out.shape[1:])
