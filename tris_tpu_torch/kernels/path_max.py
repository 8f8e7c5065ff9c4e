"""K7, forward: pixel-pair affinities ``1 - max(edge along the path)``
(``csrc/path_max_affinity.cu``), and its plain PyTorch version.

Replaces ``tris_tpu/pseudo/indexing.py::path_max_affinity_slices``: for
every direction of a ``PathIndex`` (its ``paths_by_length``, groups of
equal path length in ascending order), the max over the path's steps
(dy, dx) of the edge map's window ``edge[dy : dy + ch, rf + dx : rf + dx +
cw]`` (ch = H - rf, cw = W - 2 * rf). The result is
``[..., n_dirs, ch, cw]`` with the directions in the groups' concat order,
which the walk's transition build and the IRN loss read. A max is exact:
kernel, plain version and JAX agree bit for bit.
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
    """(steps [n_steps, 2], offsets [n_dirs + 1]) int32 on ``device``."""
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


def path_max_affinity(edge, paths_by_length, radius_floor: int):
    """K7 on a CUDA tensor (one launch); the plain version on a CPU tensor.
    edge ``[..., H, W]`` float32 -> ``[..., n_dirs, H - rf, W - 2 * rf]``."""
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
    out = build.ops().path_max_affinity(edge.reshape(-1, H, W).contiguous(), steps, offsets, rf)
    build.count("path_max_affinity")
    return out.reshape(*edge.shape[:-2], *out.shape[1:])
