"""K9: centroid refinement (``csrc/refine_centroids.cu``), and its plain
PyTorch version.

Replaces ``tris_tpu/pseudo/labels.py::_refine_centroids``: every pixel of the
stride-4 grid starts at its own coordinates and takes ``iterations`` steps
``c = clip(c + bilinear(displacement, c), 0, size - 1)``; the result is
rounded half to even to int32 ``[2, H, W]``. The bilinear sample reads the
four corners of the edge-replicated field in the JAX term order, each
product and sum rounded alone, so the centroids equal JAX's exactly.

On a CUDA tensor one launch (``csrc/launchers.h::refine_centroids_plan``,
read back by :func:`refine_centroids_plan` and emulated by
``tris_tpu_torch/tools/centroids_schedule.py``): where the field's
edge-replicated table fits shared memory, every block stages it and the
pixels are spread evenly over one block an SM; else each thread reads the
field from device memory. A warp of 32 pixels stops at the first step that
leaves all its centroids as they were (every later step would repeat it),
which :func:`refine_centroids_steps` reports.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build


def refine_centroids_plain(displacement, iterations: int = 300):
    """The plain version: the JAX package's corner table and loop, written
    out in PyTorch (one gather of the [HW, 8] table per step)."""
    _, H, W = displacement.shape
    dev = displacement.device
    cy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    cx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    f = displacement.permute(1, 2, 0)
    f = torch.cat([f, f[-1:]], 0)
    f = torch.cat([f, f[:, -1:]], 1)                        # [H + 1, W + 1, 2], edge-replicated
    neigh = torch.cat([f[:-1, :-1], f[:-1, 1:], f[1:, :-1], f[1:, 1:]], -1).reshape(H * W, 8)
    for _ in range(iterations):
        iy = torch.floor(cy).to(torch.int32)
        ix = torch.floor(cx).to(torch.int32)
        yc = (cy - iy)[..., None]
        xc = (cx - ix)[..., None]
        n = neigh[(iy * W + ix).reshape(-1).long()].reshape(H, W, 8)
        v = (n[..., 6:8] * yc * xc
             + n[..., 2:4] * (1 - yc) * xc
             + n[..., 4:6] * yc * (1 - xc)
             + n[..., 0:2] * (1 - yc) * (1 - xc))
        cy = torch.clamp(cy + v[..., 0], 0, H - 1)
        cx = torch.clamp(cx + v[..., 1], 0, W - 1)
    return torch.stack([torch.round(cy), torch.round(cx)]).to(torch.int32)


def refine_centroids_plan(H: int, W: int) -> dict:
    """The launch for the grid ``[H, W]`` (``launchers.h``'s rule, from the
    extension): staged, threads, blocks, warps and smem_bytes."""
    if min(H, W) < 0 or H * W >= 2 ** 31:
        raise ValueError(f"refine_centroids_plan: bad grid {(H, W)}")
    return dict(build.ops().refine_centroids_plan(H, W))


_last_steps = []


def refine_centroids_steps():
    """The steps each warp of the last launch in this process took (int32
    [warps], on its device; ``iterations`` where a warp found no fixed point)."""
    if not _last_steps:
        raise RuntimeError("refine_centroids_steps: no launch of refine_centroids")
    return _last_steps[0]


def refine_centroids(displacement, iterations: int = 300):
    """K9 on a CUDA tensor (one launch); the plain version on a CPU tensor.
    displacement [2, H, W] float32 -> int32 centroids [2, H, W]."""
    if displacement.device.type == "cpu":
        return refine_centroids_plain(displacement, iterations)
    build.require_cuda("refine_centroids", displacement)
    if (displacement.dtype != torch.float32 or displacement.dim() != 3
            or displacement.shape[0] != 2):
        raise TypeError(f"refine_centroids: expected float32 [2, H, W], got "
                        f"{displacement.dtype} {tuple(displacement.shape)}")
    if iterations < 0 or displacement.shape[1] * displacement.shape[2] >= 2 ** 31:
        raise ValueError(f"refine_centroids: bad grid {tuple(displacement.shape)} or "
                         f"iterations {iterations}")
    out, steps = build.ops().refine_centroids(displacement.contiguous(), int(iterations))
    build.count("refine_centroids")
    _last_steps[:] = [steps]
    return out
