"""K6, bilinear half: ``[..., H, W]`` float32 (or bfloat16) resized bilinearly
(``csrc/bilinear_resize.cu``), its backward (``csrc/bilinear_resize_bwd.cu``)
and its plain PyTorch version.

The forward flattens the planes' output rows and takes them in bands of
rows, a thread owning 4 consecutive columns (16-byte stores where ow % 4 ==
0) and each row's interpolated input row formed once in shared memory; the
bands, tiles and threads are ``csrc/launchers.h::bilinear_resize_plan``'s,
which :func:`bilinear_resize_plan` reads back from the extension and
``tris_tpu_torch/tools/resize_schedule.py`` emulates on the host;
:func:`bilinear_resize_launch_shape` gives the last launch's grid.

Replaces ``tris_tpu/ops/resize.py::bilinear_resize`` (two HIGHEST-precision
products with the interpolation matrices) on the IRNet path: the heads'
upsamples, the CAM to the stride-4 grid and the walk back to the image.
Both sample with the matrices' taps (``ops/resize.py::interp_taps``) rows
first, each product and sum rounded alone, so kernel and plain version
agree bit for bit; against the JAX matrix products they agree to rounding.
On a CUDA tensor it is a ``torch.autograd.Function`` whose backward, the
resize's adjoint, is a gather over tap ranges (IRN training and stage 2
backpropagate through the heads' and the decoder's upsamples): a block takes
a band of the planes' flattened input rows, stages the run of g rows their
ranges cover in shared memory and forms the column adjoint once per staged
row, then the row adjoint (``launchers.h::bilinear_resize_bwd_plan``, read
back by :func:`bilinear_resize_bwd_plan` and emulated by the schedule tool;
:func:`bilinear_resize_bwd_launch_shape` gives the last launch's grid). The
plain version's gradient is autograd's through the taps' gather.
``ops/resize.py::bilinear_resize``
(``F.interpolate``) stays for the stage-1 positional-embedding resize.

``--bf16`` (stage 2's eval forward): on bfloat16 planes the JAX function
casts its matrices to bfloat16 and takes two bfloat16 products, rows first,
so the taps' weights are rounded to bfloat16 (:func:`bf16_taps_on`) and each
row value and each output is the float32 sum of its two products rounded to
bfloat16; one launch of ``bilinear_resize_bf16`` (counted as
``bilinear_resize.bf16``), bit for bit the plain version, forward only (with
a gradient it raises before any launch).
"""

from __future__ import annotations

import functools

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.kernels.response_head import adjoint_taps_on, taps_on, upsample_taps_plain
from tris_tpu_torch.ops.dtypes import low

BF16 = torch.bfloat16


@functools.lru_cache(maxsize=64)
def bf16_taps_on(in_size: int, out_size: int, align_corners: bool, device: torch.device):
    """:func:`taps_on` with the weights rounded to bfloat16 (kept float32), as
    ``resize_matrix(...).astype(bfloat16)`` rounds the matrices' entries."""
    lo, hi, w0, w1 = taps_on(in_size, out_size, align_corners, device)
    return lo, hi, w0.to(BF16).float(), w1.to(BF16).float()


def bilinear_resize_plain(x, size, align_corners: bool = False):
    """The plain version: the taps gathered, rows then columns; below float32
    with the weights rounded to x's dtype, each row value and each output
    summed in float32 and rounded to x's dtype."""
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    if not low(x):
        return upsample_taps_plain(x, taps_on(h, oh, align_corners, x.device),
                                   taps_on(w, ow, align_corners, x.device))
    (ylo, yhi, wy0, wy1), (xlo, xhi, wx0, wx1) = (bf16_taps_on(n, m, align_corners, x.device)
                                                  for n, m in ((h, oh), (w, ow)))
    xf = x.float()
    r = (wy0[:, None] * xf[..., ylo.long(), :] + wy1[:, None] * xf[..., yhi.long(), :])
    r = r.to(x.dtype).float()
    return (wx0 * r[..., xlo.long()] + wx1 * r[..., xhi.long()]).to(x.dtype)


def _check_shape(name: str, planes: int, h: int, w: int, oh: int, ow: int) -> None:
    """The shapes the plans and kernels take, refused here before any launch."""
    if planes < 0 or min(h, w, oh, ow) < 1 or max(h, w, oh, ow) >= 2 ** 31:
        raise ValueError(f"{name}: bad shape {(planes, h, w, oh, ow)}")


def bilinear_resize_plan(planes: int, h: int, w: int, oh: int, ow: int) -> dict:
    """The forward's launch for ``[planes, h, w] -> [oh, ow]`` (``launchers.h``'s
    rule, from the extension): vec, groups, tile_groups, tiles, rows, threads,
    pitch, staged, chunks, band_rows, bands, blocks, in_floats and smem_bytes."""
    _check_shape("bilinear_resize_plan", planes, h, w, oh, ow)
    return dict(build.ops().bilinear_resize_plan(planes, h, w, oh, ow))


def bilinear_resize_bwd_plan(planes: int, h: int, w: int, oh: int, ow: int) -> dict:
    """The backward's launch for ``[planes, h, w] <- [oh, ow]`` (``launchers.h``'s
    rule, from the extension): staged, band, span_rows, g_pitch, r_pitch, vec,
    col_lanes, threads, blocks and smem_bytes."""
    _check_shape("bilinear_resize_bwd_plan", planes, h, w, oh, ow)
    return dict(build.ops().bilinear_resize_bwd_plan(planes, h, w, oh, ow))


def bilinear_resize_launch_shape() -> dict:
    """The grid of the last forward launch in this process: blocks, tiles,
    threads, band_rows, vec, staged, in_floats and smem_bytes."""
    if build.launches["bilinear_resize"] == 0:
        raise RuntimeError("bilinear_resize_launch_shape: no launch of bilinear_resize counted")
    return dict(build.ops().bilinear_resize_launch_shape())


def bilinear_resize_bwd_launch_shape() -> dict:
    """The grid of the last backward launch in this process: blocks, threads,
    band, span_rows, vec, staged and smem_bytes."""
    if build.launches["bilinear_resize_bwd"] == 0:
        raise RuntimeError("bilinear_resize_bwd_launch_shape: no launch of bilinear_resize_bwd "
                           "counted")
    return dict(build.ops().bilinear_resize_bwd_launch_shape())


class _BilinearResize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, oh, ow, align_corners):
        h, w = x.shape[-2:]
        out = build.ops().bilinear_resize(x, list(taps_on(h, oh, align_corners, x.device)),
                                          list(taps_on(w, ow, align_corners, x.device)))
        build.count("bilinear_resize")
        ctx.meta = (h, w, oh, ow, align_corners)
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, oh, ow, ac = ctx.meta
        dev = g.device
        dx = build.ops().bilinear_resize_bwd(
            g.contiguous(), list(taps_on(h, oh, ac, dev)), list(taps_on(w, ow, ac, dev)),
            list(adjoint_taps_on(h, oh, ac, dev)), list(adjoint_taps_on(w, ow, ac, dev)))
        build.count("bilinear_resize_bwd")
        return dx, None, None, None


def bilinear_resize(x, size, align_corners: bool = False):
    """K6 on a CUDA tensor (one launch forward, one backward); the plain
    version on a CPU tensor. ``[..., H, W]`` float32 (or bfloat16, forward
    only) -> ``[..., size[0], size[1]]``; the input itself when the size is
    unchanged, as the JAX function returns it."""
    oh, ow = int(size[0]), int(size[1])
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    if x.device.type == "cpu":
        return bilinear_resize_plain(x, (oh, ow), align_corners)
    combo = build.require_cuda("bilinear_resize", x, accepted=((torch.float32,), (BF16,)))
    _check_shape("bilinear_resize", x.numel() // max(h * w, 1), h, w, oh, ow)
    lead = x.shape[:-2]
    if combo == 1:
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("bilinear_resize: the bfloat16 forward takes no gradient (no "
                             "bfloat16 backward kernel)")
        out = build.ops().bilinear_resize_bf16(
            x.reshape(-1, h, w).contiguous(), list(bf16_taps_on(h, oh, align_corners, x.device)),
            list(bf16_taps_on(w, ow, align_corners, x.device)))
        build.count("bilinear_resize.bf16")
        return out.reshape(*lead, oh, ow)
    out = _BilinearResize.apply(x.reshape(-1, h, w).contiguous(), oh, ow, align_corners)
    return out.reshape(*lead, oh, ow)

