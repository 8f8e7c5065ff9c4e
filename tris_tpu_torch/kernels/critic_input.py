"""K5: the critic's input, forward (``csrc/critic_input.cu``) and backward to
the maps (``csrc/critic_input_bwd.cu``), and its plain PyTorch version.

Replaces ``tris_tpu/eval/validate.py`` lines 276-284 (``to224`` of the relu
maps and of the image, their product; the same step is
``train/stage1.py:70-75``) and the space-to-depth of
``tris_tpu/models/clip.py::PatchEmbed``: per (image, sentence) pair ``p`` of
image ``p // S``, ``resize(cams[p]) * resize(image[p // S])``, resized
``align_corners=True`` to ``out_size``², laid out as the patch matrix
``[P * g², 3 * patch²]`` (g = out_size / patch, columns (c, py, px)) that
``VisionTransformer.forward_patches`` takes. On CUDA tensors it is a
``torch.autograd.Function`` whose backward, the hand-written kernel, gives
the maps' gradient; the image is data and must not require one.

The backward is one launch: a block takes a band of one map's source rows,
stages the image rows the band's output rows sample, forms in shared memory
the rows of d cam_n and their column adjoint that the band's adjoint ranges
cover, and writes the band's gradient
(``csrc/launchers.h::critic_input_bwd_plan``, read back by
:func:`critic_input_bwd_plan` and emulated by
``tris_tpu_torch/tools/critic_input_schedule.py``). A shape whose band does
not fit shared memory is refused before the forward's launch when the maps
need a gradient.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.kernels.response_head import adjoint_taps_on, taps_on, upsample_taps_plain


def critic_input_plain(cams, image, S: int, out_size: int, patch: int):
    """The plain version: both resizes with the kernel's taps in its order
    (rows, then columns), the product, then reshape and permute (its
    gradient is autograd's, whose index backward scatters with atomics on
    CUDA)."""
    P, H, W = cams.shape
    ty = taps_on(H, out_size, True, cams.device)
    tx = taps_on(W, out_size, True, cams.device)
    cam = upsample_taps_plain(cams, ty, tx)                        # [P, n, n]
    img = upsample_taps_plain(image, ty, tx)                       # [P/S, 3, n, n]
    pair_image = torch.div(torch.arange(P, device=cams.device), S, rounding_mode="floor")
    fg = cam[:, None] * img[pair_image]                            # [P, 3, n, n]
    g = out_size // patch
    fg = fg.reshape(P, 3, g, patch, g, patch).permute(0, 2, 4, 1, 3, 5)
    return fg.reshape(P * g * g, 3 * patch * patch)


def check_bwd_plan(plan: dict, P: int, H: int, W: int, out_size: int) -> dict:
    """``plan`` if the backward takes it; else raises (before any launch)."""
    if not plan["fits"]:
        raise ValueError(f"critic_input: the backward's band of [{H}, {W}] maps <- "
                         f"[{out_size}, {out_size}] must fit shared memory "
                         f"({plan['smem_bytes']} bytes, at most {build.MAX_SMEM}) and its "
                         f"{out_size} columns a block's {plan['threads']} threads")
    return plan


def critic_input_bwd_plan(P: int, H: int, W: int, out_size: int) -> dict:
    """The backward's launch for ``P`` maps ``[H, W] <- [out_size, out_size]``
    (``launchers.h``'s rule, from the extension): fits, band, span_rows,
    threads, blocks and smem_bytes."""
    if P < 0 or min(H, W, out_size) < 1 or max(H, W, out_size) >= 2 ** 31:
        raise ValueError(f"critic_input_bwd_plan: bad shape {(P, H, W, out_size)}")
    return dict(build.ops().critic_input_bwd_plan(P, H, W, out_size))


def critic_input_bwd_launch_shape() -> dict:
    """The grid of the last backward launch in this process: blocks, threads,
    band, span_rows and smem_bytes."""
    if build.launches["critic_input_bwd"] == 0:
        raise RuntimeError("critic_input_bwd_launch_shape: no launch of critic_input_bwd counted")
    return dict(build.ops().critic_input_bwd_launch_shape())


class _CriticInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cams, image, S, out_size, patch, save):
        P, H, W = cams.shape
        ty = taps_on(H, out_size, True, cams.device)
        tx = taps_on(W, out_size, True, cams.device)
        out = build.ops().critic_input(cams, image, list(ty), list(tx), S, patch)
        build.count("critic_input")
        ctx.meta = (P, H, W, S, out_size, patch)
        if save:  # nothing is kept when the maps need no gradient
            ctx.save_for_backward(image)
        return out

    @staticmethod
    def backward(ctx, d_a):
        (image,) = ctx.saved_tensors
        P, H, W, S, n, patch = ctx.meta
        dev = image.device
        d_cams = build.ops().critic_input_bwd(
            d_a.contiguous(), image, list(taps_on(H, n, True, dev)), list(taps_on(W, n, True, dev)),
            list(adjoint_taps_on(H, n, True, dev)), list(adjoint_taps_on(W, n, True, dev)),
            P, S, patch)
        build.count("critic_input_bwd")
        return d_cams, None, None, None, None, None


def critic_input(cams, image, S: int, out_size: int, patch: int):
    """K5 on CUDA tensors (1 launch forward, 1 backward); the plain version on
    CPU tensors.

    cams [P, H, W] f32 (P = B * S), image [B, 3, H, W] f32 (normalised).
    Returns A [P * g², 3 * patch²]."""
    if cams.device.type == "cpu":
        return critic_input_plain(cams, image, S, out_size, patch)
    build.require_cuda("critic_input", cams, image)
    P, H, W = cams.shape
    if (image.dim() != 4 or tuple(image.shape[1:]) != (3, H, W) or P != image.shape[0] * S
            or out_size % patch):
        raise ValueError(f"critic_input: bad shapes cams{tuple(cams.shape)} "
                         f"image{tuple(image.shape)} S={S} out={out_size} patch={patch}")
    grad = torch.is_grad_enabled()
    if grad and image.requires_grad:
        raise ValueError("critic_input: the image is data; it gets no gradient here")
    save = grad and cams.requires_grad
    if save:
        check_bwd_plan(critic_input_bwd_plan(P, H, W, out_size), P, H, W, out_size)
    return _CriticInput.apply(cams.contiguous(), image.contiguous(), S, out_size, patch, save)
