"""K5: the critic's input (``csrc/critic_input.cu``) and its plain PyTorch
version.

Replaces ``tris_tpu/eval/validate.py`` lines 276-284 (``to224`` of the relu
maps and of the image, their product; the same step is
``train/stage1.py:70-75``) and the space-to-depth of
``tris_tpu/models/clip.py::PatchEmbed``: per (image, sentence) pair ``p`` of
image ``p // S``, ``resize(cams[p]) * resize(image[p // S])``, resized
``align_corners=True`` to ``out_size``², laid out as the patch matrix
``[P * g², 3 * patch²]`` (g = out_size / patch, columns (c, py, px)) that
``VisionTransformer.forward_patches`` takes.
"""

from __future__ import annotations

import torch

from tris_tpu_torch.kernels import build
from tris_tpu_torch.kernels.response_head import taps_on, upsample_taps_plain


def critic_input_plain(cams, image, S: int, out_size: int, patch: int):
    """The plain version: both resizes with the kernel's taps in its order
    (rows, then columns), the product, then reshape and permute."""
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


def critic_input(cams, image, S: int, out_size: int, patch: int):
    """K5 on CUDA tensors; the plain version on CPU tensors.

    cams [P, H, W] f32 (P = B * S), image [B, 3, H, W] f32 (normalised).
    Returns A [P * g², 3 * patch²]."""
    if cams.device.type == "cpu":
        return critic_input_plain(cams, image, S, out_size, patch)
    build.require_cuda_f32("critic_input", cams, image)
    P, H, W = cams.shape
    if (image.dim() != 4 or tuple(image.shape[1:]) != (3, H, W) or P != image.shape[0] * S
            or out_size % patch):
        raise ValueError(f"critic_input: bad shapes cams{tuple(cams.shape)} "
                         f"image{tuple(image.shape)} S={S} out={out_size} patch={patch}")
    ty = taps_on(H, out_size, True, cams.device)
    tx = taps_on(W, out_size, True, cams.device)
    out = build.ops().critic_input(cams.contiguous(), image.contiguous(), list(ty), list(tx),
                                   S, patch)
    build.count("critic_input")
    return out
