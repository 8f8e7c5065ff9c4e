"""Single-image demo, on the card by default.

    python -m tris_tpu_torch.cli.demo --img figs/demo.png \\
        --text 'man on the right' --pretrain stage2.pth [--device cuda|cpu]

Port of ``tris_tpu/cli/demo.py`` (the reference's ``demo.py:28-100``): the
stage-2 model, one forward at 320 px, a bilinear upsample to the original
size (``align_corners=True``), min-max normalisation, and a JET heatmap
overlay saved to ``figs/demo_({text}).png``. Comma-separated phrases are
tokenised one by one, each cut to ``--max_query_len``, and concatenated
into one sequence.

The image is read with PIL and resized with PIL's bilinear filter, not
cv2's ``INTER_LINEAR`` as the JAX package does (a decided divergence: the
reference's eval transforms resize with PIL); its channels are in the order
``cv2.imread`` gives, BGR, as the JAX package feeds them. cv2 and
matplotlib are imported only by :func:`visualize_cam`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tris_tpu_torch.cli.common import build_stage2, load_pretrained, refuse_bf16
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data.transforms import image_to_array
from tris_tpu_torch.device import to_device
from tris_tpu_torch.eval.validate import image_to_nchw, resize_to_original_np
from tris_tpu_torch.tokenizer import tokenize

SIZE = 320


def get_norm_cam(cam: np.ndarray) -> np.ndarray:
    """Min-max normalize a relu'd CAM (demo.py:41-48)."""
    cam = np.maximum(cam, 0.0)
    lo, hi = cam.min(), cam.max()
    return (cam - lo) / (hi - lo + 1e-5)


def visualize_cam(norm_cam: np.ndarray, original_bgr: np.ndarray, root: str = None):
    """JET overlay 0.6 heat / 0.4 image (demo.py:28-39)."""
    import cv2

    heat = cv2.applyColorMap(np.uint8(norm_cam * 255), cv2.COLORMAP_JET)
    img = cv2.addWeighted(heat, 0.6, cv2.cvtColor(original_bgr, cv2.COLOR_RGB2BGR), 0.4, 0)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if root is None:
        return img
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(root) or ".", exist_ok=True)
    plt.imsave(root, img)
    return img


def prepare_data(img_path: str, text: str, size: int = SIZE, max_length: int = 20):
    """(image [size, size, 3] float32 normalized, word_ids, h, w, the image
    [h, w, 3] uint8 BGR). word_ids: each comma-separated phrase tokenized and
    cut to ``max_length``, the pieces concatenated (demo.py:50-68),
    [n_phrases * max_length] int32."""
    from PIL import Image

    bgr = np.ascontiguousarray(np.asarray(Image.open(img_path).convert("RGB"))[..., ::-1])
    h, w = bgr.shape[:2]
    img = image_to_array(Image.fromarray(bgr), size)
    ids = [tokenize(t, context_length=77)[0, :max_length] for t in text.split(",")]
    return img, np.concatenate(ids).astype(np.int32), h, w, bgr


@torch.no_grad()
def norm_cam_of(model, img: np.ndarray, word_ids: np.ndarray, h: int, w: int) -> np.ndarray:
    """One eval forward of the stage-2 ``model`` on its device: image [size,
    size, 3] and word_ids [L] -> the min-max normalized map at [h, w]."""
    device = next(model.parameters()).device
    out = model(image_to_nchw(to_device(img[None], device)), to_device(word_ids[None], device))
    return get_norm_cam(resize_to_original_np(out[0, 0].cpu().numpy(), h, w))


def demo_cam(model, img_path: str, text: str, size: int = SIZE,
             max_length: int = 20) -> np.ndarray:
    """The demo's compute: an image file and a text -> norm_cam [h, w]."""
    img, word_ids, h, w, _ = prepare_data(img_path, text, size, max_length)
    return norm_cam_of(model, img, word_ids, h, w)


def main(args):
    refuse_bf16(args, "the demo")
    model = load_pretrained(args, build_stage2(args)).eval()
    img, word_ids, h, w, bgr = prepare_data(args.img, args.text, SIZE, args.max_query_len)
    norm_cam = norm_cam_of(model, img, word_ids, h, w)
    root = f"figs/demo_({args.text}).png"
    visualize_cam(norm_cam, bgr, root=root)
    print(f"saved {root}")
    return norm_cam


if __name__ == "__main__":
    main(get_parser().parse_args())
