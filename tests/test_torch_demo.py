"""The single-image demo in the PyTorch port against the JAX package, on the
CPU: the comma-split tokens and the image read as ``tris_tpu/cli/demo.py``'s
``prepare_data`` gives them, ``norm_cam`` against JAX's stage-2 forward,
upsample and min-max normalisation on the same image array within 1e-4 (a
small stage 2 whose weights go through ``ckpt/from_jax.py``), the resize
divergence (PIL bilinear, not cv2 ``INTER_LINEAR``) by name, and ``main``
writing the overlay PNG.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_models import TINY
from tests.test_torch_stage2 import make_stage2_pair
from tris_tpu.cli import demo as jdemo
from tris_tpu.eval.validate import resize_to_original_np as j_resize
from tris_tpu_torch.cli import demo
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tris_tpu_torch.models import clip as clip_mod

torch.set_num_threads(2)

TEXT = "man on the left, a red umbrella"


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    """A 90 x 120 PNG (lossless: PIL and cv2 read the same bytes)."""
    path = tmp_path_factory.mktemp("demo") / "demo.png"
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def stage2():
    return make_stage2_pair(3)


def test_tokens_and_image_as_jax_prepare_data(image_path):
    # each comma-separated phrase tokenized, cut to max_length and concatenated; the image
    # in cv2.imread's BGR order at its original size
    _, j_ids, jh, jw, j_bgr = jdemo.prepare_data(image_path, TEXT, 64, 20)
    _, ids, h, w, bgr = demo.prepare_data(image_path, TEXT, 64, 20)
    assert ids.dtype == np.int32 and ids.shape == (40,)
    np.testing.assert_array_equal(ids, j_ids)
    assert ids[0] == ids[20] == 49406 and 49407 in ids[:20] and 49407 in ids[20:]
    assert (h, w) == (jh, jw) == (90, 120)
    np.testing.assert_array_equal(bgr, j_bgr)


def test_demo_resizes_with_pil_bilinear_not_cv2_inter_linear(image_path):
    # the decided divergence: the port resizes with PIL's bilinear filter (antialiased on a
    # downscale), where the JAX demo takes cv2's INTER_LINEAR; the normalisation and the
    # BGR channel order are the JAX demo's
    j_img = jdemo.prepare_data(image_path, TEXT, 64, 20)[0]
    img, _, _, _, bgr = demo.prepare_data(image_path, TEXT, 64, 20)
    pil = np.asarray(Image.fromarray(bgr).resize((64, 64), Image.BILINEAR), np.float32)
    np.testing.assert_array_equal(img, (pil / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    assert img.shape == j_img.shape == (64, 64, 3)
    assert np.abs(img - j_img).max() > 0.05   # not the same resize
    assert np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max() < 0.05   # the same channels


def test_norm_cam_matches_jax(stage2, image_path):
    # one eval forward of stage 2 on the same image array and tokens, the upsample to the
    # original size and the min-max normalisation: within 1e-4
    jm, v, tm = stage2
    tm.eval()
    img, ids, h, w, _ = demo.prepare_data(image_path, TEXT, 64, 20)
    eval_vars = {k: v[k] for k in ("params", "batch_stats") if k in v}
    out = jm.apply(eval_vars, jnp.asarray(img)[None], jnp.asarray(ids)[None], train=False)
    want = jdemo.get_norm_cam(j_resize(np.asarray(out)[0, :, :, 0], h, w))
    got = demo.norm_cam_of(tm, img, ids, h, w)
    assert got.shape == want.shape == (90, 120)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.max() > 0.99 and got.min() == 0.0


def test_main_writes_the_overlay(stage2, image_path, monkeypatch, tmp_path):
    # python -m tris_tpu_torch.cli.demo --img ... --text ... --pretrain ... --device cpu on a
    # tiny backbone: figs/demo_({text}).png, the JET overlay at the image's size
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    monkeypatch.chdir(tmp_path)
    _, _, tm = stage2
    path = tmp_path / "stage2.pth"
    torch.save(tm.state_dict(), path)
    args = get_parser().parse_args(["--img", image_path, "--text", "a dog, the cat",
                                    "--pretrain", str(path), "--device", "cpu"])
    norm_cam = demo.main(args)
    png = tmp_path / "figs" / "demo_(a dog, the cat).png"
    assert png.exists() and norm_cam.shape == (90, 120)
    assert np.asarray(Image.open(png)).shape[:2] == (90, 120)
    np.testing.assert_allclose(norm_cam, demo.demo_cam(tm.eval(), image_path, "a dog, the cat"),
                               rtol=0, atol=1e-6)
