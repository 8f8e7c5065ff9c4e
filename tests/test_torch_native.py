"""The port's native host library (``tris_tpu_torch/native``) against its
plain versions and the JAX package, on the CPU: the twin of
``tests/test_native.py`` on the port's own build and binding.

- the COCO codec and polygon fill against the numpy codec, byte for byte;
- connected components against ``scipy.ndimage.label``;
- the CRF's native lattice against the numpy lattice (|dQ| < 1e-3, ir-label
  agreement >= 0.9999, the JAX package's bar) and against the JAX package's
  ``tris_tpu.pseudo.crf`` within 1e-5; its thread count changes no bit;
- the JPEG decode and both fused decodes byte for byte against the port's
  PIL chains, the DCT-scaled decode within the JAX package's bar;
- what is not caught: an unbuildable library raises, the CRF raises where
  the JAX package warns and falls back, a decoder fault propagates.
"""

import io

import numpy as np
import pytest
from scipy import ndimage

from tris_tpu_torch import native
from tris_tpu_torch.data import mask_ops, transforms
from tris_tpu_torch.pseudo import crf as crf_mod
from tris_tpu_torch.pseudo.labels import cam_to_ir_label



@pytest.fixture
def jpeg():
    """Skips where the library was built without libjpeg (decided in the
    test, not at import: the build runs at first use)."""
    if not native.jpeg_available():
        pytest.skip("the native library was built without libjpeg")


def _blobby_image(rng, h, w):
    """COCO-ish synthetic photo: a few smooth colour regions and texture noise
    (``tests/test_native.py``'s)."""
    img = np.zeros((h, w, 3), np.float32)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    for _ in range(4):
        cy, cx = rng.random() * h, rng.random() * w
        ry, rx = 10 + rng.random() * h / 2, 10 + rng.random() * w / 2
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] = rng.integers(30, 225, 3)
    img += rng.normal(0, 6, img.shape)
    img = ndimage.gaussian_filter(img, (1.5, 1.5, 0))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cam_like(rng, h, w):
    cy, cx = rng.random() * h, rng.random() * w
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    cam = np.exp(-(((yy - cy) / (h / 4)) ** 2 + ((xx - cx) / (w / 4)) ** 2))
    cam += 0.1 * rng.random((h, w)).astype(np.float32)
    return (cam / cam.max()).astype(np.float32)


def _seeds(cam, h, w):
    """``cam_to_ir_label``'s fg and bg seeds (thresholds 0.3 and 0.1)."""
    return np.stack([
        np.argmax(np.concatenate([np.full((1, h, w), t), cam[None]], 0), 0)
        for t in (0.3, 0.1)]).astype(np.int32)


def _seed_unaries(cam, h, w):
    return np.stack([crf_mod.unary_from_labels(s, 2) for s in _seeds(cam, h, w)])


def _ir_label_numpy(img, cam):
    """``cam_to_ir_label`` with the CRF on the numpy lattice."""
    fg, bg = crf_mod.crf_inference_label_multi(img, _seeds(cam, *cam.shape), n_labels=2,
                                               backend="numpy")
    conf = fg.astype(np.uint8)
    conf[fg == 0] = 255
    conf[(bg + fg) == 0] = 0
    return conf


def _smooth_rgb(rng, h, w, gray=False):
    base = rng.random((h // 8 + 2, w // 8 + 2, 1 if gray else 3)) * 255
    up = ndimage.zoom(base, (8, 8, 1), order=1)[:h, :w]
    return np.clip(up, 0, 255).astype(np.uint8)


def _jpeg(arr, quality=90, mode=None):
    from PIL import Image

    img = Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr,
                          "L" if arr.shape[-1] == 1 else "RGB")
    if mode is not None:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# -- the mask codec ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 53), (1, 9), (64, 1)])
def test_rle_round_trip_against_the_numpy_codec(shape):
    rng = np.random.default_rng(1)
    for _ in range(5):
        m = (rng.random(shape) > 0.5).astype(np.uint8)
        counts = native.rle_encode(m)
        np.testing.assert_array_equal(
            counts, mask_ops.string_to_counts(mask_ops.rle_encode(m)["counts"]))
        np.testing.assert_array_equal(native.rle_decode(counts, *shape), m)
        rle = mask_ops.rle_encode(m)
        np.testing.assert_array_equal(mask_ops.rle_decode(rle),
                                      mask_ops.rle_decode(rle, backend="numpy"))


def test_polygon_fill_equals_the_numpy_codec():
    rng = np.random.default_rng(2)
    for _ in range(20):
        poly = (rng.random(12) * 30).tolist()
        np.testing.assert_array_equal(
            native.polygon_to_counts(poly, 32, 32),
            mask_ops.string_to_counts(mask_ops.polygon_to_rle(poly, 32, 32, "numpy")["counts"]))
        assert (mask_ops.polygon_to_rle(poly, 32, 32)
                == mask_ops.polygon_to_rle(poly, 32, 32, backend="numpy"))
    polys = [(rng.random(10) * 40).tolist() for _ in range(3)]
    np.testing.assert_array_equal(
        mask_ops.segmentation_to_mask(polys, 41, 47),
        sum(mask_ops.rle_decode(mask_ops.polygon_to_rle(p, 41, 47, "numpy"), "numpy")
            for p in polys))


def test_connected_components_against_scipy():
    rng = np.random.default_rng(3)
    for _ in range(5):
        m = (rng.random((40, 40)) > 0.5).astype(np.uint8)
        lab_c, n_c = native.connected_components(m)
        lab_s, n_s = ndimage.label(m)
        assert n_c == n_s
        pairs = set(zip(lab_c.ravel().tolist(), lab_s.ravel().tolist()))
        assert len({a for a, _ in pairs}) == len(pairs) == len({b for _, b in pairs})


# -- the CRF ----------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_native_against_the_numpy_lattice(seed):
    """The JAX package's bar (``tests/test_native.py::test_crf_backends_cross_agree``)."""
    h, w = 96, 128
    r = np.random.default_rng(seed)
    img, cam = _blobby_image(r, h, w), _cam_like(r, h, w)
    unaries = _seed_unaries(cam, h, w)
    q_native = crf_mod.dense_crf_inference_multi(img, unaries)
    q_numpy = crf_mod.dense_crf_inference_multi(img, unaries, backend="numpy")
    assert np.abs(q_native - q_numpy).max() < 1e-3
    agree = (cam_to_ir_label(img, cam) == _ir_label_numpy(img, cam)).mean()
    assert agree >= 0.9999


def test_crf_native_against_the_jax_package():
    from tris_tpu.pseudo import crf as jax_crf

    h, w = 72, 96
    r = np.random.default_rng(5)
    img, cam = _blobby_image(r, h, w), _cam_like(r, h, w)
    unaries = _seed_unaries(cam, h, w)
    q = crf_mod.dense_crf_inference_multi(img, unaries)
    np.testing.assert_allclose(q, jax_crf.dense_crf_inference_multi(img, unaries), atol=1e-5)
    q1 = crf_mod.dense_crf_inference(img, unaries[0])
    np.testing.assert_allclose(q1, jax_crf.dense_crf_inference(img, unaries[0]), atol=1e-5)
    from tris_tpu.pseudo.labels import cam_to_ir_label as jax_ir_label

    np.testing.assert_array_equal(cam_to_ir_label(img, cam), jax_ir_label(img, cam))


def test_crf_threads_change_no_bit():
    h, w = 64, 80
    r = np.random.default_rng(6)
    img, cam = _blobby_image(r, h, w), _cam_like(r, h, w)
    unaries = _seed_unaries(cam, h, w)
    one = crf_mod.dense_crf_inference_multi(img, unaries, threads=1)
    np.testing.assert_array_equal(crf_mod.dense_crf_inference_multi(img, unaries, threads=3), one)


@pytest.mark.parametrize("threads", [1, 3])
def test_crf_threads_leave_torchs_thread_count(threads):
    """The library shares torch's OpenMP runtime; its team is its own
    setting, so a call leaves torch's count on the calling thread as it was."""
    import torch

    r = np.random.default_rng(7)
    img, cam = _blobby_image(r, 32, 40), _cam_like(r, 32, 40)
    before = torch.get_num_threads()
    crf_mod.dense_crf_inference_multi(img, _seed_unaries(cam, 32, 40), threads=threads)
    assert torch.get_num_threads() == before


def test_crf_raises_where_the_jax_package_warns_and_falls_back(monkeypatch):
    """A decided divergence (ROADMAP.md §3): the JAX package warns once and
    runs the numpy lattice when its library is missing; the port raises."""
    def unbuildable():
        raise RuntimeError("tris_tpu_torch.native: the build failed")

    monkeypatch.setattr(native, "_lib", unbuildable)
    img = np.zeros((8, 8, 3), np.uint8)
    unary = crf_mod.unary_from_labels(np.zeros((8, 8), np.int32), 2)
    with pytest.raises(RuntimeError, match="build failed"):
        crf_mod.dense_crf_inference(img, unary)
    crf_mod.dense_crf_inference(img, unary, backend="numpy")  # asked for by name
    with pytest.raises(ValueError, match="backend"):
        crf_mod.dense_crf_inference(img, unary, backend="scipy")


# -- the build --------------------------------------------------------------------------------


def test_an_unbuildable_library_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int tris_broken( { return 0; }\n')
    with pytest.raises(RuntimeError, match="build failed"):
        native.build_library([src], tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build_library([src], tmp_path / "build", cxx="no-such-compiler-g++")


def test_the_build_is_keyed_and_reused(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text('extern "C" int tris_one() { return 1; }\n')
    first = native.build_library([src], tmp_path)
    assert native.build_library([src], tmp_path) == first
    src.write_text('extern "C" int tris_one() { return 2; }\n')
    assert native.build_library([src], tmp_path) != first


# -- the decodes ------------------------------------------------------------------------------


def test_jpeg_decode_byte_equal_to_pil(jpeg):
    from PIL import Image

    rng = np.random.default_rng(7)
    for h, w, gray, q in [(480, 640, False, 90), (375, 500, True, 90), (123, 77, False, 95)]:
        data = _jpeg(_smooth_rgb(rng, h, w, gray), quality=q)
        out = native.jpeg_decode(data)
        assert out is not None and out.shape == (h, w, 3)
        np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    assert native.jpeg_decode(b"not a jpeg") is None


@pytest.mark.parametrize("normalize", [True, False])
def test_fused_f32_decode_equals_the_pil_chain(jpeg, tmp_path, normalize):
    rng = np.random.default_rng(8)
    for i, (h, w, gray) in enumerate([(480, 640, False), (375, 500, True), (99, 131, False)]):
        path = _write(tmp_path, f"img{i}.jpg", _jpeg(_smooth_rgb(rng, h, w, gray)))
        ref = transforms.image_to_array(transforms.load_image(path), 320, normalize=normalize)
        with open(path, "rb") as f:
            mean, std = ((transforms.IMAGENET_MEAN, transforms.IMAGENET_STD) if normalize
                         else (None, None))
            arr, hw = native.jpeg_decode_resize_norm(f.read(), 320, mean, std)
        assert hw == (h, w)
        np.testing.assert_array_equal(arr, ref)
        np.testing.assert_array_equal(transforms.load_transformed(path, 320, normalize), ref)


def test_fused_u8_decode_equals_the_pil_chain(jpeg, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(9)
    for i, (h, w, gray) in enumerate([(480, 640, False), (375, 500, True), (320, 320, False)]):
        path = _write(tmp_path, f"u8img{i}.jpg", _jpeg(_smooth_rgb(rng, h, w, gray)))
        ref = np.asarray(transforms.load_image(path).resize((320, 320), Image.BILINEAR))
        with open(path, "rb") as f:
            out, hw = native.jpeg_decode_resize_u8(f.read(), 320)
        assert hw == (h, w) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(transforms.load_transformed_u8(path, 320), ref)


def test_scaled_decode_close_to_exact(jpeg):
    """The JAX package's bar (``tests/test_native.py::test_fast_decode_close_to_exact``)."""
    rng = np.random.default_rng(10)
    worst = 0.0
    for _ in range(3):
        data = _jpeg(_smooth_rgb(rng, 480, 640))
        exact, _ = native.jpeg_decode_resize_norm(data, 320, transforms.IMAGENET_MEAN,
                                                  transforms.IMAGENET_STD)
        fast, _ = native.jpeg_decode_resize_norm(data, 320, transforms.IMAGENET_MEAN,
                                                 transforms.IMAGENET_STD, fast=True)
        worst = max(worst, float(np.abs(exact - fast).mean()))
    assert worst < 0.05


def test_a_declined_jpeg_goes_to_pil_and_nothing_else_is_caught(jpeg, tmp_path, monkeypatch):
    """CMYK: the decoder returns None (its documented per-file contract) and
    PIL decodes that file; a fault of the decoder itself propagates."""
    from PIL import Image

    rng = np.random.default_rng(11)
    data = _jpeg(_smooth_rgb(rng, 48, 64), mode="CMYK")
    assert native.jpeg_decode_resize_u8(data, 32) is None
    path = _write(tmp_path, "cmyk.jpg", data)
    np.testing.assert_array_equal(
        transforms.load_transformed(path, 32),
        transforms.image_to_array(transforms.load_image(path), 32))
    np.testing.assert_array_equal(
        transforms.load_transformed_u8(path, 32),
        np.asarray(transforms.load_image(path).resize((32, 32), Image.BILINEAR)))

    def broken(*a, **k):
        raise ValueError("a fault of the binding")

    monkeypatch.setattr(native, "jpeg_decode_resize_norm", broken)
    monkeypatch.setattr(native, "jpeg_decode_resize_u8", broken)
    rgb = _write(tmp_path, "rgb.jpg", _jpeg(_smooth_rgb(rng, 48, 64)))
    with pytest.raises(ValueError, match="fault of the binding"):
        transforms.load_transformed(rgb, 32)
    with pytest.raises(ValueError, match="fault of the binding"):
        transforms.load_transformed_u8(rgb, 32)


def test_the_fused_decodes_equal_the_jax_package(tmp_path):
    from tris_tpu.data import transforms as jax_transforms

    rng = np.random.default_rng(12)
    path = _write(tmp_path, "img.jpg", _jpeg(_smooth_rgb(rng, 200, 300)))
    np.testing.assert_array_equal(transforms.load_transformed(path, 96),
                                  jax_transforms.load_transformed(path, 96))
    np.testing.assert_array_equal(transforms.load_transformed_u8(path, 96),
                                  jax_transforms.load_transformed_u8(path, 96))


def test_the_build_without_openmp_gives_the_same_crf(tmp_path):
    """``tools/crf_threads.py``'s other design: the same sources without
    ``-fopenmp`` label as the port's build on one thread, bit for bit."""
    import ctypes

    from tris_tpu_torch.tools import crf_threads

    h, w = 48, 64
    r = np.random.default_rng(8)
    img, cam = _blobby_image(r, h, w), _cam_like(r, h, w)
    unaries = _seed_unaries(cam, h, w)
    want = crf_mod.dense_crf_inference_multi(img, unaries)
    lib = native._bind(ctypes.CDLL(crf_threads.build_without_openmp(str(tmp_path))))
    assert lib.tris_set_num_threads(4) == 1
    saved = native._lib_handle
    native._lib_handle = lib
    try:
        got = crf_mod.dense_crf_inference_multi(img, unaries)
    finally:
        native._lib_handle = saved
    np.testing.assert_array_equal(got, want)
