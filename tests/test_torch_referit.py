"""ReferIt eval in the PyTorch port against the JAX package, on the CPU.

``tris_tpu_torch/data/referit.py`` against ``tris_tpu/data/referit.py`` on
``tests/test_referit.py``'s synthetic tree (three 60 x 80 images, a box
under 5 % skipped) and on one of this file's (a ref with a stack of RLEs
and two boxes): lengths, refs, masks, boxes, ``word_ids``, images within
1e-6. ``tris_tpu_torch/eval/validate_referit.py`` against JAX's on a small
stage 1 whose weights go through ``ckpt/from_jax.py``, by the host route
and by K4's plain version (``device_resize``), metrics within 1e-4; the
expressions unpadded give the maps the JAX loop's padding gives; and
``cli.validate --dataset referit`` end to end.
"""

import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_referit import referit_root  # noqa: F401  (the fixture)
from tests.test_torch_models import TINY, make_stage1_pair
from tris_tpu.data import referit as JR
from tris_tpu.eval.validate_referit import validate_referit as j_validate_referit
from tris_tpu_torch.cli import validate as cli_validate
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data import mask_ops
from tris_tpu_torch.data import referit as R
from tris_tpu_torch.eval.validate import make_eval_forward
from tris_tpu_torch.eval.validate_referit import validate_referit
from tris_tpu_torch.models import clip as clip_mod

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def referit_multi(tmp_path_factory):
    """Two images: a ref whose mask is a stack of two RLEs (summed) and whose
    box list holds two boxes, a ref with one flat box, and on the second
    image three kept refs (S = 3, padded to 4 by the JAX loop)."""
    root = tmp_path_factory.mktemp("referit_multi")
    (root / "annotations").mkdir()
    (root / "images").mkdir()
    rng = np.random.default_rng(5)
    ann = {}
    for image_id, (h, w) in (("a7", (48, 72)), ("b9", (70, 52))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"{image_id}.jpg")
        refs = []
        for k in range(3 if image_id == "b9" else 2):
            y0, x0 = 4 + 6 * k, 3 + 9 * k
            m1 = np.zeros((h, w), np.uint8)
            m1[y0:y0 + 20, x0:x0 + 15] = 1
            m2 = np.zeros((h, w), np.uint8)
            m2[y0 + 10:y0 + 30, x0 + 10:x0 + 30] = 1
            stacked = k == 0
            refs.append({
                "image_id": image_id,
                "query": f"the {['left', 'middle', 'right'][k]} thing number {k}",
                "bbox": ([[x0, y0, x0 + 15, y0 + 20], [x0 + 10, y0 + 10, x0 + 30, y0 + 30]]
                         if stacked else [x0, y0, x0 + 15, y0 + 20]),
                "segmentation": ([mask_ops.rle_encode(m1), mask_ops.rle_encode(m2)]
                                 if stacked else mask_ops.rle_encode(m1)),
            })
        ann[image_id] = {"annotations": refs}
    for split in ("train", "test"):
        with open(root / "annotations" / f"{split}.pickle", "wb") as f:
            pickle.dump(ann, f)
    return str(root)


@pytest.fixture(scope="module", params=["referit_root", "referit_multi"])
def tree(request):
    return request.getfixturevalue(request.param)


@pytest.fixture(scope="module")
def stage1():
    return make_stage1_pair()


def test_test_dataset_matches_jax(tree):
    want = JR.ReferItTestDataset(tree, size=64, max_tokens=20)
    got = R.ReferItTestDataset(tree, size=64, max_tokens=20)
    assert len(got) == len(want) and got.files == want.files
    for i in range(len(want)):
        w, g = want.example(i), got.example(i)
        assert g["orig_size"] == w["orig_size"] and g["img_path"] == w["img_path"]
        np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1e-6)
        assert len(g["refs"]) == len(w["refs"]) > 0
        for gr, wr in zip(g["refs"], w["refs"]):
            assert gr["sentences"] == wr["sentences"]
            np.testing.assert_array_equal(gr["word_ids"], wr["word_ids"])
            np.testing.assert_array_equal(gr["bbox"], wr["bbox"])
            assert gr["mask"].dtype == wr["mask"].dtype == np.uint8
            np.testing.assert_array_equal(gr["mask"], wr["mask"])


def test_test_dataset_keeps_boxes_over_5_percent(referit_root, referit_multi):
    # the fixture's 3 x 3 box (under 5 %) is skipped on every image; the stacked
    # RLEs sum over their third axis (2 where the two rectangles overlap)
    ds = R.ReferItTestDataset(referit_root, size=64)
    assert [len(ds.example(i)["refs"]) for i in range(len(ds))] == [2, 2, 2]
    ref = R.ReferItTestDataset(referit_multi, size=64).example(0)["refs"][0]
    assert ref["bbox"].shape == (2, 4) and ref["mask"].max() == 2


def test_train_dataset_matches_jax(tree):
    want = JR.ReferItTrainDataset(tree, size=64, max_tokens=20, negative_samples=2)
    got = R.ReferItTrainDataset(tree, size=64, max_tokens=20, negative_samples=2)
    assert len(got) == len(want) and got.refs == want.refs
    for i in range(len(want)):
        w = want.train_example(i, np.random.default_rng(i))
        g = got.train_example(i, np.random.default_rng(i))
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(g["word_ids"], w["word_ids"])
        np.testing.assert_array_equal(g["neg_word_ids"], w["neg_word_ids"])


@pytest.mark.parametrize("device_resize", [False, True])
def test_validate_referit_matches_jax(stage1, tree, device_resize):
    # the host route (numpy resize, the JAX code) and K4's plain version
    # (device_resize=True on CPU tensors): mIoU, oIoU, hit, hitm, Prec@X within 1e-4
    jm, v, tm = stage1
    want = j_validate_referit(jm, v, JR.ReferItTestDataset(tree, size=64, max_tokens=20))
    got = validate_referit(tm, R.ReferItTestDataset(tree, size=64, max_tokens=20),
                           device_resize=device_resize)
    assert set(got) == set(want) == {"mIoU", "oIoU", "hit", "hitm", "prec@0.5", "prec@0.6",
                                     "prec@0.7", "prec@0.8", "prec@0.9"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert got["mIoU"] > 0


def test_unpadded_expressions_give_the_padded_maps(stage1, referit_multi):
    # the JAX loop pads an image's S expressions with zero rows to a power of two for
    # jit's buckets; each expression's map is its own, so the port's unpadded forward
    # gives the same maps as the padded one
    _, _, tm = stage1
    ex = R.ReferItTestDataset(referit_multi, size=64).example(1)
    ids = np.stack([r["word_ids"] for r in ex["refs"]])[None]
    assert ids.shape[1] == 3
    padded = np.concatenate([ids, np.zeros_like(ids[:, :1])], axis=1)
    forward = make_eval_forward(tm)
    with torch.no_grad():
        got = forward(ex["image"][None], ids)
        want = forward(ex["image"][None], padded)[:, :3]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_validate_referit(stage1, referit_root, monkeypatch, tmp_path, stage):
    # python -m tris_tpu_torch.cli.validate --dataset referit --device cpu on a tiny
    # backbone: stage 1 from a --pretrain the port saved, against JAX's metrics on the
    # same weights within 1e-4; stage 2 from its seeded init
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    jm, v, tm = stage1
    flags = ["--dataset", "referit", "--refer_data_root", referit_root, "--test_split", "test",
             "--size", "64", "--device", "cpu", "--stage", str(stage)]
    if stage == 1:
        path = tmp_path / "stage1.pth"
        torch.save(tm.state_dict(), path)
        flags += ["--hidden_dim", "32", "--pretrain", str(path)]
    res = cli_validate.main(get_parser().parse_args(flags))
    assert set(res) >= {"mIoU", "oIoU", "hit", "hitm", "prec@0.5"}
    if stage == 1:
        want = j_validate_referit(jm, v, JR.ReferItTestDataset(referit_root, size=64))
        for k in want:
            np.testing.assert_allclose(res[k], want[k], atol=1e-4, err_msg=k)
    assert all(0.0 <= x <= 100.0 for x in res.values())
