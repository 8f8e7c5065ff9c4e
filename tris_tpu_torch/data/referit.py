"""ReferIt (RefCLEF-style flicker pickle) datasets.

Port of ``tris_tpu/data/referit.py`` (the reference's
``dataset/Dataset_referit.py``) on this package's own transforms, RLE
decoder and tokenizer:

- train: the pickle ``annotations/{split}.pickle`` flattened to one entry
  per ref; one CLIP-tokenized query a sample, plus optional negatives drawn
  from other refs with another query;
- test: per image, every expression whose box covers more than 5 % of the
  image, with its RLE-decoded mask (a 3-D RLE stack summed over its third
  axis) and its boxes.

Images are normalized with ImageNet stats at ``size x size`` (PIL bilinear,
``data/transforms.py``). Layout NHWC. scipy and cv2 are imported inside the
two helpers that use them.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, List

import numpy as np

from tris_tpu_torch.data import mask_ops
from tris_tpu_torch.data.transforms import image_to_array, load_image, load_transformed
from tris_tpu_torch.tokenizer import tokenize


def _tokenize_query(query: str, max_tokens: int) -> np.ndarray:
    return tokenize(query, context_length=77, truncate=True)[0, :max_tokens].astype(np.int32)


def _load_annotations(root: str, split: str) -> dict:
    with open(os.path.join(root, "annotations", split + ".pickle"), "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_referit_gt_mask(mask_path: str) -> np.ndarray:
    """SAIAPR TC-12 .mat ground-truth mask (Dataset_referit.py:21-24)."""
    from scipy import io as sio

    return sio.loadmat(mask_path)["segimg_t"] == 0


def save_tmp_mask(input_path: str, save_name: str) -> None:
    """Dump a .mat gt mask as a PNG (Dataset_referit.py:26-28)."""
    import cv2

    cv2.imwrite(save_name, load_referit_gt_mask(input_path).astype(np.uint8) * 255)


class ReferItTrainDataset:
    def __init__(self, root: str, split: str = "train", size: int = 320,
                 max_tokens: int = 20, negative_samples: int = 0):
        self.annotations = _load_annotations(root, split)
        self.img_folder = os.path.join(root, "images")
        self.size = size
        self.max_tokens = max_tokens
        self.negative_samples = negative_samples
        self.refs: List[dict] = [ref for key in self.annotations
                                 for ref in self.annotations[str(key)]["annotations"]]

    def __len__(self) -> int:
        return len(self.refs)

    def train_example(self, index: int, rng: np.random.Generator) -> dict:
        ref = self.refs[index]
        out = {
            "image": load_transformed(
                os.path.join(self.img_folder, f"{ref['image_id']}.jpg"), self.size),
            "word_ids": _tokenize_query(ref["query"], self.max_tokens),
        }
        if self.negative_samples > 0:
            negs = []
            while len(negs) < self.negative_samples:
                other = self.refs[int(rng.integers(len(self.refs)))]
                if other["query"] != ref["query"]:
                    negs.append(_tokenize_query(other["query"], self.max_tokens))
            out["neg_word_ids"] = np.stack(negs)
        return out


class ReferItTestDataset:
    """Per-image iteration: all expressions with decoded masks (>5% area)."""

    def __init__(self, root: str, split: str = "test", size: int = 320, max_tokens: int = 20):
        self.annotations = _load_annotations(root, split)
        self.files = list(self.annotations.keys())
        self.img_folder = os.path.join(root, "images")
        self.size = size
        self.max_tokens = max_tokens

    def __len__(self) -> int:
        return len(self.files)

    def example(self, index: int) -> dict:
        item = str(self.files[index])
        img_path = os.path.join(self.img_folder, item + ".jpg")
        img = load_image(img_path)
        oh, ow = img.height, img.width
        refs = []
        for ann in self.annotations[item]["annotations"]:
            bbox = np.asarray(ann["bbox"])
            b = bbox[0] if bbox.ndim == 2 else bbox
            if (b[3] - b[1]) * (b[2] - b[0]) <= 0.05 * oh * ow:
                continue  # tiny boxes are skipped (Dataset_referit.py:136)
            mask = mask_ops.rle_decode(ann["segmentation"])
            if mask.ndim == 3:
                mask = mask.sum(axis=2)
            refs.append({
                "sentences": ann["query"],
                "word_ids": _tokenize_query(ann["query"], self.max_tokens),
                "bbox": bbox,
                "mask": mask.astype(np.uint8),
            })
        return {"image": image_to_array(img, self.size), "refs": refs, "orig_size": (oh, ow),
                "img_path": img_path}

    def iter_examples(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self.example(i)
