"""RefCOCO-family dataset + host input pipeline.

Re-design of `reference/dataset/ReferDataset.py`:

- All sentences are pre-tokenized at init: CLIP-tokenized at context 77 then
  truncated to ``max_tokens`` — exactly the reference's
  ``tokenize(sent)[:max_tokens]`` slice (ReferDataset.py:109), so an over-long
  sentence may lose its EOT token and ``argmax(ids)`` falls back to the
  largest id, as in the reference.
- Train mode samples one sentence per ref and ``negative_samples`` negative
  expressions (same-image refs preferred, ReferDataset.py:190-229).
- Eval mode returns ALL sentences, padded to the dataset-wide max with a
  validity mask — static shapes for jit-batched evaluation (the reference
  loops sentences in Python at batch 1; we batch them).
- Stage-2: loads IRNet pseudo-masks ``{index}_{img_id}.npy`` and NEAREST-
  resizes to the train size (ReferDataset.py:178-186).

The ``Loader`` assembles fixed-shape numpy batches with background-thread
prefetch and per-process sharding (the TPU equivalent of DistributedSampler).
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Iterator, List, Optional

import numpy as np

from tris_tpu_torch.data.refer import REFER
from tris_tpu_torch.data.transforms import load_transformed, native_jpeg, resize_mask_nearest
from tris_tpu_torch.tokenizer import tokenize
from tris_tpu_torch.utils.threads import threaded_in_order


class ReferSegDataset:
    def __init__(
        self,
        refer_data_root: str = "./data",
        dataset: str = "refcoco",
        splitBy: str = "unc",
        split: str = "train",
        size: int = 320,
        max_tokens: int = 20,
        eval_mode: bool = False,
        negative_samples: int = 0,
        pseudo_path: Optional[str] = None,
        u8_images: Optional[bool] = None,
    ):
        self.refer = REFER(refer_data_root, dataset, splitBy)
        self.split = split
        self.size = size
        self.max_tokens = max_tokens
        self.eval_mode = eval_mode
        self.negative_samples = negative_samples
        self.pseudo_path = pseudo_path
        # u8 feed: ship resized uint8 images and normalize on device
        # (ops/normalize.py) — 4x less H2D + collate memcpy. Default from
        # TRIS_U8_FEED (off: the f32 feed is the parity-exact reference path).
        if u8_images is None:
            u8_images = os.environ.get("TRIS_U8_FEED", "0") == "1"
        self.u8_images = u8_images

        self.ref_ids: List[int] = self.refer.getRefIds(split=split)
        self.refid2index = {r: i for i, r in enumerate(self.ref_ids)}

        # pre-tokenize every sentence of every ref
        self.input_ids: List[np.ndarray] = []   # per ref: [S_i, L]
        self.word_masks: List[np.ndarray] = []
        self.sentences: List[List[str]] = []
        for rid in self.ref_ids:
            ref = self.refer.Refs[rid]
            sents = [s["sent"] for s in ref["sentences"]]
            ids77 = tokenize(sents, context_length=77, truncate=True)
            ids = ids77[:, : self.max_tokens].astype(np.int32)
            self.input_ids.append(ids)
            self.word_masks.append((ids > 0).astype(np.int32))
            self.sentences.append(sents)

        self.max_sents = max(len(s) for s in self.sentences) if self.sentences else 1

    def __len__(self) -> int:
        return len(self.ref_ids)

    def max_orig_size(self) -> tuple:
        """(max_height, max_width) over this split's images — the static
        padded output shape for device-side original-size resizes. Cached:
        it is a constant of the split but gets asked per validate() call."""
        if getattr(self, "_max_orig_size", None) is None:
            mh = mw = 1
            for rid in self.ref_ids:
                img = self.refer.Imgs[self.refer.Refs[rid]["image_id"]]
                mh = max(mh, int(img["height"]))
                mw = max(mw, int(img["width"]))
            self._max_orig_size = (mh, mw)
        return self._max_orig_size

    # ---- raw annotation access -------------------------------------------

    def ref_info(self, index: int) -> dict:
        rid = self.ref_ids[index]
        ref = self.refer.Refs[rid]
        img = self.refer.Imgs[ref["image_id"]]
        x, y, w, h = self.refer.Anns[ref["ann_id"]]["bbox"]
        bbox = np.array([x, y, x + w, y + h], dtype=np.int64)  # x1y1x2y2, int like reference
        return {"ref": ref, "img": img, "bbox": bbox}

    def load_image_array(self, index: int) -> np.ndarray:
        info = self.ref_info(index)
        path = os.path.join(self.refer.IMAGE_DIR, info["img"]["file_name"])
        if self.u8_images:
            from tris_tpu_torch.data.transforms import load_transformed_u8

            return load_transformed_u8(path, self.size)
        return load_transformed(path, self.size)

    def numeric_image_id(self, index: int) -> int:
        """The reference's integer 'img_path' key (ReferDataset.py:231-232)."""
        name = self.ref_info(index)["img"]["file_name"]
        return int(name.split(".")[0].split("_")[-1])

    # ---- examples --------------------------------------------------------

    def train_example(self, index: int, rng: np.random.Generator) -> dict:
        info = self.ref_info(index)
        image = self.load_image_array(index)
        s = int(rng.integers(len(self.input_ids[index])))
        out = {
            "image": image,
            "word_ids": self.input_ids[index][s],
            "word_mask": self.word_masks[index][s],
        }
        if self.negative_samples > 0:
            out["neg_word_ids"] = self._sample_negatives(index, self.sentences[index][s], rng)
        if self.pseudo_path is not None:
            out["pseudo"] = self._load_pseudo(index)[..., None].astype(np.float32)
        return out

    def eval_example(self, index: int) -> dict:
        info = self.ref_info(index)
        image = self.load_image_array(index)
        n = len(self.input_ids[index])
        target = self.refer.getMask(info["ref"])["mask"]
        target = np.asarray(target > 0, np.uint8)
        return {
            "image": image,
            # unpadded [S_i, L]; _collate pads the batch to a power-of-two
            # bucket of the batch max (not the dataset-wide max: refcocog
            # refs reach ~30 sentences with a median of 2-4, and eval/PRMS
            # run full forwards on every padded slot)
            "word_ids": self.input_ids[index],
            "word_masks": self.word_masks[index],
            "num_sents": n,
            "target": target,           # original size [H, W]
            "bbox": info["bbox"],
            "orig_size": np.array(target.shape, np.int64),
            "img_id": self.numeric_image_id(index),
            "sentences": self.sentences[index],
            "index": index,
        }

    def _sample_negatives(self, index: int, pos_sentence: str, rng: np.random.Generator) -> np.ndarray:
        info = self.ref_info(index)
        this_rid = self.ref_ids[index]
        neg_index = []
        for item in self.refer.imgToRefs[info["ref"]["image_id"]]:
            rid = item["ref_id"]
            if rid != this_rid and rid in self.refid2index:
                neg_index.append(self.refid2index[rid])
        picks = []
        if neg_index:
            while len(picks) < self.negative_samples:
                ni = neg_index[int(rng.integers(len(neg_index)))]
                si = int(rng.integers(len(self.input_ids[ni])))
                picks.append(self.input_ids[ni][si])
        else:
            while len(picks) < self.negative_samples:
                ni = int(rng.integers(len(self.input_ids)))
                si = int(rng.integers(len(self.input_ids[ni])))
                if self.sentences[ni][si] != pos_sentence:
                    picks.append(self.input_ids[ni][si])
        return np.stack(picks, axis=0)  # [S, L]

    def _load_pseudo(self, index: int) -> np.ndarray:
        img_id = self.ref_info(index)["ref"]["image_id"]
        path = os.path.join(self.pseudo_path, f"{index}_{img_id}.npy")
        info = np.load(path, allow_pickle=True).item()
        mask = (info["mask"] * 1.0).sum(0)
        return resize_mask_nearest(mask.astype(np.uint8), self.size)


@functools.lru_cache(maxsize=None)
def _state_decoder() -> None:
    """Once a process, in the log: the native library was built without
    libjpeg, so every image goes through PIL."""
    if native_jpeg() is None:
        logging.getLogger("tris").warning(
            "tris_tpu_torch.native was built without libjpeg (<jpeglib.h> not found): "
            "images are decoded by PIL")


class Loader:
    """Fixed-shape batched iterator with thread prefetch + process sharding.
    The first ``Loader`` of a process builds the native library if needed
    and states in the log when it has no JPEG decoder."""

    def __init__(
        self,
        dataset: ReferSegDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 1234,
        drop_last: bool = True,
        num_threads: int = 8,  # stage-1 train step consumes ~500 img/s on v5e
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.process_index = process_index
        self.process_count = process_count
        _state_decoder()

    def _per_process(self) -> int:
        """Refs each process takes an epoch: all of them on one process; on
        several, ``ceil(len / process_count)``, the shuffled order padded with
        its own head to a multiple of the process count (as torch's
        ``DistributedSampler``), so that every rank yields the same number of
        batches."""
        n = len(self.ds)
        return n if self.process_count == 1 else -(-n // self.process_count)

    def __len__(self) -> int:
        n = self._per_process()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yield batches for one epoch (deterministic given (seed, epoch));
        ``len(self)`` of them on every process."""
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        if self.process_count > 1:
            total = self._per_process() * self.process_count
            order = np.resize(order, total)        # the head repeated after the tail
            order = order[self.process_index :: self.process_count]
        nb = len(self)

        def make_batch(batch_idx: int) -> dict:
            idxs = order[batch_idx * self.batch_size : (batch_idx + 1) * self.batch_size]
            brng = np.random.default_rng(self.seed * 1000003 + epoch * 131 + batch_idx)
            if self.ds.eval_mode:
                examples = [self.ds.eval_example(int(i)) for i in idxs]
                n_real = len(examples)
                # pad a short final batch to full size (drop_last=False) so
                # jit doesn't compile an extra program for it; padded rows
                # carry num_sents=0 and batch_valid=0 and are skipped on host
                while len(examples) < self.batch_size:
                    pad = dict(examples[-1])
                    pad["num_sents"] = 0
                    examples.append(pad)
                batch = _collate(examples)
                batch["batch_valid"] = (np.arange(self.batch_size) < n_real).astype(np.int32)
                return batch
            examples = [self.ds.train_example(int(i), brng) for i in idxs]
            return _collate(examples)

        if self.num_threads <= 1:
            for b in range(nb):
                yield make_batch(b)
            return
        # a failed batch (a missing image or pseudo-mask) raises here
        yield from threaded_in_order(make_batch, nb, self.num_threads)


def _pow2_bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _collate(examples: List[dict]) -> dict:
    out = {}
    for key in examples[0]:
        vals = [e[key] for e in examples]
        if key in ("sentences",):
            out[key] = vals
        elif key == "target":
            out[key] = vals  # variable original sizes: keep as list
        elif key in ("word_ids", "word_masks") and np.asarray(vals[0]).ndim == 2:
            # ragged eval sentences [S_i, L]: pad to a power-of-two bucket of
            # the batch max so jit compiles once per bucket, not per count
            # (mirrors validate_referit.py bucketing)
            S = _pow2_bucket(max(v.shape[0] for v in vals))
            L = vals[0].shape[1]
            padded = np.zeros((len(vals), S, L), np.int32)
            for i, v in enumerate(vals):
                padded[i, : v.shape[0]] = v
            out[key] = padded
        else:
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out
