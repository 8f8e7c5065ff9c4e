"""REFER annotation API (RefCOCO / RefCOCO+ / RefCOCOg / RefCLEF).

Host-side re-implementation of the classic REFER index
(`reference/dataset/refer.py:44-233`): loads ``refs(splitBy).p`` +
``instances.json`` and builds the id indices the datasets and evaluators
need. No torch/pycocotools dependencies — mask decoding uses
:mod:`tris_tpu_torch.data.mask_ops`.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Sequence, Union

import numpy as np

from tris_tpu_torch.data import mask_ops


class REFER:
    def __init__(self, data_root: str = "./data", dataset: str = "refcoco", splitBy: str = "unc"):
        self.data_root = data_root
        self.dataset = dataset
        self.splitBy = splitBy
        self.DATA_DIR = os.path.join(data_root, "refer", dataset)
        if dataset in ("refcoco", "refcoco+", "refcocog"):
            self.IMAGE_DIR = os.path.join(data_root, "train2014")
        elif dataset == "refclef":
            self.IMAGE_DIR = os.path.join(data_root, "images/saiapr_tc-12")
        else:
            raise ValueError(f"unknown refer dataset: {dataset}")

        with open(os.path.join(self.DATA_DIR, f"refs({splitBy}).p"), "rb") as f:
            self.refs: List[dict] = pickle.load(f)
        with open(os.path.join(self.DATA_DIR, "instances.json")) as f:
            instances = json.load(f)

        self.Anns: Dict = {ann["id"]: ann for ann in instances["annotations"]}
        self.Imgs: Dict = {img["id"]: img for img in instances["images"]}
        self.Cats: Dict = {cat["id"]: cat["name"] for cat in instances["categories"]}

        self.imgToAnns: Dict = {}
        for ann in instances["annotations"]:
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)

        self.Refs: Dict = {}
        self.Sents: Dict = {}
        self.imgToRefs: Dict = {}
        self.refToAnn: Dict = {}
        self.annToRef: Dict = {}
        self.catToRefs: Dict = {}
        self.sentToRef: Dict = {}
        self.sentToTokens: Dict = {}
        for ref in self.refs:
            rid = ref["ref_id"]
            self.Refs[rid] = ref
            self.imgToRefs.setdefault(ref["image_id"], []).append(ref)
            self.catToRefs.setdefault(ref["category_id"], []).append(ref)
            self.refToAnn[rid] = self.Anns[ref["ann_id"]]
            self.annToRef[ref["ann_id"]] = ref
            for sent in ref["sentences"]:
                self.Sents[sent["sent_id"]] = sent
                self.sentToRef[sent["sent_id"]] = ref
                self.sentToTokens[sent["sent_id"]] = sent["tokens"]

    # ---- queries (refer.py:143-233) ---------------------------------------

    def getRefIds(self, image_ids=None, cat_ids=None, ref_ids=None, split: str = "") -> List[int]:
        image_ids = _as_list(image_ids)
        cat_ids = _as_list(cat_ids)
        ref_ids = _as_list(ref_ids)

        refs = self.refs
        if image_ids:
            refs = [r for image_id in image_ids for r in self.imgToRefs.get(image_id, [])]
        if cat_ids:
            refs = [r for r in refs if r["category_id"] in cat_ids]
        if ref_ids:
            wanted = set(ref_ids)
            refs = [r for r in refs if r["ref_id"] in wanted]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"no such split: {split}")
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids=None, cat_ids=None) -> List[int]:
        image_ids = _as_list(image_ids)
        cat_ids = _as_list(cat_ids)
        if image_ids:
            anns = [a for i in image_ids for a in self.imgToAnns.get(i, [])]
        else:
            anns = list(self.Anns.values())
        if cat_ids:
            anns = [a for a in anns if a["category_id"] in cat_ids]
        return [a["id"] for a in anns]

    def getImgIds(self, ref_ids=None) -> List[int]:
        ref_ids = _as_list(ref_ids)
        if ref_ids:
            return list({self.Refs[r]["image_id"] for r in ref_ids})
        return list(self.Imgs.keys())

    def getCatIds(self) -> List[int]:
        return list(self.Cats.keys())

    def loadRefs(self, ref_ids) -> List[dict]:
        return [self.Refs[r] for r in _as_list(ref_ids)]

    def loadAnns(self, ann_ids) -> List[dict]:
        return [self.Anns[a] for a in _as_list(ann_ids)]

    def loadImgs(self, image_ids) -> List[dict]:
        return [self.Imgs[i] for i in _as_list(image_ids)]

    def loadCats(self, cat_ids) -> List[str]:
        return [self.Cats[c] for c in _as_list(cat_ids)]

    def getRefBox(self, ref_id: int) -> List[float]:
        return self.refToAnn[ref_id]["bbox"]  # [x, y, w, h]

    def getMask(self, ref: dict) -> dict:
        """Binary mask + area for a ref (refer.py:279-292)."""
        ann = self.refToAnn[ref["ref_id"]]
        image = self.Imgs[ref["image_id"]]
        h, w = image["height"], image["width"]
        seg = ann["segmentation"]
        if isinstance(seg[0] if isinstance(seg, list) else None, list):
            rles = mask_ops.fr_poly_objects(seg, h, w)
            m = mask_ops.rle_decode(rles).sum(axis=-1).astype(np.uint8)
            area = int(np.sum(mask_ops.rle_area(rles)))
        else:
            m = mask_ops.segmentation_to_mask(seg, h, w).astype(np.uint8)
            area = int(m.sum())
        return {"mask": m, "area": area}


    # ---- visualization (refer.py:235-277,329-333) --------------------------

    def showRef(self, ref: dict, seg_box: str = "seg"):
        """Draw the image with the referred object's polygons or box."""
        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon, Rectangle
        from PIL import Image

        ax = plt.gca()
        image = self.Imgs[ref["image_id"]]
        ax.imshow(Image.open(os.path.join(self.IMAGE_DIR, image["file_name"])))
        for sid, sent in enumerate(ref["sentences"]):
            print(f"{sid + 1}. {sent['sent']}")
        ann = self.Anns[ref["ann_id"]]
        if seg_box == "seg":
            seg = ann["segmentation"]
            if isinstance(seg[0] if isinstance(seg, list) else None, list):
                polygons = [
                    Polygon(np.asarray(p).reshape(len(p) // 2, 2), closed=True, alpha=0.4)
                    for p in seg
                ]
                ax.add_collection(PatchCollection(
                    polygons, facecolors="none", edgecolors=(1, 1, 0), linewidths=3))
                ax.add_collection(PatchCollection(
                    polygons, facecolors="none", edgecolors=(1, 0, 0), linewidths=1))
            else:
                m = mask_ops.segmentation_to_mask(seg, image["height"], image["width"])
                overlay = np.zeros((*m.shape, 4))
                overlay[..., 1] = 0.65
                overlay[..., 3] = m * 0.5
                ax.imshow(overlay)
        elif seg_box == "box":
            x, y, w, h = self.getRefBox(ref["ref_id"])
            ax.add_patch(Rectangle((x, y), w, h, fill=False, edgecolor="green", linewidth=3))

    def showMask(self, ref: dict):
        import matplotlib.pyplot as plt

        plt.gca().imshow(self.getMask(ref)["mask"])


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
