"""IRNet's instance pseudo-mask pass (``make_ins_seg``) on the card.

Port of pass 3 of ``tris_tpu/pseudo/pipeline.py``: CAMs
(``{cam_dir}/{name}.npy`` at the original image size, from PRMS) and a
trained IRNet give ``{ins_seg_dir}/{name}.npy`` dicts. Image naming follows
the reference (voc12/dataloader.py:117-188): names are ``{idx}_{img_id}``,
resolving to ``COCO_train2014_{img_id:012d}.jpg`` or ``{img_id}.jpg`` for
ReferIt. Images decode with PIL. Passes 1 (CRF ir-labels) and 2 (IRN
training) are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from tris_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


@dataclasses.dataclass
class PseudoConfig:
    train_list: str = ""                # names json from PRMS
    data_root: str = "./data/train2014"
    cam_dir: str = "./out/cam"
    ir_label_dir: str = "./out/ir_label"
    ins_seg_dir: str = "./out/ins_seg"
    irn_weights: str = "./out/res50_irn.pth"
    conf_fg_thres: float = 0.3
    conf_bg_thres: float = 0.1
    crop_size: int = 512
    radius: int = 10
    beta: float = 10.0
    exp_times: int = 8
    ins_seg_bg_thres: float = 0.25
    num_workers: int = 8
    referit: bool = False
    # the multi-scale hook of ReferClassificationDatasetMSF; the reference's
    # pass runs at (1.0,) and reads the first scale only
    scales: tuple = (1.0,)


def load_names(cfg: PseudoConfig) -> List[str]:
    with open(cfg.train_list) as f:
        return json.load(f)


def image_path(cfg: PseudoConfig, name: str) -> str:
    img_id = name.split("_")[-1]
    if cfg.referit or "referit" in cfg.data_root:
        return os.path.join(cfg.data_root, f"{img_id}.jpg")
    return os.path.join(cfg.data_root, f"COCO_train2014_{int(img_id):012d}.jpg")


def load_raw_image(cfg: PseudoConfig, name: str) -> np.ndarray:
    """The uint8 [H, W, 3] image (grayscale replicated to three channels)."""
    from PIL import Image

    img = np.asarray(Image.open(image_path(cfg, name)))
    if img.ndim == 2:  # voc12/dataloader.py:164-166
        img = np.stack([img] * 3, axis=-1)
    return img


def normalize_image(img: np.ndarray) -> np.ndarray:
    return ((img.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def _ins_seg_load(cfg: PseudoConfig, name: str):
    """Host input stage: decode the image, normalise (or rescale first), load
    the CAM."""
    raw = load_raw_image(cfg, name)
    oh, ow = raw.shape[:2]
    if len(cfg.scales) == 1 and cfg.scales[0] == 1.0:
        img = normalize_image(raw)
    else:
        # the first scale's image, rescaled raw and then normalised, as the
        # reference feeds pack['img'][0]; the flip average is in the model
        from tris_tpu_torch.pseudo.aug import multi_scale_flip_stacks

        img = normalize_image(multi_scale_flip_stacks(raw, cfg.scales)[0][0])
    cam = np.asarray(np.load(os.path.join(cfg.cam_dir, name + ".npy"), allow_pickle=True),
                     np.float32)
    return name, (oh, ow), img, cam


def _ins_seg_worker(cfg: PseudoConfig, model, names: List[str], device, progress,
                    io_threads: int = 2, depth: int = 1):
    """One device's software pipeline: image k+1's device work (the IRNet
    forward and K9, then the walk) is queued before image k's host work
    (connected components, ``detect_instance``, the npy write) runs. CUDA
    dispatch is asynchronous, so host and card overlap; ``.cpu()`` is the
    fetch. ``depth`` is how many images sit between a stage's dispatch and
    its fetch.

      S1 (device): edge/displacement inference + centroid refinement
      S2 (host): fetch disp and centroids -> ``cluster_centroids``;
         (device): CAM resize and mask -> bucketed walk -> upsample, argmax
      S3 (host): fetch the walk's outputs -> ``detect_from_walk`` -> save
    """
    from tris_tpu_torch import kernels as K
    from tris_tpu_torch.device import to_device
    from tris_tpu_torch.pseudo.irnet import edge_displacement_infer
    from tris_tpu_torch.pseudo.labels import (
        cluster_centroids, detect_from_walk, walk_upsample_argmax)

    q1: collections.deque = collections.deque()
    q2: collections.deque = collections.deque()

    def s1(item):
        name, osize, img, cam = item
        edge, disp = edge_displacement_infer(model, to_device(img, device))
        q1.append((name, osize, cam, edge, disp, K.refine_centroids(disp)))

    def s2():
        name, osize, cam, edge, disp, cents = q1.popleft()
        instance_map = cluster_centroids(cents.cpu().numpy(), disp.cpu().numpy())
        rw_up, shape = walk_upsample_argmax(
            instance_map, cam, edge, osize, beta=cfg.beta, exp_times=cfg.exp_times,
            ins_seg_bg_thres=cfg.ins_seg_bg_thres, device=device)
        q2.append((name, osize, rw_up, shape))

    def s3():
        name, osize, rw_up, shape = q2.popleft()
        detected = detect_from_walk(rw_up.cpu().numpy(), shape.cpu().numpy(), osize)
        np.save(os.path.join(cfg.ins_seg_dir, name + ".npy"), detected)  # a dict npy
        progress(name)

    with torch.no_grad(), ThreadPoolExecutor(max_workers=max(1, io_threads)) as io:
        for item in io.map(lambda n: _ins_seg_load(cfg, n), names):
            s1(item)
            if len(q1) > depth:
                s2()
            if len(q2) > depth:
                s3()
        while q1:
            s2()
            if len(q2) > depth:
                s3()
        while q2:
            s3()


def run_make_ins_seg(cfg: PseudoConfig, model=None, names: Optional[List[str]] = None,
                     log=print, device="cuda", num_shards: Optional[int] = None,
                     shard_idx: Optional[int] = None, depth: int = 1):
    """Instance pseudo-masks for ``names`` (default: the names json), on one
    device (``"cuda"`` unless the caller asks for the CPU), pipelined one
    image deep (:func:`_ins_seg_worker`). ``model`` is an IRNet on that
    device; without it, ``cfg.irn_weights`` is loaded. ``num_shards`` /
    ``shard_idx`` take every ``num_shards``-th name from ``shard_idx`` (the
    reference's strided ``split_dataset``); by default the
    ``torch.distributed`` rank and world size when a group is initialised.
    The JAX package's fan-out over the local devices is not ported."""
    from tris_tpu_torch.cli.common import dist_rank_world
    from tris_tpu_torch.device import resolve_device
    from tris_tpu_torch.pseudo.irnet import build_irnet

    dev = resolve_device(device)
    names = names if names is not None else load_names(cfg)
    if num_shards is None:
        shard_idx, num_shards = dist_rank_world()
    if num_shards > 1:
        names = names[shard_idx::num_shards]
    if model is None:
        model = build_irnet(cfg.irn_weights, dev)
    os.makedirs(cfg.ins_seg_dir, exist_ok=True)
    done = 0

    def progress(name):
        nonlocal done
        done += 1
        if done % 50 == 0:
            log(f"ins_seg {done}/{len(names)}")

    _ins_seg_worker(cfg, model, names, dev, progress, depth=depth)
