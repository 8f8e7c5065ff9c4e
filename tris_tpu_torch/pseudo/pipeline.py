"""IRNet's pseudo-label pipeline: its three passes, with the reference's
file contract.

Port of ``tris_tpu/pseudo/pipeline.py``:

  1. cam_to_ir_label: ``{cam_dir}/{name}.npy`` -> ``{ir_label_dir}/{name}.png``
     (the dense CRF on the host, in worker processes);
  2. train_irn: ir labels -> a trained IRNet, ``torch.save`` of its
     ``state_dict`` to ``irn_weights`` (``.pth``), on one device or data
     parallel over a process group;
  3. make_ins_seg: CAMs (at the original image size, from PRMS) and an
     IRNet -> ``{ins_seg_dir}/{name}.npy`` dicts, the names strided over the
     ranks of a process group and fanned out over the local devices.

Image naming follows the reference (voc12/dataloader.py:117-188): names are
``{idx}_{img_id}``, resolving to ``COCO_train2014_{img_id:012d}.jpg`` or
``{img_id}.jpg`` for ReferIt. Images decode with PIL.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from tris_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tris_tpu_torch.parallel import rank_world, wrap_ddp
from tris_tpu_torch.utils.threads import threaded_in_order


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


def _ir_label_one(args) -> str:
    cfg, name = args
    from PIL import Image

    from tris_tpu_torch.pseudo.labels import cam_to_ir_label

    img = load_raw_image(cfg, name)
    cam = np.asarray(np.load(os.path.join(cfg.cam_dir, name + ".npy"), allow_pickle=True),
                     np.float32)
    conf = cam_to_ir_label(img, cam, cfg.conf_fg_thres, cfg.conf_bg_thres)
    out = os.path.join(cfg.ir_label_dir, name + ".png")
    Image.fromarray(conf).save(out)
    return out


def run_cam_to_ir_label(cfg: PseudoConfig, names: Optional[List[str]] = None,
                        parallel: bool = True):
    """The CRF labelling of every name on the host, in ``cfg.num_workers``
    spawned processes, as the reference's multiprocessing.spawn
    (cam_to_ir_label.py:82-92): a fork would copy a parent whose CUDA
    context and thread pools the workers must not share. The parent builds
    the native library first; each worker's CRF runs on one OpenMP thread,
    so that the workers do not oversubscribe the host. In a process group each rank labels every
    world-th name from its rank, then waits for the others."""
    import multiprocessing

    from tris_tpu_torch import native

    names = names if names is not None else load_names(cfg)
    rank, world = rank_world()
    names = names[rank::world]  # a process group's ranks stride the names
    os.makedirs(cfg.ir_label_dir, exist_ok=True)
    native.build_library()  # once, here, before the workers load it
    tasks = [(cfg, n) for n in names]
    if parallel and len(names) > 1:
        with ProcessPoolExecutor(max_workers=min(cfg.num_workers, len(names)),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            list(ex.map(_ir_label_one, tasks, chunksize=4))
    else:
        for t in tasks:
            _ir_label_one(t)
    if world > 1:
        torch.distributed.barrier()  # every rank's labels are on disk before training


def irn_train_batches(cfg: PseudoConfig, names: List[str], path_index, batch_size: int,
                      epochs: int, seed: int = 1234, num_threads: Optional[int] = None,
                      labels: str = "device", process_index: int = 0, process_count: int = 1):
    """Augmented IRN training batches as numpy, the reference's
    ``ReferAffinityDataset``: rescale by (0.5, 1.5), normalise, flip, random
    crop to ``cfg.crop_size`` (image padded with 0, label with 255), the
    label map at quarter scale. The same batches as the JAX package's for
    the same seed.

    Built by ``num_threads`` worker threads (default ``cfg.num_workers``)
    and yielded in order, so the host builds the next batches while the
    card trains. A short final batch wraps around to the epoch's first
    samples. Every batch's augmentations draw from their own stream, seeded
    from (seed, epoch, batch, process), whatever the threads' timing.

    Across ``process_count`` processes (data-parallel IRN training,
    ``batch_size`` per process) process ``process_index`` takes every
    ``process_count``-th name of the epoch's permutation from its own, cut
    to ``n // process_count`` so that every process yields as many batches
    (a step is a collective): the JAX pass's slices and batches. Where a
    process's slice would be empty (more processes than names) this raises;
    the JAX pass fills it with the whole permutation, so that process trains
    on the others' examples (``ROADMAP.md`` §3).

    ``labels="device"`` yields ``image`` [B, crop, crop, 3] float32 and
    ``reduced_label`` [B, crop/4, crop/4] uint8, from which K8 builds the
    pair masks on the card; ``labels="host"`` yields the three masks
    ``aff_bg_pos``, ``aff_fg_pos``, ``aff_neg`` [B, n_dirs, n_pairs] float32
    instead (about 24 MB per example at crop 512), which only the loss on
    the CPU reads. Values are the same."""
    from PIL import Image

    from tris_tpu_torch.pseudo.aug import (
        affinity_labels_from_indices, pil_rescale, random_crop_pair, random_lr_flip_pair,
        random_scale_pair)

    num_threads = cfg.num_workers if num_threads is None else num_threads
    n = len(names)
    local_n = n // process_count
    if local_n == 0 and process_count > 1:
        raise ValueError(f"irn_train_batches: {n} names leave process {process_index} of "
                         f"{process_count} no examples")
    nb_per_epoch = -(-local_n // batch_size)

    epoch_rng = np.random.default_rng(seed)
    orders = [epoch_rng.permutation(n)[process_index::process_count][:local_n]
              for _ in range(epochs)]

    def make_batch(epoch: int, b: int) -> dict:
        order = orders[epoch]
        idxs = order[b * batch_size:(b + 1) * batch_size]
        if len(idxs) < batch_size:  # wrap the final short batch (tiled if n < batch_size)
            idxs = np.concatenate([idxs, np.resize(order, batch_size - len(idxs))])
        rng = np.random.default_rng(
            (seed * 1000003 + epoch * 131 + b + process_index * 97003) % (2 ** 63))
        imgs, reduceds, bgs, fgs, negs = [], [], [], [], []
        for i in idxs:
            name = names[i]
            img = load_raw_image(cfg, name)
            label = np.asarray(Image.open(os.path.join(cfg.ir_label_dir, name + ".png")))
            img, label = random_scale_pair(img, label, (0.5, 1.5), rng)
            img = normalize_image(img)
            img, label = random_lr_flip_pair(img, label, rng)
            img, label = random_crop_pair(img, label, cfg.crop_size, rng)
            reduced = pil_rescale(label, 0.25, 0)
            imgs.append(img)
            if labels == "device":
                reduceds.append(reduced.astype(np.uint8))
            else:
                bg, fg, neg = affinity_labels_from_indices(
                    reduced, path_index.src_indices, path_index.dst_indices)
                bgs.append(bg)
                fgs.append(fg)
                negs.append(neg)
        out = {"image": np.stack(imgs).astype(np.float32)}
        if labels == "device":
            out["reduced_label"] = np.stack(reduceds)
        else:
            out["aff_bg_pos"], out["aff_fg_pos"], out["aff_neg"] = (
                np.stack(bgs), np.stack(fgs), np.stack(negs))
        return out

    tasks = [(e, b) for e in range(epochs) for b in range(nb_per_epoch)]
    if num_threads <= 1 or len(tasks) <= 1:
        for e, b in tasks:
            yield make_batch(e, b)
        return

    # a failed batch (a missing image or ir label) raises here
    yield from threaded_in_order(lambda t: make_batch(*tasks[t]), len(tasks),
                                 min(num_threads, len(tasks)))


def calibration_images(cfg: PseudoConfig, names: List[str], batch_size: int):
    """The mean-shift calibration's batches: the images of each full batch
    of ``names`` in order, normalised and top-left cropped to
    ``cfg.crop_size`` (padded with 0), NHWC float32."""
    from tris_tpu_torch.pseudo.aug import top_left_crop

    for start in range(0, len(names) - batch_size + 1, batch_size):
        yield np.stack([top_left_crop(normalize_image(load_raw_image(cfg, name)), cfg.crop_size, 0)
                        for name in names[start:start + batch_size]]).astype(np.float32)


def run_train_irn(cfg: PseudoConfig, names: Optional[List[str]] = None, epochs: int = 3,
                  batch_size: int = 24, lr: float = 0.1, log=print, device="cuda", model=None):
    """IRN training on one device (``"cuda"`` unless the caller asks for the
    CPU): IRNet's heads from a seeded init (``model`` to start from another
    IRNet), ``epochs`` over ``names`` at ``batch_size``, then the mean-shift
    calibration over the top-left crops of the full batches of ``names``
    (it raises, as the JAX pass does, when ``names`` has fewer than
    ``batch_size``), saved as a ``state_dict`` to ``cfg.irn_weights`` (by
    rank 0). Returns the model.

    In a process group of several ranks the heads train under DDP, each rank
    on its slice of the names (:func:`irn_train_batches`), ``batch_size``
    per rank: a step is the JAX pass's step on the global batch. The trunk
    is frozen (``FrozenBatchNorm``, GroupNorm), so no statistics cross the
    ranks. Every rank calibrates on all the names, as every JAX process
    does."""
    from tris_tpu_torch.device import resolve_device
    from tris_tpu_torch.pseudo.indexing import PathIndex
    from tris_tpu_torch.pseudo.irnet import IRNet
    from tris_tpu_torch.pseudo.train_irn import (
        IRNTrainConfig, batch_to_device, calibrate_mean_shift, make_irn_optimizer, train_step)

    dev = resolve_device(device)
    names = names if names is not None else load_names(cfg)
    path_index = PathIndex(cfg.radius, (cfg.crop_size // 4, cfg.crop_size // 4))
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = IRNet()
    model = model.to(dev).train()
    tcfg = IRNTrainConfig(crop_size=cfg.crop_size, radius=cfg.radius, lr=lr, epochs=epochs,
                          batch_size=batch_size)
    rank, world = rank_world()
    max_step = -(-(len(names) // world) // batch_size) * epochs  # the short batch wraps
    opt, sched = make_irn_optimizer(model, tcfg, max(max_step, 1))
    net = wrap_ddp(model, dev)
    if world > 1:
        log(f"irn train: DP over {world} processes (global batch {batch_size * world})")

    it = 0
    for batch in irn_train_batches(cfg, names, path_index, batch_size, epochs,
                                   process_index=rank, process_count=world):
        metrics = train_step(net, opt, sched, path_index, batch_to_device(batch, dev))
        it += 1
        if it % 50 == 0:
            log(f"irn step {it}/{max_step} loss={float(metrics['loss']):.4f}")

    model.eval().requires_grad_(False)
    calibrate_mean_shift(model, (torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
                                 for x in calibration_images(cfg, names, batch_size)))
    if rank == 0:
        if os.path.dirname(cfg.irn_weights):
            os.makedirs(os.path.dirname(cfg.irn_weights), exist_ok=True)
        torch.save(model.state_dict(), cfg.irn_weights)
    if world > 1:
        torch.distributed.barrier()  # the weights are on disk before any rank reads them
    return model


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
                     shard_idx: Optional[int] = None, depth: int = 1, devices=None):
    """Instance pseudo-masks for ``names`` (default: the names json),
    pipelined one image deep (:func:`_ins_seg_worker`) on each device, as the
    JAX pass fans out: the names strided first across the processes, then
    across this process's devices, one worker thread a device. Outputs are
    the serial pass's: each image's work is unchanged, only overlapped.

    ``device``: ``"cuda"`` unless the caller asks for the CPU. ``devices``
    (default: every local card on one process; in a process group of
    several ranks, the rank's own card) are the devices the workers take.
    ``model`` is an IRNet (copied to each device); without it,
    ``cfg.irn_weights`` is loaded on each. ``num_shards`` / ``shard_idx``
    take every ``num_shards``-th name from ``shard_idx`` (the reference's
    strided ``split_dataset``); by default the ``torch.distributed`` rank
    and world size when a group is initialised."""
    import copy
    import threading

    from tris_tpu_torch.device import resolve_device
    from tris_tpu_torch.pseudo.irnet import build_irnet

    dev = resolve_device(device)
    names = names if names is not None else load_names(cfg)
    if num_shards is None:
        shard_idx, num_shards = rank_world()
    if num_shards > 1:
        names = names[shard_idx::num_shards]
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" and rank_world()[1] == 1 and dev.index is None
                   else [dev])
    devices = [torch.device(d) for d in devices][:max(1, len(names))]
    models = [build_irnet(cfg.irn_weights, d) if model is None
              else model if next(model.parameters()).device == d
              else copy.deepcopy(model).to(d) for d in devices]
    os.makedirs(cfg.ins_seg_dir, exist_ok=True)
    done = 0
    lock = threading.Lock()

    def progress(name):
        nonlocal done
        with lock:
            done += 1
            if done % 50 == 0:
                log(f"ins_seg {done}/{len(names)}")

    if len(devices) == 1:
        _ins_seg_worker(cfg, models[0], names, devices[0], progress, depth=depth)
        return
    threads = torch.get_num_threads()

    def worker(model, part, device):
        # a new thread starts with the host's default intra-op thread count, which splits
        # (and so rounds) the host ops' sums otherwise than the caller's setting would
        torch.set_num_threads(threads)
        _ins_seg_worker(cfg, model, part, device, progress, depth=depth)

    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(worker, m, names[d::len(devices)], dv)
                   for d, (m, dv) in enumerate(zip(models, devices))]
        for f in futures:
            f.result()  # a worker's failure raises here
