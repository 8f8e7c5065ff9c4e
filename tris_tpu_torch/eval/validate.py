"""Batched stage-1 evaluation and PRMS response-map selection.

Port of ``tris_tpu/eval/validate.py::validate`` and ``validate_prms``. All
padded sentences of a batch of refs go through one forward of
``TRISStage1.response_maps`` (``[B, S, H, W]`` maps, the reference's
batch-1-per-sentence semantics); the u8 feed is normalised on the card by K6.
PRMS then scores every map with the frozen ViT critic (its input is K5) and
keeps each ref's best one. The maps are upsampled to each image's ORIGINAL
size, max-normalised and thresholded (validate.py:180-208 of the reference):

- on the card by K4 (``kernels.eval_metrics``): when neither CAMs nor box
  metrics are wanted only [B, S] (I, U, hit, hitm) scalars reach the host
  (``_device_metrics``); otherwise the normalised padded maps do
  (``_device_resize_norm``);
- on the host with numpy when ``device_resize=False`` (the user's choice).

Pipelined: batch k+1's device work is queued before batch k's host work
runs, and batch k's results are copied to pinned host memory right behind
its own work, so the host waits for those copies only.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from tris_tpu_torch import kernels
from tris_tpu_torch.device import HostFetch, to_device
from tris_tpu_torch.eval.metrics import SegEvalAccumulator
from tris_tpu_torch.ops.resize import _resize_matrix_np


def _host_pool(host_threads: int) -> Optional[ThreadPoolExecutor]:
    """Thread pool for per-ref host metric work (the resize matmuls release
    the GIL inside BLAS). host_threads=0 -> cpu_count; 1 -> run inline."""
    n = (os.cpu_count() or 1) if host_threads == 0 else host_threads
    return ThreadPoolExecutor(max_workers=n) if n > 1 else None


def _map_jobs(pool: Optional[ThreadPoolExecutor], fn, jobs):
    return list(pool.map(fn, jobs)) if pool is not None else [fn(j) for j in jobs]


def resize_to_original_np(cam: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Host bilinear resize (align_corners=True) via the interpolation
    matrices; cam: [h, w] -> [oh, ow]."""
    ah = _resize_matrix_np(cam.shape[0], oh, True)
    aw = _resize_matrix_np(cam.shape[1], ow, True)
    return ah @ cam.astype(np.float32) @ aw.T


def normalize_threshold(cam: np.ndarray):
    """Max-normalize then threshold. Returns (cam_norm, pred)."""
    cam = cam / (cam.max() + 1e-5)
    return cam, cam > 1e-9


def _padded_targets_boxes(batch, maxh: int, maxw: int):
    B = len(batch["target"])
    tgt = np.zeros((B, maxh, maxw), np.uint8)
    for b, t in enumerate(batch["target"]):
        tgt[b, : t.shape[0], : t.shape[1]] = t
    flat = [np.asarray(bb, np.float32).reshape(-1) for bb in batch["bbox"]]
    for bb in flat:
        # the host chain's is_correct_hit accepts a [K, 4] box stack and hits
        # on ANY box; the device metrics handle one
        if bb.size != 4:
            raise ValueError(
                f"device-metrics path supports exactly one gt box per ref, got "
                f"{bb.size // 4}; rerun with --no_device_resize for multi-box data"
            )
    return tgt, np.stack(flat)


def _max_orig_size(loader) -> tuple:
    """The padded (maxH, maxW) of the device resize: the loader's dataset
    must say it, since the padded shape must hold every original image."""
    size = getattr(getattr(loader, "ds", None), "max_orig_size", None)
    if size is None:
        raise TypeError(
            f"validate(device_resize=True) needs loader.ds.max_orig_size(); "
            f"{type(loader).__name__} has none. Pass device_resize=False "
            f"(--no_device_resize) to resize on the host instead")
    maxh, maxw = size()
    return int(maxh), int(maxw)


def image_to_nchw(image: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] u8 (normalised by K6) or already-normalised f32 ->
    [B, 3, H, W] float32."""
    if image.dtype == torch.uint8:
        return kernels.normalize_u8_nchw(image)
    return image.permute(0, 3, 1, 2).contiguous()


def make_eval_forward(model):
    """(image [B, H, W, 3] numpy f32 or u8, word_ids [B, S, L] numpy) ->
    relu maps [B, S, H, W] float32 on the model's device (queued, not waited
    for): cast to float32 as the JAX package casts them before its metrics
    (a no-op for stage 1, whose maps are float32 in every dtype)."""
    device = next(model.parameters()).device

    def forward(image: np.ndarray, word_ids: np.ndarray) -> torch.Tensor:
        x = image_to_nchw(to_device(image, device))
        return model.response_maps(x, to_device(word_ids, device)).float()

    return forward


def make_prms_forward(model, critic):
    """One PRMS step for a ref batch, on the models' device (queued).

    (image [B, H, W, 3] numpy f32 or u8, word_ids [B, S, L], valid [B, S]
    bool) -> (best [B], relu maps [B, S, H, W], scores [B, S]), with
    ``score_j = sum_i cos(critic_img(map_j * image), critic_txt(sent_i))``
    over the valid sentences i (validate.py:311-334 of the reference); an
    invalid j scores -inf."""
    device = next(model.parameters()).device
    size = critic.config.image_resolution
    patch = critic.config.vision_patch_size

    def forward(image: np.ndarray, word_ids: np.ndarray, valid: np.ndarray):
        x = image_to_nchw(to_device(image, device))
        ids = to_device(word_ids, device)
        valid_t = to_device(valid, device)
        B, S, L = ids.shape
        cams = model.response_maps(x, ids).float()                      # [B, S, H, W]
        a = kernels.critic_input(cams.reshape(B * S, *cams.shape[2:]), x, S, size, patch)
        img_feat = critic.visual.forward_patches(a)                     # [B*S, C]
        _, txt_feat = critic.encode_text(ids.reshape(B * S, L))
        img_feat = img_feat / torch.linalg.vector_norm(img_feat, dim=-1, keepdim=True)
        txt_feat = txt_feat / torch.linalg.vector_norm(txt_feat, dim=-1, keepdim=True)
        score_mat = torch.einsum("bjc,bic->bji", img_feat.reshape(B, S, -1),
                                 txt_feat.reshape(B, S, -1))            # [B, Sj, Si]
        scores = score_mat.masked_fill(~valid_t[:, None, :], 0.0).sum(dim=2)
        scores = scores.masked_fill(~valid_t, -torch.inf)
        return scores.argmax(dim=1), cams, scores

    return forward


@torch.no_grad()
def validate(
    model,
    loader,
    with_boxes: bool = True,
    save_cam: bool = False,
    cam_save_dir: Optional[str] = None,
    name_save_dir: Optional[str] = None,
    dataset_name: str = "refcoco",
    print_freq: int = 50,
    log=print,
    host_threads: int = 0,
    device_resize: bool = True,
) -> dict:
    """Standard (non-PRMS) evaluation of a ``TRISStage1`` or ``TRISStage2``
    (its ``response_maps``) over an eval-mode Loader, on the device its
    parameters live on.

    With ``device_resize`` the original-size upsample and max-normalise run
    on the device, padded to ``loader.ds.max_orig_size()`` (a loader whose
    dataset lacks it raises); when no CAMs or box metrics are needed
    (``save_cam=False, with_boxes=False``), I/U/hit reduce there too and
    only per-sentence scalars are fetched. With ``device_resize=False`` the
    host does the resize, fanning (ref, sentence) jobs over ``host_threads``
    (0 = cpu_count). With ``save_cam`` each map is saved as
    ``{cam_save_dir}/{idx}_{j}_{img_id}.npy`` and the names json lists
    every process's names, written by rank 0 alone."""
    model.eval()
    device = next(model.parameters()).device
    forward = make_eval_forward(model)
    acc = SegEvalAccumulator(with_boxes=with_boxes)
    cam_out_names = []
    if save_cam and cam_save_dir:
        os.makedirs(cam_save_dir, exist_ok=True)
    max_size = _max_orig_size(loader) if device_resize else None
    scalars_only = bool(max_size) and not save_cam and not with_boxes
    # the pool serves every non-scalars process() path: host resize matmuls
    # when not device_resize, and the cv2 box-metric pass either way
    pool = None if scalars_only else _host_pool(host_threads)
    step = 0

    def process(fetch, batch):
        out = fetch.numpy()  # waits for this batch's copies only
        if scalars_only:
            I, U, hit, hitm = out
            for b in range(I.shape[0]):
                for j in range(int(batch["num_sents"][b])):
                    acc.add_stats(float(I[b, j]), float(U[b, j]),
                                  float(hit[b, j]), float(hitm[b, j]), weight=1)
            return
        cams = out[0]
        jobs = [(b, j) for b in range(cams.shape[0]) for j in range(int(batch["num_sents"][b]))]

        def one(job):
            b, j = job
            oh, ow = batch["target"][b].shape
            if max_size:  # cams are already device-normalized at padded size
                cam_norm = np.ascontiguousarray(cams[b, j, :oh, :ow])
                pred = cam_norm > 1e-9
            else:
                cam = resize_to_original_np(cams[b, j], oh, ow)
                cam_norm, pred = normalize_threshold(cam)
                cam_norm = cam_norm.astype(np.float32)
            stats = acc.compute(batch["target"][b], pred, cam_norm, batch["bbox"][b])
            return b, j, stats, cam_norm

        for b, j, stats, cam_norm in _map_jobs(pool, one, jobs):
            acc.add_computed(stats, weight=1)
            if save_cam and cam_save_dir:
                idx = int(batch["index"][b])
                img_id = int(batch["img_id"][b])
                np.save(os.path.join(cam_save_dir, f"{idx}_{j}_{img_id}.npy"), cam_norm)
                cam_out_names.append(f"{idx}_{j}_{img_id}")

    pending = None
    for batch in loader.epoch(0):
        cams = forward(batch["image"], batch["word_ids"])
        if max_size:
            sizes = [t.shape for t in batch["target"]]
            tables = kernels.eval_tables(cams.shape[2], cams.shape[3], sizes, max_size, device)
            if scalars_only:
                tgt, boxes = _padded_targets_boxes(batch, *max_size)
                out = kernels.eval_metrics(cams, tables, to_device(tgt, device), to_device(boxes, device))
            else:
                out = (kernels.eval_metrics(cams, tables, want_norm=True),)
        else:
            out = (cams,)
        fetch = HostFetch(out)
        if pending is not None:
            process(*pending)
            step += 1
            if step % print_freq == 0:
                r = acc.results()
                log(f"eval [{step}] mIoU {r['mIoU']:.3f} oIoU {r['oIoU']:.3f} hit {r['hit']:.3f}")
        pending = (fetch, batch)
    if pending is not None:
        process(*pending)
    if pool is not None:
        pool.shutdown()
    names, writer = _names_of_all_processes(cam_out_names)
    if save_cam and name_save_dir and writer:
        os.makedirs(name_save_dir, exist_ok=True)
        with open(os.path.join(name_save_dir, f"{dataset_name}_train_cam_name.json"), "w") as f:
            json.dump(names, f)
    return acc.merge_across_processes().results()


def _names_of_all_processes(names: list):
    """(every process's names, rank 0 first; whether this process writes
    them): gathered over ``torch.distributed`` when a group is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return names, True
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, names)
    return [n for part in parts for n in part], dist.get_rank() == 0


@torch.no_grad()
def validate_prms(
    model,
    critic,
    loader,
    save_cam: bool = False,
    cam_save_dir: Optional[str] = None,
    name_save_dir: Optional[str] = None,
    dataset_name: str = "refcoco",
    print_freq: int = 50,
    log=print,
    host_threads: int = 0,
    device_resize: bool = True,
) -> dict:
    """PRMS evaluation and the CAM dump that feeds IRNet
    (validate.py:253-387 of the reference): per ref, the best-scoring
    sentence's map is kept, scored with weight ``num_sents``, and with
    ``save_cam`` saved as ``{cam_save_dir}/{idx}_{img_id}.npy`` at the
    original size, its name listed in ``{dataset}_train_names.json``.

    Pipelined like :func:`validate`. With ``device_resize`` K4 upsamples
    and max-normalises the selected map on the card and reduces it to [B]
    scalars; the normalised map is fetched only for ``save_cam``. With
    ``device_resize=False`` the host does it. The names json lists every
    process's names and is written by rank 0 alone (the JAX package writes
    it from every process with its own names only)."""
    model.eval()
    critic.eval()
    device = next(model.parameters()).device
    forward = make_prms_forward(model, critic)
    acc = SegEvalAccumulator(with_boxes=False)
    cam_out_names = []
    if save_cam and cam_save_dir:
        os.makedirs(cam_save_dir, exist_ok=True)
    max_size = _max_orig_size(loader) if device_resize else None
    pool = None if max_size else _host_pool(host_threads)
    step = 0

    def dump(batch, b, cam_norm):
        if save_cam and cam_save_dir:
            name = f"{int(batch['index'][b])}_{int(batch['img_id'][b])}"
            np.save(os.path.join(cam_save_dir, f"{name}.npy"), cam_norm)
            cam_out_names.append(name)

    def process(fetch, batch):
        out = fetch.numpy()
        # n == 0 rows are the padding of a short final batch
        jobs = [b for b in range(len(batch["target"])) if int(batch["num_sents"][b]) > 0]
        if max_size:
            I, U, hit, hitm = out[:4]
            for b in jobs:
                acc.add_stats(float(I[b]), float(U[b]), float(hit[b]), float(hitm[b]),
                              weight=int(batch["num_sents"][b]))
                if save_cam:
                    oh, ow = batch["target"][b].shape
                    dump(batch, b, out[4][b, :oh, :ow])
            return
        best, cams = out

        def one(b):
            oh, ow = batch["target"][b].shape
            cam = resize_to_original_np(cams[b, int(best[b])], oh, ow)
            cam_norm, pred = normalize_threshold(cam)
            return b, pred, cam_norm.astype(np.float32)

        for b, pred, cam_norm in _map_jobs(pool, one, jobs):
            acc.add(batch["target"][b], pred, cam_norm, batch["bbox"][b],
                    weight=int(batch["num_sents"][b]))
            dump(batch, b, cam_norm)

    pending = None
    for batch in loader.epoch(0):
        valid = np.arange(batch["word_ids"].shape[1])[None] < batch["num_sents"][:, None]
        best, cams, _ = forward(batch["image"], batch["word_ids"], valid)
        if max_size:
            B, S, H, W = cams.shape
            sel = cams.gather(1, best[:, None, None, None].expand(B, 1, H, W))
            tables = kernels.eval_tables(H, W, [t.shape for t in batch["target"]], max_size,
                                         device)
            tgt, boxes = _padded_targets_boxes(batch, *max_size)
            stats = kernels.eval_metrics(sel, tables, to_device(tgt, device),
                                         to_device(boxes, device))
            out = [s[:, 0] for s in stats]
            if save_cam:
                out.append(kernels.eval_metrics(sel, tables, want_norm=True)[:, 0])
        else:
            out = [best, cams]
        fetch = HostFetch(out)
        if pending is not None:
            process(*pending)
            step += 1
            if step % print_freq == 0:
                r = acc.results()
                log(f"prms [{step}] mIoU {r['mIoU']:.3f} oIoU {r['oIoU']:.3f} hit {r['hit']:.3f}")
        pending = (fetch, batch)
    if pending is not None:
        process(*pending)
    if pool is not None:
        pool.shutdown()
    names, writer = _names_of_all_processes(cam_out_names)
    if save_cam and name_save_dir and writer:
        os.makedirs(name_save_dir, exist_ok=True)
        with open(os.path.join(name_save_dir, f"{dataset_name}_train_names.json"), "w") as f:
            json.dump(names, f)
    return acc.merge_across_processes().results()
