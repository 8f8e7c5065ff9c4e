"""IRNet's label maps: ir labels from CAMs by the CRF, and instance
pseudo-masks from CAMs, edges and displacements.

Port of ``tris_tpu/pseudo/labels.py``:

- :func:`cam_to_ir_label`: the CRF pass's label map (``pseudo/crf.py``, on
  the host);
- :func:`find_centroids_with_refinement` (K9, ``kernels.refine_centroids``);
- :func:`cluster_centroids` and :func:`detect_instance`: connected
  components on the host with scipy.ndimage (copies of the JAX package's);
- :func:`walk_upsample_argmax`: the CAM resized to the stride-4 grid (K6),
  masked per instance, random-walked (K7, K10 and the squarings), upsampled
  x4 (K6), max-normalised and thresholded into an argmax, on the device;
- :func:`detect_from_walk` and :func:`make_instance_masks`.

The file contract is the reference's: ``ins_seg/{name}.npy`` holds a dict
``{'score', 'mask', 'class', 'cam'}``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import ndimage

from tris_tpu_torch import kernels as K
from tris_tpu_torch.pseudo.crf import crf_inference_label_multi
from tris_tpu_torch.pseudo.indexing import propagate_to_edge_bucketed


def cam_to_ir_label(image: np.ndarray, cam: np.ndarray, conf_fg_thres: float = 0.3,
                    conf_bg_thres: float = 0.1) -> np.ndarray:
    """image [H, W, 3] uint8 (raw); cam [H, W] in [0, 1] -> the uint8 ir
    label map: 1 confident foreground, 0 confident background, 255
    uncertain (cam_to_ir_label.py:48-76 of the reference). The two seeds,
    the CAM padded with each threshold and argmaxed, are refined by one
    fused CRF over the image (the native lattice on one thread: the pass's
    processes carry the parallelism)."""
    cams = np.maximum(cam, 0.0)[None]

    def seed_label(thres: float) -> np.ndarray:
        padded = np.concatenate([np.full_like(cams[:1], thres), cams], axis=0)
        return np.argmax(padded, axis=0).astype(np.int32)

    seeds = np.stack([seed_label(conf_fg_thres), seed_label(conf_bg_thres)])
    fg_conf, bg_conf = crf_inference_label_multi(image, seeds, n_labels=2)
    conf = fg_conf.copy().astype(np.uint8)
    conf[fg_conf == 0] = 255
    conf[(bg_conf + fg_conf) == 0] = 0
    return conf


def find_centroids_with_refinement(displacement, iterations: int = 300,
                                   device="cuda") -> np.ndarray:
    """K9 on a displacement field [2, H, W], numpy (on ``device``) or a
    tensor (on its own device): the int32 centroids [2, H, W] as numpy."""
    if not isinstance(displacement, torch.Tensor):
        from tris_tpu_torch.device import resolve_device

        displacement = torch.as_tensor(np.asarray(displacement, np.float32),
                                       device=resolve_device(device))
    return K.refine_centroids(displacement, iterations).cpu().numpy()


def _compress_range(arr: np.ndarray) -> np.ndarray:
    """Relabel values to consecutive 0..K (imutils.compress_range)."""
    _, inv = np.unique(arr, return_inverse=True)
    return inv.reshape(arr.shape)


def _to_one_hot(labels: np.ndarray, maximum_val: int | None = None) -> np.ndarray:
    if maximum_val is None:
        maximum_val = int(labels.max()) + 1
    return (np.arange(maximum_val)[:, None, None] == labels[None]).astype(bool)


def cluster_centroids(centroids: np.ndarray, displacement: np.ndarray,
                      thres: float = 2.5) -> np.ndarray:
    """Group pixels whose refined centroids land in the same weak-displacement
    component (make_ins_seg_labels.py:58-75 of the reference). Returns the
    one-hot [K + 1, H, W]."""
    dp_strength = np.sqrt(displacement[1] ** 2 + displacement[0] ** 2)
    h, w = dp_strength.shape
    dp_label, _ = ndimage.label(dp_strength < thres)  # the cross structure: connectivity 1
    clusters = dp_label.reshape(-1)[centroids[0].reshape(-1) * w + centroids[1].reshape(-1)]
    return _to_one_hot(_compress_range(clusters.reshape(h, w) + 1))


def detect_instance(score_map: np.ndarray, masks: np.ndarray, class_ids: np.ndarray,
                    max_fragment_size: float = 0) -> dict:
    """Split instance maps into connected fragments, score them, drop tiny ones
    (make_ins_seg_labels.py:82-105 of the reference)."""
    pred_score, pred_label, pred_mask = [], [], []
    for ag_score, ag_mask, ag_class in zip(score_map, masks, class_ids):
        if ag_mask.sum() < 1:
            continue
        lab, n = ndimage.label(ag_mask)
        for seg_id in range(1, n + 1):
            seg = lab == seg_id
            if seg.sum() < max_fragment_size:
                pred_score.append(0)
            else:
                pred_score.append(float((ag_score * seg).max()))
            pred_label.append(ag_class)
            pred_mask.append(seg)
    if not pred_mask:
        h, w = masks.shape[1:]
        return {"score": np.zeros((1,)), "mask": np.zeros((1, h, w), bool),
                "class": np.zeros((1,), class_ids.dtype)}
    return {"score": np.stack(pred_score, 0), "mask": np.stack(pred_mask, 0),
            "class": np.stack(pred_label, 0)}


def instance_cams(instance_map: np.ndarray, cam, device) -> torch.Tensor:
    """The original-size CAM resized to the stride-4 grid (K6,
    ``align_corners=True``) and masked by each instance: [K, gh, gw]."""
    gh, gw = instance_map.shape[1:]
    cam_d = torch.as_tensor(np.asarray(cam, np.float32), device=device)
    return K.bilinear_resize(cam_d, (gh, gw), True)[None] * torch.as_tensor(
        instance_map, dtype=torch.float32, device=device)


def upsample_argmax(rw: torch.Tensor, orig_size: Tuple[int, int], ins_seg_bg_thres: float = 0.25):
    """The walk [K, gh, gw] upsampled x4 (K6, ``align_corners=False``),
    cropped to the image, max-normalised, and argmax'd against the
    background threshold: ``(rw_up [K, oh, ow], instance_shape [oh, ow])``."""
    oh, ow = orig_size
    rw_up = K.bilinear_resize(rw, (rw.shape[1] * 4, rw.shape[2] * 4), False)[:, :oh, :ow]
    rw_up = rw_up / rw_up.max()
    bg = torch.full((1, oh, ow), ins_seg_bg_thres, dtype=rw_up.dtype, device=rw_up.device)
    return rw_up, torch.argmax(torch.cat([bg, rw_up], 0), 0)


def walk_upsample_argmax(instance_map: np.ndarray, cam, edge, orig_size: Tuple[int, int],
                         beta: float = 10.0, exp_times: int = 8,
                         ins_seg_bg_thres: float = 0.25, device=None):
    """The device half of the per-instance walk (make_ins_seg_labels.py:138-158
    of the reference): :func:`instance_cams`, the bucketed walk along
    low-edge paths, :func:`upsample_argmax`. Dispatch is asynchronous:
    returns device tensors ``(rw_up [K, oh, ow], instance_shape [oh, ow])``.
    ``edge`` is a tensor or numpy; ``device`` defaults to the edge tensor's."""
    if device is None:
        device = edge.device if isinstance(edge, torch.Tensor) else "cuda"
    edge = torch.as_tensor(edge, dtype=torch.float32, device=device)
    rw = propagate_to_edge_bucketed(instance_cams(instance_map, cam, device), edge, radius=5,
                                    beta=beta, exp_times=exp_times)
    return upsample_argmax(rw, orig_size, ins_seg_bg_thres)


def detect_from_walk(rw_up_np: np.ndarray, instance_shape_np: np.ndarray,
                     orig_size: Tuple[int, int]) -> dict:
    """The host half after the walk: one-hot the argmax'd instance shape,
    split into connected fragments, score, drop fragments under 1 % of the
    image (make_ins_seg_labels.py:149-163). Returns the npy dict
    {'score', 'mask', 'class', 'cam'}."""
    oh, ow = orig_size
    n_maps = rw_up_np.shape[0]
    one_hot = _to_one_hot(instance_shape_np, maximum_val=n_maps + 1)[1:]
    class_ids = np.zeros((n_maps,), np.int64)  # one 'referred' class
    detected = detect_instance(rw_up_np, one_hot, class_ids, max_fragment_size=oh * ow * 0.01)
    detected["cam"] = rw_up_np
    return detected


def make_instance_masks(edge, disp, cam: np.ndarray, orig_size: Tuple[int, int],
                        beta: float = 10.0, exp_times: int = 8,
                        ins_seg_bg_thres: float = 0.25, device="cuda") -> dict:
    """edge [h4, w4], disp [2, h4, w4] (numpy or tensors), cam [oh, ow] at the
    original size -> the ins_seg dict, one stage after the other (the
    pipelined pass, ``pipeline.run_make_ins_seg``, drives the same stages)."""
    if not isinstance(disp, torch.Tensor):
        from tris_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        disp = torch.as_tensor(np.asarray(disp, np.float32), device=dev)
    instance_map = cluster_centroids(K.refine_centroids(disp).cpu().numpy(), disp.cpu().numpy())
    rw_up, shape = walk_upsample_argmax(instance_map, cam, edge, orig_size, beta=beta,
                                        exp_times=exp_times, ins_seg_bg_thres=ins_seg_bg_thres,
                                        device=disp.device)
    return detect_from_walk(rw_up.cpu().numpy(), shape.cpu().numpy(), orig_size)
