"""Evaluation metrics: mask IoU, point-hit, box generation/IoU/NMS, meters.

Host-side (numpy/cv2/matplotlib) re-implementations of
`reference/utils/util.py:9-47`, `utils/box_eval_utils.py`,
`utils/box_utils.py:50-117`, and `validate.py:106-117`: a copy of the JAX
package's ``tris_tpu/eval/metrics.py`` whose cross-process merge uses
``torch.distributed``. The hot mask metrics run on the card as K4
(``kernels/eval_metrics.py``). cv2 and matplotlib are imported only by the
box metrics that use them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class AverageMeter:
    """Running average: ``sum += val * n; avg = sum / count`` (utils/util.py:30-47)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def compute_mask_iu(target: np.ndarray, pred: np.ndarray) -> Tuple[int, int]:
    """(intersection, union) of binary masks (utils/util.py:9-15)."""
    t = target.astype(bool)
    p = pred.astype(bool)
    return int(np.logical_and(t, p).sum()), int(np.logical_or(t, p).sum())


def is_correct_hit(bboxes: np.ndarray, heatmap: np.ndarray, gt_mask: np.ndarray):
    """CAM-peak hit test (validate.py:106-117).

    Returns (hit_in_any_box, (row, col) of peak, hit_in_mask).
    """
    max_loc = np.unravel_index(int(np.argmax(heatmap)), heatmap.shape)
    hitm = 1 if gt_mask[max_loc[0], max_loc[1]] else 0
    boxes = np.atleast_2d(np.asarray(bboxes))
    for bbox in boxes:
        if bbox[0] <= max_loc[1] <= bbox[2] and bbox[1] <= max_loc[0] <= bbox[3]:
            return 1, max_loc, hitm
    return 0, max_loc, hitm


def box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of x1y1x2y2 boxes [N,4] x [M,4] -> [N,M] (box_utils.py:50-67)."""
    boxes1 = np.atleast_2d(np.asarray(boxes1, np.float64))
    boxes2 = np.atleast_2d(np.asarray(boxes2, np.float64))
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS on xywh->x1y1x2y2? No: expects x1y1x2y2 boxes. Returns kept indices."""
    order = np.argsort(-np.asarray(scores))
    boxes = np.asarray(boxes, np.float64)
    keep: List[int] = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        ious = box_iou(boxes[i : i + 1], boxes)[0]
        suppressed |= ious > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def _cam_to_gray(cam: np.ndarray) -> np.ndarray:
    """CAM -> cubehelix colormap -> uint8 gray (box_eval_utils.py:26-41)."""
    import cv2
    import matplotlib.pyplot as plt

    intensity = cam.astype(np.float64)
    intensity = intensity - intensity.min()
    maxv = intensity.max()
    if maxv > 0:
        intensity = intensity / maxv
    rgb = (plt.get_cmap("cubehelix")(intensity)[..., :3] * 255.0).astype(np.uint8)
    return cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)


def generate_bbox(cam: np.ndarray, threshold: float = 0.5, nms_threshold: float = 0.05,
                  max_drop_th: float = 0.5) -> List[List[float]]:
    """CAM -> candidate boxes [(x1, y1, x2, y2, conf), ...] (box_eval_utils.py:39-73)."""
    import cv2

    gray = _cam_to_gray(cam)
    thr_val = int(threshold * gray.max())
    _, thr_gray = cv2.threshold(gray, thr_val, 255, cv2.THRESH_TOZERO)
    contours, _ = cv2.findContours(thr_gray, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    if len(contours) == 0:
        return [[0, 0, 1, 1, 0], [0, 0, 1, 1, 0]]
    proposals = [cv2.boundingRect(c) for c in contours]
    confs = np.array([thr_gray[y : y + h, x : x + w].mean() / 255.0 for (x, y, w, h) in proposals])
    boxes_xywh = np.array(proposals, np.float64)
    # NOTE(parity): the reference feeds xywh boxes straight into torchvision
    # nms, which treats them as x1y1x2y2 (box_eval_utils.py:61-63); keep that.
    inx = nms(boxes_xywh, confs, nms_threshold)
    out = []
    max_conf = confs.max()
    for i in inx:
        x, y, w, h = boxes_xywh[i]
        c = confs[i]
        if c > max_drop_th * max_conf:
            out.append([x, y, x + w, y + h, float(c)])
    if not out:
        out = [[0, 0, 1, 1, 0], [0, 0, 1, 1, 0]]
    return out


def eval_box_iou(pred_box: Sequence[float], gt_box: Sequence[float]) -> float:
    """Diag-summed IoU of one pred vs one gt (box_eval_utils.py:10-14)."""
    return float(box_iou([pred_box[:4]], [list(gt_box)])[0, 0])


def eval_box_acc(pred_boxes: Sequence[Sequence[float]], gt_box: Sequence[float]) -> int:
    """1 if any generated box overlaps gt with IoU > 0.5 (box_eval_utils.py:16-24)."""
    for bp in pred_boxes:
        if float(box_iou([list(bp[:4])], [list(gt_box)])[0, 0]) > 0.5:
            return 1
    return 0


# The reference accumulates Prec@X on ReferIt (validate_referit.py:133-136)
SEG_IOU_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


class SegEvalAccumulator:
    """Accumulates mIoU / oIoU / Hit / HitM / box metrics / Prec@X."""

    def __init__(self, with_boxes: bool = True):
        self.miou = AverageMeter()
        self.I = 0.0
        self.U = 0.0
        self.hit = 0.0
        self.hitm = 0.0
        self.n = 0
        self.box_miou = AverageMeter()
        self.box_acc = AverageMeter()
        self.with_boxes = with_boxes
        self.prec_hits = {t: 0.0 for t in SEG_IOU_THRESHOLDS}

    def add_stats(self, I: float, U: float, hit: float, hitm: float, weight: int = 1):
        """Update all non-box counters from precomputed (I, U, hit, hitm) —
        the entry point for device-side metric reduction, where masks never
        reach the host. Matches :meth:`add`'s arithmetic exactly."""
        iou = I / max(U, 1e-12)
        self.I += I * weight * weight
        self.U += U * weight * weight
        self.miou.update(iou, weight)
        self.n += weight
        self.hit += hit * weight
        self.hitm += hitm * weight
        for t in SEG_IOU_THRESHOLDS:
            self.prec_hits[t] += (iou >= t) * weight

    def compute(self, target: np.ndarray, pred: np.ndarray, cam: np.ndarray,
                gt_box: np.ndarray) -> tuple:
        """Pure per-sample metric computation — no accumulator mutation, so it
        is safe to fan out over threads (the cv2 contour/NMS box pass is the
        heavy part). Returns an opaque stats tuple for :meth:`add_computed`."""
        I, U = compute_mask_iu(target, pred)
        hit, max_loc, hitm = is_correct_hit(gt_box, cam, target)
        box_iou_v = box_acc_v = None
        if self.with_boxes:
            boxes = generate_bbox(pred.astype(np.float64))
            bbox_hit = boxes[0]
            for bb in boxes:
                if bb[0] <= max_loc[1] <= bb[2] and bb[1] <= max_loc[0] <= bb[3]:
                    bbox_hit = bb
            box_iou_v = eval_box_iou(bbox_hit, gt_box)
            box_acc_v = eval_box_acc(boxes, gt_box)
        return (I, U, hit, hitm, box_iou_v, box_acc_v)

    def add_computed(self, stats: tuple, weight: int = 1):
        """Accumulate a stats tuple from :meth:`compute` (main thread only)."""
        I, U, hit, hitm, box_iou_v, box_acc_v = stats
        self.add_stats(I, U, hit, hitm, weight)
        if self.with_boxes:
            self.box_miou.update(box_iou_v, weight)
            self.box_acc.update(box_acc_v, weight)

    def add(self, target: np.ndarray, pred: np.ndarray, cam: np.ndarray,
            gt_box: np.ndarray, weight: int = 1):
        """weight=1 for the per-sentence path; weight=S for PRMS, reproducing
        the reference's meter updates exactly (validate.py:204-208,343-352 —
        including the S^2 weighting of the oIoU I/U sums in PRMS)."""
        self.add_computed(self.compute(target, pred, cam, gt_box), weight)

    def merge_across_processes(self):
        """Sum raw counters over all processes when ``torch.distributed`` is
        initialised (the reference's dist.all_reduce metric aggregation,
        utils/util.py:17-27); the identity otherwise."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return self
        vec = torch.tensor(
            [self.miou.sum, self.miou.count, self.I, self.U, self.hit, self.hitm,
             self.n, self.box_miou.sum, self.box_miou.count, self.box_acc.sum,
             self.box_acc.count]
            + [self.prec_hits[t] for t in SEG_IOU_THRESHOLDS],
            dtype=torch.float64,
        )
        if dist.get_backend() == "nccl":
            vec = vec.cuda()
        dist.all_reduce(vec)
        total = vec.cpu().numpy()
        (self.miou.sum, self.miou.count, self.I, self.U, self.hit, self.hitm,
         self.n, self.box_miou.sum, self.box_miou.count, self.box_acc.sum,
         self.box_acc.count) = total[:11]
        self.miou.count = int(self.miou.count)
        self.n = int(self.n)
        for i, t in enumerate(SEG_IOU_THRESHOLDS):
            self.prec_hits[t] = total[11 + i]
        return self

    def results(self) -> dict:
        res = {
            "mIoU": 100.0 * self.miou.avg,
            "oIoU": 100.0 * self.I / max(self.U, 1e-12),
            "hit": 100.0 * self.hit / max(self.n, 1),
            "hitm": 100.0 * self.hitm / max(self.n, 1),
        }
        for t in SEG_IOU_THRESHOLDS:
            res[f"prec@{t}"] = 100.0 * self.prec_hits[t] / max(self.n, 1)
        if self.with_boxes:
            res["box_mIoU"] = 100.0 * self.box_miou.avg
            res["box_acc"] = 100.0 * self.box_acc.avg
        return res
