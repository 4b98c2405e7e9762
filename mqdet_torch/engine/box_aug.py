"""Multi-scale / horizontal-flip test-time augmentation (the port's copy of
`mqdet_tpu/engine/box_aug.py`, which imports no framework; reference
maskrcnn_benchmark/data/datasets/evaluation/box_aug.py:12-214).

Run the detector at TEST.SCALES (and, under TEST.FLIP, on the mirrored
image), map every detection set back to the original image, optionally keep
only boxes whose sqrt-area lies in a per-scale range (TEST.RANGES),
concatenate, and merge per class with NMS, Gaussian soft-NMS or box voting
(TEST.SPECIAL_NMS, TEST.TH), capped at a detection count. Host-side numpy:
the merge is cheap beside the forwards and keeps the reference's per-class
semantics. `tests/test_torch_port_tta.py` holds every function equal to the
JAX package's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]).clip(0) * (a[:, 3] - a[:, 1]).clip(0)
    area_b = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (br - tl).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    order = np.argsort(-scores)
    keep = []
    supp = np.zeros(len(boxes), bool)
    iou = _iou_matrix(boxes, boxes)
    for i in order:
        if supp[i]:
            continue
        keep.append(i)
        supp |= iou[i] > thresh
    return np.asarray(keep, np.int64)


def soft_nms_numpy(
    boxes: np.ndarray, scores: np.ndarray, thresh: float, sigma: float = 0.5,
    score_thresh: float = 1e-3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian soft-NMS (csrc/cpu/soft_nms.cpp semantics)."""
    boxes = boxes.copy()
    scores = scores.copy()
    idx = np.arange(len(boxes))
    keep, new_scores = [], []
    while len(idx):
        i = int(np.argmax(scores[idx]))
        cur = idx[i]
        keep.append(cur)
        new_scores.append(scores[cur])
        idx = np.delete(idx, i)
        if not len(idx):
            break
        ious = _iou_matrix(boxes[cur : cur + 1], boxes[idx])[0]
        scores[idx] *= np.exp(-(ious ** 2) / sigma)
        idx = idx[scores[idx] > score_thresh]
    return np.asarray(keep, np.int64), np.asarray(new_scores, np.float32)


def bbox_vote(
    boxes: np.ndarray, scores: np.ndarray, thresh: float, soft: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Box voting merge (box_aug.py bbox_vote/soft_bbox_vote): clusters by
    IoU > thresh around the current best box and replaces it with the
    score-weighted average of the cluster."""
    order = np.argsort(-scores)
    boxes = boxes[order]
    scores = scores[order]
    out_boxes, out_scores = [], []
    while len(boxes):
        ious = _iou_matrix(boxes[:1], boxes)[0]
        cluster = ious > thresh
        w = scores[cluster]
        merged = (boxes[cluster] * w[:, None]).sum(0) / w.sum()
        if soft:
            sc = float(w.sum() / max(1, cluster.sum()) * (1 + w.max()) / 2)
            sc = min(sc, float(w.max()))
        else:
            sc = float(scores[0])
        out_boxes.append(merged)
        out_scores.append(sc)
        boxes = boxes[~cluster]
        scores = scores[~cluster]
    return (
        np.asarray(out_boxes, np.float32).reshape(-1, 4),
        np.asarray(out_scores, np.float32),
    )


def merge_multi_scale(
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    nms_type: str = "nms",
    thresh: float = 0.6,
    max_detections: int = 100,
    select_classes: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Per-class merge of concatenated multi-transform detections
    (box_aug.py merge_result_from_multi_scales:166-214)."""
    out_b, out_s, out_l = [], [], []
    classes = (
        list(select_classes) if select_classes else sorted(set(labels.tolist()))
    )
    for j in classes:
        sel = labels == j
        if not sel.any():
            continue
        bj, sj = boxes[sel], scores[sel]
        if nms_type == "soft-nms":
            keep, sj2 = soft_nms_numpy(bj, sj, thresh)
            bj, sj = bj[keep], sj2
        elif nms_type in ("vote", "soft-vote"):
            bj, sj = bbox_vote(bj, sj, thresh, soft=nms_type == "soft-vote")
        else:
            keep = nms_numpy(bj, sj, thresh)
            bj, sj = bj[keep], sj[keep]
        out_b.append(bj)
        out_s.append(sj)
        out_l.append(np.full(len(bj), j, np.int64))
    if not out_b:
        return {
            "boxes": np.zeros((0, 4), np.float32),
            "scores": np.zeros((0,), np.float32),
            "labels": np.zeros((0,), np.int64),
        }
    b = np.concatenate(out_b)
    s = np.concatenate(out_s)
    l = np.concatenate(out_l)
    if max_detections > 0 and len(s) > max_detections:
        kth = np.partition(s, len(s) - max_detections)[len(s) - max_detections]
        sel = s >= kth
        b, s, l = b[sel], s[sel], l[sel]
    return {"boxes": b, "scores": s, "labels": l}


def im_detect_bbox_aug(
    predict_at_scale: Callable[[np.ndarray, int, int, bool], Dict[str, np.ndarray]],
    image: np.ndarray,
    scales: Sequence[int],
    max_size: int,
    flip: bool = False,
    ranges: Optional[Sequence[Optional[Tuple[float, float]]]] = None,
    nms_type: str = "nms",
    thresh: float = 0.6,
    max_detections: int = 100,
) -> Dict[str, np.ndarray]:
    """Run `predict_at_scale(image, min_size, max_size, hflip)` for each
    TTA transform and merge. predict_at_scale must return detections in the
    ORIGINAL image frame: {boxes (N,4) xyxy, scores (N,), labels (N,)}.
    Horizontal-flip un-mirroring is the predictor's responsibility (it knows
    the resize geometry)."""
    if ranges is None or len(ranges) != len(scales):
        ranges = [None] * len(scales)
    all_b, all_s, all_l = [], [], []

    def keep_range(det, rng):
        if rng is None:
            return det
        area = np.sqrt(
            (det["boxes"][:, 2] - det["boxes"][:, 0]).clip(0)
            * (det["boxes"][:, 3] - det["boxes"][:, 1]).clip(0)
        )
        lo, hi = rng
        sel = (area >= lo) & (area < hi)
        return {k: v[sel] for k, v in det.items()}

    for scale, rng in zip(scales, ranges):
        det = keep_range(predict_at_scale(image, scale, max_size, False), rng)
        all_b.append(det["boxes"]); all_s.append(det["scores"]); all_l.append(det["labels"])
        if flip:
            det = keep_range(predict_at_scale(image, scale, max_size, True), rng)
            all_b.append(det["boxes"]); all_s.append(det["scores"]); all_l.append(det["labels"])

    return merge_multi_scale(
        np.concatenate(all_b) if all_b else np.zeros((0, 4), np.float32),
        np.concatenate(all_s) if all_s else np.zeros((0,), np.float32),
        np.concatenate(all_l) if all_l else np.zeros((0,), np.int64),
        nms_type=nms_type,
        thresh=thresh,
        max_detections=max_detections,
    )
