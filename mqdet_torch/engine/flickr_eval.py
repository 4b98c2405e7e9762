"""Flickr30k entities phrase-grounding Recall@k evaluator.

Capability twin of FlickrEvaluator
(maskrcnn_benchmark/data/datasets/evaluation/flickr/flickr_eval.py): for
each (sentence, phrase) pair, a hit at k means any of the top-k predicted
boxes reaches IoU >= iou_thresh with the phrase's (merged) ground-truth
boxes. Reports recall@k overall and per phrase category, plus "upper bound"
(any prediction hits). Pure numpy, torch-free.

The port's copy of `mqdet_tpu/engine/flickr_eval.py` (framework-free; PIL is
imported only where an image is decoded), pinned to the original by
`tests/test_torch_port_cli.py`.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]).clip(0) * (a[:, 3] - a[:, 1]).clip(0)
    area_b = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (br - tl).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def merge_boxes(boxes: np.ndarray) -> np.ndarray:
    """Union bounding box of all GT boxes for one phrase
    (flickr_eval.py:_merge_boxes semantics for merged-boxes protocol)."""
    if len(boxes) == 1:
        return boxes
    return np.asarray(
        [[boxes[:, 0].min(), boxes[:, 1].min(), boxes[:, 2].max(), boxes[:, 3].max()]],
        dtype=boxes.dtype,
    )


class RecallTracker:
    """Track recall@k split by phrase category (flickr_eval.py:220-260)."""

    def __init__(self, topk: Sequence[int]):
        self.topk = list(topk)
        self.positives = {k: defaultdict(int) for k in self.topk}
        self.total = {k: defaultdict(int) for k in self.topk}

    def add_positive(self, k: int, category: str):
        self.positives[k][category] += 1

    def add_negative(self, k: int, category: str):
        pass

    def add(self, k: int, category: str, hit: bool):
        self.total[k][category] += 1
        if hit:
            self.positives[k][category] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for k in self.topk:
            out[str(k)] = {
                cat: self.positives[k][cat] / max(1, self.total[k][cat])
                for cat in self.total[k]
            }
        return out


class FlickrEvaluator:
    """Accumulate phrase-grounding predictions and compute Recall@k.

    add(pred_boxes, phrase_gt) per sentence:
      pred_boxes: (P, N, 4) — top-N score-sorted boxes per phrase, or a list
                  of (N_i, 4) arrays
      phrase_gt:  list of dicts {"boxes": (M, 4), "category": str}
    """

    def __init__(
        self,
        topk: Sequence[int] = (1, 5, 10),
        iou_thresh: float = 0.5,
        merge_gt_boxes: bool = True,
    ):
        self.iou_thresh = iou_thresh
        self.merge_gt = merge_gt_boxes
        self.topk = list(topk)
        self.tracker = RecallTracker(self.topk + [-1])

    def add(self, pred_boxes, phrase_gt: List[dict]):
        for preds, gt in zip(pred_boxes, phrase_gt):
            gt_boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
            if not len(gt_boxes):
                continue
            if self.merge_gt:
                gt_boxes = merge_boxes(gt_boxes)
            cat = gt.get("category", "all")
            preds = np.asarray(preds, np.float32).reshape(-1, 4)
            if len(preds):
                ious = box_iou(preds, gt_boxes).max(axis=1)
            else:
                ious = np.zeros((0,), np.float32)
            for k in self.topk:
                hit = bool((ious[:k] >= self.iou_thresh).any()) if len(ious) else False
                self.tracker.add(k, cat, hit)
                self.tracker.add(k, "all", hit) if cat != "all" else None
            ub = bool((ious >= self.iou_thresh).any()) if len(ious) else False
            self.tracker.add(-1, cat, ub)
            if cat != "all":
                self.tracker.add(-1, "all", ub)

    def summarize(self) -> Dict[str, float]:
        rep = self.tracker.report()
        out = {}
        for k, cats in rep.items():
            key = "upper_bound" if k == "-1" else f"recall@{k}"
            for cat, v in cats.items():
                out[f"{key}_{cat}" if cat != "all" else key] = round(v, 4)
        return out


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    """PASCAL VOC AP (evaluation/voc/voc_eval.py semantics): 11-point
    interpolation (2007) or area under the monotone PR envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(precision[recall >= t].max()) if (recall >= t).any() else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def voc_detection_ap(
    predictions: Dict[int, Dict[str, np.ndarray]],
    ground_truth: Dict[int, Dict[str, np.ndarray]],
    num_classes: int,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict[str, float]:
    """VOC-style per-class AP@iou over a dataset.

    predictions[image_id] = {boxes (N,4), scores (N,), labels (N,)}
    ground_truth[image_id] = {boxes (M,4), labels (M,), difficult (M,) opt}
    """
    aps = {}
    for cls in range(1, num_classes + 1):
        records = []  # (score, image_id, box)
        npos = 0
        gt_by_img = {}
        for img, gt in ground_truth.items():
            sel = gt["labels"] == cls
            boxes = gt["boxes"][sel]
            diff = gt.get("difficult")
            diff = diff[sel].astype(bool) if diff is not None else np.zeros(len(boxes), bool)
            gt_by_img[img] = {"boxes": boxes, "difficult": diff, "used": np.zeros(len(boxes), bool)}
            npos += int((~diff).sum())
        for img, det in predictions.items():
            sel = det["labels"] == cls
            for b, s in zip(det["boxes"][sel], det["scores"][sel]):
                records.append((float(s), img, b))
        if npos == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for i, (s, img, box) in enumerate(records):
            gt = gt_by_img.get(img)
            if gt is None or not len(gt["boxes"]):
                fp[i] = 1
                continue
            ious = box_iou(box[None], gt["boxes"])[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh and not gt["difficult"][j]:
                if not gt["used"][j]:
                    tp[i] = 1
                    gt["used"][j] = True
                else:
                    fp[i] = 1
            elif ious[j] < iou_thresh:
                fp[i] = 1
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / npos
        prec = tp_c / np.maximum(tp_c + fp_c, 1e-9)
        aps[f"AP_cls{cls}"] = round(voc_ap(rec, prec, use_07_metric), 4)
    if aps:
        aps["mAP"] = round(float(np.mean(list(aps.values()))), 4)
    return aps
