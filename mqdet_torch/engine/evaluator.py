"""Detection mAP evaluation in pure numpy (no pycocotools, no lvis): the
port's copy of `mqdet_tpu/engine/evaluator.py` (pinned to the original by
`tests/test_torch_port_eval.py`). The JAX module calls a native C++ matcher
when it is built; this copy keeps the numpy matcher, which computes the same
thing, so it imports nothing of the JAX package.

Reference evaluation stack (maskrcnn_benchmark/data/datasets/evaluation/
coco/coco_eval.py and the vendored LVIS evaluator lvis/lvis_eval.py:155-766
incl. LvisEvaluatorFixedAP :766): greedy IoU matching per (image,
category), 101-point interpolated AP over IoU 0.50:0.95, COCO per-image
maxDets, and the LVIS "fixed AP" protocol: federated evaluation (a
category only scores on images where it is exhaustively annotated or
explicitly negative) with a global per-category cap of 10k detections
instead of a per-image cap.

`state_dict` and `merge_state` are the JAX module's cross-process merge
(`engine/inference.py::run_inference` gathers every rank's state).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, COCO convention (no +1)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / union, 0.0)


def _match(det_boxes, gt_boxes, gt_ignore, thresholds):
    """Greedy matching per COCOeval.evaluateImg: dets sorted by score.

    Returns (tp (T, D) bool, det_ignore (T, D) bool)."""
    t = len(thresholds)
    d = len(det_boxes)
    g = len(gt_boxes)
    tp = np.zeros((t, d), bool)
    dt_ig = np.zeros((t, d), bool)
    if g == 0:
        return tp, dt_ig
    ious = box_iou_xyxy(det_boxes, gt_boxes)
    for ti, thr in enumerate(thresholds):
        taken = np.zeros(g, bool)
        for di in range(d):
            best, best_iou = -1, thr - 1e-10
            for gi in range(g):
                # any matched gt — real OR ignored — is consumed
                # (lvis_eval.py:366 `if gt_m[...] > 0: continue`)
                if taken[gi]:
                    continue
                if gt_ignore[gi] and best > -1 and not gt_ignore[best]:
                    break  # gts sorted: real first, ignored last
                if ious[di, gi] > best_iou:
                    best, best_iou = gi, ious[di, gi]
            if best > -1:
                taken[best] = True
                if gt_ignore[best]:
                    dt_ig[ti, di] = True
                else:
                    tp[ti, di] = True
    return tp, dt_ig


def average_precision(scores, tp, dt_ig, num_gt) -> np.ndarray:
    """(T,) AP from pooled detections of one category."""
    t = tp.shape[0]
    ap = np.zeros(t)
    if num_gt == 0:
        return np.full(t, np.nan)
    order = np.argsort(-scores, kind="mergesort")
    for ti in range(t):
        keep = ~dt_ig[ti, order]
        tps = tp[ti, order][keep]
        fps = ~tps
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(fps)
        recall = tp_cum / num_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
        # precision envelope
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        if len(precision) == 0:
            ap[ti] = 0.0
            continue
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        prec_at = np.where(
            idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0
        )
        ap[ti] = prec_at.mean()
    return ap


class DetectionEvaluator:
    """Accumulates per-image detections; computes COCO or LVIS-fixed AP.

    style='coco': per-image maxDets cap (100), all categories on all images.
    style='lvis_fixed': federated image sets + global 10k/category cap.
    """

    def __init__(
        self,
        style: str = "coco",
        max_dets: int = 100,
        per_cat_cap: int = 10000,
        category_frequency: Optional[Dict[int, str]] = None,
    ):
        assert style in ("coco", "lvis_fixed")
        self.style = style
        self.max_dets = max_dets
        self.per_cat_cap = per_cat_cap
        self.category_frequency = category_frequency or {}
        # per category: list of (score, image_id, box)
        self._dets = defaultdict(list)
        # per (image, category): gt boxes
        self._gts = defaultdict(list)
        self._gt_ignore = defaultdict(list)
        self._images = set()
        self._cat_pos_images = defaultdict(set)
        self._cat_neg_images = defaultdict(set)
        # (image, category) pairs where the category was NOT exhaustively
        # annotated: unmatched detections there are ignored, not FPs
        # (lvis_eval.py:389-398)
        self._cat_nel_images = defaultdict(set)
        self._categories = set()

    def add_image(
        self,
        image_id,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_labels: np.ndarray,
        neg_category_ids: Sequence[int] = (),
        not_exhaustive_category_ids: Sequence[int] = (),
        gt_ignore: Optional[np.ndarray] = None,
    ):
        self._images.add(image_id)
        if gt_ignore is None:
            gt_ignore = np.zeros(len(gt_boxes), bool)
        for box, lab, ig in zip(gt_boxes, gt_labels, gt_ignore):
            self._gts[(image_id, int(lab))].append(box)
            self._gt_ignore[(image_id, int(lab))].append(bool(ig))
            self._cat_pos_images[int(lab)].add(image_id)
            self._categories.add(int(lab))
        for c in neg_category_ids:
            self._cat_neg_images[int(c)].add(image_id)
            self._categories.add(int(c))
        for c in not_exhaustive_category_ids:
            self._cat_nel_images[int(c)].add(image_id)

        if self.style == "coco" and len(det_scores) > self.max_dets:
            order = np.argsort(-det_scores, kind="mergesort")[: self.max_dets]
            det_boxes, det_scores, det_labels = (
                det_boxes[order], det_scores[order], det_labels[order]
            )
        for box, score, lab in zip(det_boxes, det_scores, det_labels):
            self._dets[int(lab)].append((float(score), image_id, box))

    def register_categories(self, cat_ids: Sequence[int]):
        for c in cat_ids:
            self._categories.add(int(c))

    def state_dict(self) -> dict:
        """Picklable snapshot of the accumulated records, for the cross-host
        eval merge (twin of the reference's pickle all_gather of per-rank
        prediction dicts, engine/inference.py:293-312 + the LVIS evaluator's
        synchronize_between_processes, lvis/lvis_eval.py)."""
        return {
            "dets": dict(self._dets),
            "gts": dict(self._gts),
            "gt_ignore": dict(self._gt_ignore),
            "images": self._images,
            "cat_pos_images": dict(self._cat_pos_images),
            "cat_neg_images": dict(self._cat_neg_images),
            "cat_nel_images": dict(self._cat_nel_images),
            "categories": self._categories,
        }

    def merge_state(self, state: dict) -> None:
        """Merge another rank's snapshot. Images already accumulated locally
        are skipped whole (per-image records must not double-count when the
        host shards overlap, e.g. padded last batches)."""
        new_images = state["images"] - self._images
        self._images |= new_images
        self._categories |= state["categories"]
        for key, boxes in state["gts"].items():
            if key[0] in new_images:
                self._gts[key].extend(boxes)
                self._gt_ignore[key].extend(state["gt_ignore"][key])
        for cat, recs in state["dets"].items():
            self._dets[cat].extend(
                r for r in recs if r[1] in new_images
            )
        for name in ("cat_pos_images", "cat_neg_images", "cat_nel_images"):
            mine = getattr(self, f"_{name}")
            for cat, imgs in state[name].items():
                mine[cat] |= imgs & new_images

    def summarize(self) -> Dict[str, float]:
        per_cat_ap: Dict[int, np.ndarray] = {}
        per_cat_ap50: Dict[int, float] = {}
        for cat in sorted(self._categories):
            dets = self._dets.get(cat, [])
            dets.sort(key=lambda x: -x[0])
            if self.style == "lvis_fixed":
                dets = dets[: self.per_cat_cap]
                allowed = self._cat_pos_images[cat] | self._cat_neg_images[cat]
                dets = [d for d in dets if d[1] in allowed]
                eval_images = allowed
            else:
                eval_images = self._images

            num_gt = 0
            scores_all, tp_all, ig_all = [], [], []
            by_image = defaultdict(list)
            for score, img, box in dets:
                by_image[img].append((score, box))
            for img in eval_images:
                gts = np.asarray(
                    self._gts.get((img, cat), np.zeros((0, 4))), np.float32
                ).reshape(-1, 4)
                gt_ig = np.asarray(
                    self._gt_ignore.get((img, cat), []), bool
                ).reshape(-1)
                # sort: real gts first, ignored last (matching expects this)
                if gt_ig.any():
                    order = np.argsort(gt_ig, kind="mergesort")
                    gts, gt_ig = gts[order], gt_ig[order]
                num_gt += int((~gt_ig).sum())
                img_dets = by_image.get(img, [])
                if not img_dets:
                    continue
                img_dets.sort(key=lambda x: -x[0])
                dboxes = np.asarray([b for _, b in img_dets], np.float32).reshape(-1, 4)
                dscores = np.asarray([s for s, _ in img_dets], np.float32)
                tp, dt_ig = _match(dboxes, gts, gt_ig, IOU_THRESHOLDS)
                if img in self._cat_nel_images.get(cat, ()):
                    # not exhaustively annotated: unmatched dets are ignored
                    dt_ig = dt_ig | ~tp
                scores_all.append(dscores)
                tp_all.append(tp)
                ig_all.append(dt_ig)

            if scores_all:
                scores_cat = np.concatenate(scores_all)
                tp_cat = np.concatenate(tp_all, axis=1)
                ig_cat = np.concatenate(ig_all, axis=1)
            else:
                scores_cat = np.zeros((0,))
                tp_cat = np.zeros((len(IOU_THRESHOLDS), 0), bool)
                ig_cat = np.zeros((len(IOU_THRESHOLDS), 0), bool)
            ap = average_precision(scores_cat, tp_cat, ig_cat, num_gt)
            per_cat_ap[cat] = ap
            per_cat_ap50[cat] = ap[0]

        valid = [c for c, ap in per_cat_ap.items() if not np.isnan(ap).all()]
        if not valid:
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        stack = np.stack([per_cat_ap[c] for c in valid])
        out = {
            "AP": float(np.nanmean(stack)),
            "AP50": float(np.nanmean(stack[:, 0])),
            "AP75": float(np.nanmean(stack[:, IOU_THRESHOLDS.tolist().index(0.75)])),
        }
        # LVIS frequency splits (rare/common/frequent)
        if self.category_frequency:
            for key, tag in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                sel = [c for c in valid if self.category_frequency.get(c) == key]
                if sel:
                    out[tag] = float(np.nanmean(np.stack([per_cat_ap[c] for c in sel])))
        out["per_category_AP"] = {c: float(np.nanmean(per_cat_ap[c])) for c in valid}
        return out


def check_expected_results(results: Dict[str, float], expected, sigma_tol: float):
    """TEST.EXPECTED_RESULTS guard (evaluation/coco/coco_eval.py:512):
    each entry (metric, mean, std); asserts |actual - mean| <= tol*std."""
    errors = []
    for metric, mean, std in expected:
        actual = results.get(metric)
        if actual is None:
            errors.append(f"metric {metric} missing")
            continue
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        if not (lo <= actual <= hi):
            errors.append(f"{metric}={actual:.4f} outside [{lo:.4f}, {hi:.4f}]")
    if errors:
        raise AssertionError("; ".join(errors))
