"""Evaluation dispatch by dataset type (counterpart of
`mqdet_tpu/engine/eval_dispatch.py`; reference data/datasets/evaluation/
__init__.py:10-36):
  COCO-format detection  -> COCO-style bbox AP (`engine/evaluator.py`)
  LVIS                   -> the fixed-AP federated protocol
  PascalVOC              -> VOC per-class AP (`engine/flickr_eval.py` voc_*)
  Flickr / grounding     -> phrase-grounding Recall@k (`FlickrEvaluator`)

`run_evaluation` is the entry point of `tools/eval.py`; it picks the
protocol from the dataset's type. Everything runs on the model's device.
The grounding loop builds the split functions per image bucket, as
`run_inference` does (the JAX loop builds them once, for the first bucket).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from mqdet_torch.engine.evaluator import DetectionEvaluator
from mqdet_torch.engine.flickr_eval import FlickrEvaluator, voc_detection_ap


class VOCEvaluator:
    """run_inference-compatible adapter over voc_detection_ap
    (reference: data/datasets/evaluation/voc/voc_eval.py do_voc_evaluation)."""

    def __init__(self, iou_thresh: float = 0.5, use_07_metric: bool = False):
        self.iou_thresh = iou_thresh
        self.use_07_metric = use_07_metric
        self.num_classes = 0
        self.preds: Dict = {}
        self.gts: Dict = {}

    def register_categories(self, cat_ids):
        self.num_classes = max(cat_ids)

    def add_image(self, img_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, neg_category_ids=()):
        self.preds[img_id] = {
            "boxes": np.asarray(det_boxes, np.float32).reshape(-1, 4),
            "scores": np.asarray(det_scores, np.float32).reshape(-1),
            "labels": np.asarray(det_labels, np.int64).reshape(-1),
        }
        self.gts[img_id] = {
            "boxes": np.asarray(gt_boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(gt_labels, np.int64).reshape(-1),
        }

    def summarize(self) -> Dict[str, float]:
        res = voc_detection_ap(self.preds, self.gts, self.num_classes, iou_thresh=self.iou_thresh,
                               use_07_metric=self.use_07_metric)
        if "mAP" in res:
            res["AP"] = res["mAP"]
        return res


def dataset_eval_style(cfg, dataset, dataset_name: str, force_lvis: bool = False) -> str:
    """'grounding' | 'voc' | 'lvis_fixed' | 'coco'."""
    from mqdet_torch.data.datasets_extra import GroundingCaptionDataset, PascalVOCDataset

    if isinstance(dataset, GroundingCaptionDataset):
        return "grounding"
    if isinstance(dataset, PascalVOCDataset):
        return "voc"
    if force_lvis or "lvis" in dataset_name:
        return "lvis_fixed"
    return "coco"


def build_evaluator(cfg, style: str):
    if style == "voc":
        return VOCEvaluator(use_07_metric=cfg.TEST.VOC_USE_07_METRIC)
    return DetectionEvaluator(style=style, max_dets=cfg.MODEL.ATSS.DETECTIONS_PER_IMG)


def run_evaluation(cfg, model, dataset, tokenizer, selector=None, max_images: Optional[int] = None,
                   dataset_name: str = "", force_lvis: bool = False, verbose: bool = True) -> Dict[str, float]:
    """The dispatching twin of inference() + evaluate() (reference
    engine/inference.py:528-590 -> data/datasets/evaluation/__init__.py)."""
    from mqdet_torch.engine.inference import run_inference

    style = dataset_eval_style(cfg, dataset, dataset_name, force_lvis)
    if style == "grounding":
        return run_grounding_inference(cfg, model, dataset, tokenizer, max_images=max_images, verbose=verbose)
    return run_inference(cfg, model, dataset, tokenizer, selector, evaluator=build_evaluator(cfg, style),
                         max_images=max_images, verbose=verbose)


def run_grounding_inference(cfg, model, dataset, tokenizer, max_images: Optional[int] = None,
                            verbose: bool = True) -> Dict[str, float]:
    """Phrase-grounding Recall@k over a GroundingCaptionDataset, on the
    model's device.

    Reference counterpart: FlickrEvaluator consumption in inference()
    (data/datasets/evaluation/flickr/flickr_eval.py): each image's caption is
    the prompt, each tokens_positive_eval span group is a phrase slot, and
    recall@k asks whether any top-k box of the phrase's slot reaches IoU >=
    0.5 with the merged GT boxes of that phrase."""
    from mqdet_torch.data.grounding import create_positive_map
    from mqdet_torch.data.transforms import EvalTransform
    from mqdet_torch.engine.predict import make_split_predict_fns

    device = next(model.parameters()).device
    t_len = cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
    n_slots = cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT
    transform = EvalTransform(cfg)
    fns = {}

    dummy_q = torch.zeros((1, 1, cfg.MODEL.BACKBONE.OUT_CHANNELS), dtype=torch.float32, device=device)
    dummy_qm = torch.zeros((1, 1, t_len), dtype=torch.float32, device=device)

    evaluator = FlickrEvaluator()
    ids = dataset.ids[:max_images] if max_images else dataset.ids
    t0 = time.time()
    for count, img_id in enumerate(ids):
        caption = dataset.caption(img_id)
        spans = dataset.tokens_positive_eval(img_id)
        boxes_gt, ann_spans = dataset.annotations(img_id)
        if spans is None:
            # phrase slots from the distinct per-box span groups
            spans = []
            for s in ann_spans:
                if s and s not in spans:
                    spans.append(s)
        spans = [list(map(tuple, s)) for s in spans][:n_slots]
        if not spans:
            continue

        tokenized = tokenizer(caption, max_length=t_len, padding="max_length", truncation=True,
                              return_tensors="np")
        phrase_map = create_positive_map(tokenized, spans, t_len)  # (P, T)
        agg = np.zeros((1, n_slots, t_len), np.float32)
        agg[0, : len(spans)] = phrase_map

        image, (oh, ow), (sy, sx) = transform(dataset.load_image(img_id), device)
        bucket = tuple(image.shape[-2:])
        if bucket not in fns:
            fns[bucket] = make_split_predict_fns(model, bucket, cfg)
        encode_fn, head_fn = fns[bucket]
        dets = head_fn(
            encode_fn(image),
            torch.from_numpy(tokenized["input_ids"].astype(np.int32)).to(device),
            torch.from_numpy(tokenized["attention_mask"].astype(np.int32)).to(device),
            dummy_q, dummy_qm, torch.from_numpy(agg).to(device),
            torch.tensor([[oh, ow]], dtype=torch.float32, device=device),
        )
        boxes = dets.boxes[0].float().cpu().numpy() * np.array([sx, sy, sx, sy], np.float32)
        scores = dets.scores[0].float().cpu().numpy()
        labels = dets.labels[0].cpu().numpy()
        valid = dets.valid[0].cpu().numpy()

        pred_per_phrase, gt_per_phrase = [], []
        for p, span in enumerate(spans):
            sel = valid & (labels == p + 1)
            order = np.argsort(-scores[sel])
            pred_per_phrase.append(boxes[sel][order])
            gmatch = [boxes_gt[i] for i, s in enumerate(ann_spans) if [tuple(x) for x in s] == span]
            gt_per_phrase.append({
                "boxes": np.stack(gmatch) if gmatch else np.zeros((0, 4), np.float32),
                "category": "all",
            })
        evaluator.add(pred_per_phrase, gt_per_phrase)
        if verbose and (count + 1) % 50 == 0:
            print(f"[grounding-eval] {count + 1}/{len(ids)} images, {(count + 1) / (time.time() - t0):.3f} img/s")

    results = evaluator.summarize()
    results["images_per_second"] = len(ids) / max(time.time() - t0, 1e-6)
    if "recall@1" in results:
        results["AP"] = results["recall@1"]  # the headline metric of bbox.csv
    return results
