"""Grounding / caption / background / VOC dataset readers.

Capability twins of the remaining reference dataset-registry entries
(maskrcnn_benchmark/data/datasets/__init__.py):

- `GroundingCaptionDataset` — ModulatedDataset (modulated_coco.py:~60-160):
  COCO-format json whose image dicts carry a `caption` (and optionally
  `dataset_name`, `tokens_positive_eval`) and whose annotations carry
  `tokens_positive` char spans into that caption.
- `FlickrDataset` / `RefExpDataset` / `GQADataset` / `PhrasecutDetection` —
  thin ModulatedDataset subclasses (flickr.py:7, refexp.py:14, gqa.py:10,
  phrasecut.py:7); they differ only in dataset_name bookkeeping.
- `MixedDataset` — mixed.py:15-124: one annotation file over images from two
  roots, selected per image by img_info["data_source"] ("coco" vs vg).
- `CaptionTSVDataset` — caption.py:14-230: TSV rows of
  `key \t json \t base64img` where json holds caption + bboxes +
  tokens_positive; confidence screening (caption_conf/caption_nms) and
  negative-caption packing with positive-span shifting (pack_caption
  :69-106).
- `BackgroundDataset` — background.py:11-48: images with no boxes, used as
  pure negatives.
- `PascalVOCDataset` — voc.py:17-100: VOC XML annotations.

All readers expose the repo's host-side dataset contract: `.ids`,
`.load_image(id)`, `.annotations(id)`, plus `caption(id)` /
`tokens_positive(id)` for the caption-grounding family, so they feed the
same fixed-shape example builders as the COCO reader. Unlike the reference
(which routes everything through BoxList + torch), these are pure
numpy/PIL/json — device work starts after batching.

The port's copy of `mqdet_tpu/data/datasets_extra.py` (framework-free; PIL is
imported only where an image is decoded), pinned to the original by
`tests/test_torch_port_cli.py`.
"""
from __future__ import annotations

import base64
import io
import json
import os
import random
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mqdet_torch.data.tsv import TSVFile


def _load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class GroundingCaptionDataset:
    """COCO-format grounding data with per-image captions and per-box
    `tokens_positive` spans (ModulatedDataset semantics).

    Boxes whose area is non-positive are dropped; images without any valid
    annotation are dropped (has_valid_annotation, modulated_coco.py).
    """

    dataset_name: Optional[str] = None

    def __init__(
        self,
        ann_file: str,
        img_dir: str,
        filter_empty: bool = True,
    ):
        with open(ann_file) as f:
            data = json.load(f)
        self.img_dir = img_dir
        self.images = {im["id"]: im for im in data["images"]}
        anns: Dict[int, List[dict]] = {}
        for a in data.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            w, h = a["bbox"][2], a["bbox"][3]
            if w <= 0 or h <= 0:
                continue
            anns.setdefault(a["image_id"], []).append(a)
        self.anns_by_image = anns
        ids = sorted(self.images.keys())
        if filter_empty:
            ids = [i for i in ids if anns.get(i)]
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def image_path(self, img_id) -> str:
        return os.path.join(self.img_dir, self.images[img_id]["file_name"])

    def load_image(self, img_id) -> np.ndarray:
        return _load_rgb(self.image_path(img_id))

    def caption(self, img_id) -> str:
        return self.images[img_id]["caption"]

    def image_size(self, img_id) -> Tuple[int, int]:
        im = self.images[img_id]
        return im["height"], im["width"]

    def annotations(self, img_id):
        """Returns (boxes xyxy (N,4) f32, tokens_positive list of span-lists)."""
        anns = self.anns_by_image.get(img_id, [])
        boxes = np.asarray(
            [
                [a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                 a["bbox"][1] + a["bbox"][3]]
                for a in anns
            ],
            np.float32,
        ).reshape(-1, 4)
        spans = [[tuple(s) for s in a.get("tokens_positive", [])] for a in anns]
        return boxes, spans

    def tokens_positive_eval(self, img_id):
        """Eval-time phrase spans (flickr.py via modulated_coco.py
        tokens_positive_eval handling)."""
        return self.images[img_id].get("tokens_positive_eval")


class FlickrDataset(GroundingCaptionDataset):
    """flickr.py:7 — phrase-grounding recall eval uses sentence_id /
    original_img_id carried on the image dicts."""

    dataset_name = "flickr"

    def sentence_meta(self, img_id) -> dict:
        im = self.images[img_id]
        return {
            k: im[k]
            for k in ("sentence_id", "original_img_id", "original_id", "task_id")
            if k in im
        }


class RefExpDataset(GroundingCaptionDataset):
    dataset_name = "refexp"


class GQADataset(GroundingCaptionDataset):
    dataset_name = "gqa"


class PhrasecutDetection(GroundingCaptionDataset):
    dataset_name = "phrasecut"


class MixedDataset(GroundingCaptionDataset):
    """mixed.py:15-124 — single annotation file, two image roots; each image
    dict's data_source picks the root ("coco" -> root_coco, else root_vg)."""

    dataset_name = "mixed"

    def __init__(self, ann_file: str, img_dir_coco: str, img_dir_vg: str,
                 filter_empty: bool = True):
        super().__init__(ann_file, img_dir_coco, filter_empty=filter_empty)
        self.img_dir_coco = img_dir_coco
        self.img_dir_vg = img_dir_vg

    def image_path(self, img_id) -> str:
        im = self.images[img_id]
        root = self.img_dir_coco if im.get("data_source") == "coco" else self.img_dir_vg
        return os.path.join(root, im["file_name"])


def nms_screen(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> List[int]:
    """Plain IoU NMS keep-indices for caption-box screening (caption.py
    further_screen caption_nms path)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]).clip(0) * (boxes[:, 3] - boxes[:, 1]).clip(0)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(boxes[i, 0], boxes[order, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[order, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[order, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[order, 3])
        inter = (xx2 - xx1).clip(0) * (yy2 - yy1).clip(0)
        iou = inter / np.maximum(areas[i] + areas[order] - inter, 1e-9)
        suppressed[order[iou > thresh]] = True
    return keep


def pack_caption(
    positive_caption: str,
    negative_captions: Sequence[str],
    tokens_positive: List[List[Tuple[int, int]]],
    rng: random.Random,
) -> Tuple[str, List[List[Tuple[int, int]]], List[Tuple[int, int]]]:
    """Concatenate the positive caption with shuffled negatives; shift the
    positive spans to the new offsets (caption.py pack_caption:69-106).

    Returns (caption, shifted_tokens_positive, greenlight_span).
    """
    if not negative_captions:
        return positive_caption, tokens_positive, [(0, len(positive_caption))]
    pieces = [positive_caption] + list(negative_captions)
    rng.shuffle(pieces)
    caption = ""
    start = 0
    for p in pieces:
        if p == positive_caption:
            start = len(caption)
        caption += p
        if not p.endswith("."):
            caption += "."
        caption += " "
    shifted = [
        [(b + start, e + start) for (b, e) in spans] for spans in tokens_positive
    ]
    return caption, shifted, [(start, start + len(positive_caption))]


class CaptionTSVDataset:
    """Caption-grounding TSV shards (caption.py CaptionTSV).

    Row: `key \t json \t base64image` with json
    `{"caption": str, "bboxes": [[x1,y1,x2,y2]...], "tokens_positive": ...,
      "scores": [...]}` (format v1/v2 put boxes under different keys; both
    accepted). Supports confidence screening (caption_conf, caption.py
    further_screen), NMS screening (caption_nms) and min-box filtering
    (caption_min_box).
    """

    def __init__(
        self,
        tsv_file: str,
        caption_min_box: int = 1,
        further_screen: bool = False,
        caption_conf: float = 0.5,
        caption_nms: float = -1.0,
        pack_random_caption_number: int = 0,
        seed: int = 0,
    ):
        self.tsv = TSVFile(tsv_file)
        self.caption_min_box = caption_min_box
        self.further_screen = further_screen
        self.caption_conf = caption_conf
        self.caption_nms = caption_nms
        self.pack_random_caption_number = pack_random_caption_number
        self.rng = random.Random(seed)
        self.ids = list(range(len(self.tsv)))

    def __len__(self):
        return len(self.ids)

    def _row(self, idx: int):
        row = self.tsv[idx]
        meta = json.loads(row[1])
        return row, meta

    def load_image(self, idx: int) -> np.ndarray:
        from PIL import Image

        row = self.tsv[idx]
        raw = base64.b64decode(row[-1])
        with Image.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGB"))

    def example(self, idx: int):
        """Returns dict(caption, boxes (N,4) xyxy, tokens_positive,
        greenlight_span) after screening/packing."""
        _, meta = self._row(idx)
        caption = meta["caption"]
        boxes = np.asarray(meta.get("bboxes", meta.get("boxes", [])), np.float32)
        boxes = boxes.reshape(-1, 4)
        spans = [
            [tuple(s) for s in sp] for sp in meta.get("tokens_positive", [])
        ]
        scores = np.asarray(meta.get("scores", [1.0] * len(boxes)), np.float32)

        if self.further_screen and len(boxes):
            keep = scores >= self.caption_conf
            boxes, scores = boxes[keep], scores[keep]
            spans = [s for s, k in zip(spans, keep) if k]
            if self.caption_nms > 0 and len(boxes):
                ki = nms_screen(boxes, scores, self.caption_nms)
                boxes, scores = boxes[ki], scores[ki]
                spans = [spans[i] for i in ki]

        if len(boxes) < self.caption_min_box:
            return None

        greenlight = [(0, len(caption))]
        if self.pack_random_caption_number > 0:
            negs = []
            for _ in range(self.pack_random_caption_number):
                _, m2 = self._row(self.rng.randrange(len(self)))
                negs.append(m2["caption"])
            caption, spans, greenlight = pack_caption(
                caption, negs, spans, self.rng
            )
        return {
            "caption": caption,
            "boxes": boxes,
            "tokens_positive": spans,
            "greenlight_span": greenlight,
        }


class BackgroundDataset:
    """background.py:11-48 — pure-negative images (no annotations); the json
    is `{"images": [{"id", "file_name", ...}]}`."""

    def __init__(self, ann_file: str, img_dir: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.img_dir = img_dir
        self.images = {im["id"]: im for im in data["images"]}
        self.ids = sorted(self.images.keys())
        self.ind_to_class: Dict[int, str] = {}

    def __len__(self):
        return len(self.ids)

    def load_image(self, img_id) -> np.ndarray:
        return _load_rgb(os.path.join(self.img_dir, self.images[img_id]["file_name"]))

    def annotations(self, img_id):
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)


VOC_CLASSES = (
    "__background__ ", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)


class PascalVOCDataset:
    """voc.py:17-100 — VOC XML reader: data_dir/{Annotations,JPEGImages,
    ImageSets/Main/<split>.txt}; boxes are 1-based inclusive in the XML and
    converted to 0-based xyxy like the reference (voc.py:84-92)."""

    def __init__(self, data_dir: str, split: str, use_difficult: bool = False):
        self.data_dir = data_dir
        self.split = split
        self.use_difficult = use_difficult
        with open(
            os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")
        ) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.class_to_ind = {c: i for i, c in enumerate(VOC_CLASSES)}
        self.ind_to_class = {i: c for i, c in enumerate(VOC_CLASSES) if i > 0}
        # run_inference surface (category ids are already contiguous; VOC has
        # no federated negative-category annotations)
        self.cat_id_to_contiguous = {i: i for i in self.ind_to_class}
        self.img_neg_cats: Dict[str, Tuple[int, ...]] = {}

    def __len__(self):
        return len(self.ids)

    def load_image(self, img_id: str) -> np.ndarray:
        return _load_rgb(os.path.join(self.data_dir, "JPEGImages", f"{img_id}.jpg"))

    def annotations(self, img_id: str):
        tree = ET.parse(
            os.path.join(self.data_dir, "Annotations", f"{img_id}.xml")
        )
        boxes, labels = [], []
        for obj in tree.findall("object"):
            difficult = int((obj.find("difficult").text or "0")) == 1 \
                if obj.find("difficult") is not None else False
            if difficult and not self.use_difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            # VOC is 1-based inclusive
            box = [
                float(bb.find("xmin").text) - 1.0,
                float(bb.find("ymin").text) - 1.0,
                float(bb.find("xmax").text) - 1.0,
                float(bb.find("ymax").text) - 1.0,
            ]
            boxes.append(box)
            labels.append(self.class_to_ind.get(name, 0))
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64),
        )


class ImageNetDataset:
    """imagenet.py twin (maskrcnn_benchmark/data/datasets/imagenet.py:14-62).

    Classification-style reader over a meta json with `classes`,
    `class_to_idx` and `samples` ([relative_path, class_idx] pairs);
    `select_class` restricts to a class subset (the reference uses it for
    class-sampled pre-training batches). Pure numpy/PIL.
    """

    def __init__(self, ann_file: str, root: str):
        meta_file = os.path.join(root, ann_file)
        assert os.path.exists(meta_file), f"meta file {meta_file} not found"
        with open(meta_file) as f:
            meta = json.load(f)
        self.root = root
        self.classes = meta["classes"]
        self.class_to_idx = meta["class_to_idx"]
        self.allsamples = meta["samples"]
        self.samples = list(self.allsamples)
        self.ids = list(range(len(self.samples)))
        self.ind_to_class = {
            int(v): k for k, v in self.class_to_idx.items()
        }

    def select_class(self, cls) -> None:
        """Restrict samples to class indices in `cls` (imagenet.py:42-45)."""
        cls = set(cls)
        self.samples = [s for s in self.allsamples if s[-1] in cls]
        self.ids = list(range(len(self.samples)))

    def __len__(self):
        return len(self.samples)

    def load_image(self, idx: int) -> np.ndarray:
        path, _ = self.samples[idx]
        return _load_rgb(os.path.join(self.root, path))

    def target(self, idx: int) -> int:
        return int(self.samples[idx][-1])

    def __getitem__(self, idx: int):
        return self.load_image(idx), self.target(idx), idx


class CocoDetectionTSVDataset:
    """coco_dt.py twin (CocoDetectionTSV, coco_dt.py:19-154).

    OD annotations over TSV shards (`key \t labels_json \t base64img`) with
    the standard dataset surface the grounding loader consumes
    (ids / ind_to_class / annotations / load_image). The reference does the
    OD->grounding caption synthesis inside __getitem__
    (convert_object_detection_to_grounding_optimized_for_od,
    coco_dt.py:103-118); in this package that synthesis lives in
    GroundingTrainLoader, shared by every OD-style reader.

    `categories`: optional {name: contiguous_id} map; if absent, class names
    are scanned from the label column and assigned sorted contiguous ids.
    """

    def __init__(self, tsv_file: str, categories: Optional[Dict] = None):
        from mqdet_torch.data.tsv import ODTSVDataset

        self.od = ODTSVDataset(tsv_file)
        self.ids = list(range(len(self.od)))
        if categories:
            self.class_to_ind = {str(k): int(v) for k, v in categories.items()}
        else:
            names = set()
            for i in self.ids:
                _, ns = self.od.get_annotations(i)
                names.update(n for n in ns if n)
            self.class_to_ind = {n: i + 1 for i, n in enumerate(sorted(names))}
        self.ind_to_class = {v: k for k, v in self.class_to_ind.items()}
        self.cat_id_to_contiguous = {v: v for v in self.ind_to_class}
        self.img_neg_cats: Dict = {}

    def __len__(self):
        return len(self.ids)

    def load_image(self, idx: int) -> np.ndarray:
        img, _, _ = self.od[idx]
        return np.asarray(img)

    def annotations(self, idx: int):
        boxes, names = self.od.get_annotations(idx)
        keep = [(b, self.class_to_ind[n]) for b, n in zip(boxes, names)
                if n in self.class_to_ind]
        if not keep:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        bs = np.asarray([b for b, _ in keep], np.float32)
        ls = np.asarray([l for _, l in keep], np.int64)
        return bs, ls


class PseudoDataDataset(CaptionTSVDataset):
    """pseudo_data.py twin (PseudoData, pseudo_data.py:16-228).

    Pseudo-labeled caption grounding over TSV shards. On top of
    CaptionTSVDataset's screening this adds:
      * caption_format_version="v2": the nested per-entity format
        (bboxes[i][j], scores[i][j], shared tokens_positive[i]) is flattened
        per box (convert_anno_from_yiling_to_ours, pseudo_data.py:204-219)
      * strict-confidence screening (`scores > conf`, pseudo_data.py:133 —
        the caption reader uses >=)
      * inference_caption mode: caption-only rows (no boxes), for teacher
        inference over unlabeled data (pseudo_data.py:108-118)
    """

    def __init__(
        self,
        tsv_file: str,
        caption_min_box: int = 1,
        further_screen: bool = False,
        caption_conf: float = 0.5,
        caption_nms: float = -1.0,
        pack_random_caption_number: int = 0,
        caption_format_version: str = "v1",
        inference_caption: bool = False,
        seed: int = 0,
    ):
        super().__init__(
            tsv_file, caption_min_box=caption_min_box,
            further_screen=further_screen, caption_conf=caption_conf,
            caption_nms=caption_nms,
            pack_random_caption_number=pack_random_caption_number, seed=seed,
        )
        self.caption_format_version = caption_format_version
        self.inference_caption = inference_caption

    @staticmethod
    def _flatten_v2(meta: dict) -> dict:
        """convert_anno_from_yiling_to_ours (pseudo_data.py:204-219)."""
        bboxes, spans, scores = [], [], []
        for i in range(len(meta["bboxes"])):
            for j in range(len(meta["bboxes"][i])):
                bboxes.append(meta["bboxes"][i][j])
                spans.append(meta["tokens_positive"][i])
                scores.append(meta["scores"][i][j])
        out = dict(meta)
        out["bboxes"] = bboxes
        out["tokens_positive"] = spans
        out["scores"] = scores
        return out

    def example(self, idx: int):
        _, meta = self._row(idx)
        if self.inference_caption:
            caption = (
                meta if isinstance(meta, str) else meta.get("caption", "")
            )
            return {
                "caption": caption,
                "boxes": np.zeros((0, 4), np.float32),
                "tokens_positive": [],
                "greenlight_span": [(0, len(caption))],
            }
        if self.caption_format_version == "v2":
            meta = self._flatten_v2(meta)
        caption = meta["caption"]
        boxes = np.asarray(meta.get("bboxes", []), np.float32).reshape(-1, 4)
        spans = [
            [tuple(s) for s in sp] for sp in meta.get("tokens_positive", [])
        ]
        scores = np.asarray(meta.get("scores", [1.0] * len(boxes)), np.float32)

        if self.further_screen and len(boxes):
            keep = scores > self.caption_conf  # strict (pseudo_data.py:133)
            boxes, scores = boxes[keep], scores[keep]
            spans = [s for s, k in zip(spans, keep) if k]
            if self.caption_nms > 0 and len(boxes):
                ki = nms_screen(boxes, scores, self.caption_nms)
                boxes, scores = boxes[ki], scores[ki]
                spans = [spans[i] for i in ki]

        if len(boxes) < self.caption_min_box:
            return None
        return {
            "caption": caption,
            "boxes": boxes,
            "tokens_positive": spans,
            "greenlight_span": [(0, len(caption))],
        }
