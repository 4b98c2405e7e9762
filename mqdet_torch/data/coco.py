"""COCO/LVIS-format dataset reader (json; PIL only to read an image file,
imported when an image is read). The port's copy of `mqdet_tpu/data/coco.py`
(framework-free; pinned to the original by
`tests/test_torch_port_querybank.py`).

Reference dataset classes (maskrcnn_benchmark/data/datasets/
modulated_coco_new.py CocoGrounding_New, coco.py, lvis.py): annotation
loading, category filtering, few-shot subsampling
(modulated_coco_new.py:88-105), crowd exclusion, the LVIS federated fields
and OVERRIDE_CATEGORY for ODinW. A machine without PIL reads its images
through a subclass that overrides `load_image` (as `chip_smoke.py` does).
"""
from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


class CocoDetectionDataset:
    """Minimal COCO-format reader exposing what the pipeline needs."""

    def __init__(
        self,
        ann_file: str,
        img_dir: str,
        exclude_crowd: bool = True,
        few_shot: int = 0,
        shuffle_seed: int = 0,
        override_category: Optional[List[dict]] = None,
        filter_empty: bool = True,
    ):
        with open(ann_file) as f:
            data = json.load(f)

        self.img_dir = img_dir
        cats = data.get("categories", [])
        if override_category:
            # ODinW OVERRIDE_CATEGORY json (tools/finetune.py / odinw configs)
            byid = {c["id"]: c for c in override_category}
            cats = [byid.get(c["id"], c) for c in cats]
        self.categories = sorted(cats, key=lambda c: c["id"])
        self.cat_id_to_name = {c["id"]: c["name"] for c in self.categories}
        # contiguous ids 1..C in category-id order (reference json_category_id
        # mapping semantics)
        self.cat_id_to_contiguous = {
            c["id"]: i + 1 for i, c in enumerate(self.categories)
        }
        self.contiguous_to_cat_id = {
            v: k for k, v in self.cat_id_to_contiguous.items()
        }
        self.ind_to_class = {
            self.cat_id_to_contiguous[c["id"]]: c["name"] for c in self.categories
        }

        self.images = {im["id"]: im for im in data["images"]}
        anns_by_image: Dict[int, List[dict]] = defaultdict(list)
        for ann in data.get("annotations", []):
            if exclude_crowd and ann.get("iscrowd", 0):
                continue
            if ann.get("bbox") is None:
                continue
            w, h = ann["bbox"][2], ann["bbox"][3]
            if w <= 0 or h <= 0:
                continue
            anns_by_image[ann["image_id"]].append(ann)
        self.anns_by_image = anns_by_image

        ids = sorted(self.images.keys())
        if filter_empty:
            ids = [i for i in ids if len(anns_by_image[i])]

        if few_shot > 0:
            ids = self._few_shot_subsample(ids, few_shot, shuffle_seed)
        self.ids = ids

        # LVIS federated fields (neg_category_ids / not_exhaustive_category_ids)
        self.img_neg_cats = {
            im["id"]: set(im.get("neg_category_ids", [])) for im in data["images"]
        }
        self.img_not_exhaustive = {
            im["id"]: set(im.get("not_exhaustive_category_ids", []))
            for im in data["images"]
        }

    def _few_shot_subsample(self, ids, shots: int, seed: int) -> List[int]:
        """K-shot image subsampling (modulated_coco_new.py:88-105): keep
        images until every category has >= shots instances."""
        rng = random.Random(seed)
        ids = list(ids)
        rng.shuffle(ids)
        counts: Dict[int, int] = defaultdict(int)
        kept = []
        for img_id in ids:
            cats = {a["category_id"] for a in self.anns_by_image[img_id]}
            if any(counts[c] < shots for c in cats):
                kept.append(img_id)
                for a in self.anns_by_image[img_id]:
                    counts[a["category_id"]] += 1
        return sorted(kept)

    def __len__(self):
        return len(self.ids)

    def image_path(self, img_id: int) -> str:
        return os.path.join(self.img_dir, self.images[img_id]["file_name"])

    def load_image(self, img_id: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.image_path(img_id)) as im:
            return np.asarray(im.convert("RGB"))

    def annotations(self, img_id: int):
        """(boxes xyxy (N, 4), contiguous labels (N,)) numpy."""
        anns = self.anns_by_image[img_id]
        if not anns:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        boxes = np.asarray([a["bbox"] for a in anns], np.float32)
        boxes = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], axis=1)
        labels = np.asarray(
            [self.cat_id_to_contiguous[a["category_id"]] for a in anns], np.int32
        )
        return boxes, labels

    def image_size(self, img_id: int):
        im = self.images[img_id]
        return im["height"], im["width"]
