"""Vision-query extraction: boxes -> pooled pyramid features -> bank
(counterpart of `mqdet_tpu/mq/extract.py`; reference
GeneralizedVLRCNN_New.extract_query, generalized_vl_rcnn_new.py:232-288, and
the extraction loop of tools/train_net.py:256-336):
  * boxes expanded x EXPAND_RATIO about their center, clipped to the image
    (expand_bbox, :32-49);
  * ROIAlign-pooled 7x7 from the image tower's levels: level-mapped when
    SELECT_FPN_LEVEL (S = 1), else from every level (S = levels);
  * spatially mean-pooled to (num_boxes, S, C);
  * added per label to a QueryBank, capped at MAX_QUERY_NUMBER.

Both families go through `encode_image`: MQ-GLIP's 5 FPN levels, or
MQ-GroundingDINO's 4 `input_proj` levels with the first 4 POOLER_SCALES.
Features are pooled in float32 whatever the model's dtype. Extraction runs
no hand-written kernel: the image tower and ROIAlign are plain PyTorch.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from mqdet_torch.core.boxes import expand_boxes
from mqdet_torch.mq.bank import QueryBank
from mqdet_torch.ops.roi_align import all_level_roi_align, multi_level_roi_align


def pool_queries(cfg, feats: Sequence[torch.Tensor], boxes: torch.Tensor, image_h, image_w) -> torch.Tensor:
    """The pooling half of extraction: image features (batch 1, NCHW, any
    dtype) and boxes (N, 4) on their device -> (N, S, C) float32."""
    scales = tuple(cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES)
    resolution = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    boxes = expand_boxes(boxes, cfg.VISION_QUERY.EXPAND_RATIO, image_h, image_w)
    maps = [f[0].permute(1, 2, 0).float() for f in feats]  # (H, W, C) each
    if cfg.VISION_QUERY.SELECT_FPN_LEVEL:
        pooled = multi_level_roi_align(maps, boxes, scales, output_size=resolution)  # (N, P, P, C)
        return pooled.mean(dim=(1, 2))[:, None, :]  # (N, 1, C)
    pooled = all_level_roi_align(maps, boxes, scales, output_size=resolution)  # (L, N, P, P, C)
    return pooled.mean(dim=(2, 3)).transpose(0, 1)  # (N, L, C)


def make_extract_fn(model, cfg) -> Callable:
    """Returns extract(images (1, 3, H, W), boxes (N, 4) xyxy in the resized
    image's coordinates, image_h, image_w) -> (N, S, C) float32 pooled query
    features on the model's device (S = 1 level-mapped, else one per level):
    `encode_image`, then `pool_queries`. Inputs are moved to the model's
    device."""
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(images, boxes, image_h, image_w):
        feats = model.encode_image(torch.as_tensor(images).to(dev))
        return pool_queries(cfg, feats, torch.as_tensor(boxes, dtype=torch.float32).to(dev), image_h, image_w)

    return extract


def extract_queries_into_bank(
    extract_fn: Callable,
    data_iter: Iterable[dict],
    bank: QueryBank,
    max_query_number: int = 5000,
    exclude_similar: bool = False,
) -> QueryBank:
    """Drive extraction over a dataset iterator, as the JAX module does.

    data_iter yields dicts with: image (1, 3, H, W) padded and normalized,
    boxes (N, 4) in its coordinates, labels (N,), image_size (h, w) of the
    resized image. An image whose labels are all at the cap is skipped."""
    for batch in data_iter:
        needed = [bank.count(int(l)) < max_query_number for l in batch["labels"]]
        if not any(needed):
            continue
        pooled = extract_fn(batch["image"], batch["boxes"], *batch["image_size"]).cpu().numpy()
        for feat, label, ok in zip(pooled, batch["labels"], needed):
            if not ok:
                continue
            bank.add(int(label), feat[None], exclude_similar=exclude_similar, capacity=max_query_number)
    return bank


def dataset_extraction_iter(dataset, transform, device="cuda", ids=None):
    """The JAX training CLI's extraction iterator (tools/train.py:214-225):
    per image of `dataset` (or of `ids`, a rank's shard), the transformed
    image on `device` and its GT boxes mapped into the resized image."""
    for img_id in dataset.ids if ids is None else ids:
        image, (oh, ow), (sy, sx) = transform(dataset.load_image(img_id), device)
        boxes, labels = dataset.annotations(img_id)
        yield {
            "image": image,
            "boxes": boxes / np.array([sx, sy, sx, sy], np.float32),
            "labels": labels,
            "image_size": (float(oh), float(ow)),
        }
