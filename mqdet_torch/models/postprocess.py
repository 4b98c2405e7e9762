"""ATSS post-processing, batched (counterpart of
`mqdet_tpu/models/postprocess.py`; reference modeling/rpn/inference.py
ATSSPostProcessor): per level, sigmoid(dot logits) -> class scores by MEAN
aggregation over each class's token span (one matmul with the (C, T) agg
map), threshold, exact top-k in two stages, decode, clip; then class-aware
NMS and the cap at DETECTIONS_PER_IMG.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from mqdet_torch.core import boxes as box_ops
from mqdet_torch.core.detections import Detections
from mqdet_torch.ops.nms import NEG_INF, class_aware_nms, topk_stable


class PostprocessParams(NamedTuple):
    pre_nms_thresh: float = 0.05
    pre_nms_top_n: int = 1000
    nms_thresh: float = 0.6
    detections_per_img: int = 100
    min_size: float = 0.0


def _level_candidates(bbox_reg, centerness, dot_logits, anchors, agg_map, sizes, p):
    """One level, batched: bbox_reg (B, HW, 4), centerness (B, HW), dot_logits
    (B, HW, T), anchors (HW, 4), agg_map (B, C, T), sizes (B, 2) -> the top
    pre_nms_top_n candidates per item (fixed count)."""
    probs = torch.sigmoid(dot_logits.float())
    scores = torch.matmul(probs, agg_map.transpose(1, 2))  # (B, HW, C)
    ranked = scores * torch.sigmoid(centerness.float())[..., None]
    masked = torch.where(scores > p.pre_nms_thresh, ranked, torch.full_like(ranked, NEG_INF))
    b, hw, num_classes = masked.shape
    k = min(p.pre_nms_top_n, hw * num_classes)
    # exact top-k in two stages: every entry of the global top k lies in one
    # of the k positions ranked by their best class score
    k_pos = min(k, hw)
    _, pos_idx = topk_stable(masked.amax(dim=-1), k_pos)  # (B, k_pos)
    rows = masked.gather(1, pos_idx[..., None].expand(b, k_pos, num_classes))
    top_scores, flat_idx = topk_stable(rows.reshape(b, -1), min(k, k_pos * num_classes))
    loc = pos_idx.gather(1, flat_idx // num_classes)
    cls = (flat_idx % num_classes + 1).to(torch.int32)
    boxes = box_ops.decode(
        bbox_reg.float().gather(1, loc[..., None].expand(*loc.shape, 4)), anchors[loc]
    )
    boxes = box_ops.clip_to_image(boxes, sizes[:, 0:1], sizes[:, 1:2])
    valid = (top_scores > NEG_INF / 2) & box_ops.remove_small_boxes_mask(boxes, p.min_size)
    return boxes, torch.sqrt(top_scores.clamp(min=0.0)), cls, valid


def atss_candidates(head_out: dict, anchors_levels: List[torch.Tensor], agg_map: torch.Tensor,
                    image_sizes: torch.Tensor, p: PostprocessParams):
    """Every level's top candidates, concatenated: (boxes (B, N, 4), scores
    (B, N), labels (B, N), valid (B, N))."""
    b = head_out["bbox_reg"][0].shape[0]
    parts = [
        _level_candidates(
            br.permute(0, 2, 3, 1).reshape(b, -1, 4),
            ct.reshape(b, -1),
            dl,
            an,
            agg_map.float(),
            image_sizes.float(),
            p,
        )
        for br, ct, dl, an in zip(
            head_out["bbox_reg"], head_out["centerness"], head_out["dot_product_logits"], anchors_levels
        )
    ]
    return tuple(torch.cat([x[i] for x in parts], 1) for i in range(4))


def atss_select(boxes, scores, labels, valid, p: PostprocessParams) -> Detections:
    """Class-aware NMS over the candidates and the cap at
    DETECTIONS_PER_IMG."""
    keep_idx, keep_valid = class_aware_nms(
        boxes, torch.where(valid, scores, torch.full_like(scores, NEG_INF)), labels, valid,
        p.nms_thresh, p.detections_per_img,
    )
    return Detections(
        boxes=boxes.gather(1, keep_idx[..., None].expand(*keep_idx.shape, 4)),
        scores=torch.where(keep_valid, scores.gather(1, keep_idx), torch.zeros((), device=scores.device)),
        labels=torch.where(keep_valid, labels.gather(1, keep_idx), torch.zeros((), dtype=torch.int32, device=labels.device)),
        valid=keep_valid,
    )


def atss_postprocess(
    head_out: dict,
    anchors_levels: List[torch.Tensor],
    agg_map: torch.Tensor,      # (B, C, T)
    image_sizes: torch.Tensor,  # (B, 2) true (h, w)
    p: PostprocessParams,
) -> Detections:
    return atss_select(*atss_candidates(head_out, anchors_levels, agg_map, image_sizes, p), p)
