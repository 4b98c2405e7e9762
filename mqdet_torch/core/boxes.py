"""Box operations with the legacy Detectron "+1" convention (counterpart of
`mqdet_tpu/core/boxes.py`; reference structures/bounding_box.py and the
BoxCoder of modeling/rpn/vldyhead.py). Boxes are xyxy float32."""
from __future__ import annotations

import math

import torch

TO_REMOVE = 1.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0] + TO_REMOVE) * (boxes[..., 3] - boxes[..., 1] + TO_REMOVE)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter)


def box_iou_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise IoU of aligned (..., 4) boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (box_area(a) + box_area(b) - inter)


def encode(gt_boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """BoxCoder.encode: xyxy boxes -> (dx, dy, dw, dh) targets against anchors."""
    wx, wy, ww, wh = BOX_CODER_WEIGHTS
    ex_w = anchors[..., 2] - anchors[..., 0] + TO_REMOVE
    ex_h = anchors[..., 3] - anchors[..., 1] + TO_REMOVE
    ex_cx = (anchors[..., 2] + anchors[..., 0]) * 0.5
    ex_cy = (anchors[..., 3] + anchors[..., 1]) * 0.5
    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0] + TO_REMOVE
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1] + TO_REMOVE
    gt_cx = (gt_boxes[..., 2] + gt_boxes[..., 0]) * 0.5
    gt_cy = (gt_boxes[..., 3] + gt_boxes[..., 1]) * 0.5
    return torch.stack(
        [wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
         ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)],
        dim=-1,
    )


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def giou(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Generalized IoU of aligned xyxy boxes, areas WITHOUT the +1 (the
    reference's GIoULoss)."""
    px1, py1 = pred[..., 0], pred[..., 1]
    px2 = torch.maximum(px1, pred[..., 2])
    py2 = torch.maximum(py1, pred[..., 3])
    pred_area = (px2 - px1) * (py2 - py1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    target_area = (tx2 - tx1) * (ty2 - ty1)
    ix1, iy1 = torch.maximum(px1, tx1), torch.maximum(py1, ty1)
    ix2, iy2 = torch.minimum(px2, tx2), torch.minimum(py2, ty2)
    inter = torch.where((iy2 > iy1) & (ix2 > ix1), (ix2 - ix1) * (iy2 - iy1), torch.zeros_like(ix1))
    ex1, ey1 = torch.minimum(px1, tx1), torch.minimum(py1, ty1)
    ex2, ey2 = torch.maximum(px2, tx2), torch.maximum(py2, ty2)
    enclose = (ex2 - ex1) * (ey2 - ey1) + eps
    union = pred_area + target_area - inter + eps
    return inter / union - (enclose - union) / enclose


def decode(preds: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """BoxCoder.decode: (dx, dy, dw, dh) deltas + anchors -> xyxy."""
    wx, wy, ww, wh = BOX_CODER_WEIGHTS
    widths = anchors[..., 2] - anchors[..., 0] + TO_REMOVE
    heights = anchors[..., 3] - anchors[..., 1] + TO_REMOVE
    ctr_x = (anchors[..., 2] + anchors[..., 0]) * 0.5
    ctr_y = (anchors[..., 3] + anchors[..., 1]) * 0.5
    dx = preds[..., 0] / wx
    dy = preds[..., 1] / wy
    dw = (preds[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (preds[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    pred_cx = dx * widths + ctr_x
    pred_cy = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack(
        [
            pred_cx - 0.5 * (pred_w - TO_REMOVE),
            pred_cy - 0.5 * (pred_h - TO_REMOVE),
            pred_cx + 0.5 * (pred_w - TO_REMOVE),
            pred_cy + 0.5 * (pred_h - TO_REMOVE),
        ],
        dim=-1,
    )


def clip_to_image(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp to [0, size - 1]; height / width are scalars or (...,) tensors
    broadcasting against the leading dims of boxes."""
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), width - TO_REMOVE)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), height - TO_REMOVE)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), width - TO_REMOVE)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), height - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    ws = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    hs = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (ws >= min_size) & (hs >= min_size)


def expand_boxes(boxes: torch.Tensor, ratio: float, height, width) -> torch.Tensor:
    """expand_bbox (generalized_vl_rcnn_new.py:32-49): scale boxes about their
    center by `ratio`, clipped to the image."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    half_w = (boxes[..., 2] - boxes[..., 0]) * 0.5 * ratio
    half_h = (boxes[..., 3] - boxes[..., 1]) * 0.5 * ratio
    out = torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1)
    return clip_to_image(out, height, width)
