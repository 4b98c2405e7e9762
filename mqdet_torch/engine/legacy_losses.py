"""Losses, post-processor and training step of the legacy heads (counterpart
of `mqdet_tpu/engine/legacy_losses.py`; reference modeling/rpn/loss.py
FCOSLossComputation :272-470, RetinaNetLossComputation :163-270 and the
class-logit variant of ATSSLossComputation, modeling/rpn/inference.py's
post-processors).

Fixed shapes as in JAX: the ground truth of a batch is padded to G boxes
with a validity mask, assignment is vectorised over the batch, reductions
are masked. Targets take no gradient (JAX's depend on the ground truth
only). Head outputs are the heads' NCHW maps, read in flax's NHWC order
(location-major, then anchor, then class), as the anchors and locations
are laid out. `fcos_locations` is a copy of the JAX module's numpy function
(pinned by a test). `make_legacy_train_step` takes a `torch.optim`
optimizer where JAX takes an optax transformation; plain `torch.optim.SGD`
makes `optax.sgd`'s update.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mqdet_torch.core import boxes as box_ops
from mqdet_torch.core.detections import Detections
from mqdet_torch.engine.losses import atss_match, centerness_targets
from mqdet_torch.models.postprocess import PostprocessParams
from mqdet_torch.ops.anchors import anchors_for_fpn
from mqdet_torch.ops.focal_loss import sigmoid_focal_loss
from mqdet_torch.ops.nms import class_aware_nms, topk_stable

INF = 1e8
NEG_INF = -1e18

# FCOS per-level object size-of-interest ranges (loss.py:341-347)
FCOS_SIZE_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


def fcos_locations(image_hw: Tuple[int, int], strides: Tuple[int, ...]) -> List[np.ndarray]:
    """Per-level (HW, 2) pixel centers (fcos.py compute_locations:
    shift + stride // 2)."""
    h, w = image_hw
    out = []
    for s in strides:
        ys = (np.arange(-(-h // s), dtype=np.float32)) * s + s // 2
        xs = (np.arange(-(-w // s), dtype=np.float32)) * s + s // 2
        gx, gy = np.meshgrid(xs, ys)
        out.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return out


def _flat(maps: List[torch.Tensor], width: int) -> torch.Tensor:
    """Per-level NCHW maps -> (B, sum(H W A), width) in NHWC order, fp32."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, width) for m in maps], 1).float()


def _on(refs: Sequence[np.ndarray], like: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.as_tensor(np.asarray(r)) for r in refs]).to(like.device, torch.float32)


class FCOSTargets(NamedTuple):
    cls_labels: torch.Tensor   # (B, N) int64, 0 = background
    reg_targets: torch.Tensor  # (B, N, 4) l/t/r/b distances
    centerness: torch.Tensor   # (B, N)


def fcos_match(locations: torch.Tensor, level_sizes: Tuple[int, ...], gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor) -> FCOSTargets:
    """compute_targets_for_locations (loss.py:397-452), batched: locations
    (N, 2), gt (B, G, ...). A location is positive for a box it lies inside
    whose max(l, t, r, b) falls in its level's size range; ties go to the
    box of least area (the first among equal areas)."""
    xs, ys = locations[:, 0], locations[:, 1]
    l = xs[None, :, None] - gt_boxes[:, None, :, 0]
    t = ys[None, :, None] - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - xs[None, :, None]
    b = gt_boxes[:, None, :, 3] - ys[None, :, None]
    reg = torch.stack([l, t, r, b], -1)  # (B, N, G, 4)
    inside = reg.amin(-1) > 0
    max_reg = reg.amax(-1)
    dev = locations.device
    lo = torch.cat([torch.full((s,), float(FCOS_SIZE_RANGES[i][0]), device=dev) for i, s in enumerate(level_sizes)])
    hi = torch.cat([torch.full((s,), float(FCOS_SIZE_RANGES[i][1]), device=dev) for i, s in enumerate(level_sizes)])
    in_range = (max_reg >= lo[None, :, None]) & (max_reg <= hi[None, :, None])
    area = box_ops.box_area(gt_boxes)  # (B, G)
    cand = inside & in_range & gt_valid.bool()[:, None, :]
    area_masked = torch.where(cand, area[:, None, :], torch.full_like(max_reg, INF))
    matched = area_masked.argmin(-1)  # (B, N)
    has_match = area_masked.amin(-1) < INF
    cls_labels = torch.where(has_match, torch.gather(gt_labels.long(), 1, matched), 0)
    reg_t = torch.gather(reg, 2, matched[..., None, None].expand(*matched.shape, 1, 4))[:, :, 0]
    lr_min = torch.minimum(reg_t[..., 0], reg_t[..., 2])
    lr_max = torch.maximum(reg_t[..., 0], reg_t[..., 2])
    tb_min = torch.minimum(reg_t[..., 1], reg_t[..., 3])
    tb_max = torch.maximum(reg_t[..., 1], reg_t[..., 3])
    ctr = torch.sqrt((lr_min / lr_max.clamp(min=1e-8)).clamp(min=0.0) * (tb_min / tb_max.clamp(min=1e-8)).clamp(min=0.0))
    return FCOSTargets(cls_labels, reg_t, ctr)


def fcos_decode(locations: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """(N, 2) centers + (..., N, 4) l/t/r/b -> xyxy."""
    return torch.stack([locations[:, 0] - distances[..., 0], locations[:, 1] - distances[..., 1],
                        locations[:, 0] + distances[..., 2], locations[:, 1] + distances[..., 3]], -1)


def _bce_logits(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return -(t * F.logsigmoid(x) + (1.0 - t) * F.logsigmoid(-x))


def fcos_losses(head_out: Dict[str, List[torch.Tensor]], locations_levels: List[np.ndarray],
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
                gamma: float = 2.0, alpha: float = 0.25) -> Dict[str, torch.Tensor]:
    """FCOSLossComputation.__call__ (loss.py:454-470): class focal / num_pos,
    centerness-weighted GIoU / sum of the centerness targets, centerness BCE
    / num_pos."""
    level_sizes = tuple(len(x) for x in locations_levels)
    cls = _flat(head_out["cls_logits"], num_classes)
    reg = _flat(head_out["bbox_reg"], 4)
    ctr = _flat(head_out["centerness"], 1)[..., 0]
    locs = _on(locations_levels, cls)
    with torch.no_grad():
        tgt = fcos_match(locs, level_sizes, gt_boxes.float(), gt_labels, gt_valid)
        pos = tgt.cls_labels > 0
        num_pos = pos.sum().float().clamp(min=1.0)
        gt_decoded = fcos_decode(locs, tgt.reg_targets)
        w = torch.where(pos, tgt.centerness, 0.0)
    cls_loss = sigmoid_focal_loss(cls.reshape(-1, num_classes), tgt.cls_labels.reshape(-1),
                                  gamma=gamma, alpha=alpha).sum() / num_pos
    g = box_ops.giou(fcos_decode(locs, reg), gt_decoded)
    reg_loss = ((1.0 - g) * w).sum() / w.sum().clamp(min=1e-6)
    ctr_loss = torch.where(pos, _bce_logits(tgt.centerness, ctr), 0.0).sum() / num_pos
    return {"loss_cls": cls_loss, "loss_reg": reg_loss, "loss_centerness": ctr_loss}


def retina_match(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                 fg_iou: float = 0.5, bg_iou: float = 0.4):
    """Matcher(0.5, 0.4, allow_low_quality_matches=True) (modeling/matcher.py),
    batched: anchors (N, 4), gt (B, G, ...). Per anchor its best box; below
    bg background (0), in [bg, fg) ignored (-1); an anchor reaching some
    box's best IoU gets its own best box's label back. Returns (labels
    (B, N), best box (B, N), best IoU (B, N))."""
    valid = gt_valid.bool()
    ious = box_ops.box_iou(anchors[None], gt_boxes)  # (B, N, G)
    ious = torch.where(valid[:, None, :], ious, torch.full_like(ious, -1.0))
    best_iou, best_gt = ious.amax(2), ious.argmax(2)
    own = torch.gather(gt_labels.long(), 1, best_gt)
    labels = torch.where(best_iou >= fg_iou, own,
                         torch.where(best_iou < bg_iou, torch.zeros_like(own), torch.full_like(own, -1)))
    gt_best = ious.amax(1)  # (B, G)
    force = (ious >= gt_best[:, None, :] - 1e-7) & valid[:, None, :] & (gt_best[:, None, :] > 0)
    labels = torch.where(force.any(2), own, labels)
    return labels, best_gt, best_iou


_UNIT = (0.0, 0.0, 1.0, 1.0)


def _safe(gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """Padded rows as unit boxes, so that encoding them stays finite."""
    unit = torch.tensor(_UNIT, dtype=torch.float32, device=gt_boxes.device)
    return torch.where(gt_valid.bool()[..., None], gt_boxes.float(), unit)


def retina_losses(head_out: Dict[str, List[torch.Tensor]], anchors_levels: List[np.ndarray],
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
                  num_anchors: int, beta: float = 0.11, gamma: float = 2.0,
                  alpha: float = 0.25) -> Dict[str, torch.Tensor]:
    """RetinaNetLossComputation.__call__ (loss.py:232-270): sigmoid focal on
    the anchors not ignored / num_pos, smooth L1 (beta 0.11) of the encoded
    deltas of the positives / num_pos."""
    cls = _flat(head_out["cls_logits"], num_classes)
    reg = _flat(head_out["bbox_reg"], 4)
    anchors = _on(anchors_levels, cls)
    with torch.no_grad():
        gt_safe = _safe(gt_boxes, gt_valid)
        labels, matched, _ = retina_match(anchors, gt_safe, gt_labels, gt_valid)
        pos = labels > 0
        num_pos = pos.sum().float().clamp(min=1.0)
        tgt = box_ops.encode(torch.gather(gt_safe, 1, matched[..., None].expand(*matched.shape, 4)), anchors[None])
    # an ignored anchor (-1) adds nothing: both focal indicators need t >= 0
    cls_loss = sigmoid_focal_loss(cls.reshape(-1, num_classes), labels.reshape(-1), gamma=gamma,
                                  alpha=alpha).sum() / num_pos
    diff = (reg - tgt).abs()
    sl1 = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    reg_loss = torch.where(pos[..., None], sl1, 0.0).sum() / num_pos
    return {"loss_cls": cls_loss, "loss_reg": reg_loss}


def atss_legacy_losses(head_out: Dict[str, List[torch.Tensor]], anchors_levels: List[np.ndarray],
                       gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
                       topk: int = 9) -> Dict[str, torch.Tensor]:
    """ATSSLossComputation with per-class logits: the assignment of
    `engine/losses.py::atss_match`, focal on the class targets,
    centerness-weighted GIoU, centerness BCE."""
    level_sizes = tuple(len(a) for a in anchors_levels)
    cls = _flat(head_out["cls_logits"], num_classes)
    reg = _flat(head_out["bbox_reg"], 4)
    ctr = _flat(head_out["centerness"], 1)[..., 0]
    anchors = _on(anchors_levels, cls)
    with torch.no_grad():
        gt_safe = _safe(gt_boxes, gt_valid)
        token_map = torch.zeros(*gt_labels.shape, 1, device=cls.device)  # the class variant reads no tokens
        tgt = atss_match(anchors, level_sizes, gt_safe, gt_labels, gt_valid, token_map, topk)
        pos = tgt.cls_labels > 0
        num_pos = pos.sum().float().clamp(min=1.0)
        gt_dec = box_ops.decode(tgt.reg_targets, anchors[None])
        ctr_t = centerness_targets(tgt.reg_targets, anchors[None])
        w = torch.where(pos, ctr_t, 0.0)
    cls_loss = sigmoid_focal_loss(cls.reshape(-1, num_classes), tgt.cls_labels.reshape(-1)).sum() / num_pos
    g = box_ops.giou(box_ops.decode(reg, anchors[None]), gt_dec)
    reg_loss = ((1.0 - g) * w).sum() / w.sum().clamp(min=1e-6)
    ctr_loss = torch.where(pos, _bce_logits(ctr_t, ctr), 0.0).sum() / num_pos
    return {"loss_cls": cls_loss, "loss_reg": reg_loss, "loss_centerness": ctr_loss}


def legacy_postprocess_single(head_out: Dict[str, List[torch.Tensor]], anchors_or_locations: List[np.ndarray],
                              kind: str, image_h, image_w, p: PostprocessParams, num_classes: int,
                              item: int = 0) -> Detections:
    """The RetinaNet / FCOS / ATSS post-processor (modeling/rpn/inference.py)
    for batch item `item`: per level, threshold and the top pre_nms_top_n
    of (HW A x C) scores (ties to the lower index), decode and clip; then
    class-aware NMS (`class_aware_nms`, JAX's `class_aware_nms_matrix`) to detections_per_img
    slots. `kind`: "fcos" | "retina" | "atss"."""
    boxes_l, scores_l, labels_l, valid_l = [], [], [], []
    has_ctr = "centerness" in head_out
    for lvl, ref in enumerate(anchors_or_locations):
        logits = head_out["cls_logits"][lvl][item].permute(1, 2, 0).reshape(-1, num_classes)
        scores = torch.sigmoid(logits.float())
        if has_ctr:
            c = torch.sigmoid(head_out["centerness"][lvl][item].permute(1, 2, 0).reshape(-1).float())
            scores = torch.sqrt(scores * c[:, None]) if kind == "atss" else scores * c[:, None]
        reg = head_out["bbox_reg"][lvl][item].permute(1, 2, 0).reshape(-1, 4).float()
        r = torch.as_tensor(np.asarray(ref)).to(reg.device, torch.float32)
        boxes = fcos_decode(r, reg) if kind == "fcos" else box_ops.decode(reg, r)
        boxes = box_ops.clip_to_image(boxes, image_h, image_w)
        flat = scores.reshape(-1)
        k = min(p.pre_nms_top_n, flat.shape[0])
        top_scores, top_idx = topk_stable(torch.where(flat > p.pre_nms_thresh, flat,
                                                      torch.full_like(flat, NEG_INF)), k)
        boxes_l.append(boxes[top_idx // num_classes])
        scores_l.append(top_scores)
        labels_l.append((top_idx % num_classes + 1).to(torch.int32))
        valid_l.append(top_scores > NEG_INF / 2)
    boxes, scores = torch.cat(boxes_l), torch.cat(scores_l)
    labels, valid = torch.cat(labels_l), torch.cat(valid_l)
    keep_idx, keep_valid = class_aware_nms(
        boxes[None], torch.where(valid, scores, torch.full_like(scores, NEG_INF))[None], labels[None], valid[None],
        p.nms_thresh, p.detections_per_img)
    keep_idx, keep_valid = keep_idx[0], keep_valid[0]
    return Detections(
        boxes=boxes[keep_idx],
        scores=torch.where(keep_valid, scores[keep_idx], 0.0),
        labels=torch.where(keep_valid, labels[keep_idx], 0),
        valid=keep_valid,
    )


def build_legacy_machinery(cfg, image_hw: Tuple[int, int]):
    """(loss_fn, postprocess_fn) of cfg.MODEL.RPN_ARCHITECTURE at a fixed
    image bucket:
      loss_fn(head_out, gt_boxes (B, G, 4), gt_labels (B, G), gt_valid (B, G))
        -> dict of scalar losses
      postprocess_fn(head_out, image_h, image_w, item=0) -> Detections"""
    arch = cfg.MODEL.RPN_ARCHITECTURE
    strides = tuple(cfg.MODEL.RPN.ANCHOR_STRIDE)
    ncls = cfg.MODEL.ATSS.NUM_CLASSES - 1
    p = PostprocessParams(
        pre_nms_thresh=cfg.MODEL.ATSS.INFERENCE_TH,
        pre_nms_top_n=cfg.MODEL.ATSS.PRE_NMS_TOP_N,
        nms_thresh=cfg.MODEL.ATSS.NMS_TH,
        detections_per_img=cfg.MODEL.ATSS.DETECTIONS_PER_IMG,
    )
    if arch == "FCOS":
        refs = fcos_locations(image_hw, strides)
        kind = "fcos"

        def loss_fn(head_out, gt_boxes, gt_labels, gt_valid):
            return fcos_losses(head_out, refs, gt_boxes, gt_labels, gt_valid, ncls)
    elif arch in ("RETINA", "ATSS"):
        refs = anchors_for_fpn(image_hw, strides, sizes=tuple(cfg.MODEL.RPN.ANCHOR_SIZES),
                               aspect_ratios=tuple(cfg.MODEL.RPN.ASPECT_RATIOS))
        kind = arch.lower()
        if arch == "RETINA":
            na = len(cfg.MODEL.RPN.ASPECT_RATIOS)

            def loss_fn(head_out, gt_boxes, gt_labels, gt_valid):
                return retina_losses(head_out, refs, gt_boxes, gt_labels, gt_valid, ncls, num_anchors=na)
        else:
            topk = cfg.MODEL.ATSS.TOPK

            def loss_fn(head_out, gt_boxes, gt_labels, gt_valid):
                return atss_legacy_losses(head_out, refs, gt_boxes, gt_labels, gt_valid, ncls, topk)
    else:
        raise ValueError(f"no legacy machinery for RPN_ARCHITECTURE {arch!r}")

    def postprocess_fn(head_out, image_h, image_w, item: int = 0):
        return legacy_postprocess_single(head_out, refs, kind, image_h, image_w, p, ncls, item)

    return loss_fn, postprocess_fn


def make_legacy_train_step(model, loss_fn, optimizer: torch.optim.Optimizer,
                           compute_dtype: Optional[torch.dtype] = None):
    """One training step of a LegacyDetector (tools/train_net.py for the
    non-VLDyHead architectures), on the padded ground truth:
      step(images (B, 3, H, W), gt_boxes, gt_labels, gt_valid) -> (loss, losses)
    The forward runs with deterministic=False; the summed losses are
    differentiated with respect to every parameter `optimizer` holds, and
    `optimizer.step()` applies the update. `compute_dtype` (bf16 on a card,
    TPU.COMPUTE_DTYPE) runs the forward under autocast with the parameters
    kept in their own dtype, as flax's `dtype` computes in bf16 from fp32
    parameters; None computes in the parameters' dtype."""
    def step(images, gt_boxes, gt_labels, gt_valid):
        dev = next(model.parameters()).device
        optimizer.zero_grad(set_to_none=True)
        cast = (torch.autocast(dev.type, dtype=compute_dtype) if compute_dtype is not None
                else nullcontext())
        with cast:
            head_out = model(images.to(dev), deterministic=False)
        losses = loss_fn(head_out, gt_boxes.to(dev), gt_labels.to(dev), gt_valid.to(dev))
        loss = sum(losses.values())
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in losses.items()}

    return step
