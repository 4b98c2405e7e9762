"""ATSS matching and the GLIP training losses (counterpart of
`mqdet_tpu/engine/losses.py`; reference modeling/rpn/loss.py
ATSSLossComputation and generalized_vl_rcnn_new.py's gate loss).

Fixed shapes as in JAX: ground truth arrives padded to G boxes with a
validity mask, and every argmax and threshold is masked, batched over the
images. The per-level top-k of ATSS takes JAX's order among ties (the lower
anchor index first, as `jax.lax.top_k` does): a stable ascending sort of the
distances. Normalizers are sums over the whole batch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from mqdet_torch.core import boxes as box_ops
from mqdet_torch.engine.optim import flax_path, flax_is_scalar
from mqdet_torch.ops.focal_loss import token_sigmoid_binary_focal_loss

INF = 1e8


class ATSSTargets(NamedTuple):
    cls_labels: torch.Tensor    # (B, N) int64, 0 = background
    reg_targets: torch.Tensor   # (B, N, 4)
    token_labels: torch.Tensor  # (B, N, T)
    matched_gt: torch.Tensor    # (B, N) index of the matched box (0 if none)


def atss_match(anchors: torch.Tensor, level_sizes: Sequence[int], gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor, gt_token_map: torch.Tensor,
               topk: int = 9, num_anchors_per_loc: int = 1) -> ATSSTargets:
    """ATSS assignment of a batch. anchors (N, 4), all levels concatenated;
    gt_boxes (B, G, 4), gt_labels (B, G), gt_valid (B, G) bool, gt_token_map
    (B, G, T) normalized positive-map rows."""
    b, g = gt_labels.shape
    n = anchors.shape[0]
    valid = gt_valid.bool()
    ious = box_ops.box_iou(anchors[None], gt_boxes)  # (B, N, G)
    ious = torch.where(valid[:, None, :], ious, torch.full_like(ious, -1.0))

    a_cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    a_cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    g_cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    g_cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    dist = torch.sqrt((a_cx[None, :, None] - g_cx[:, None]) ** 2 + (a_cy[None, :, None] - g_cy[:, None]) ** 2)

    parts, start = [], 0
    for size in level_sizes:
        k = min(topk * num_anchors_per_loc, size)
        idx = torch.sort(dist[:, start:start + size], dim=1, stable=True).indices[:, :k]  # (B, k, G)
        mask = torch.zeros(b, size, g, dtype=torch.bool, device=anchors.device)
        parts.append(mask.scatter_(1, idx, True))
        start += size
    candidate = torch.cat(parts, 1)  # (B, N, G)

    num_cand = candidate.sum(1)
    mean = torch.where(candidate, ious, torch.zeros_like(ious)).sum(1) / num_cand.clamp(min=1)
    var = torch.where(candidate, (ious - mean[:, None]) ** 2, torch.zeros_like(ious)).sum(1) / (
        (num_cand - 1).clamp(min=1))
    is_pos = candidate & (ious >= (mean + torch.sqrt(var))[:, None])

    l = a_cx[None, :, None] - gt_boxes[:, None, :, 0]
    t = a_cy[None, :, None] - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - a_cx[None, :, None]
    bb = gt_boxes[:, None, :, 3] - a_cy[None, :, None]
    inside = torch.minimum(torch.minimum(l, r), torch.minimum(t, bb)) > 0.01
    is_pos = is_pos & inside & valid[:, None, :]

    ious_inf = torch.where(is_pos, ious, torch.full_like(ious, -INF))
    matched_iou = ious_inf.amax(dim=2)
    matched_gt = ious_inf.argmax(dim=2)  # the first among equal maxima, as jnp.argmax
    is_matched = matched_iou > -INF / 2

    cls_labels = torch.where(is_matched, torch.gather(gt_labels.long(), 1, matched_gt), 0)
    boxes = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(b, n, 4))
    reg_targets = box_ops.encode(boxes, anchors[None])
    t_len = gt_token_map.shape[-1]
    token_labels = torch.gather(gt_token_map, 1, matched_gt[..., None].expand(b, n, t_len))
    unmatched = torch.zeros(t_len, dtype=token_labels.dtype, device=token_labels.device)
    unmatched[-1] = 1.0
    token_labels = torch.where(is_matched[..., None], token_labels, unmatched)
    return ATSSTargets(cls_labels, reg_targets, token_labels, matched_gt)


def centerness_targets(reg_targets: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """sqrt((min/max l,r) * (min/max t,b)) of the decoded targets; (..., N)."""
    gts = box_ops.decode(reg_targets, anchors)
    a_cx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    a_cy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    l, t = a_cx - gts[..., 0], a_cy - gts[..., 1]
    r, b = gts[..., 2] - a_cx, gts[..., 3] - a_cy
    lr = torch.minimum(l, r) / torch.maximum(l, r).clamp(min=1e-8)
    tb = torch.minimum(t, b) / torch.maximum(t, b).clamp(min=1e-8)
    return torch.sqrt(lr.clamp(min=0.0) * tb.clamp(min=0.0))


def glip_losses(head_out: Dict, anchors: torch.Tensor, level_sizes: Sequence[int], gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor, gt_token_map: torch.Tensor,
                text_masks: torch.Tensor, topk: int = 9, reg_loss_weight: float = 2.0,
                focal_alpha: float = 0.25, focal_gamma: float = 2.0) -> Dict[str, torch.Tensor]:
    """Token focal loss on the dot-product logits, GIoU weighted by the
    centerness targets, centerness BCE; in fp32. `head_out` is VLDyHead's:
    per-level NCHW bbox_reg (B, 4, H, W) and centerness (B, 1, H, W), and
    (B, H W, T) dot-product logits."""
    b = gt_boxes.shape[0]
    bbox_reg = torch.cat([x.permute(0, 2, 3, 1).reshape(b, -1, 4) for x in head_out["bbox_reg"]], 1).float()
    centerness = torch.cat([x.reshape(b, -1) for x in head_out["centerness"]], 1).float()
    dot_logits = torch.cat(head_out["dot_product_logits"], 1).float()

    with torch.no_grad():
        targets = atss_match(anchors, level_sizes, gt_boxes, gt_labels, gt_valid, gt_token_map, topk=topk)
        pos = targets.cls_labels > 0
        total_pos = pos.sum().float().clamp(min=1.0)
        ctr_t = torch.where(pos, centerness_targets(targets.reg_targets, anchors), 0.0)
        sum_ctr = ctr_t.sum().clamp(min=1e-6)
        tgt_boxes = box_ops.decode(targets.reg_targets, anchors)

    dp_loss = token_sigmoid_binary_focal_loss(
        dot_logits, targets.token_labels, text_masks, alpha=focal_alpha, gamma=focal_gamma) / total_pos
    giou = box_ops.giou(box_ops.decode(bbox_reg, anchors), tgt_boxes)
    reg_loss = ((1.0 - giou) * ctr_t).sum() / sum_ctr * reg_loss_weight
    bce = F.relu(centerness) - centerness * ctr_t + torch.log1p(torch.exp(-centerness.abs()))
    ctr_loss = torch.where(pos, bce, 0.0).sum() / total_pos
    return {"loss_dot_product_token": dp_loss, "loss_reg": reg_loss, "loss_centerness": ctr_loss}


def gate_parameters(named_params, model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The gates the JAX package collects: parameters whose flax leaf is a
    0-d `ff_gate` / `attn_gate` (the port keeps `ff_gate` as a (1,) tensor,
    the reference's shape; the bridge's rule maps it to the flax scalar).
    `model` picks the rule table of the names (MQ-GLIP's without one)."""
    return {
        name: p for name, p in named_params
        if flax_path(name, model).endswith(("ff_gate", "attn_gate")) and flax_is_scalar(name, p.shape, model)
    }


def gate_loss_from_params(named_params, scale: float = 1.0, regularize: bool = False,
                          model: Optional[torch.nn.Module] = None) -> torch.Tensor:
    """MQ-Det's gate loss, scale * mean(1 - |g|) over `gate_parameters`;
    detached unless GATE_REGULARIZATION."""
    gates = list(gate_parameters(named_params, model).values())
    if not gates:
        return torch.zeros(())
    loss = scale * torch.mean(1.0 - torch.cat([g.float().reshape(-1) for g in gates]).abs())
    return loss if regularize else loss.detach()


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy with ignore_index -100 (mean over labelled tokens)."""
    valid = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
