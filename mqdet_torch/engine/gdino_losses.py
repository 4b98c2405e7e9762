"""GroundingDINO's training losses: the Hungarian matcher and the set
criterion (counterpart of `mqdet_tpu/engine/gdino_losses.py`; reference
groundingdino_new/models/GroundingDINO/loss.py:18-180, matcher.py:8-181).

  * The matcher's cost per (query, gt): the focal class cost, the mean over
    the gt's tokens (its positive-map row binarised, `> 0`) of pos_cost -
    neg_cost on the sigmoid probabilities (1e-8 inside the logs), + the L1
    distance of the cxcywh boxes + (-GIoU), weighted set_cost_class / bbox /
    giou (1 / 5 / 2); `-inf` padded logits read as NEG_INF_SUB, invalid gt
    and non-finite costs as BIG.
  * The set criterion per decoder layer: the binary token focal loss over
    the real text tokens, summed, against per-query target rows (a matched
    query takes its gt's binarised positive-map row, every other query the
    `[no-obj]` one-hot of the last token), the L1 and 1 - GIoU of the matched
    boxes, each divided by num_boxes (the valid gt of the global batch, at
    least 1: across processes the sum over the ranks, so each rank's loss is
    its share of the global loss; the matching stays per image);
    then the weight-dict multipliers loss_ce / bbox / giou_coef (2 / 5 / 2)
    on the final layer and on every auxiliary layer (keys `{name}_{i}`),
    each of which is matched anew.

The assignment. JAX runs `optax.assignment.hungarian_algorithm` inside jit
on the padded (G, Q) cost, whose invalid gt rows carry the constant BIG. The
port builds the same costs on the device in fp32, for every layer and image
at once, moves them to the host in one transfer (with the validity mask):
one host synchronisation per step, after the forward. It solves each image's
**valid** rows there with `scipy.optimize.linear_sum_assignment`. With rows
of a constant cost every assignment of the invalid rows costs the same, so
the optimum of the valid rows is the padded problem's (an exact tie of two
optima may resolve differently). An invalid row's query is -1: the
assignment carries the validity mask to the losses, so they need no second
transfer.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mqdet_torch.core import boxes as box_ops
from mqdet_torch.ops.focal_loss import token_sigmoid_binary_focal_loss
from mqdet_torch.parallel import comm

BIG = 1e6
NEG_INF_SUB = -1e4  # finite stand-in for ContrastiveEmbed's -inf padding


def _finite_logits(logits: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(logits), logits, torch.full_like(logits, NEG_INF_SUB)).float()


def _pairwise_giou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Q, 4), (..., G, 4) cxcywh -> (..., Q, G) GIoU."""
    return box_ops.giou(box_ops.cxcywh_to_xyxy(a)[..., :, None, :], box_ops.cxcywh_to_xyxy(b)[..., None, :, :])


@torch.no_grad()
def matching_costs(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, gt_token_map: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_valid: torch.Tensor, cost_class: float = 1.0,
                   cost_bbox: float = 5.0, cost_giou: float = 2.0, alpha: float = 0.25,
                   gamma: float = 2.0) -> torch.Tensor:
    """The matcher's (..., Q, G) cost in fp32 on the inputs' device:
    pred_logits (..., Q, T), pred_boxes (..., Q, 4) cxcywh; gt_token_map
    (B, G, T), gt_boxes (B, G, 4) cxcywh normalised, gt_valid (B, G), the
    leading dims of the predictions ending in B (layers may lead)."""
    prob = torch.sigmoid(_finite_logits(pred_logits))
    pos_cost = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    neg_cost = (1 - alpha) * (prob**gamma) * (-torch.log(1 - prob + 1e-8))
    tok = (gt_token_map > 0).float()
    denom = tok.sum(-1).clamp(min=1.0)  # (B, G)
    cost_cls = torch.matmul(pos_cost - neg_cost, tok.transpose(-1, -2)) / denom[..., None, :]
    pb, gb = pred_boxes.float(), gt_boxes.float()
    cost_l1 = (pb[..., :, None, :] - gb[..., None, :, :]).abs().sum(-1)
    cost_g = -_pairwise_giou_cxcywh(pb, gb)
    cost = cost_class * cost_cls + cost_bbox * cost_l1 + cost_giou * cost_g
    cost = torch.where(gt_valid.bool()[..., None, :], cost, torch.full_like(cost, BIG))
    return torch.where(torch.isfinite(cost), cost, torch.full_like(cost, BIG))


def assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """One image's assignment: cost (Q, G), valid (G,) -> (G,) int64, the
    query of each valid gt (distinct), by `linear_sum_assignment` over the
    valid rows; -1 for an invalid gt."""
    from scipy.optimize import linear_sum_assignment

    q, g = cost.shape
    if g > q:
        raise ValueError(f"{g} gt slots for {q} queries: one-to-one matching needs G <= Q")
    out = np.full(g, -1, np.int64)
    rows = np.flatnonzero(valid)
    if rows.size:
        gt_i, q_i = linear_sum_assignment(cost[:, rows].T.astype(np.float64))
        out[rows[gt_i]] = q_i
    return out


def hungarian_match(pred_logits, pred_boxes, gt_token_map, gt_boxes, gt_valid, cost_class: float = 1.0,
                    cost_bbox: float = 5.0, cost_giou: float = 2.0, alpha: float = 0.25, gamma: float = 2.0):
    """matcher.py HungarianMatcher.forward for one image: (Q, T), (Q, 4),
    (G, T), (G, 4), (G,) -> (row_ind (G,) int64 numpy, valid (G,) bool
    numpy), the query assigned to each gt (-1 where it is invalid)."""
    cost = matching_costs(pred_logits, pred_boxes, gt_token_map[None], gt_boxes[None], gt_valid[None],
                          cost_class, cost_bbox, cost_giou, alpha, gamma)[0]
    valid = gt_valid.bool().cpu().numpy()
    return assign(cost.cpu().numpy(), valid), valid


def _layers(outputs: Dict):
    """(logits, boxes) of every decoder layer: the final one, then the auxiliary ones in order."""
    return [outputs["pred_logits"]] + list(outputs["aux_logits"]), [outputs["pred_boxes"]] + list(outputs["aux_boxes"])


def match_layers(outputs: Dict, gt_boxes, gt_valid, gt_token_map, cost_class: float = 1.0,
                 cost_bbox: float = 5.0, cost_giou: float = 2.0, alpha: float = 0.25,
                 gamma: float = 2.0) -> np.ndarray:
    """(L, B, G) int64: the assignment (`assign`) of every layer (the final
    one, then the auxiliary ones in order) and image, from one
    device-to-host transfer of all their costs and the validity mask."""
    logits, boxes = _layers(outputs)
    cost = matching_costs(torch.stack([x.detach() for x in logits]), torch.stack([x.detach() for x in boxes]),
                          gt_token_map, gt_boxes, gt_valid, cost_class, cost_bbox, cost_giou, alpha, gamma)
    n_layers, b, q, g = cost.shape
    host = torch.cat([cost.reshape(-1), gt_valid.float().reshape(-1)]).cpu().numpy()  # the step's one sync
    costs, valid = host[: cost.numel()].reshape(n_layers, b, q, g), host[cost.numel():].reshape(b, g) > 0
    return np.stack([np.stack([assign(costs[l, i], valid[i]) for i in range(b)]) for l in range(n_layers)])


def _layer_losses(pred_logits, pred_boxes, q_idx, b_idx, g_idx, gt_boxes, tok, tmask, num_boxes, alpha, gamma):
    """One layer's unweighted terms; (b_idx, g_idx) the valid gt, q_idx their queries."""
    b, q, t_len = pred_logits.shape
    targets = torch.zeros(b, q, t_len, device=pred_logits.device)
    targets[b_idx, q_idx] = tok[b_idx, g_idx]
    noobj = torch.zeros(t_len, device=pred_logits.device)
    noobj[-1] = 1.0
    targets = torch.where((targets.sum(-1) == 0)[..., None], noobj, targets)
    ce = token_sigmoid_binary_focal_loss(_finite_logits(pred_logits), targets, tmask, alpha=alpha, gamma=gamma)
    matched = pred_boxes[b_idx, q_idx].float()
    gbx = gt_boxes[b_idx, g_idx].float()
    g = box_ops.giou(box_ops.cxcywh_to_xyxy(matched), box_ops.cxcywh_to_xyxy(gbx))
    return {"loss_ce": ce / num_boxes, "loss_bbox": (matched - gbx).abs().sum() / num_boxes,
            "loss_giou": (1.0 - g).sum() / num_boxes}


def gdino_set_loss(
    outputs: Dict,
    gt_boxes: torch.Tensor,      # (B, G, 4) cxcywh normalised
    gt_valid: torch.Tensor,      # (B, G)
    gt_token_map: torch.Tensor,  # (B, G, T)
    text_masks: torch.Tensor,    # (B, T)
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    loss_ce_coef: float = 2.0,
    loss_bbox_coef: float = 5.0,
    loss_giou_coef: float = 2.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
    assignment: Optional[np.ndarray] = None,
) -> Dict[str, torch.Tensor]:
    """SetCriterion over the final and auxiliary decoder layers (module
    docstring). `assignment` (L, B, G) replaces the matcher's (`match_layers`)
    with a given one: for comparing runs whose near-tied costs may flip a
    pair; training never passes it."""
    if assignment is None:
        assignment = match_layers(outputs, gt_boxes, gt_valid, gt_token_map, cost_class, cost_bbox, cost_giou,
                                  alpha, gamma)
    logits, boxes = _layers(outputs)
    if np.shape(assignment) != (len(logits),) + tuple(gt_valid.shape):
        raise ValueError(f"assignment {np.shape(assignment)} != {(len(logits),) + tuple(gt_valid.shape)}")
    dev = outputs["pred_logits"].device
    assignment = np.asarray(assignment)
    # the valid (image, gt) pairs (query >= 0) and each layer's query for them, in one host-to-device copy
    b_np, g_np = np.nonzero(assignment[0] >= 0)
    idx = torch.from_numpy(np.concatenate([b_np[None], g_np[None], assignment[:, b_np, g_np]])).to(dev)
    b_idx, g_idx, q_idx = idx[0], idx[1], idx[2:]
    num_boxes = float(len(b_np))
    if comm.get_world_size() > 1:
        num_boxes = comm.all_reduce_sum(torch.tensor([num_boxes], dtype=torch.float64, device=dev)).item()
    num_boxes = max(num_boxes, 1.0)
    tok = (gt_token_map > 0).float()
    tmask = text_masks
    t_len = outputs["pred_logits"].shape[-1]
    if tmask.shape[-1] < t_len:  # the mask padded to max_text_len
        tmask = F.pad(tmask, (0, t_len - tmask.shape[-1]))
    weights = {"loss_ce": loss_ce_coef, "loss_bbox": loss_bbox_coef, "loss_giou": loss_giou_coef}
    losses = {}
    for i, (pl, pb) in enumerate(zip(logits, boxes)):
        suffix = "" if i == 0 else f"_{i - 1}"
        for k, v in _layer_losses(pl, pb, q_idx[i], b_idx, g_idx, gt_boxes, tok, tmask, num_boxes, alpha,
                                  gamma).items():
            losses[k + suffix] = v * weights[k]
    return losses
