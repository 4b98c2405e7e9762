"""Exact greedy class-aware NMS (counterpart of `mqdet_tpu/ops/nms.py::
class_aware_nms_matrix`; reference csrc/cuda/ml_nms.cu): IoU, with the +1
convention, only suppresses within a label; the keep set and its score order
are those of the sequential greedy loop.

Batched over a leading dim. Candidates are sorted by score (ties to the lower
index, as `lax.top_k` breaks them); the strict lower-triangular relation
M[i, j] = (j outranks i) & same label & IoU > t is built in row blocks; then
keep <- valid & ~any(M & keep) is iterated to its fixpoint, which is the
greedy keep set (entries of rank r are final after r + 1 steps).
"""
from __future__ import annotations

import torch

from mqdet_torch.core.boxes import box_iou

NEG_INF = torch.finfo(torch.float32).min


def topk_stable(x: torch.Tensor, k: int):
    """Top k along the last dim, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def class_aware_nms(
    boxes: torch.Tensor,   # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    labels: torch.Tensor,  # (B, N)
    valid: torch.Tensor,   # (B, N) bool
    iou_threshold: float,
    max_outputs: int,
    row_block: int = 1024,
):
    """Returns keep_idx (B, max_outputs) int64 indices into the input, score
    ordered, and keep_valid (B, max_outputs) bool."""
    b, n = scores.shape
    dev = scores.device
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    sorted_scores, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    b_s = boxes.gather(1, order[..., None].expand(b, n, 4))
    l_s = labels.gather(1, order)
    v_s = valid.gather(1, order) & (sorted_scores > NEG_INF / 2)

    rank = torch.arange(n, device=dev)
    m = torch.empty(b, n, n, dtype=torch.bool, device=dev)
    for r0 in range(0, n, row_block):
        r1 = min(n, r0 + row_block)
        iou = box_iou(b_s[:, r0:r1], b_s)
        m[:, r0:r1] = (
            (iou > iou_threshold)
            & (l_s[:, r0:r1, None] == l_s[:, None, :])
            & (rank[None, None, :] < rank[r0:r1, None][None])
        )
    keep = v_s
    for _ in range(n + 1):
        new = v_s & ~(m & keep[:, None, :]).any(-1)
        if torch.equal(new, keep):
            break
        keep = new

    kept_scores = torch.where(keep, sorted_scores, torch.full_like(sorted_scores, NEG_INF))
    k = min(max_outputs, n)
    top_scores, top_pos = topk_stable(kept_scores, k)
    keep_idx = order.gather(1, top_pos)
    keep_valid = top_scores > NEG_INF / 2
    if k < max_outputs:
        pad = max_outputs - k
        keep_idx = torch.cat([keep_idx, keep_idx.new_zeros(b, pad)], 1)
        keep_valid = torch.cat([keep_valid, keep_valid.new_zeros(b, pad)], 1)
    return keep_idx, keep_valid
