"""Exact greedy class-aware NMS (counterpart of `mqdet_tpu/ops/nms.py::
class_aware_nms_matrix`; reference csrc/cuda/ml_nms.cu): IoU, with the +1
convention, only suppresses within a label; the keep set and its score order
are those of the sequential greedy loop.

Batched over a leading dim. Candidates are sorted by score (ties to the lower
index, as `lax.top_k` breaks them); the strict lower-triangular relation
M[i, j] = (j outranks i) & same label & IoU > t is built in row blocks; then
keep <- valid & ~any(M & keep) is iterated to its fixpoint, which is the
greedy keep set (entries of rank r are final after r + 1 steps).

`soft_nms` is the JAX package's Gaussian soft-NMS (`mqdet_tpu/ops/nms.py::
soft_nms`), batched; as in JAX, no model calls it (the test-time
augmentation's merge, `engine/box_aug.py`, has its own numpy one).
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


def soft_nms(
    boxes: torch.Tensor,   # (..., N, 4)
    scores: torch.Tensor,  # (..., N)
    valid: torch.Tensor,   # (..., N) bool
    sigma: float = 0.5,
    score_threshold: float = 0.001,
    max_outputs: int = 300,
):
    """Gaussian soft-NMS (the JAX package's `soft_nms`; reference
    csrc/cpu/soft_nms.cpp, method gaussian), batched over leading dims, on
    the tensors' device: `max_outputs` greedy steps, each taking the best
    remaining score (ties to the lower index) and decaying every other by
    exp(-IoU^2 / sigma), with the +1 IoU. Returns keep_idx (..., max_outputs)
    int64, keep_score float32 (the decayed score at selection) and
    keep_valid bool; a step whose best is not above `score_threshold` gives
    index 0, score 0, invalid."""
    n = scores.shape[-1]
    work = torch.where(valid, scores.float(), torch.full_like(scores, NEG_INF, dtype=torch.float32))
    ar = torch.arange(n, device=scores.device)
    idx, kept, ok_all = [], [], []
    for _ in range(max_outputs):
        best = work.argmax(-1, keepdim=True)                        # (..., 1)
        best_score = work.gather(-1, best)
        ok = best_score > score_threshold
        idx.append(torch.where(ok, best, torch.zeros_like(best)))
        kept.append(torch.where(ok, best_score, torch.zeros_like(best_score)))
        ok_all.append(ok)
        top = boxes.gather(-2, best[..., None].expand(*best.shape, 4))  # (..., 1, 4)
        decay = torch.exp(-(box_iou(top, boxes)[..., 0, :] ** 2) / sigma)
        work = torch.where(ar == best, torch.full_like(work, NEG_INF), work * decay)
    return torch.cat(idx, -1), torch.cat(kept, -1), torch.cat(ok_all, -1)
