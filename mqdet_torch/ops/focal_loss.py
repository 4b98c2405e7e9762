"""Focal losses in plain PyTorch (counterpart of `mqdet_tpu/ops/focal_loss.py`;
reference layers/sigmoid_focal_loss.py). Elementwise, as in JAX: no kernel is
warranted, the work fuses into the logits' producer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-class sigmoid focal loss. logits (N, C) with class c at column
    c - 1; targets (N,) int in [0, C], 0 = background. Returns (N, C)."""
    num_classes = logits.shape[-1]
    class_range = torch.arange(1, num_classes + 1, dtype=targets.dtype, device=targets.device)[None, :]
    t = targets[:, None]
    p = torch.sigmoid(logits)
    pos = (t == class_range).to(logits.dtype)
    neg = ((t != class_range) & (t >= 0)).to(logits.dtype)
    term1 = (1 - p) ** gamma * torch.log(p.clamp(min=1e-8))
    term2 = p**gamma * torch.log((1 - p).clamp(min=1e-8))
    return -pos * term1 * alpha - neg * term2 * (1 - alpha)


def token_sigmoid_binary_focal_loss(logits: torch.Tensor, targets: torch.Tensor, text_mask: torch.Tensor,
                                    alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Binary token focal loss summed over valid tokens. logits, targets
    (B, A, T); text_mask (B, T). Returns a scalar."""
    p = torch.sigmoid(logits)
    ce = F.relu(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    mask = (text_mask > 0).to(loss.dtype)[:, None, :]
    return (loss * mask).sum()
