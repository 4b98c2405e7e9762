"""Fixed-capacity detections (counterpart of `mqdet_tpu/core/detections.py`):
a struct of tensors with a validity mask, any leading batch dims.

boxes (..., N, 4) float32 xyxy; scores (..., N) float32; labels (..., N)
int32, 1-based class slot, 0 where invalid; valid (..., N) bool.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, List

import numpy as np
import torch


@dataclass
class Detections:
    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def stack(dets: List["Detections"]) -> "Detections":
        """Stack along a new leading dim."""
        return Detections(**{f.name: torch.stack([getattr(d, f.name) for d in dets]) for f in fields(Detections)})


def concatenate(dets: List[Detections]) -> Detections:
    """cat_boxlist over the capacity axis."""
    return Detections(
        boxes=torch.cat([d.boxes for d in dets], dim=-2),
        scores=torch.cat([d.scores for d in dets], dim=-1),
        labels=torch.cat([d.labels for d in dets], dim=-1),
        valid=torch.cat([d.valid for d in dets], dim=-1),
    )


def top_k(dets: Detections, k: int) -> Detections:
    """The k highest-scoring valid detections, compacted to the front (ties
    to the lower slot, as `lax.top_k`), over any leading dims."""
    from mqdet_torch.ops.nms import NEG_INF, topk_stable

    masked = torch.where(dets.valid, dets.scores, torch.full_like(dets.scores, NEG_INF))
    _, idx = topk_stable(masked, k)
    return Detections(
        boxes=dets.boxes.gather(-2, idx[..., None].expand(*idx.shape, 4)),
        scores=dets.scores.gather(-1, idx),
        labels=dets.labels.gather(-1, idx),
        valid=dets.valid.gather(-1, idx),
    )


def resize(dets: Detections, scale_y, scale_x) -> Detections:
    """BoxList.resize: boxes from the network's input scale to the original
    image's."""
    s = torch.stack([torch.as_tensor(v, dtype=dets.boxes.dtype, device=dets.boxes.device)
                     for v in (scale_x, scale_y, scale_x, scale_y)]).reshape(1, 4)
    return replace(dets, boxes=dets.boxes * s)


def to_numpy_dict(dets: Detections) -> Dict[str, np.ndarray]:
    """Host-side: the valid slots as numpy arrays."""
    valid = dets.valid.cpu().numpy()
    return {
        "boxes": dets.boxes.cpu().numpy()[valid],
        "scores": dets.scores.cpu().numpy()[valid],
        "labels": dets.labels.cpu().numpy()[valid],
    }
