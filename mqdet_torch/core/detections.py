"""Fixed-capacity detections (counterpart of `mqdet_tpu/core/detections.py`):
a struct of tensors with a validity mask, any leading batch dims.

boxes (..., N, 4) float32 xyxy; scores (..., N) float32; labels (..., N)
int32, 1-based class slot, 0 where invalid; valid (..., N) bool.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List

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
