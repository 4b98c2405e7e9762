"""The language-free detection heads FCOS, RetinaNet and ATSS and the
detector around them (counterpart of `mqdet_tpu/models/legacy_heads.py`;
reference modeling/rpn/{fcos/fcos.py, retina.py, atss.py}): a shared tower
of 3x3 convs per branch, the same weights at every pyramid level. None of
the MQ-Det configs uses them (RPN_ARCHITECTURE is VLDYHEAD everywhere);
`build_rpn_head` dispatches on cfg.MODEL.RPN_ARCHITECTURE as JAX's does.

Outputs are dicts of per-level NCHW maps (`cls_logits`, `bbox_reg` and, for
FCOS and ATSS, `centerness`); the losses and the post-processor
(`engine/legacy_losses.py`) read them in flax's NHWC order. Convs start
from normal(0.01) kernels and the classifier's bias from the prior
probability 0.01, as the JAX modules initialise; GroupNorm takes 32 groups
at flax's eps 1e-6. Module names are the JAX module's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import GroupNorm, Scale, cl

LEVELS = 5  # P3..P7: one Scale per level


def _conv3(cin: int, cout: int, bias_value: float = 0.0) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 3, padding=1)
    nn.init.normal_(conv.weight, std=0.01)
    nn.init.constant_(conv.bias, bias_value)
    return conv


class _ConvTower(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_convs: int, use_gn: bool = True,
                 prefix: str = "tower"):
        super().__init__()
        self.names = []
        for i in range(num_convs):
            self.add_module(f"{prefix}_conv{i}", _conv3(in_channels if i == 0 else channels, channels))
            self.add_module(f"{prefix}_gn{i}", GroupNorm(32, channels) if use_gn else nn.Identity())
            self.names.append((f"{prefix}_conv{i}", f"{prefix}_gn{i}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, gn in self.names:
            x = F.relu(getattr(self, gn)(cl(getattr(self, conv)(x))))
        return x


def _prior_bias(prior_prob: float) -> float:
    return -math.log((1 - prior_prob) / prior_prob)


class FCOSHead(nn.Module):
    """Per-pixel class logits, l/t/r/b distances (per-level Scale, then exp)
    and centerness (fcos.py)."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, channels: int = 256, num_convs: int = 4,
                 prior_prob: float = 0.01, levels: int = LEVELS):
        super().__init__()
        self.cls_tower = _ConvTower(in_channels, channels, num_convs, prefix="cls_tower")
        self.bbox_tower = _ConvTower(in_channels, channels, num_convs, prefix="bbox_tower")
        self.cls_logits = _conv3(channels, num_classes, _prior_bias(prior_prob))
        self.bbox_pred = _conv3(channels, 4)
        self.centerness = _conv3(channels, 1)
        for i in range(levels):
            self.add_module(f"scale_{i}", Scale())

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        logits, boxes, centerness = [], [], []
        for i, f in enumerate(feats):
            ct, bt = self.cls_tower(f), self.bbox_tower(f)
            logits.append(self.cls_logits(ct))
            centerness.append(self.centerness(bt))
            boxes.append(torch.exp(getattr(self, f"scale_{i}")(self.bbox_pred(bt))))
        return {"cls_logits": logits, "bbox_reg": boxes, "centerness": centerness}


class RetinaHead(nn.Module):
    """Anchor-based class logits and box deltas, towers without GN (retina.py)."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, num_anchors: int = 9, channels: int = 256,
                 num_convs: int = 4, prior_prob: float = 0.01):
        super().__init__()
        self.cls_tower = _ConvTower(in_channels, channels, num_convs, use_gn=False, prefix="cls_tower")
        self.bbox_tower = _ConvTower(in_channels, channels, num_convs, use_gn=False, prefix="bbox_tower")
        self.cls_logits = _conv3(channels, num_classes * num_anchors, _prior_bias(prior_prob))
        self.bbox_pred = _conv3(channels, 4 * num_anchors)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        return {"cls_logits": [self.cls_logits(self.cls_tower(f)) for f in feats],
                "bbox_reg": [self.bbox_pred(self.bbox_tower(f)) for f in feats]}


class ATSSHead(nn.Module):
    """Anchor-based class logits, box deltas (per-level Scale) and
    centerness (atss.py)."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, num_anchors: int = 1, channels: int = 256,
                 num_convs: int = 4, prior_prob: float = 0.01, levels: int = LEVELS):
        super().__init__()
        self.cls_tower = _ConvTower(in_channels, channels, num_convs, prefix="cls_tower")
        self.bbox_tower = _ConvTower(in_channels, channels, num_convs, prefix="bbox_tower")
        self.cls_logits = _conv3(channels, num_classes * num_anchors, _prior_bias(prior_prob))
        self.bbox_pred = _conv3(channels, 4 * num_anchors)
        self.centerness = _conv3(channels, num_anchors)
        for i in range(levels):
            self.add_module(f"scale_{i}", Scale())

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        logits, boxes, centerness = [], [], []
        for i, f in enumerate(feats):
            ct, bt = self.cls_tower(f), self.bbox_tower(f)
            logits.append(self.cls_logits(ct))
            boxes.append(getattr(self, f"scale_{i}")(self.bbox_pred(bt)))
            centerness.append(self.centerness(bt))
        return {"cls_logits": logits, "bbox_reg": boxes, "centerness": centerness}


def build_rpn_head(cfg, in_channels: int = None) -> nn.Module:
    """The RPN registry dispatch (modeling/rpn/rpn.py build_rpn): the legacy
    heads; VLDYHEAD is built by the MQ-GLIP model. `in_channels`: the
    backbone's map width (MODEL.BACKBONE.OUT_CHANNELS by default; flax
    infers it from the input)."""
    arch = cfg.MODEL.RPN_ARCHITECTURE
    ncls = cfg.MODEL.ATSS.NUM_CLASSES - 1
    cin = in_channels or cfg.MODEL.BACKBONE.OUT_CHANNELS
    if arch == "FCOS":
        return FCOSHead(cin, num_classes=ncls)
    if arch == "RETINA":
        return RetinaHead(cin, num_classes=ncls, num_anchors=len(cfg.MODEL.RPN.ASPECT_RATIOS))
    if arch == "ATSS":
        return ATSSHead(cin, num_classes=ncls)
    raise ValueError(
        f"RPN_ARCHITECTURE {arch!r}: VLDYHEAD is built by the MQGLIP "
        "meta-architecture; legacy heads: FCOS | RETINA | ATSS"
    )


class LegacyDetector(nn.Module):
    """Language-free GeneralizedRCNN (rpn_only): backbone pyramid -> head maps.
    The losses and the post-processor are `engine/legacy_losses.py`'s."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward(self, images: torch.Tensor, deterministic: bool = True) -> Dict[str, List[torch.Tensor]]:
        feats = self.backbone(cl(images.to(self.dtype)), deterministic)
        return self.head(list(feats))


def build_legacy_detector(cfg) -> LegacyDetector:
    from mqdet_torch.models.backbones import build_backbone

    backbone = build_backbone(cfg)
    out = backbone.out_channels
    return LegacyDetector(backbone, build_rpn_head(cfg, out if isinstance(out, int) else None))
