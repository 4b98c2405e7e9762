"""The backbone registry: MODEL.BACKBONE.CONV_BODY name -> pyramid backbone
(counterpart of `mqdet_tpu/models/backbones.py`; reference
modeling/backbone/__init__.py:19-239). Every builder returns a module whose
`forward(images NCHW, deterministic=True)` gives the feature list the head
takes, and whose `out_channels` is its maps' width:

- *-RETINANET / *-FPN / *-BIFPN / EFFICIENT-DET: 5 pyramid levels (P3..P7,
  strides 8..128; 4..64 for EFFICIENT-DET with start_from 2);
- R-*-C4 / R-*-C5: the ResNet stage maps C2..C5 (body only).

As in JAX, "CVT-FPN-RETINANET" is registered and raises (the reference
entry calls a `cvt` module it never imports), an unknown name raises
KeyError, and fbnet has no entry. MQ-GLIP builds its SWINT-FPN inside the
model (`models/mq_glip.py`); the entry here builds the same pair alone.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from mqdet_torch.models.efficientnet import EfficientNet, EffNetFPN, bifpn_cells
from mqdet_torch.models.fpn import FPN
from mqdet_torch.models.resnet import ResNet
from mqdet_torch.models.swin import SwinTransformer

BACKBONES: Dict[str, Callable] = {}


def register(*names: str):
    def deco(fn):
        for n in names:
            BACKBONES[n] = fn
        return fn
    return deco


class _BodyFPN(nn.Module):
    """body (4 stage maps) -> FPN over the last 3 -> P3..P7
    (build_retinanet_swint_fpn_backbone :37-81, build_eff_fpn_p6p7_backbone
    :165-192)."""

    def __init__(self, body: nn.Module, body_channels: List[int], out_channels: int = 256):
        super().__init__()
        self.body = body
        self.fpn = FPN(list(body_channels[1:4]), out_channels)
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> List[torch.Tensor]:
        return self.fpn(list(self.body(x))[1:4])  # Swin's forward(x) draws nothing: the evaluation forward


class _BodyBiFPN(nn.Module):
    """body -> NUM_REPEATS stacked BiFPN cells (:195-219)."""

    def __init__(self, body: nn.Module, out_channels: int = 256, num_repeats: int = 3, attention: bool = True):
        super().__init__()
        self.body = body
        self.out_channels = out_channels
        self.num_repeats = num_repeats
        bifpn_cells(self, body.out_channels[1:4], out_channels, num_repeats, attention)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> List[torch.Tensor]:
        feats = tuple(self.body(x))[1:4]
        for i in range(self.num_repeats):
            feats = getattr(self, f"bifpn{i}")(feats)
        return list(feats)


def _resnet_body(cfg) -> ResNet:
    name = cfg.MODEL.BACKBONE.CONV_BODY
    return ResNet(depths=(3, 4, 23, 3) if name.startswith("R-101") else (3, 4, 6, 3))


@register("R-50-C4", "R-50-C5", "R-101-C4", "R-101-C5")
def build_resnet_backbone(cfg):
    """Body-only ResNet (:19-26): the C2..C5 stage maps."""
    return _resnet_body(cfg)


@register("R-50-RETINANET", "R-101-RETINANET")
def build_resnet_retinanet_backbone(cfg):
    body = _resnet_body(cfg)
    return _BodyFPN(body, body.out_channels, cfg.MODEL.BACKBONE.OUT_CHANNELS)


@register("SWINT-FPN-RETINANET", "SWINT-FPN")
def build_swint_fpn_backbone(cfg):
    """Swin under SWINT.VERSION (:44-54) + FPN."""
    sw = cfg.MODEL.SWINT
    body = SwinTransformer(sw.EMBED_DIM, tuple(sw.DEPTHS), tuple(sw.NUM_HEADS), sw.WINDOW_SIZE, sw.MLP_RATIO,
                           sw.DROP_PATH_RATE, sw.VERSION)
    e = sw.EMBED_DIM
    return _BodyFPN(body, [e, 2 * e, 4 * e, 8 * e], cfg.MODEL.BACKBONE.OUT_CHANNELS)


def _eff_version(cfg) -> str:
    # "EFFICIENT3-FPN-RETINANET" -> "b3" (:171-173)
    return cfg.MODEL.BACKBONE.CONV_BODY.split("-")[0].replace("EFFICIENT", "b")


@register(
    "EFFICIENT7-FPN-RETINANET", "EFFICIENT7-FPN-FCOS",
    "EFFICIENT5-FPN-RETINANET", "EFFICIENT5-FPN-FCOS",
    "EFFICIENT3-FPN-RETINANET", "EFFICIENT3-FPN-FCOS",
)
def build_eff_fpn_backbone(cfg):
    body = EfficientNet(_eff_version(cfg))
    return _BodyFPN(body, body.out_channels, cfg.MODEL.BACKBONE.OUT_CHANNELS)


@register(
    "EFFICIENT7-BIFPN-RETINANET", "EFFICIENT7-BIFPN-FCOS",
    "EFFICIENT5-BIFPN-RETINANET", "EFFICIENT5-BIFPN-FCOS",
    "EFFICIENT3-BIFPN-RETINANET", "EFFICIENT3-BIFPN-FCOS",
)
def build_eff_bifpn_backbone(cfg):
    return _BodyBiFPN(EfficientNet(_eff_version(cfg)), cfg.MODEL.BACKBONE.OUT_CHANNELS,
                      cfg.MODEL.BIFPN.NUM_REPEATS, cfg.MODEL.BIFPN.USE_ATTENTION)


@register("EFFICIENT-DET")
def build_efficientdet_backbone(cfg):
    return EffNetFPN(cfg.MODEL.BACKBONE.EFFICIENT_DET_COMPOUND, cfg.MODEL.BACKBONE.EFFICIENT_DET_START_FROM)


@register("CVT-FPN-RETINANET")
def build_cvt_backbone(cfg):
    raise NotImplementedError(
        "CVT-FPN-RETINANET is dead code in the reference: "
        "modeling/backbone/__init__.py:128-162 calls cvt.build_cvt_backbone "
        "but never imports a cvt module, so the entry raises NameError when "
        "invoked. No config in the reference uses it."
    )


def build_backbone(cfg) -> nn.Module:
    """build_backbone dispatch (:233-239)."""
    name = cfg.MODEL.BACKBONE.CONV_BODY
    if name not in BACKBONES:
        raise KeyError(f"cfg.MODEL.BACKBONE.CONV_BODY: {name} is not registered in registry")
    return BACKBONES[name](cfg)
