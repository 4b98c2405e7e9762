"""FPN + LastLevelP6P7 over Swin stages 2-4 (counterpart of
`mqdet_tpu/models/fpn.py`; reference modeling/backbone/fpn.py as wired for
SWINT-FPN-RETINANET). P6 = conv_s2(P5), P7 = conv_s2(relu(P6)); top-down
upsampling is nearest x2 cropped to the lateral size. NCHW channels_last.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import GroupNorm, cl


class LastLevelP6P7(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.p6 = nn.Conv2d(c, c, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(c, c, 3, stride=2, padding=1)


class FPN(nn.Module):
    """3 input levels -> 5 output levels (strides 8..128). `use_gn`
    (MODEL.FPN.USE_GN) puts a GroupNorm(32) (flax's eps 1e-6) after each
    lateral and output conv, which then has no bias; `use_relu`
    (MODEL.FPN.USE_RELU) a ReLU after that: the JAX module's `block`. P6 and
    P7 take neither. Under USE_GN the norms are the modules
    `fpn_inner{l}_gn` / `fpn_layer{l}_gn` (flax's names)."""

    def __init__(self, in_channels: List[int], out_channels: int = 256, use_gn: bool = False,
                 use_relu: bool = False):
        super().__init__()
        self.use_gn, self.use_relu = use_gn, use_relu
        for i, cin in enumerate(in_channels):
            for name, c, k in ((f"fpn_inner{i + 2}", cin, 1), (f"fpn_layer{i + 2}", out_channels, 3)):
                self.add_module(name, nn.Conv2d(c, out_channels, k, padding=k // 2, bias=not use_gn))
                if use_gn:
                    self.add_module(f"{name}_gn", GroupNorm(32, out_channels))
        self.top_blocks = LastLevelP6P7(out_channels)
        self.num_in = len(in_channels)

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = cl(getattr(self, name)(x))
        if self.use_gn:
            y = getattr(self, f"{name}_gn")(y)
        return F.relu(y) if self.use_relu else y

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [self._block(f"fpn_inner{i + 2}", cl(f)) for i, f in enumerate(feats)]
        merged = [laterals[-1]]
        for i in range(len(laterals) - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            up = F.interpolate(merged[0], scale_factor=2, mode="nearest")[:, :, :h, :w]
            merged.insert(0, laterals[i] + up)
        outs = [self._block(f"fpn_layer{i + 2}", m) for i, m in enumerate(merged)]
        p6 = cl(self.top_blocks.p6(outs[-1]))
        p7 = cl(self.top_blocks.p7(F.relu(p6)))
        return outs + [p6, p7]
