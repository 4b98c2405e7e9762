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

from mqdet_torch.models.layers import cl


class LastLevelP6P7(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.p6 = nn.Conv2d(c, c, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(c, c, 3, stride=2, padding=1)


class FPN(nn.Module):
    """3 input levels -> 5 output levels (strides 8..128). GLIP configs keep
    MODEL.FPN.USE_GN / USE_RELU off, the only setting built here."""

    def __init__(self, in_channels: List[int], out_channels: int = 256):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 2}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_layer{i + 2}", nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.top_blocks = LastLevelP6P7(out_channels)
        self.num_in = len(in_channels)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [cl(getattr(self, f"fpn_inner{i + 2}")(cl(f))) for i, f in enumerate(feats)]
        merged = [laterals[-1]]
        for i in range(len(laterals) - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            up = F.interpolate(merged[0], scale_factor=2, mode="nearest")[:, :, :h, :w]
            merged.insert(0, laterals[i] + up)
        outs = [cl(getattr(self, f"fpn_layer{i + 2}")(m)) for i, m in enumerate(merged)]
        p6 = cl(self.top_blocks.p6(outs[-1]))
        p7 = cl(self.top_blocks.p7(F.relu(p6)))
        return outs + [p6, p7]
