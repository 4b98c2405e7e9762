"""ResNet trunk with frozen BatchNorm (counterpart of
`mqdet_tpu/models/resnet.py`; reference modeling/backbone/resnet.py):
bottleneck stages C2..C5, the stride on the 1x1 conv (`stride_in_1x1`, as
Caffe2) or on the 3x3, a 1x1 strided conv + FrozenBatchNorm downsample.
Module and parameter names are the JAX module's (`stem_conv`,
`layer{s}_block{b}.conv1`, ...), so a flax leaf maps to the state_dict key
of the same path (`io/from_jax.py::legacy_rules`). NCHW, channels_last.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import FrozenBatchNorm, cl


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int, stride: int = 1,
                 stride_in_1x1: bool = True, dilation: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if in_channels != out_channels or stride != 1:
            self.downsample_conv = nn.Conv2d(in_channels, out_channels, 1, stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(out_channels)
        else:
            self.downsample_conv = None
        self.conv1 = nn.Conv2d(in_channels, bottleneck_channels, 1, s1, bias=False)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = nn.Conv2d(bottleneck_channels, bottleneck_channels, 3, s3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = nn.Conv2d(bottleneck_channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return cl(F.relu(y + residual))


class ResNet(nn.Module):
    """The stem (7x7/2 conv, FrozenBatchNorm, ReLU, 3x3/2 max pool padded
    with -inf) and four bottleneck stages; returns the stages in
    `return_stages` (1-based: C2..C5) as NCHW maps at strides 4..32."""

    def __init__(self, depths: Tuple[int, ...] = (3, 4, 6, 3), base_channels: int = 64,
                 stride_in_1x1: bool = True, return_stages: Sequence[int] = (1, 2, 3, 4)):
        super().__init__()
        self.return_stages = tuple(return_stages)
        self.stem_conv = nn.Conv2d(3, base_channels, 7, 2, padding=3, bias=False)
        self.stem_bn = FrozenBatchNorm(base_channels)
        self.stages: List[List[str]] = []
        channels, cin = base_channels, base_channels
        self.out_channels = []
        for stage, blocks in enumerate(depths, start=1):
            names = []
            for b in range(blocks):
                name = f"layer{stage}_block{b}"
                self.add_module(name, Bottleneck(cin, channels * 4, channels, (1 if stage == 1 else 2) if b == 0
                                                 else 1, stride_in_1x1))
                cin = channels * 4
                names.append(name)
            self.stages.append(names)
            if stage in self.return_stages:
                self.out_channels.append(cin)
            channels *= 2

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> List[torch.Tensor]:
        y = F.relu(self.stem_bn(self.stem_conv(cl(x))))
        y = F.max_pool2d(y, 3, 2, padding=1)
        outs = []
        for stage, names in enumerate(self.stages, start=1):
            for name in names:
                y = getattr(self, name)(y)
            if stage in self.return_stages:
                outs.append(y)
        return outs


def resnet50() -> ResNet:
    return ResNet(depths=(3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet(depths=(3, 4, 23, 3))
