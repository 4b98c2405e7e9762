"""EfficientNet trunk, BiFPN and EffNetFPN (counterpart of
`mqdet_tpu/models/efficientnet.py`; reference modeling/backbone/
{efficientnet,bifpn,efficientdet}.py), NCHW, channels_last.

Convolutions and the BiFPN max pools pad as flax's `padding="SAME"` does,
TF SAME: for kernel k and stride s an extent H pads max((ceil(H / s) - 1) *
s + k - H, 0) in all, the odd pixel after (bottom / right), zeros for a
conv and -inf for a pool (`same_pad`). That differs from a symmetric
`padding=k // 2` at every stride-2 layer. Depthwise convs are `groups = C`
(flax's (kh, kw, 1, C) kernel is torch's (C, 1, kh, kw)). Batch norms are
`FrozenBatchNorm`. Module names are the JAX module's; the BiFPN's
down-channel 1x1 conv + norm pairs, which flax names in its scope in the
order it builds them, are `Conv_i` / `FrozenBatchNorm_i` here too.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import FrozenBatchNorm, cl


def round_channels(channels: float, divisor: int = 8) -> int:
    """efficientnet.py:17-38 make-divisible rounding."""
    rounded = max(int(channels + divisor / 2.0) // divisor * divisor, divisor)
    if float(rounded) < 0.9 * channels:
        rounded += divisor
    return rounded


# base b0 stage description (efficientnet.py:651-658)
_LAYERS = [1, 2, 2, 3, 3, 4, 1]
_DOWNSAMPLE = [1, 1, 1, 1, 0, 1, 0]
_CHANNELS = [16, 24, 40, 80, 112, 192, 320]
_EXPANSION = [1, 6, 6, 6, 6, 6, 6]
_KERNELS = [3, 3, 5, 3, 5, 5, 3]
_STRIDES = [1, 2, 2, 2, 1, 2, 1]

# version -> (depth_factor, width_factor) (efficientnet.py:625-655)
_VERSION_FACTORS = {
    "b0": (1.0, 1.0), "b1": (1.1, 1.0), "b2": (1.2, 1.1), "b3": (1.4, 1.2), "b4": (1.8, 1.4),
    "b5": (2.2, 1.6), "b6": (2.6, 1.8), "b7": (3.1, 2.0), "b8": (3.6, 2.2),
}


def efficientnet_spec(version: str):
    """The b{n} compound scaling as merged per-stage unit lists: a layer
    group with downsample 0 joins the previous stage (efficientnet.py:662-676).
    Returns (channels, kernels, expansions, stage_strides, init_channels,
    out_channels), the first three per stage and per unit."""
    if version not in _VERSION_FACTORS:
        raise ValueError(f"Unsupported EfficientNet version {version}")
    depth_f, width_f = _VERSION_FACTORS[version]
    layers = [int(math.ceil(li * depth_f)) for li in _LAYERS]
    channels = [round_channels(ci * width_f) for ci in _CHANNELS]

    def merge(values):
        stages: List[list] = []
        for v, n, down in zip(values, layers, _DOWNSAMPLE):
            if down:
                stages.append([v] * n)
            else:
                stages[-1].extend([v] * n)
        return stages

    st_channels = merge(channels)
    st_kernels = merge(_KERNELS)
    st_expansion = merge(_EXPANSION)
    st_strides = [s[0] for s in merge(_STRIDES)]
    out_channels = [st[-1] for st in st_channels[1:]]  # stages 2..5
    init_channels = round_channels(32 * width_f)
    return st_channels, st_kernels, st_expansion, st_strides, init_channels, out_channels


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """Pad the last two dims of x as TF SAME does for kernel k, stride s."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dim first
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with TF SAME padding (flax's `padding="SAME"`)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, stride, padding=0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cl(super().forward(same_pad(x, self.kernel_size[0], self.stride[0])))


class _ConvBN(nn.Module):
    """Conv (TF SAME, no bias) + FrozenBatchNorm + optional swish."""

    def __init__(self, cin: int, features: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.act = act
        self.conv = SameConv2d(cin, features, kernel, stride, groups=groups, bias=False)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class _SqueezeExcite(nn.Module):
    """SEBlock (EffiInvResUnit :445-449): pooled -> 1x1 conv -> swish -> 1x1
    conv -> sigmoid gate."""

    def __init__(self, channels: int, bottleneck: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, bottleneck, 1)
        self.fc2 = nn.Conv2d(bottleneck, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.silu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _DwsConvUnit(nn.Module):
    """Stage-1 depthwise-separable unit (EffiDwsConvUnit :331-389)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.residual = in_channels == out_channels and stride == 1
        self.dw = _ConvBN(in_channels, in_channels, 3, stride, groups=in_channels)
        self.se = _SqueezeExcite(in_channels, max(1, in_channels // 4))
        self.pw = _ConvBN(in_channels, out_channels, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw(self.se(self.dw(x)))
        return y + x if self.residual else y


class _InvResUnit(nn.Module):
    """MBConv inverted-residual unit (EffiInvResUnit :391-471)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int, expansion: int):
        super().__init__()
        self.residual = in_channels == out_channels and stride == 1
        mid = in_channels * expansion
        self.expand = _ConvBN(in_channels, mid, 1)
        self.dw = _ConvBN(mid, mid, kernel, stride, groups=mid)
        self.se = _SqueezeExcite(mid, max(1, in_channels // 4))
        self.project = _ConvBN(mid, out_channels, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.se(self.dw(self.expand(x))))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """EfficientNet-b{n} trunk returning (C2, C3, C4, C5) at strides 4..32:
    the outputs of merged stages 2..5 (efficientnet.py forward :615-621)."""

    def __init__(self, version: str = "b0"):
        super().__init__()
        st_channels, st_kernels, st_expansion, st_strides, init_ch, out = efficientnet_spec(version)
        self.out_channels = out
        self.stem = _ConvBN(3, init_ch, 3, 2)
        self.stages: List[List[str]] = []
        in_ch = init_ch
        for si, (chs, ks, exps) in enumerate(zip(st_channels, st_kernels, st_expansion)):
            names = []
            for ui, (ch, k, e) in enumerate(zip(chs, ks, exps)):
                stride = st_strides[si] if ui == 0 else 1
                unit = _DwsConvUnit(in_ch, ch, stride) if si == 0 else _InvResUnit(in_ch, ch, k, stride, e)
                names.append(f"s{si + 1}_u{ui + 1}")
                self.add_module(names[-1], unit)
                in_ch = ch
            self.stages.append(names)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> List[torch.Tensor]:
        x = self.stem(cl(x))
        outs = []
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if si > 0:
                outs.append(x)
        return outs


class _SeparableConvBN(nn.Module):
    """BiFPN node conv: depthwise 3x3 SAME (no bias) + pointwise 1x1 + BN."""

    def __init__(self, features: int):
        super().__init__()
        self.dw = SameConv2d(features, features, 3, groups=features, bias=False)
        self.pw = nn.Conv2d(features, features, 1)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.pw(self.dw(x)))


def _max_pool_s2_same(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2) with TF SAME padding, -inf pads (bifpn.py:60-63)."""
    return F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)


def _upsample_to(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest x2 upsample cropped to the target size (bifpn.py:55-58)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)[:, :, :out_h, :out_w]


# the BiFPN's down-channel pairs in flax's construction order (Conv_i / FrozenBatchNorm_i)
_DOWN = ("p5_to_p6", "p3_down_channel", "p4_down_channel", "p5_down_channel", "p4_down_channel_2",
         "p5_down_channel_2")
_BLENDS = (("p6_w1", 2), ("p5_w1", 2), ("p4_w1", 2), ("p3_w1", 2), ("p4_w2", 3), ("p5_w2", 3),
           ("p6_w2", 3), ("p7_w2", 2))


class BiFPN(nn.Module):
    """One BiFPN cell (bifpn.py:7-271): five levels, top-down then
    bottom-up. `first_time` takes the 3 body maps (C3, C4, C5, channels
    `in_channels`) and makes P6 / P7 by strided pooling; later cells take 5
    maps. `attention` blends each node's inputs by relu-normalised weights
    (eps 1e-4, fast attention); off, by a plain sum."""

    def __init__(self, out_channels: int, in_channels: Sequence[int] = (), first_time: bool = False,
                 attention: bool = True, epsilon: float = 1e-4):
        super().__init__()
        self.first_time, self.attention, self.epsilon = first_time, attention, epsilon
        if first_time:
            c3, c4, c5 = in_channels[-3:]
            for i, cin in enumerate((c5, c3, c4, c5, c4, c5)):
                self.add_module(f"Conv_{i}", nn.Conv2d(cin, out_channels, 1))
                self.add_module(f"FrozenBatchNorm_{i}", FrozenBatchNorm(out_channels))
        for name in ("conv6_up", "conv5_up", "conv4_up", "conv3_up", "conv4_down", "conv5_down", "conv6_down",
                     "conv7_down"):
            self.add_module(name, _SeparableConvBN(out_channels))
        if attention:
            for name, n in _BLENDS:
                setattr(self, name, nn.Parameter(torch.ones(n)))

    def _dn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        i = _DOWN.index(name)
        return getattr(self, f"FrozenBatchNorm_{i}")(cl(getattr(self, f"Conv_{i}")(x)))

    def _blend(self, name: str, parts: List[torch.Tensor]) -> torch.Tensor:
        if not self.attention:
            return sum(parts)
        w = F.relu(getattr(self, name))
        w = w / (w.sum() + self.epsilon)
        return sum(w[i].to(p.dtype) * p for i, p in enumerate(parts))

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if self.first_time:
            p3, p4, p5 = feats[-3:]
            p6_in = _max_pool_s2_same(self._dn("p5_to_p6", p5))
            p7_in = _max_pool_s2_same(p6_in)
            p3_in, p4_in, p5_in = self._dn("p3_down_channel", p3), self._dn("p4_down_channel", p4), \
                self._dn("p5_down_channel", p5)
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = feats

        def node(conv, blend, parts):
            return getattr(self, conv)(F.silu(self._blend(blend, parts)))

        def up(x, like):
            return _upsample_to(x, like.shape[2], like.shape[3])

        p6_up = node("conv6_up", "p6_w1", [p6_in, up(p7_in, p6_in)])
        p5_up = node("conv5_up", "p5_w1", [p5_in, up(p6_up, p5_in)])
        p4_up = node("conv4_up", "p4_w1", [p4_in, up(p5_up, p4_in)])
        p3_out = node("conv3_up", "p3_w1", [p3_in, up(p4_up, p3_in)])
        if self.first_time:
            p4_in, p5_in = self._dn("p4_down_channel_2", p4), self._dn("p5_down_channel_2", p5)
        p4_out = node("conv4_down", "p4_w2", [p4_in, p4_up, _max_pool_s2_same(p3_out)])
        p5_out = node("conv5_down", "p5_w2", [p5_in, p5_up, _max_pool_s2_same(p4_out)])
        p6_out = node("conv6_down", "p6_w2", [p6_in, p6_up, _max_pool_s2_same(p5_out)])
        p7_out = node("conv7_down", "p7_w2", [p7_in, _max_pool_s2_same(p6_out)])
        return tuple(cl(p) for p in (p3_out, p4_out, p5_out, p6_out, p7_out))


# EfficientDetBackbone compound tables (efficientdet.py:1229-1246)
_DET_BACKBONE = ["b0", "b1", "b2", "b3", "b4", "b5", "b6", "b6"]
_DET_FILTERS = [64, 88, 112, 160, 224, 288, 384, 384]
_DET_REPEATS = [3, 4, 5, 6, 7, 7, 8, 8]


def bifpn_cells(module: nn.Module, in_channels: Sequence[int], out_channels: int, repeats: int,
                attention: bool) -> None:
    """Register `repeats` BiFPN cells `bifpn{i}` on module, the first over
    the body maps `in_channels`."""
    for i in range(repeats):
        module.add_module(f"bifpn{i}", BiFPN(out_channels, in_channels if i == 0 else (), i == 0, attention))


class EffNetFPN(nn.Module):
    """EfficientNet-D backbone + BiFPN stack (efficientdet.py EffNetFPN
    :1193-1216). `start_from` 3 feeds (C3, C4, C5); 2 feeds (C2, C3, C4),
    the pyramid one level down. Returns 5 maps of `out_channels`; attention
    is off for compound >= 6."""

    def __init__(self, compound_coef: int = 0, start_from: int = 3):
        super().__init__()
        if start_from not in (2, 3):
            raise ValueError(f"EFFICIENT_DET_START_FROM {start_from}: 2 or 3")
        self.start_from = start_from
        self.out_channels = _DET_FILTERS[compound_coef]
        self.body = EfficientNet(_DET_BACKBONE[compound_coef])
        body_ch = self.body.out_channels
        self.repeats = _DET_REPEATS[compound_coef]
        bifpn_cells(self, body_ch[:3] if start_from == 2 else body_ch[1:], self.out_channels, self.repeats,
                    compound_coef < 6)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> List[torch.Tensor]:
        c2, c3, c4, c5 = self.body(x)
        feats = (c2, c3, c4) if self.start_from == 2 else (c3, c4, c5)
        for i in range(self.repeats):
            feats = getattr(self, f"bifpn{i}")(feats)
        return list(feats)
