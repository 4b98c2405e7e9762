"""VLDyHead, GLIP's fused dynamic head (counterpart of
`mqdet_tpu/models/vldyhead.py`; reference modeling/rpn/vldyhead.py).

NUM_CONVS stages of [VLFuse (MHA-B bi-attention) -> BertLayer (text self
attention) -> DyConv (three modulated deformable convs + scale attention +
DYReLU)], then the cls / bbox / centerness convs and the dot-product token
head with its +-50000 clip. `dyhead_tower` holds the stages at the
reference's indices 3i, 3i+1, 3i+2, so the state_dict keys are its keys.

Every deformable conv is one call per level (13 per stage at 5 levels),
dispatched as the JAX package's `DeformConvGN` does on `MQDET_DEFORM_IMPL`,
read at call time: `gather` samples exactly (`modulated_deform_conv`);
`pallas` (the default, and `pallas_interpret`) with C % 128 == 0 clips the
offsets to +-`TPU.DEFORM_RADIUS` in the band kernel
(`modulated_deform_conv_pallas`); anything else clips them in the gather
kernel (`modulated_deform_conv_window`). On the CPU each route runs its plain
version. Offsets predicted at level L and applied to the conv over level L+1
are read with the reference CUDA kernel's strided reinterpretation, per batch
item (`TPU.DEFORM_OFFSET_COMPAT = "strided"`), or resampled (`"resample"`).
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.bert import BertLayer
from mqdet_torch.models.fusion import VLFuse
from mqdet_torch.models.layers import DYReLU, GroupNorm, Scale, cl, h_sigmoid, remat, upsample_bilinear
from mqdet_torch.ops.deform_conv import (
    modulated_deform_conv,
    modulated_deform_conv_pallas,
    modulated_deform_conv_window,
    reinterpret_offsets_strided,
    resize_offsets,
)

# The JAX package's VLDyHead builds its DyConv GroupNorms with 16 groups
# whatever MODEL.GROUP_NORM.NUM_GROUPS says; so does the port.
GN_GROUPS = 16


class ModulatedDeformConv(nn.Module):
    """3x3 DCNv2 parameters in the reference's layout (O, I, 3, 3)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, offset, mask, radius: int):
        """x: (B, C, H, W); offset (B, Ho, Wo, 18), mask (B, Ho, Wo, 9) NHWC.
        Returns (B, Cout, Ho, Wo) channels_last. The route follows
        MQDET_DEFORM_IMPL (module docstring)."""
        impl = os.environ.get("MQDET_DEFORM_IMPL", "pallas")
        args = (x.permute(0, 2, 3, 1).contiguous(), offset, mask,
                self.weight.permute(2, 3, 1, 0).contiguous(), self.bias)
        if impl == "gather":
            y = modulated_deform_conv(*args, stride=self.stride)
        elif impl in ("pallas", "pallas_interpret") and x.shape[1] % 128 == 0:
            # the JAX package's block_rows: 16 at the 100-row level, else 8
            y = modulated_deform_conv_pallas(*args, stride=self.stride, radius=radius,
                                             block_rows=16 if x.shape[2] // self.stride >= 100 else 8)
        else:
            y = modulated_deform_conv_window(*args, stride=self.stride, radius=radius)
        return y.permute(0, 3, 1, 2)


class DeformConvGN(nn.Module):
    """Conv3x3Norm with a modulated deformable conv + GroupNorm. `radius`
    and `offset_compat` are the JAX module's (`TPU.DEFORM_RADIUS`,
    `TPU.DEFORM_OFFSET_COMPAT`)."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int, radius: int = 2,
                 offset_compat: str = "strided"):
        super().__init__()
        self.stride = stride
        self.radius = radius
        self.offset_compat = offset_compat
        self.conv = ModulatedDeformConv(cin, cout, stride)
        self.bn = GroupNorm(groups, cout)

    def forward(self, x, offset, mask):
        ho, wo = -(-x.shape[2] // self.stride), -(-x.shape[3] // self.stride)
        if offset.shape[1:3] != (ho, wo):
            prep = reinterpret_offsets_strided if self.offset_compat == "strided" else resize_offsets
            offset, mask = prep(offset, mask, ho, wo)
        return self.bn(self.conv(x, offset, mask, self.radius))


class DyConv(nn.Module):
    """For each level L: the scale-attention-weighted mean of conv_s1(L),
    conv_s2(L-1) and up(conv_s1(L+1)), all three with level L's offsets,
    then DYReLU. DyConv.0 runs over level L+1, DyConv.1 over L, DyConv.2
    (stride 2) over L-1."""

    def __init__(self, channels: int, gn_groups: int, radius: int = 2, offset_compat: str = "strided"):
        super().__init__()
        self.DyConv = nn.ModuleList(
            DeformConvGN(channels, channels, s, gn_groups, radius, offset_compat) for s in (1, 1, 2)
        )
        self.AttnConv = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, 1, 1), nn.ReLU())
        self.relu = DYReLU(channels)
        self.offset = nn.Conv2d(channels, 27, 3, padding=1)

    def _attn_weight(self, f):
        return h_sigmoid(F.relu(self.AttnConv[1](f.mean(dim=(2, 3), keepdim=True))))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        conv_hi, conv_mid, conv_lo = self.DyConv
        offsets, masks = [], []
        for f in feats:
            om = self.offset(f).permute(0, 2, 3, 1)  # (B, H, W, 27)
            offsets.append(om[..., :18].contiguous())
            masks.append(torch.sigmoid(om[..., 18:27]).contiguous())
        n = len(feats)
        outs = []
        for level, feature in enumerate(feats):
            temp = [conv_mid(feature, offsets[level], masks[level])]
            if level > 0:
                temp.append(conv_lo(feats[level - 1], offsets[level], masks[level]))
            if level < n - 1:
                hi = conv_hi(feats[level + 1], offsets[level], masks[level])
                temp.append(upsample_bilinear(hi, feature.shape[2], feature.shape[3]))
            acc = None
            for f in temp:
                f = f * self._attn_weight(f)
                acc = f if acc is None else acc + f
            outs.append(cl(self.relu(acc / len(temp))))
        return outs


class VLDyHead(nn.Module):
    """The fused head. forward returns per-level NCHW logits / bbox_reg /
    centerness, the (B, HW, T) fp32 dot-product logits and the fused text.
    With `remat` (the JAX package's `TPU.REMAT` rule, `models/mq_glip.py`)
    each stage's VLFuse, BertLayer and DyConv is one checkpointed segment
    (`layers.remat`) wherever autograd records the forward."""

    def __init__(self, cfg, remat: bool = False):
        super().__init__()
        self.remat = remat
        dy = cfg.MODEL.DYHEAD
        lb = cfg.MODEL.LANGUAGE_BACKBONE
        ch = cfg.MODEL.BACKBONE.OUT_CHANNELS
        fc = dy.FUSE_CONFIG
        if not (fc.TYPE == "MHA-B" and fc.EARLY_FUSE_ON and fc.USE_FUSED_FEATURES_DOT_PRODUCT
                and dy.USE_DFCONV and dy.USE_DYFUSE and dy.USE_DYRELU and not fc.MLM_LOSS
                and not fc.ADD_LINEAR_LAYER):
            raise NotImplementedError("only the MQ-GLIP-T head (MHA-B, DCN, DyFuse, DyReLU) is ported")
        self.num_convs = dy.NUM_CONVS
        tower = []
        for _ in range(self.num_convs):
            tower += [
                VLFuse(self.num_convs, ch, lb.LANG_DIM),
                BertLayer(lb.LANG_DIM, lb.NUM_HEADS, lb.INTERMEDIATE_SIZE),
                DyConv(ch, GN_GROUPS, cfg.TPU.DEFORM_RADIUS, cfg.TPU.DEFORM_OFFSET_COMPAT),
            ]
        self.dyhead_tower = nn.ModuleList(tower)
        num_classes = dy.NUM_CLASSES - 1
        self.cls_logits = nn.Conv2d(ch, num_classes, 1)
        self.bbox_pred = nn.Conv2d(ch, 4, 1)
        self.centerness = nn.Conv2d(ch, 1, 1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in cfg.MODEL.RPN.ANCHOR_STRIDE)
        self.dot_product_projection_text = nn.Linear(lb.LANG_DIM, ch)
        bias_value = -math.log((1 - dy.PRIOR_PROB) / dy.PRIOR_PROB)
        self.log_scale = nn.Parameter(torch.tensor([float(dy.LOG_SCALE)]))
        self.bias_lang = nn.Parameter(torch.zeros(lb.LANG_DIM))
        self.bias0 = nn.Parameter(torch.tensor([bias_value]))

    def forward(self, feats, lang_hidden, lang_masks, generator=None) -> Dict[str, object]:
        """`generator`: the fusion's training route (`models/fusion.py`)."""
        attn_bias = (1.0 - lang_masks[:, None, None, :].float()) * -10000.0
        visual = feats
        for i in range(self.num_convs):
            fuse, lang_layer, dyconv = self.dyhead_tower[3 * i : 3 * i + 3]
            visual, lang_hidden = remat(fuse, visual, lang_hidden, lang_masks, generator, enabled=self.remat,
                                        generator=generator)
            lang_hidden = remat(lang_layer, lang_hidden, attn_bias, enabled=self.remat)
            visual = remat(dyconv, visual, enabled=self.remat)

        emb = lang_hidden.float()
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        proj_text = self.dot_product_projection_text((emb / 2.0).to(lang_hidden.dtype)).float()
        dot_bias = emb @ self.bias_lang.float() + self.bias0.float()  # (B, T)
        inv_scale = torch.exp(-self.log_scale.float())

        logits, bbox_reg, centerness, dot_logits = [], [], [], []
        for level, x in enumerate(visual):
            b, c = x.shape[:2]
            logits.append(self.cls_logits(x))
            bbox_reg.append(self.scales[level](self.bbox_pred(x)))
            centerness.append(self.centerness(x))
            q = x.permute(0, 2, 3, 1).reshape(b, -1, c).float()
            dp = torch.matmul(q, proj_text.transpose(1, 2)) * inv_scale + dot_bias[:, None, :]
            dot_logits.append(dp.clamp(-50000.0, 50000.0))
        return {
            "logits": logits,
            "bbox_reg": bbox_reg,
            "centerness": centerness,
            "dot_product_logits": dot_logits,
            "fused_lang_hidden": lang_hidden,
        }
