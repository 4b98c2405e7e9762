"""VLDyHead, GLIP's fused dynamic head (counterpart of
`mqdet_tpu/models/vldyhead.py`; reference modeling/rpn/vldyhead.py).

NUM_CONVS stages of [fusion (FUSE_CONFIG.TYPE: MHA-B bi-attention, MHA-S,
SCAN or FILM) -> BertLayer (text self attention) -> DyConv (three modulated
deformable convs + scale attention + DYReLU)], then the cls / bbox /
centerness convs and the dot-product token head with its +-50000 clip.
`dyhead_tower` holds the stages at the reference's indices 3i, 3i+1, 3i+2,
so the state_dict keys are those of the rule table; a module the switches
leave out (EARLY_FUSE_ON off: the fusion and the BertLayer; the last
stage's BertLayer without USE_FUSED_FEATURES_DOT_PRODUCT) keeps its index as
an `nn.Identity`. The other switches are the JAX module's: USE_DFCONV off
gives each DyConv plain 3x3 GN convs (no DCN kernel), USE_DYFUSE off drops
the scale attention, USE_DYRELU off takes a ReLU; ADD_LINEAR_LAYER adds the
zero-init `tunable_linear` prompt (1000, lang_dim) to the text stream and to
the embedding; QUERY_FUSION injects the PreSelect-augmented queries into the
text with one GCP block (no FFN) before the tower; MLM_LOSS adds the MLM
head on the dot product's embedding (`mlm_logits`).

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
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.bert import BertLayer, GatedCrossAttentionBlock, MLMHead
from mqdet_torch.models.fusion import FILMFuse, SCANFuse, T2IFuse, VLFuse
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


class PlainConvGN(nn.Module):
    """Conv3x3Norm without DCN (USE_DFCONV off): a 3x3 conv + GroupNorm."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding=1)
        self.bn = GroupNorm(groups, cout)

    def forward(self, x, offset=None, mask=None):
        return self.bn(self.conv(x))


class DyConv(nn.Module):
    """For each level L: the scale-attention-weighted mean of conv_s1(L),
    conv_s2(L-1) and up(conv_s1(L+1)), all three with level L's offsets,
    then DYReLU. DyConv.0 runs over level L+1, DyConv.1 over L, DyConv.2
    (stride 2) over L-1. `use_deform` / `use_dyfuse` / `use_dyrelu` off:
    plain GN convs (no offsets), an unweighted mean, a ReLU."""

    def __init__(self, channels: int, gn_groups: int, radius: int = 2, offset_compat: str = "strided",
                 in_channels: Optional[int] = None, use_deform: bool = True, use_dyfuse: bool = True,
                 use_dyrelu: bool = True):
        super().__init__()
        cin = in_channels or channels
        self.use_deform = use_deform
        # the reference's registration order (DyConv, AttnConv, relu, offset): `init_params` draws in it
        if use_deform:
            self.DyConv = nn.ModuleList(
                DeformConvGN(cin, channels, s, gn_groups, radius, offset_compat) for s in (1, 1, 2)
            )
        else:
            self.DyConv = nn.ModuleList(PlainConvGN(cin, channels, s, gn_groups) for s in (1, 1, 2))
        if use_dyfuse:
            self.AttnConv = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, 1, 1), nn.ReLU())
        else:
            self.AttnConv = None
        self.relu = DYReLU(channels) if use_dyrelu else None
        self.offset = nn.Conv2d(cin, 27, 3, padding=1) if use_deform else None

    def _attn_weight(self, f):
        return h_sigmoid(F.relu(self.AttnConv[1](f.mean(dim=(2, 3), keepdim=True))))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        conv_hi, conv_mid, conv_lo = self.DyConv
        n = len(feats)
        offsets, masks = [None] * n, [None] * n
        if self.use_deform:
            for i, f in enumerate(feats):
                om = self.offset(f).permute(0, 2, 3, 1)  # (B, H, W, 27)
                offsets[i] = om[..., :18].contiguous()
                masks[i] = torch.sigmoid(om[..., 18:27]).contiguous()
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
                if self.AttnConv is not None:
                    f = f * self._attn_weight(f)
                acc = f if acc is None else acc + f
            mean = acc / len(temp)
            outs.append(cl(self.relu(mean) if self.relu is not None else F.relu(mean)))
        return outs


class VLDyHead(nn.Module):
    """The fused head. forward returns per-level NCHW logits / bbox_reg /
    centerness, the (B, HW, T) fp32 dot-product logits, the fused text and,
    under MLM_LOSS, `mlm_logits` (B, T, vocab). With `remat` (the JAX
    package's `TPU.REMAT` rule, `models/mq_glip.py`) each stage's MHA-B
    VLFuse, BertLayer and DyConv is one checkpointed segment
    (`layers.remat`) wherever autograd records the forward; MHA-S, SCAN and
    FILM are not, as in JAX."""

    def __init__(self, cfg, remat: bool = False):
        super().__init__()
        self.remat = remat
        dy = cfg.MODEL.DYHEAD
        lb = cfg.MODEL.LANGUAGE_BACKBONE
        ch = cfg.MODEL.BACKBONE.OUT_CHANNELS
        fc = dy.FUSE_CONFIG
        if fc.TYPE not in ("MHA-B", "MHA-S", "SCAN", "FILM"):
            raise NotImplementedError(f"FUSE_CONFIG.TYPE {fc.TYPE}")
        self.fuse_type, self.early_fuse = fc.TYPE, bool(fc.EARLY_FUSE_ON)
        self.use_fused_dot_product = bool(fc.USE_FUSED_FEATURES_DOT_PRODUCT)
        self.num_convs = dy.NUM_CONVS
        levels = len(cfg.MODEL.RPN.ANCHOR_STRIDE)
        # SCAN and FILM hand DyConv 256 channels whatever the head's width (the JAX modules' out_dim)
        dy_in = 256 if self.early_fuse and fc.TYPE in ("SCAN", "FILM") else ch
        tower = []
        for i in range(self.num_convs):
            fuse = lang = nn.Identity()
            if self.early_fuse:
                fuse = {
                    "MHA-B": lambda: VLFuse(self.num_convs, ch, lb.LANG_DIM),
                    "MHA-S": lambda: T2IFuse(self.num_convs, ch, lb.LANG_DIM, bool(fc.USE_LAYER_SCALE)),
                    "SCAN": lambda: SCANFuse(levels, lb.LANG_DIM),
                    "FILM": lambda: FILMFuse(levels, ch, lb.LANG_DIM),
                }[fc.TYPE]()
                if i < self.num_convs - 1 or self.use_fused_dot_product:
                    lang = BertLayer(lb.LANG_DIM, lb.NUM_HEADS, lb.INTERMEDIATE_SIZE)
            tower += [
                fuse, lang,
                DyConv(ch, GN_GROUPS, cfg.TPU.DEFORM_RADIUS, cfg.TPU.DEFORM_OFFSET_COMPAT, dy_in,
                       bool(dy.USE_DFCONV), bool(dy.USE_DYFUSE), bool(dy.USE_DYRELU)),
            ]
        self.dyhead_tower = nn.ModuleList(tower)
        self.tunable_linear = nn.Linear(lb.LANG_DIM, 1000, bias=False) if fc.ADD_LINEAR_LAYER else None
        if self.tunable_linear is not None:
            nn.init.zeros_(self.tunable_linear.weight)
        self.query_fuse_qv_layer = (
            GatedCrossAttentionBlock(lb.LANG_DIM, lb.HIDDEN_SIZE, enable_ffn=False)
            if cfg.VISION_QUERY.QUERY_FUSION else None
        )
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
        self.mlm_head = MLMHead(lb.LANG_DIM, lb.VOCAB_SIZE) if fc.MLM_LOSS else None

    def forward(self, feats, lang_hidden, lang_masks, generator=None, embedding=None, augmented_vision=None,
                query_mask=None, lang_aggregate=None) -> Dict[str, object]:
        """`generator`: the fusion's training route (`models/fusion.py`).
        `embedding`: the language tower's masked mean features, which the dot
        product reads without USE_FUSED_FEATURES_DOT_PRODUCT;
        `augmented_vision` / `query_mask`: QUERY_FUSION's inputs;
        `lang_aggregate`: SCAN's and FILM's."""
        attn_bias = (1.0 - lang_masks[:, None, None, :].float()) * -10000.0
        if self.tunable_linear is not None:
            t = lang_hidden.shape[1]
            prompt = self.tunable_linear.weight[None, :t]
            lang_hidden = lang_hidden + prompt.to(lang_hidden.dtype)
            if embedding is not None:
                embedding = embedding + prompt.to(embedding.dtype)
        if self.query_fuse_qv_layer is not None and augmented_vision is not None:
            lang_hidden = self.query_fuse_qv_layer(lang_hidden, augmented_vision.to(lang_hidden.dtype), query_mask)
        visual = feats
        for i in range(self.num_convs):
            fuse, lang_layer, dyconv = self.dyhead_tower[3 * i : 3 * i + 3]
            if self.early_fuse:
                if self.fuse_type == "MHA-B":
                    visual, lang_hidden = remat(fuse, visual, lang_hidden, lang_masks, generator,
                                                enabled=self.remat, generator=generator)
                elif self.fuse_type == "MHA-S":
                    visual, lang_hidden = fuse(visual, lang_hidden, lang_masks, generator)
                else:
                    visual = fuse(visual, lang_aggregate, generator)
                if not isinstance(lang_layer, nn.Identity):
                    lang_hidden = remat(lang_layer, lang_hidden, attn_bias, enabled=self.remat)
            visual = remat(dyconv, visual, enabled=self.remat)

        if self.use_fused_dot_product:
            embedding = lang_hidden
        emb = embedding.float()
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        proj_text = self.dot_product_projection_text((emb / 2.0).to(embedding.dtype)).float()
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
        out = {
            "logits": logits,
            "bbox_reg": bbox_reg,
            "centerness": centerness,
            "dot_product_logits": dot_logits,
            "fused_lang_hidden": lang_hidden,
        }
        if self.mlm_head is not None:
            out["mlm_logits"] = self.mlm_head(embedding)
        return out
