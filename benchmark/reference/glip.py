"""The reference MQ-GLIP: Swin-T, FPN with P6/P7, GCP-BERT, the VLDyHead of
GLIP (Li et al. 2022) with MHA-B early fusion, BERT layers on the text and
DyHead convolutions (Dai et al. 2021) on modulated deformable convs, then
ATSS decoding (Zhang et al. 2020) with class-aware NMS, in plain float32
PyTorch. Module names are the released checkpoints'.

Stated choices of the configuration that the reference computes as well:
the deformable offsets are clamped to +-`deform_radius` (the program's
default route), an offset field predicted on level L and applied to the
conv over level L+1 is read as the original CUDA kernel reads it
(`ops.strided_misread`), and class scores are the MEAN of the token
probabilities over each class's tokens.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.towers import (BertLayer, Conv2d, LayerNorm, Linear, QVBert, Swin, group_norm)

GN_GROUPS = 16


class _P6P7(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.p6, self.p7 = Conv2d(c, c, 3, 2, 1), Conv2d(c, c, 3, 2, 1)


class FPN(nn.Module):
    def __init__(self, in_channels, c):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 2}", Conv2d(cin, c, 1))
            self.add_module(f"fpn_layer{i + 2}", Conv2d(c, c, 3, 1, 1))
        self.top_blocks = _P6P7(c)
        self.n = len(in_channels)

    def forward(self, feats):
        lat = [getattr(self, f"fpn_inner{i + 2}")(f) for i, f in enumerate(feats)]
        merged = [lat[-1]]
        for i in range(self.n - 2, -1, -1):
            h, w = lat[i].shape[2:]
            merged.insert(0, lat[i] + F.interpolate(merged[0], scale_factor=2, mode="nearest")[:, :, :h, :w])
        outs = [getattr(self, f"fpn_layer{i + 2}")(m) for i, m in enumerate(merged)]
        p6 = self.top_blocks.p6(outs[-1])
        return outs + [p6, self.top_blocks.p7(F.relu(p6))]


class _Backbone(nn.Module):
    def __init__(self, s):
        super().__init__()
        e = s["swin_dim"]
        self.body = Swin(e, s["swin_depths"], s["swin_heads"], s["swin_window"])
        self.fpn = FPN([2 * e, 4 * e, 8 * e], s["channels"])


class _Body(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.model = QVBert(s, s["channels"])


class _Language(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.body = _Body(s)


class _BiAttn(nn.Module):
    def __init__(self, v, l, e, heads):
        super().__init__()
        self.heads, self.head_dim = heads, e // heads
        self.v_proj, self.l_proj = Linear(v, e), Linear(l, e)
        self.values_v_proj, self.values_l_proj = Linear(v, e), Linear(l, e)
        self.out_v_proj, self.out_l_proj = Linear(e, v), Linear(e, l)


class BiAttentionBlock(nn.Module):
    """LayerNorm both sides, one bi-attention, and the layer-scaled update
    added to the NORMED inputs."""

    def __init__(self, v, l, e, heads):
        super().__init__()
        self.layer_norm_v, self.layer_norm_l = LayerNorm(v, eps=1e-5), LayerNorm(l, eps=1e-5)
        self.attn = _BiAttn(v, l, e, heads)
        self.gamma_v, self.gamma_l = nn.Parameter(torch.ones(v)), nn.Parameter(torch.ones(l))

    def forward(self, v, lang, mask):
        vn, ln = self.layer_norm_v(v), self.layer_norm_l(lang)
        a = self.attn
        dv, dl = ops.bi_attention(a.v_proj(vn) * a.head_dim**-0.5, a.l_proj(ln), a.values_v_proj(vn),
                                  a.values_l_proj(ln), mask, a.heads)
        return vn + self.gamma_v * a.out_v_proj(dv), ln + self.gamma_l * a.out_l_proj(dl)


class VLFuse(nn.Module):
    def __init__(self, v, l):
        super().__init__()
        self.b_attn = BiAttentionBlock(v, l, 2048, 8)

    def forward(self, levels, lang, mask):
        shapes = [f.shape for f in levels]
        tokens = torch.cat([f.flatten(2).transpose(1, 2) for f in levels], 1)
        v, lang = self.b_attn(tokens, lang, mask)
        out, start = [], 0
        for b, c, h, w in shapes:
            out.append(v[:, start:start + h * w].transpose(1, 2).reshape(b, c, h, w))
            start += h * w
        return out, lang


class _DCN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c, c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c))


class Norm(nn.Module):
    """A GroupNorm's affine parameters."""

    def __init__(self, c):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.ones(c)), nn.Parameter(torch.zeros(c))


class DeformConvGN(nn.Module):
    def __init__(self, c, stride, radius):
        super().__init__()
        self.stride, self.radius = stride, radius
        self.conv, self.bn = _DCN(c), Norm(c)

    def forward(self, x, offset, mask):
        ho, wo = -(-x.shape[2] // self.stride), -(-x.shape[3] // self.stride)
        if offset.shape[2:] != (ho, wo):
            offset, mask = ops.strided_misread(offset, ho, wo), ops.strided_misread(mask, ho, wo)
        y = ops.deform_conv(x, offset, mask, self.conv.weight, self.conv.bias, self.stride, self.radius)
        return group_norm(y, GN_GROUPS, self.bn.weight, self.bn.bias)


class DYReLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        self.fc = nn.Sequential(Linear(c, c // 4), nn.ReLU(), Linear(c // 4, 4 * c))

    def forward(self, x):
        theta = torch.clamp(self.fc(x.mean(dim=(2, 3))) + 3.0, 0.0, 6.0) / 6.0
        a1, b1, a2, b2 = (t[:, :, None, None] for t in theta.split(self.c, -1))
        return torch.maximum(x * ((a1 - 0.5) * 2 + 1) + (b1 - 0.5), x * ((a2 - 0.5) * 2) + (b2 - 0.5))


class DyConv(nn.Module):
    """Per level L: the scale-attention-weighted mean of conv_s1(L),
    conv_s2(L-1) and the upsampled conv_s1(L+1), each with level L's offsets
    and masks, then dynamic ReLU."""

    def __init__(self, c, radius):
        super().__init__()
        self.DyConv = nn.ModuleList(DeformConvGN(c, s, radius) for s in (1, 1, 2))
        self.AttnConv = nn.Sequential(nn.Identity(), Conv2d(c, 1, 1))
        self.relu = DYReLU(c)
        self.offset = Conv2d(c, 27, 3, 1, 1)

    def forward(self, feats):
        hi, mid, lo = self.DyConv
        om = [self.offset(f) for f in feats]
        offs = [o[:, :18] for o in om]
        masks = [torch.sigmoid(o[:, 18:]) for o in om]
        outs = []
        n = len(feats)
        for lvl, f in enumerate(feats):
            temp = [mid(f, offs[lvl], masks[lvl])]
            if lvl > 0:
                temp.append(lo(feats[lvl - 1], offs[lvl], masks[lvl]))
            if lvl < n - 1:
                up = hi(feats[lvl + 1], offs[lvl], masks[lvl])
                temp.append(F.interpolate(up, size=f.shape[2:], mode="bilinear", align_corners=True))
            acc = 0.0
            for t in temp:
                wgt = F.relu(self.AttnConv[1](t.mean(dim=(2, 3), keepdim=True)))
                acc = acc + t * torch.clamp(wgt + 3.0, 0.0, 6.0) / 6.0
            outs.append(self.relu(acc / len(temp)))
        return outs


class _Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))


class VLDyHead(nn.Module):
    def __init__(self, s):
        super().__init__()
        c, l = s["channels"], s["hidden"]
        tower = []
        for _ in range(s["head_stages"]):
            tower += [VLFuse(c, l), BertLayer(l, s["heads"], s["intermediate"]), DyConv(c, s["deform_radius"])]
        self.dyhead_tower = nn.ModuleList(tower)
        self.bbox_pred, self.centerness = Conv2d(c, 4, 1), Conv2d(c, 1, 1)
        self.scales = nn.ModuleList(_Scale() for _ in s["anchor_strides"])
        self.dot_product_projection_text = Linear(l, c)
        self.log_scale = nn.Parameter(torch.zeros(1))
        self.bias_lang = nn.Parameter(torch.zeros(l))
        self.bias0 = nn.Parameter(torch.zeros(1))

    def forward(self, feats, lang, mask):
        bias = (1.0 - mask[:, None, None, :].float()) * -10000.0
        for i in range(len(self.dyhead_tower) // 3):
            fuse, layer, dyconv = self.dyhead_tower[3 * i:3 * i + 3]
            feats, lang = fuse(feats, lang, mask)
            lang = layer(lang, bias)
            feats = dyconv(feats)
        emb = lang / lang.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        proj = self.dot_product_projection_text(emb / 2.0)
        dot_bias = ops.matmul(emb, self.bias_lang) + self.bias0
        out = {"bbox_reg": [], "centerness": [], "dot": []}
        for lvl, x in enumerate(feats):
            out["bbox_reg"].append(self.bbox_pred(x) * self.scales[lvl].scale)
            out["centerness"].append(self.centerness(x))
            tokens = x.flatten(2).transpose(1, 2)
            dot = ops.matmul(tokens, proj.transpose(1, 2)) * torch.exp(-self.log_scale) + dot_bias[:, None, :]
            out["dot"].append(dot.clamp(-50000.0, 50000.0))
        return out


class _RPN(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.head = VLDyHead(s)


class MQGLIP(nn.Module):
    """The model of one configuration file's `sizes`."""

    def __init__(self, s):
        super().__init__()
        self.s = s
        self.backbone = _Backbone(s)
        self.language_backbone = _Language(s)
        self.rpn = _RPN(s)

    def encode_image(self, images):
        return self.backbone.fpn(self.backbone.body(images)[1:4])

    def forward_head(self, feats, ids, mask, queries, query_mask):
        pooled = [F.avg_pool2d(f, 2, 2) if min(f.shape[2:]) >= 2 else f[:, :, :0, :0] for f in feats]
        image_tokens = torch.cat([p.flatten(2).transpose(1, 2) for p in pooled], 1)
        lang = self.language_backbone.body.model(ids, mask, queries.float(), query_mask, image_tokens)
        return self.rpn.head(feats, lang, mask)


def dense_scores(head: Dict[str, List[torch.Tensor]], anchors, agg_map, image_hw):
    """Every anchor's decoded, clipped box and every class's score, as ATSS
    ranks them: boxes (B, A, 4), scores (B, A, C) = sqrt(mean token
    probability over the class's tokens * sigmoid(centerness)), and the
    aggregated probabilities (B, A, C) that the pre-NMS threshold reads."""
    h, w = image_hw
    b = head["dot"][0].shape[0]
    boxes, scores, probs = [], [], []
    for reg, ctr, dot, anc in zip(head["bbox_reg"], head["centerness"], head["dot"], anchors):
        p = torch.matmul(torch.sigmoid(dot.float()), agg_map.float().transpose(1, 2))
        probs.append(p)
        scores.append(torch.sqrt((p * torch.sigmoid(ctr.float().reshape(b, -1, 1))).clamp(min=0)))
        deltas = reg.float().permute(0, 2, 3, 1).reshape(b, -1, 4)
        boxes.append(ops.clip_boxes(ops.decode(deltas, anc[None]), h, w))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(probs, 1)


def postprocess(boxes, scores, probs, level_sizes, p):
    """ATSS's selection for one item: per level the `pre_nms_top_n` best
    (anchor, class) pairs whose probability passes `pre_nms_thresh`, then
    class-aware NMS, at most `detections_per_img`. Returns (boxes (K, 4),
    scores (K,), labels (K,) 1-based)."""
    cand_b, cand_s, cand_l = [], [], []
    start = 0
    for n in level_sizes:
        s = scores[start:start + n]
        ok = probs[start:start + n] > p["pre_nms_thresh"]
        flat = torch.where(ok, s, torch.full_like(s, -1.0)).reshape(-1)
        k = min(p["pre_nms_top_n"], flat.numel())
        top, idx = torch.sort(flat, descending=True, stable=True)
        top, idx = top[:k], idx[:k]
        keep = top >= 0
        top, idx = top[keep], idx[keep]
        nc = s.shape[1]
        cand_b.append(boxes[start + idx // nc])
        cand_s.append(top)
        cand_l.append(idx % nc + 1)
        start += n
    b, s, lab = torch.cat(cand_b), torch.cat(cand_s), torch.cat(cand_l)
    keep = ops.greedy_nms(b, s, lab, p["nms_thresh"], p["detections_per_img"])
    return b[keep], s[keep], lab[keep]
