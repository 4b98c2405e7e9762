"""Deep early fusion between the image pyramid and the text (MHA-B), eval
only (counterpart of `mqdet_tpu/models/fusion.py`; reference
utils/fuse_helper.py BiMultiHeadAttention / BiAttentionBlockForCheckpoint).

The pyramid is concatenated into one visual sequence and one bidirectional
cross-attention updates both modalities, through `ops.bi_attention.
flash_bi_attention` (the CUDA kernel on the card, the plain version on the
CPU). q is pre-scaled by d^-0.5; the layer-scale residual is added to the
NORMED inputs, as in the reference.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from mqdet_torch.models.layers import LayerNorm, cl
from mqdet_torch.ops.bi_attention import flash_bi_attention


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int = 2048, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def forward(self, v, l, attention_mask_l=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """v: (B, N, v_dim); l: (B, T, l_dim); attention_mask_l: (B, T) 1 = valid."""
        q = self.v_proj(v) * self.head_dim**-0.5
        vv = self.values_v_proj(v)
        k = self.l_proj(l)
        vl = self.values_l_proj(l)
        bias = None
        if attention_mask_l is not None:
            bias = torch.where(attention_mask_l == 0, -9e15, 0.0).float()
        out_v, out_l = flash_bi_attention(q, k, vv, vl, bias, self.num_heads)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    def __init__(self, v_dim, l_dim, embed_dim=2048, num_heads=8, init_value=1.0 / 6):
        super().__init__()
        self.layer_norm_v = LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_value))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_value))

    def forward(self, v, l, attention_mask_l=None):
        vn = self.layer_norm_v(v)
        ln = self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, attention_mask_l)
        return vn + self.gamma_v.to(dv.dtype) * dv, ln + self.gamma_l.to(dl.dtype) * dl


class VLFuse(nn.Module):
    """One early-fusion stage: the levels (B, C, H_l, W_l) form one visual
    sequence of sum(H_l W_l) tokens for a single bi-attention."""

    def __init__(self, num_convs: int, v_dim: int, l_dim: int):
        super().__init__()
        self.b_attn = BiAttentionBlock(v_dim, l_dim, init_value=1.0 / num_convs)

    def forward(self, visual: List[torch.Tensor], lang_hidden, lang_masks):
        shapes = [f.shape for f in visual]
        tokens = torch.cat([f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, f.shape[1]) for f in visual], 1)
        new_v, new_l = self.b_attn(tokens, lang_hidden, lang_masks)
        outs, start = [], 0
        for b, c, h, w in shapes:
            outs.append(cl(new_v[:, start : start + h * w].reshape(b, h, w, c).permute(0, 3, 1, 2)))
            start += h * w
        return outs, new_l
