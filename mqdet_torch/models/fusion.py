"""Deep early fusion between the image pyramid and the text (MHA-B), eval
only (counterpart of `mqdet_tpu/models/fusion.py`; reference
utils/fuse_helper.py BiMultiHeadAttention / BiAttentionBlockForCheckpoint).

The pyramid's levels are passed as a list of (B, H_l W_l, C) token views and
one bidirectional cross-attention over all their tokens updates both
modalities. `MQDET_FLASH_LEVELS` (read at call time) picks how, as in the
JAX package: `concat` (the default) concatenates the normed levels inside
`BiMultiHeadAttention` and runs `ops.bi_attention.flash_bi_attention` (which
reads `MQDET_FLASH_SCORES`: `dual` selects the dual-score kernel); any other
value streams the levels through `flash_bi_attention_levels`, one launch per
level with the l-side softmax state carried between them, without
concatenating the pyramid or splitting out_v (single-score only, so `dual`
is ignored there). A single (B, N, C) tensor always takes
`flash_bi_attention`. q is pre-scaled by d^-0.5; the layer-scale residual is
added to the NORMED inputs, as in the reference.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from mqdet_torch.models.layers import LayerNorm, cl
from mqdet_torch.ops.bi_attention import flash_bi_attention, flash_bi_attention_levels

Visual = Union[torch.Tensor, Sequence[torch.Tensor]]


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

    def forward(self, v: Visual, l, attention_mask_l=None) -> Tuple[Visual, torch.Tensor]:
        """v: (B, N, v_dim) or a list of per-level (B, N_l, v_dim), returned
        in the same form; l: (B, T, l_dim); attention_mask_l: (B, T) 1 = valid."""
        scale = self.head_dim**-0.5
        k = self.l_proj(l)
        vl = self.values_l_proj(l)
        bias = None
        if attention_mask_l is not None:
            bias = torch.where(attention_mask_l == 0, -9e15, 0.0).float()
        if isinstance(v, torch.Tensor) or os.environ.get("MQDET_FLASH_LEVELS", "concat") == "concat":
            flat = v if isinstance(v, torch.Tensor) else torch.cat(list(v), 1)
            out_v, out_l = flash_bi_attention(
                self.v_proj(flat) * scale, k, self.values_v_proj(flat), vl, bias, self.num_heads
            )
            out_v = self.out_v_proj(out_v)
            if not isinstance(v, torch.Tensor):
                out_v = list(out_v.split([x.shape[1] for x in v], 1))
            return out_v, self.out_l_proj(out_l)
        qs = [self.v_proj(x) * scale for x in v]
        vvs = [self.values_v_proj(x) for x in v]
        out_vs, out_l = flash_bi_attention_levels(qs, k, vvs, vl, bias, self.num_heads)
        return [self.out_v_proj(x) for x in out_vs], self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    def __init__(self, v_dim, l_dim, embed_dim=2048, num_heads=8, init_value=1.0 / 6):
        super().__init__()
        self.layer_norm_v = LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_value))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_value))

    def forward(self, v: Visual, l, attention_mask_l=None):
        """v: one (B, N, C) tensor or a per-level list; the return matches."""
        is_list = not isinstance(v, torch.Tensor)
        vn = [self.layer_norm_v(x) for x in v] if is_list else self.layer_norm_v(v)
        ln = self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, attention_mask_l)
        if is_list:
            v = [a + self.gamma_v.to(d.dtype) * d for a, d in zip(vn, dv)]
        else:
            v = vn + self.gamma_v.to(dv.dtype) * dv
        return v, ln + self.gamma_l.to(dl.dtype) * dl


class VLFuse(nn.Module):
    """One early-fusion stage: the levels (B, C, H_l, W_l), channels_last,
    go to the bi-attention as (B, H_l W_l, C) token views (no copy)."""

    def __init__(self, num_convs: int, v_dim: int, l_dim: int):
        super().__init__()
        self.b_attn = BiAttentionBlock(v_dim, l_dim, init_value=1.0 / num_convs)

    def forward(self, visual: List[torch.Tensor], lang_hidden, lang_masks):
        tokens = [f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, f.shape[1]) for f in visual]
        new_v, new_l = self.b_attn(tokens, lang_hidden, lang_masks)
        outs = [
            cl(t.reshape(b, h, w, c).permute(0, 3, 1, 2))
            for t, (b, c, h, w) in zip(new_v, (f.shape for f in visual))
        ]
        return outs, new_l
