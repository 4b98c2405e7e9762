"""Deep early fusion between the image pyramid and the text (MHA-B)
(counterpart of `mqdet_tpu/models/fusion.py`; reference
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
`flash_bi_attention`. `MQDET_FUSION_IMPL` (read at call time, the JAX
package's switch) set to anything other than `pallas`, its default, takes
the kernels off the path: the same calls run their plain versions on any
device (`ops.kernels.plain_versions`), no launch counted, as JAX then runs
its composite. It is a switch the user sets, not a fallback. q is
pre-scaled by d^-0.5; the layer-scale residual is added to the NORMED
inputs, as in the reference.

Training follows the JAX package's `use_flash` rule: the flash kernels run
only when the forward is deterministic; given a generator (the JAX
package's `deterministic=False`) the fusion runs the JAX composite,
`bi_attention_dual_plain` (both score products in the compute dtype, fp32
softmaxes) with attention dropout (`dropout`, 0.1) on both probability
tensors, which PyTorch autograd differentiates. The kernels' launchers
refuse a forward that needs a gradient, so the eval route never cuts the
graph silently.

The other fuse types (`FUSE_CONFIG.TYPE`, the JAX module's): MHA-S
(`T2IFuse`, text -> image only), SCAN and FILM (`SCANFuse`, `FILMFuse`, from
the pooled language aggregate, with evaluation-only BatchNorms). None of
them launches a hand-written kernel: in JAX they are plain XLA.
"""
from __future__ import annotations

import os
from contextlib import nullcontext
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import LayerNorm, cl, dropout
from mqdet_torch.ops.bi_attention import bi_attention_dual_plain, flash_bi_attention, flash_bi_attention_levels
from mqdet_torch.ops.kernels import plain_versions

Visual = Union[torch.Tensor, Sequence[torch.Tensor]]


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int = 2048, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout  # attention dropout of the training composite
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def forward(self, v: Visual, l, attention_mask_l=None, generator=None) -> Tuple[Visual, torch.Tensor]:
        """v: (B, N, v_dim) or a list of per-level (B, N_l, v_dim), returned
        in the same form; l: (B, T, l_dim); attention_mask_l: (B, T) 1 = valid.
        With a generator: the training composite (module docstring)."""
        scale = self.head_dim**-0.5
        k = self.l_proj(l)
        vl = self.values_l_proj(l)
        bias = None
        if attention_mask_l is not None:
            bias = torch.where(attention_mask_l == 0, -9e15, 0.0).float()
        if generator is not None:
            flat = v if isinstance(v, torch.Tensor) else torch.cat(list(v), 1)
            out_v, out_l = bi_attention_dual_plain(
                self.v_proj(flat) * scale, k, self.values_v_proj(flat), vl, bias, self.num_heads,
                drop=lambda p: dropout(p, self.dropout, generator),
            )
            out_v = self.out_v_proj(out_v)
            if not isinstance(v, torch.Tensor):
                out_v = list(out_v.split([x.shape[1] for x in v], 1))
            return out_v, self.out_l_proj(out_l)
        # MQDET_FUSION_IMPL other than `pallas` (JAX's default): the composite, i.e. no kernel
        route = nullcontext() if os.environ.get("MQDET_FUSION_IMPL", "pallas") == "pallas" else plain_versions()
        with route:
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

    def forward(self, v: Visual, l, attention_mask_l=None, generator=None):
        """v: one (B, N, C) tensor or a per-level list; the return matches."""
        is_list = not isinstance(v, torch.Tensor)
        vn = [self.layer_norm_v(x) for x in v] if is_list else self.layer_norm_v(v)
        ln = self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, attention_mask_l, generator)
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

    def forward(self, visual: List[torch.Tensor], lang_hidden, lang_masks, generator=None):
        tokens = [f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, f.shape[1]) for f in visual]
        new_v, new_l = self.b_attn(tokens, lang_hidden, lang_masks, generator)
        outs = [
            cl(t.reshape(b, h, w, c).permute(0, 3, 1, 2))
            for t, (b, c, h, w) in zip(new_v, (f.shape for f in visual))
        ]
        return outs, new_l


# --- the other fuse types (FUSE_CONFIG.TYPE; JAX `fusion.py:269-471`) -----


def flatten_levels(visual: List[torch.Tensor]) -> torch.Tensor:
    """[(B, C, H_l, W_l)] -> (B, sum(H_l W_l), C) tokens."""
    return torch.cat([f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, f.shape[1]) for f in visual], 1)


def unflatten_levels(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """The inverse of `flatten_levels` for the levels' NCHW `shapes`."""
    outs, start = [], 0
    for b, c, h, w in shapes:
        outs.append(cl(flat[:, start:start + h * w].reshape(b, h, w, c).permute(0, 3, 1, 2)))
        start += h * w
    return outs


class MultiHeadCrossAttention(nn.Module):
    """fuse_helper.py MultiHeadAttention (:430-552): q -> kv cross-attention
    with pre-scaled queries and the text mask as a -9e15 bias; the scores in
    the compute dtype, the softmax in fp32."""

    def __init__(self, q_dim: int, k_dim: int, embed_dim: int = 2048, num_heads: int = 8):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, embed_dim // num_heads
        self.q_proj = nn.Linear(q_dim, embed_dim)
        self.k_proj = nn.Linear(k_dim, embed_dim)
        self.v_proj = nn.Linear(k_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, q_dim)

    def forward(self, q_in, k_in, v_in, attention_mask=None):
        h, d = self.num_heads, self.head_dim
        b, n, _ = q_in.shape
        t = k_in.shape[1]
        q = (self.q_proj(q_in) * d**-0.5).reshape(b, n, h, d).transpose(1, 2)
        k = self.k_proj(k_in).reshape(b, t, h, d).transpose(1, 2)
        v = self.v_proj(v_in).reshape(b, t, h, d).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2))  # (B, h, N, T)
        if attention_mask is not None:
            s = s + torch.where(attention_mask[:, None, None, :] == 0, -9e15, 0.0).to(s.dtype)
        e = torch.exp((s - s.amax(-1, keepdim=True)).float())
        p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, n, h * d)
        return self.out_proj(out)


class AttentionT2I(nn.Module):
    """fuse_helper.py AttentionT2I (:559-640): pre-LN on the image tokens and
    on the text, one text -> image cross-attention, the residual on the
    NORMED image tokens, times `gamma` (1 / NUM_CONVS at init) under
    FUSE_CONFIG.USE_LAYER_SCALE."""

    def __init__(self, num_convs: int, v_dim: int, l_dim: int, embed_dim: int = 2048, num_heads: int = 8,
                 use_layer_scale: bool = True):
        super().__init__()
        self.layer_norm_q_1 = LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_k_1 = LayerNorm(l_dim, eps=1e-5)
        self.attn = MultiHeadCrossAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma = nn.Parameter(torch.full((v_dim,), 1.0 / num_convs)) if use_layer_scale else None

    def forward(self, flat, lang_hidden, lang_masks):
        q = self.layer_norm_q_1(flat)
        kv = self.layer_norm_k_1(lang_hidden)
        delta = self.attn(q, kv, kv, lang_masks)
        return q + (self.gamma.to(delta.dtype) * delta if self.gamma is not None else delta)


class T2IFuse(nn.Module):
    """FUSE_CONFIG.TYPE "MHA-S": text -> image fusion only. The reference
    applies one AttentionT2I per level with the same parameters and per-token
    pre-LN, so the five levels flattened into one sequence are the same
    function (JAX's form). The text passes through unchanged."""

    def __init__(self, num_convs: int, v_dim: int, l_dim: int, use_layer_scale: bool = True):
        super().__init__()
        self.t2i_attn = AttentionT2I(num_convs, v_dim, l_dim, use_layer_scale=use_layer_scale)

    def forward(self, visual: List[torch.Tensor], lang_hidden, lang_masks, generator=None):
        out = self.t2i_attn(flatten_levels(visual), lang_hidden, lang_masks)
        return unflatten_levels(out, [f.shape for f in visual]), lang_hidden


def make_coord_channels(b: int, h: int, w: int, dtype, device) -> torch.Tensor:
    """fuse_helper.py _make_coord (:87-103) as the JAX package computes it:
    8 relative-position channels (x_min, y_min, x_max, y_max, x_ctr, y_ctr,
    1/h, 1/w), (B, 8, H, W). JAX's meshgrid(arange(h), arange(w),
    indexing="ij") puts the ROW index in `xv` and divides it by w (and the
    column index by h); the port copies that on purpose (ROADMAP, the
    differences reproduced on purpose)."""
    xv, yv = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    xv_min, yv_min = (xv * 2 - w) / w, (yv * 2 - h) / h
    xv_max, yv_max = ((xv + 1) * 2 - w) / w, ((yv + 1) * 2 - h) / h
    coord = torch.stack([
        xv_min, yv_min, xv_max, yv_max, (xv_min + xv_max) / 2, (yv_min + yv_max) / 2,
        torch.full((h, w), 1.0 / h, device=device), torch.full((h, w), 1.0 / w, device=device),
    ], 0).to(dtype)
    return coord[None].expand(b, 8, h, w)


class BatchNorm(nn.Module):
    """Evaluation-only BatchNorm over dim 1 of (B, C) or (B, C, H, W): the
    running statistics (flax's `batch_stats`; its momentum 0.99 is torch's
    0.01), eps 1e-5, statistics in fp32. The JAX package trains no model
    that holds one (`engine/train.py` refuses SCAN / FILM training)."""

    momentum = 0.01

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean.float(), self.running_var.float(), self.weight.float(),
                         self.bias.float(), False, 0.0, self.eps)
        return y.to(x.dtype)


class LangMappingMLP(nn.Sequential):
    """fuse_helper.py _make_mlp (:77-85): Linear-BN-ReLU-Dropout-Linear-BN-ReLU
    on the pooled language aggregate (the dropout: identity in evaluation)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, out_dim), BatchNorm(out_dim), nn.ReLU(), nn.Identity(),
                         nn.Linear(out_dim, out_dim), BatchNorm(out_dim), nn.ReLU())


def _joint_conv(cin: int, cout: int) -> nn.Sequential:
    """fuse_helper.py _make_conv: 1x1 conv + BN + ReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, 1), BatchNorm(cout), nn.ReLU())


def _refuse_training(generator, kind: str) -> None:
    if generator is not None:
        raise NotImplementedError(
            f"FUSE_CONFIG.TYPE {kind} in training: its BatchNorms need batch statistics, which the JAX "
            "package's train step does not carry (no mutable batch_stats)"
        )


class SCANFuse(nn.Module):
    """FUSE_CONFIG.TYPE "SCAN" with the JAX package's semantics (its
    docstring): the reference path cannot run (it feeds the 2-D pooled
    aggregate to the bmm-based func_attention), so the mapped aggregate is
    a single-token context, broadcast to every position (func_attention over
    one token), then per level a 1x1 conv + BN + ReLU to 256 channels."""

    def __init__(self, levels: int, l_dim: int, emb_dim: int = 256, out_dim: int = 256):
        super().__init__()
        self.mapping_lang = LangMappingMLP(l_dim, emb_dim)
        self.joint_fusion = nn.ModuleList(_joint_conv(emb_dim, out_dim) for _ in range(levels))

    def forward(self, visual: List[torch.Tensor], lang_aggregate, generator=None):
        _refuse_training(generator, "SCAN")
        ctx = self.mapping_lang(lang_aggregate)  # (B, emb)
        return [cl(conv(ctx[:, :, None, None].expand(*ctx.shape, *f.shape[2:]).to(f.dtype)))
                for conv, f in zip(self.joint_fusion, visual)]


class FILMFuse(nn.Module):
    """FUSE_CONFIG.TYPE "FILM" (vldyhead.py:423-431, 538-562): per level
    tanh(gamma) / tanh(beta) from the mapped language aggregate modulate the
    [feature, coord] channels, ReLU, then a 1x1 conv + BN + ReLU to 256."""

    def __init__(self, levels: int, v_dim: int, l_dim: int, emb_dim: int = 256, out_dim: int = 256,
                 coord_dim: int = 8):
        super().__init__()
        inp = v_dim + coord_dim
        self.mapping_lang = LangMappingMLP(l_dim, emb_dim)
        self.gamma = nn.ModuleList(nn.Linear(emb_dim, inp) for _ in range(levels))
        self.beta = nn.ModuleList(nn.Linear(emb_dim, inp) for _ in range(levels))
        self.joint_fusion = nn.ModuleList(_joint_conv(inp, out_dim) for _ in range(levels))

    def forward(self, visual: List[torch.Tensor], lang_aggregate, generator=None):
        _refuse_training(generator, "FILM")
        ctx = self.mapping_lang(lang_aggregate)
        outs = []
        for gamma, beta, conv, f in zip(self.gamma, self.beta, self.joint_fusion, visual):
            b, _, h, w = f.shape
            feat = torch.cat([f, make_coord_channels(b, h, w, f.dtype, f.device)], 1)
            g, bt = torch.tanh(gamma(ctx)), torch.tanh(beta(ctx))
            outs.append(cl(conv(F.relu(g[:, :, None, None] * feat + bt[:, :, None, None]))))
        return outs
