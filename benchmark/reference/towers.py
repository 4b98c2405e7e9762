"""The reference's image tower (Swin-T v1) and language tower (BERT-base with
MQ-Det's gated class-scalable perceiver, GCP), in plain float32 PyTorch.

Written from the published models: Swin (Liu et al. 2021, shifted windows,
relative position bias, patch merging), BERT-base (Devlin et al. 2019, post-norm
layers, exact GELU) and MQ-Det's GCP (Xu et al. 2023: the vision queries are
first conditioned on the image by two pre-select blocks, then a gated
cross-attention block, text attending to its own class's queries, precedes
every BERT layer from START_QV_LAYER on). Parameter names are those of the
released checkpoints' module trees, so one state dict loads into the
reference and the program alike. Every product goes through `ops`, so the
control's precision reaches all of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops


class Linear(nn.Linear):
    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def group_norm(x, groups, weight, bias, eps=1e-6):
    return F.group_norm(x.float(), groups, weight, bias, eps)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(ops.gelu(self.fc1(x)))


# --- Swin v1 ---------------------------------------------------------------------------


def window_rel_index(ws: int) -> torch.Tensor:
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]) + (ws - 1)
    return (rel[0] * (2 * ws - 1) + rel[1]).reshape(-1)


def shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, n, n): -100 between tokens of different regions of the shifted map."""
    region = torch.zeros(hp, wp, device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, wsl in enumerate(cuts):
            region[hs, wsl] = 3 * i + j
    r = region.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(r[:, None, :] != r[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.qkv, self.proj = Linear(dim, 3 * dim), Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))

    def forward(self, x, mask):
        bw, n, c = x.shape
        h, d = self.heads, c // self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        attn = ops.matmul(qkv[0] * d**-0.5, qkv[1].transpose(-1, -2))
        idx = window_rel_index(self.ws).to(x.device)
        attn = attn + self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n) + mask[None, :, None]).reshape(bw, h, n, n)
        out = ops.matmul(torch.softmax(attn, -1), qkv[2]).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1, self.norm2 = LayerNorm(dim, eps=1e-5), LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, ws)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, h, w):
        b, _, c = x.shape
        ws, shift = self.ws, self.shift
        y = self.norm1(x).reshape(b, h, w, c)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = shift_mask(hp, wp, ws, shift, x.device)
        win = y.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        win = self.attn(win, mask)
        y = win.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y[:, :h, :w].reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, h, w):
        b, _, c = x.shape
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        ho, wo = (h + 1) // 2, (w + 1) // 2
        return self.reduction(self.norm(x.reshape(b, ho * wo, 4 * c))), ho, wo


class _Stage(nn.Module):
    def __init__(self, dim, depth, heads, ws, last):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2) for i in range(depth))
        self.downsample = None if last else PatchMerging(dim)


class _PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = Conv2d(3, dim, 4, stride=4)
        self.norm = LayerNorm(dim, eps=1e-5)


class Swin(nn.Module):
    """Swin v1: the stage outputs at strides 4..32 as (B, C, H, W) maps,
    stages 1-3 through their output norms."""

    def __init__(self, dim, depths, heads, ws):
        super().__init__()
        self.dim = dim
        self.patch_embed = _PatchEmbed(dim)
        self.layers = nn.ModuleList(
            _Stage(dim * 2**i, d, h, ws, i == len(depths) - 1) for i, (d, h) in enumerate(zip(depths, heads)))
        for i in range(1, len(depths)):
            self.add_module(f"norm{i}", LayerNorm(dim * 2**i, eps=1e-5))

    def forward(self, images):
        b = images.shape[0]
        x = F.pad(images.float(), (0, (-images.shape[3]) % 4, 0, (-images.shape[2]) % 4))
        x = self.patch_embed.proj(x)
        h, w = x.shape[2:]
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, h, w)
            y = x if i == 0 else getattr(self, f"norm{i}")(x)
            outs.append(y.reshape(b, h, w, -1).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x, h, w = stage.downsample(x, h, w)
        return outs


# --- BERT with the GCP --------------------------------------------------------------------


class FeedForward(nn.Module):
    """LayerNorm, bias-free Linear, GELU, bias-free Linear."""

    def __init__(self, dim, mult, out_dim=None):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.linear1 = Linear(dim, int(dim * mult), bias=False)
        self.linear2 = Linear(int(dim * mult), out_dim or dim, bias=False)

    def forward(self, x):
        return self.linear2(ops.gelu(self.linear1(self.norm(x))))


class CrossAttention(nn.Module):
    """x (B, T, D) attends to y (B, V, Dv); mask (B, V, T) 1 where y_v may be
    attended by x_t: masked logits get -1e4, masked probabilities are zeroed."""

    def __init__(self, dim, vdim, out_dim=None, dim_head=64, heads=8):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm, self.norm_kv = LayerNorm(dim, eps=1e-5), LayerNorm(vdim, eps=1e-5)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(vdim, 2 * inner, bias=False)
        self.to_out = Linear(inner, out_dim or dim, bias=False)

    def forward(self, x, y, mask=None):
        h, d = self.heads, self.dim_head
        x, y = self.norm(x), self.norm_kv(y)
        b, t, _ = x.shape
        q = self.to_q(x).reshape(b, t, h, d).transpose(1, 2) * d**-0.5
        k, v = (z.reshape(b, -1, h, d).transpose(1, 2) for z in self.to_kv(y).chunk(2, -1))
        sim = ops.matmul(q, k.transpose(-1, -2))
        if mask is not None:
            keep = mask.transpose(1, 2)[:, None] != 0
            sim = sim + torch.where(keep, 0.0, -1e4)
        attn = torch.softmax(sim, -1)
        if mask is not None:
            attn = attn * keep
        return self.to_out(ops.matmul(attn, v).transpose(1, 2).reshape(b, t, h * d))


class GatedBlock(nn.Module):
    """GCP block: x += tanh(gate(attn)) * attn(x, queries); x += tanh(ff_gate) * ff(x),
    the gate a FeedForward of the attention output to one value."""

    def __init__(self, dim, vdim):
        super().__init__()
        self.attn = CrossAttention(dim, vdim)
        self.attn_gate = FeedForward(dim, 0.5, 1)
        self.ff = FeedForward(dim, 4.0)
        self.ff_gate = nn.Parameter(torch.zeros(1))

    def forward(self, x, queries, mask):
        a = self.attn(x, queries, mask)
        x = a * torch.tanh(self.attn_gate(a)) + x
        return self.ff(x) * torch.tanh(self.ff_gate) + x


class PreSelectBlock(nn.Module):
    def __init__(self, dim, out_dim):
        super().__init__()
        self.image_condition = CrossAttention(dim, dim, out_dim, dim_head=32, heads=8)
        self.res_mapping = Linear(dim, out_dim, bias=False) if dim != out_dim else None
        self.ff = FeedForward(out_dim, 4.0)

    def forward(self, queries, image):
        res = queries if self.res_mapping is None else self.res_mapping(queries)
        y = self.image_condition(queries, image) + res
        return self.ff(y) + y


class _PreSelect(nn.Module):
    def __init__(self, dim, out_dim, n):
        super().__init__()
        self.layers = nn.ModuleList(PreSelectBlock(dim, out_dim if i == n - 1 else dim) for i in range(n))


class _Dense(nn.Module):
    def __init__(self, cin, cout, ln):
        super().__init__()
        self.dense = Linear(cin, cout)
        if ln:
            self.LayerNorm = LayerNorm(cout, eps=1e-12)


class _SelfAttention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.query, self.key, self.value = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)


class _Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.self = _SelfAttention(dim)
        self.output = _Dense(dim, dim, True)


class BertLayer(nn.Module):
    def __init__(self, dim, heads, inter):
        super().__init__()
        self.heads = heads
        self.attention = _Attention(dim)
        self.intermediate = _Dense(dim, inter, False)
        self.output = _Dense(inter, dim, True)

    def forward(self, x, bias):
        b, t, c = x.shape
        h, d = self.heads, c // self.heads
        sa = self.attention.self
        q, k, v = (m(x).reshape(b, t, h, d).transpose(1, 2) for m in (sa.query, sa.key, sa.value))
        p = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) / d**0.5 + bias, -1)
        a = ops.matmul(p, v).transpose(1, 2).reshape(b, t, c)
        x = self.attention.output.LayerNorm(x + self.attention.output.dense(a))
        return self.output.LayerNorm(x + self.output.dense(ops.gelu(self.intermediate.dense(x))))


class _Embeddings(nn.Module):
    def __init__(self, vocab, dim):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, dim)
        self.position_embeddings = nn.Embedding(512, dim)
        self.token_type_embeddings = nn.Embedding(2, dim)
        self.LayerNorm = LayerNorm(dim, eps=1e-12)

    def forward(self, ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(ids.shape[1], device=ids.device)[None]
        x = self.word_embeddings(ids) + self.position_embeddings(position_ids) + self.token_type_embeddings.weight[0]
        return self.LayerNorm(x)


class _Encoder(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(s["hidden"], s["heads"], s["intermediate"]) for _ in range(s["layers"]))
        self.qv_layer = nn.ModuleList(
            GatedBlock(s["hidden"], s["hidden"]) for _ in range(s["layers"] - s["start_qv_layer"]))


class QVBert(nn.Module):
    """BERT with a GCP block before every layer from `start_qv_layer` on; the
    queries (B, V, C) are conditioned on the image tokens (B, N, C) by the
    pre-select blocks first. `attention` (B, T, T) bool, if given, replaces
    the padding mask (GroundingDINO's sub-sentence blocks)."""

    def __init__(self, s, vision_dim):
        super().__init__()
        self.start = s["start_qv_layer"]
        self.embeddings = _Embeddings(s["vocab"], s["hidden"])
        self.encoder = _Encoder(s)
        self.pre_select = _PreSelect(vision_dim, s["hidden"], s["pre_select_layers"])

    def forward(self, ids, mask, queries, query_mask, image_tokens, attention=None, position_ids=None):
        x = self.embeddings(ids, position_ids)
        keep = attention[:, None].float() if attention is not None else mask[:, None, None, :].float()
        bias = (1.0 - keep) * -10000.0
        for blk in self.pre_select.layers:
            queries = blk(queries, image_tokens)
        for i, layer in enumerate(self.encoder.layer):
            if i >= self.start:
                x = self.encoder.qv_layer[i - self.start](x, queries, query_mask)
            x = layer(x, bias)
        return x
