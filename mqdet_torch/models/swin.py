"""Swin Transformer v1 backbone (counterpart of
`mqdet_tpu/models/swin.py`, version "v1"; reference
maskrcnn_benchmark/modeling/backbone/swint.py).

Attribute names follow the reference (`patch_embed.proj`, `layers.{i}.blocks.{j}`,
`layers.{i}.downsample`, `norm{i}`), so state_dict keys are its keys. Stochastic
depth (rates linear in the block index up to `drop_path_rate`, as in JAX)
runs only when the forward is given a generator, the JAX package's
`deterministic=False`; else it is the identity. Tokens stay (B, H*W, C) inside the stages; the
stage outputs come back as NCHW channels_last maps.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import LayerNorm, Mlp, drop_path


def _rel_pos_index(ws: int) -> np.ndarray:
    """Static relative-position index for a (ws, ws) window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (n, n)


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Static SW-MSA mask: (nW, n, n) additive, -100 across shifted regions."""
    img_mask = np.zeros((hp, wp))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    mw = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = win.shape[0] // ((h // ws) * (w // ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_rel_pos_index(window_size).reshape(-1)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor = None) -> torch.Tensor:
        b_, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x).reshape(b_, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * d**-0.5, qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-1, -2)).float()  # (B_, h, n, n)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1).float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, h, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, h, n, n)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path = drop_path_rate
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self._masks = {}

    def _mask(self, hp, wp, device):
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_attn_mask(hp, wp, self.window_size, self.shift_size)
            ).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, h: int, w: int, generator=None) -> torch.Tensor:
        # the reference keeps the cyclic shift even when the map is smaller
        # than the window (swint.py:186-244)
        ws, shift = self.window_size, self.shift_size
        b, _, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        xw = self.attn(window_partition(x, ws), mask=mask)
        x = window_reverse(xw, ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x[:, :h, :w].reshape(b, h * w, c), self.drop_path, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, h, w):
        b, _, c = x.shape
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        ho, wo = (h + 1) // 2, (w + 1) // 2
        return self.reduction(self.norm(x.reshape(b, ho * wo, 4 * c))), ho, wo


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, downsample: bool, drop_path_rates=None):
        super().__init__()
        rates = drop_path_rates if drop_path_rates is not None else [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if d % 2 == 0 else window_size // 2, mlp_ratio, rates[d])
            for d in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = LayerNorm(embed_dim, eps=1e-5)


class SwinTransformer(nn.Module):
    """Returns the four stage outputs as NCHW channels_last maps (strides
    4, 8, 16, 32). Stage 0 carries no output norm (RETINANET arch)."""

    def __init__(
        self,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.0,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList()
        dim = embed_dim
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        for i, depth in enumerate(depths):
            first = sum(depths[:i])
            self.layers.append(
                BasicLayer(dim, depth, num_heads[i], window_size, mlp_ratio, i < len(depths) - 1,
                           [float(r) for r in dpr[first:first + depth]])
            )
            if i > 0:
                self.add_module(f"norm{i}", LayerNorm(dim, eps=1e-5))
            dim *= 2

    def forward(self, x: torch.Tensor, generator=None) -> List[torch.Tensor]:
        """x: (B, 3, H, W); `generator` draws the stochastic depth (None: none)."""
        b = x.shape[0]
        ph, pw = (-x.shape[2]) % 4, (-x.shape[3]) % 4
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        x = self.patch_embed.proj(x)
        hh, ww = x.shape[2], x.shape[3]
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = []
        dim = self.embed_dim
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, hh, ww, generator)
            out = x if i == 0 else getattr(self, f"norm{i}")(x)
            outs.append(out.reshape(b, hh, ww, dim).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x, hh, ww = layer.downsample(x, hh, ww)
                dim *= 2
        return outs
