"""Swin Transformer backbone, versions v1 / v2 / vl / v2_vl (counterpart of
`mqdet_tpu/models/swin.py`; reference maskrcnn_benchmark/modeling/backbone/
swint.py, swint_v2.py, swint_vl.py, swint_v2_vl.py; SWINT.VERSION).

  * v1: scaled dot-product window attention with a relative-position bias
    table, pre-norm residuals.
  * v2: cosine attention with a learnable per-head log-temperature
    (`logit_scale`, clamped at log 100), the log-spaced continuous position
    bias MLP (`cpb_mlp`, 16 * sigmoid of its output), post-norm residuals.
  * vl, v2_vl: v1's attention plus, in the LAST stage, joint image <-> text
    window attention when the forward is given text (swint_vl.py:113-211,
    618-620): image windows attend over [window tokens; text tokens], text
    over [all image tokens; text tokens], with the learned biases
    `i2t_relative_position_bias` (2, heads, ntext) and
    `t2t_relative_position_bias` (heads, ntext, ntext); the text stream has
    its own `qkv_text`, `proj_text`, `norm1_text`, `norm2_text` and
    `mlp_text`, built when the backbone is given `text_dim` and `ntext`.
    v2_vl computes vl's function (the reference's only extra, a layer-scale
    gamma, is off by default), as in JAX.

The detectors pass no text to the backbone (JAX's `encode_image` does not),
so in MQ-GLIP vl and v2_vl hold v1's parameters and compute v1's function;
the text branch is the backbone module's own, held against JAX's module in
`tests/test_torch_port_swin_versions.py`.

Attribute names follow the reference (`patch_embed.proj`, `layers.{i}.blocks.{j}`,
`layers.{i}.downsample`, `norm{i}`), so state_dict keys are its keys. Stochastic
depth (rates linear in the block index up to `drop_path_rate`, as in JAX)
runs only when the forward is given a generator, the JAX package's
`deterministic=False`; else it is the identity. Tokens stay (B, H*W, C) inside the stages; the
stage outputs come back as NCHW channels_last maps.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

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


def _cpb_table(ws: int) -> np.ndarray:
    """v2's log-spaced relative coordinates: ((2ws-1)^2, 2)."""
    coords = np.arange(-(ws - 1), ws, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords, indexing="ij"), -1) / (ws - 1) * 8.0
    grid = np.sign(grid) * np.log2(np.abs(grid) + 1.0) / np.log2(8.0)
    return grid.reshape(-1, 2).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, version: str = "v1",
                 text_dim: Optional[int] = None, ntext: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.cosine = version == "v2"
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        if self.cosine:
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
            self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(), nn.Linear(512, num_heads, bias=False))
            self.register_buffer("cpb_table", torch.from_numpy(_cpb_table(window_size)), persistent=False)
        else:
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * window_size - 1) ** 2, num_heads)
            )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_rel_pos_index(window_size).reshape(-1)),
            persistent=False,
        )
        if text_dim is not None:
            self.qkv_text = nn.Linear(text_dim, dim * 3)
            self.i2t_relative_position_bias = nn.Parameter(torch.zeros(2, num_heads, ntext))
            self.t2t_relative_position_bias = nn.Parameter(torch.zeros(num_heads, ntext, ntext))
            self.proj_text = nn.Linear(dim, text_dim)

    def _bias(self, n: int) -> torch.Tensor:
        """(h, n, n) relative-position bias: v1's table, or v2's CPB MLP."""
        h = self.num_heads
        if self.cosine:
            table = self.cpb_mlp(self.cpb_table.to(self.qkv.weight.dtype))
            return 16.0 * torch.sigmoid(table[self.relative_position_index].reshape(n, n, h).permute(2, 0, 1))
        return self.relative_position_bias_table[self.relative_position_index].reshape(n, n, h).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor = None, x_text: torch.Tensor = None,
                text_mask: torch.Tensor = None):
        """x (B_, n, C); mask (nW, n, n) additive or None. With x_text
        (B, ntext, C_text) (B_ = B * nW) and text_mask (B, ntext) additive
        or None, returns (x, x_text)."""
        b_, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x).reshape(b_, n, 3, h, d).permute(2, 0, 3, 1, 4)
        if self.cosine:
            q, k, v = F.normalize(qkv[0], dim=-1, eps=1e-6), F.normalize(qkv[1], dim=-1, eps=1e-6), qkv[2]
            attn = torch.matmul(q, k.transpose(-1, -2)).float()
            attn = attn * torch.exp(self.logit_scale.clamp(max=math.log(100.0))).float()[None]
        else:
            q, k, v = qkv[0] * d**-0.5, qkv[1], qkv[2]
            attn = torch.matmul(q, k.transpose(-1, -2)).float()  # (B_, h, n, n)
        attn = attn + self._bias(n).float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, h, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, h, n, n)
        if x_text is None:
            attn = torch.softmax(attn, dim=-1).to(x.dtype)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
            return self.proj(out)
        return self._joint(x, attn, q, k, v, x_text, text_mask)

    def _joint(self, x, attn, q, k, v, x_text, text_mask):
        """vl: the image windows and the text attend jointly (swint_vl.py:149-207)."""
        b_, h, n, d = q.shape
        c = h * d
        bt, ntext, _ = x_text.shape
        nw = b_ // bt
        if bt * nw != b_:
            raise ValueError("the window batch must be a multiple of the text batch")
        qkv_t = self.qkv_text(x_text).reshape(bt, ntext, 3, h, d).permute(2, 0, 3, 1, 4)
        q_t, k_t, v_t = qkv_t[0] * d**-0.5, qkv_t[1], qkv_t[2]  # (bt, h, ntext, d)
        i2t, t2t = self.i2t_relative_position_bias, self.t2t_relative_position_bias
        # image side: each window's tokens also attend to the text tokens
        attn_i2t = torch.einsum("bwhnd,bhmd->bwhnm", q.reshape(bt, nw, h, n, d), k_t).float()
        col = i2t[0][None, :, None, :].float()
        if text_mask is not None:
            col = col + text_mask[:, None, None, :]
        attn_full = torch.cat([attn.reshape(bt, nw, h, n, n), attn_i2t + col[:, None]], dim=-1)
        attn_full = torch.softmax(attn_full, dim=-1).to(x.dtype)
        out = (torch.einsum("bwhnm,bwhmd->bwhnd", attn_full[..., :n], v.reshape(bt, nw, h, n, d)).float()
               + torch.einsum("bwhnm,bhmd->bwhnd", attn_full[..., n:], v_t).float())
        out = self.proj(out.to(x.dtype).reshape(b_, h, n, d).transpose(1, 2).reshape(b_, n, c))
        # text side: the text attends over ALL image tokens and the text
        k_all = k.reshape(bt, nw, h, n, d).transpose(1, 2).reshape(bt, h, nw * n, d)
        v_all = v.reshape(bt, nw, h, n, d).transpose(1, 2).reshape(bt, h, nw * n, d)
        attn_t2i = torch.matmul(q_t, k_all.transpose(-1, -2)).float() + i2t[1][None, :, :, None].float()
        attn_t2t = torch.matmul(q_t, k_t.transpose(-1, -2)).float() + t2t[None].float()
        if text_mask is not None:
            attn_t2t = attn_t2t + text_mask[:, None, None, :]
        attn_t = torch.softmax(torch.cat([attn_t2i, attn_t2t], dim=-1), dim=-1).to(x.dtype)
        out_t = (torch.matmul(attn_t[..., : nw * n], v_all).float()
                 + torch.matmul(attn_t[..., nw * n:], v_t).float())
        out_t = out_t.to(x.dtype).transpose(1, 2).reshape(bt, ntext, c)
        return out, self.proj_text(out_t)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio, drop_path_rate: float = 0.0,
                 version: str = "v1", text_dim: Optional[int] = None, ntext: Optional[int] = None):
        super().__init__()
        self.drop_path = drop_path_rate
        self.window_size = window_size
        self.shift_size = shift_size
        self.post_norm = version == "v2"
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, version, text_dim, ntext)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        if text_dim is not None:  # the vl text stream (swint_vl.py:264-332)
            self.norm1_text = LayerNorm(text_dim, eps=1e-5)
            self.norm2_text = LayerNorm(text_dim, eps=1e-5)
            self.mlp_text = Mlp(text_dim, int(text_dim * mlp_ratio), text_dim)
        self._masks = {}

    def _mask(self, hp, wp, device):
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_attn_mask(hp, wp, self.window_size, self.shift_size)
            ).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, h: int, w: int, generator=None, x_text=None, text_mask=None):
        """x (B, H*W, C); with x_text (vl), returns (x, x_text)."""
        # the reference keeps the cyclic shift even when the map is smaller
        # than the window (swint.py:186-244)
        ws, shift = self.window_size, self.shift_size
        b, _, c = x.shape
        shortcut, shortcut_text = x, x_text
        if x_text is not None:
            x_text = self.norm1_text(x_text)
        if not self.post_norm:
            x = self.norm1(x)
        x = x.reshape(b, h, w, c)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        xw = self.attn(window_partition(x, ws), mask=mask, x_text=x_text, text_mask=text_mask)
        if x_text is not None:
            xw, x_text = xw
        x = window_reverse(xw, ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = x[:, :h, :w].reshape(b, h * w, c)
        if self.post_norm:  # v2: the norms after attention and MLP (swint_v2.py)
            x = shortcut + drop_path(self.norm1(x), self.drop_path, generator)
            return x + drop_path(self.norm2(self.mlp(x)), self.drop_path, generator)
        x = shortcut + drop_path(x, self.drop_path, generator)
        x = x + drop_path(self.mlp(self.norm2(x)), self.drop_path, generator)
        if shortcut_text is None:
            return x
        x_text = shortcut_text + drop_path(x_text, self.drop_path, generator)
        return x, x_text + drop_path(self.mlp_text(self.norm2_text(x_text)), self.drop_path, generator)


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
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, downsample: bool, drop_path_rates=None,
                 version: str = "v1", text_dim: Optional[int] = None, ntext: Optional[int] = None):
        super().__init__()
        rates = drop_path_rates if drop_path_rates is not None else [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if d % 2 == 0 else window_size // 2, mlp_ratio, rates[d],
                      version, text_dim, ntext)
            for d in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = LayerNorm(embed_dim, eps=1e-5)


VERSIONS = ("v1", "v2", "vl", "v2_vl")


class SwinTransformer(nn.Module):
    """Returns the four stage outputs as NCHW channels_last maps (strides
    4, 8, 16, 32). Stage 0 carries no output norm (RETINANET arch).
    `text_dim` and `ntext` (vl, v2_vl) build the last stage's text stream."""

    def __init__(
        self,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.0,
        version: str = "v1",
        text_dim: Optional[int] = None,
        ntext: Optional[int] = None,
    ):
        super().__init__()
        if version not in VERSIONS:
            raise ValueError(f"MODEL.SWINT.VERSION {version!r}: one of {VERSIONS}")
        if text_dim is not None and version not in ("vl", "v2_vl"):
            raise ValueError(f"a text stream needs Swin vl or v2_vl, not {version!r}")
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList()
        dim = embed_dim
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        for i, depth in enumerate(depths):
            first = sum(depths[:i])
            last = i == len(depths) - 1
            self.layers.append(
                BasicLayer(dim, depth, num_heads[i], window_size, mlp_ratio, not last,
                           [float(r) for r in dpr[first:first + depth]], version,
                           text_dim if last else None, ntext if last else None)
            )
            if i > 0:
                self.add_module(f"norm{i}", LayerNorm(dim, eps=1e-5))
            dim *= 2

    def forward(self, x: torch.Tensor, generator=None, x_text: Optional[torch.Tensor] = None,
                text_masks: Optional[torch.Tensor] = None):
        """x: (B, 3, H, W); `generator` draws the stochastic depth (None:
        none). With x_text (B, ntext, text_dim) (vl, v2_vl) the text joins
        the last stage, text_masks (B, ntext) 1 for real tokens, and the
        result is (stage outputs, updated x_text)."""
        use_text = x_text is not None
        if use_text and not hasattr(self.layers[-1].blocks[0], "norm1_text"):
            raise ValueError("this backbone has no text stream: build it with text_dim and ntext")
        text_mask = None
        if use_text and text_masks is not None:
            text_mask = torch.where(text_masks > 0, 0.0, -1e9).float()
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
                if use_text and layer.downsample is None:
                    x, x_text = blk(x, hh, ww, generator, x_text, text_mask)
                else:
                    x = blk(x, hh, ww, generator)
            out = x if i == 0 else getattr(self, f"norm{i}")(x)
            outs.append(out.reshape(b, hh, ww, dim).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x, hh, ww = layer.downsample(x, hh, ww)
                dim *= 2
        return (outs, x_text) if use_text else outs
