"""Multi-scale deformable attention (MSDA) sampling, eval only.

Counterpart of `mqdet_tpu/ops/ms_deform_attn.py::ms_deform_attn` with its
signature and layouts:

    ms_deform_attn(value (B, S, nh, hd), spatial_shapes [(H, W)] per level,
                   sampling_locations (B, Q, nh, L, P, 2) (x, y) in [0, 1],
                   attention_weights (B, Q, nh, L, P)) -> (B, Q, nh * hd)

per (b, q, head): sum over levels and points of weight * bilinear sample of
the level's value map at pixel (x * W - 0.5, y * H - 0.5), zero padding
corner by corner (`F.grid_sample(align_corners=False)`). On a CUDA tensor it
launches the kernel of `csrc/ms_deform_attn.cu` (bf16 value and output, fp32
locations and weights, fp32 accumulation) or raises; on a CPU tensor it runs
the plain PyTorch version below, the JAX package's gather composite
(`ms_deform_attn_sample`). Neither clips the sampling offsets: the TPU
kernel's +-R cell window exists only for the TPU.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from mqdet_torch.ops import kernels

launch_count = 0  # kernel launches since the caller last reset it
MAX_LEVELS = 4    # the kernel's level table (csrc/ms_deform_attn.cu)
HEAD_WIDTHS = (8, 32)  # the kernel's instantiations: the tiny config's and MQ-GroundingDINO-T's


def _bilinear_sample(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v (N, H, W, C); x, y (N, M) pixel coordinates -> (N, M, C) in fp32,
    zero for each corner outside the map."""
    n, h, w, c = v.shape
    flat = v.reshape(n, h * w, c)
    nidx = torch.arange(n, device=v.device)[:, None]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx, ly = x - x0, y - y0
    out = torch.zeros(n, x.shape[1], c, dtype=torch.float32, device=v.device)
    for yy, xx, wt in (
        (y0, x0, (1 - ly) * (1 - lx)),
        (y0, x0 + 1, (1 - ly) * lx),
        (y0 + 1, x0, ly * (1 - lx)),
        (y0 + 1, x0 + 1, ly * lx),
    ):
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        wt = torch.where(inb, wt, torch.zeros_like(wt))
        out += flat[nidx, idx].float() * wt[..., None]
    return out


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch MSDA, level by level (the gather composite). Accumulates
    in fp32; returns value.dtype."""
    b, s, nh, hd = value.shape
    q = sampling_locations.shape[1]
    p = sampling_locations.shape[4]
    out = torch.zeros(b * nh, q, hd, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v_l = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(b * nh, h, w, hd)
        loc = sampling_locations[:, :, :, lvl].float()  # (B, Q, nh, P, 2)
        x = (loc[..., 0] * w - 0.5).permute(0, 2, 1, 3).reshape(b * nh, q * p)
        y = (loc[..., 1] * h - 0.5).permute(0, 2, 1, 3).reshape(b * nh, q * p)
        sampled = _bilinear_sample(v_l, x, y).reshape(b * nh, q, p, hd)
        wgt = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3).reshape(b * nh, q, p)
        out += (sampled * wgt[..., None]).sum(dim=2)
        start += h * w
    return out.reshape(b, nh, q, hd).permute(0, 2, 1, 3).reshape(b, q, nh * hd).to(value.dtype)


def _launch(value, spatial_shapes, loc, attn) -> torch.Tensor:
    global launch_count
    if value.dim() != 4:
        raise ValueError(f"value must be (B, S, nh, hd), got {tuple(value.shape)}")
    b, s, nh, hd = value.shape
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    n_levels = len(shapes)
    if not 0 < n_levels <= MAX_LEVELS:
        raise ValueError(f"kernel takes 1 to {MAX_LEVELS} levels, got {n_levels}")
    if sum(h * w for h, w in shapes) != s:
        raise ValueError(f"level shapes {shapes} do not cover S = {s}")
    if loc.dim() != 6 or loc.shape[0] != b or loc.shape[2:4] != (nh, n_levels) or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations {tuple(loc.shape)} does not match value {tuple(value.shape)}")
    q, p = loc.shape[1], loc.shape[4]
    if attn.shape != (b, q, nh, n_levels, p):
        raise ValueError(f"attention_weights {tuple(attn.shape)} != {(b, q, nh, n_levels, p)}")
    if hd not in HEAD_WIDTHS:
        raise ValueError(f"kernel takes head widths {HEAD_WIDTHS}, got {hd}")
    if value.numel() >= 2**31 or b * q * nh * hd >= 2**31:
        raise ValueError("tensors too large for 32-bit element offsets")
    if value.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes a bfloat16 value, got {value.dtype}")
    for t in (loc, attn):
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 locations and weights, got {t.dtype}")
    for t in (value, loc, attn):
        if t.device != value.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("kernel needs 16-byte aligned tensors")
    out = torch.empty(b, q, nh * hd, dtype=value.dtype, device=value.device)
    hw = (ctypes.c_int * (2 * n_levels))(*[v for hw_ in shapes for v in hw_])
    ptr = ctypes.c_void_p
    code = kernels.lib().mqdet_ms_deform_attn_forward(
        ptr(value.data_ptr()), ptr(loc.data_ptr()), ptr(attn.data_ptr()), ptr(out.data_ptr()),
        hw, b, s, q, nh, hd, n_levels, p, ptr(kernels.stream_ptr(value.device)),
    )
    kernels.check(code, "mqdet_ms_deform_attn_forward")
    launch_count += 1
    return out


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """See module docstring."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"no MSDA kernel for device {value.device}")
    return _launch(value, spatial_shapes, sampling_locations, attention_weights)
