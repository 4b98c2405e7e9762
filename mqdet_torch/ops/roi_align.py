"""ROIAlign (aligned=True) in plain PyTorch (counterpart of
`mqdet_tpu/ops/roi_align.py`, an XLA gather composite there, no Pallas
kernel; reference ROIAlignV2, maskrcnn_benchmark/layers/roi_align.py:71-89).
In MQ-Det it runs only where vision queries are extracted, pooling boxes
from the pyramid.

The function is the JAX module's, not torchvision's (absent here, and its
adaptive sampling count would differ): coordinates scaled by
`spatial_scale` and shifted by -0.5, a static `sampling_ratio` x
`sampling_ratio` grid of bilinear samples per output cell, averaged, and 0
for a sample outside [-1, H] x [-1, W]. Features are one image's map as
(H, W, C); pass `f[0].permute(1, 2, 0)` of an NCHW map (contiguous under
channels_last). Inputs and outputs are float32.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _bilinear_sample(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample feat (H, W, C) at fractional (y, x) of shape (...). Returns (..., C):
    0 where y < -1, y > H, x < -1 or x > W; clamped inside otherwise."""
    h, w, c = feat.shape
    oob = (y < -1.0) | (y > h * 1.0) | (x < -1.0) | (x > w * 1.0)
    y = y.clamp(0.0, h - 1.0)
    x = x.clamp(0.0, w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(-1, c)

    def gather(yy, xx):
        return flat[(yy * w + xx).long()]

    v = (
        gather(y0, x0) * (hy * hx)[..., None]
        + gather(y0, x1) * (hy * lx)[..., None]
        + gather(y1, x0) * (ly * hx)[..., None]
        + gather(y1, x1) * (ly * lx)[..., None]
    )
    return torch.where(oob[..., None], torch.zeros((), dtype=v.dtype, device=v.device), v)


def roi_align(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign on one map: features (H, W, C), rois (R, 4) xyxy in image
    coordinates -> (R, P, P, C)."""
    p, s = output_size, sampling_ratio
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    x2 = rois[:, 2] * spatial_scale - 0.5
    y2 = rois[:, 3] * spatial_scale - 0.5
    bin_w = (x2 - x1) / p
    bin_h = (y2 - y1) / p
    # sample offsets inside each bin: (i + 0.5) / s
    offs = (torch.arange(s, dtype=torch.float32, device=rois.device) + 0.5) / s
    cell = torch.arange(p, dtype=torch.float32, device=rois.device)
    ys = y1[:, None, None] + (cell[None, :, None] + offs[None, None, :]) * bin_h[:, None, None]  # (R, p, s)
    xs = x1[:, None, None] + (cell[None, :, None] + offs[None, None, :]) * bin_w[:, None, None]
    r = rois.shape[0]
    yy = ys[:, :, :, None, None].expand(r, p, s, p, s)
    xx = xs[:, None, None, :, :].expand(r, p, s, p, s)
    return _bilinear_sample(features, yy, xx).mean(dim=(2, 4))  # (R, p, p, C)


def multi_level_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                          spatial_scales: Sequence[float], output_size: int = 7,
                          canonical_scale: int = 224, canonical_level: int = 4) -> torch.Tensor:
    """The reference `Pooler` + `LevelMapper` (poolers.py:11-130): each ROI
    pooled from the level floor(canonical_level + log2(sqrt(area) /
    canonical_scale + 1e-6)), clamped to the pyramid. As in the JAX module,
    every ROI is pooled at every level, then its level is selected (no host
    sync). Returns (R, P, P, C)."""
    n_levels = len(features)
    lvl_min = -torch.log2(torch.tensor(spatial_scales[0], dtype=torch.float32))
    area = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    scale = torch.sqrt(torch.clamp(area, min=1e-6))
    target = torch.floor(canonical_level + torch.log2(scale / canonical_scale + 1e-6))
    lvl_min = lvl_min.to(rois.device)
    target = torch.minimum(torch.maximum(target, lvl_min), lvl_min + n_levels - 1) - lvl_min
    pooled = torch.stack([roi_align(f, rois, sc, output_size) for f, sc in zip(features, spatial_scales)])
    sel = target.long()[None, :, None, None, None].expand(1, *pooled.shape[1:])
    return torch.gather(pooled, 0, sel)[0]


def all_level_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                        spatial_scales: Sequence[float], output_size: int = 7) -> torch.Tensor:
    """CustomPooler (poolers.py:133-168): every ROI from every level.
    Returns (L, R, P, P, C)."""
    return torch.stack([roi_align(f, rois, sc, output_size) for f, sc in zip(features, spatial_scales)])
