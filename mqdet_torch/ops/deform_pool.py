"""Deformable (modulated) position-sensitive RoI pooling in plain PyTorch
(counterpart of `mqdet_tpu/ops/deform_pool.py`, an XLA composite there, no
Pallas kernel; reference csrc/cuda/deform_pool_kernel_cuda.cu:55-140,
layers/deform_pool.py). No model calls it, in JAX or here: it completes the
reference's operator surface.

The function is JAX's, the CUDA kernel's forward:
  * ROI coordinates are rounded, scaled by `spatial_scale` and shifted by
    -0.5; width and height are floored at 0.1;
  * bin (ph, pw) moves by trans[class, :, part_h, part_w] * trans_std *
    the ROI's size;
  * a bin averages sample_per_part^2 bilinear samples, and a sample outside
    [-0.5, size - 0.5] is left out of the count (not averaged as 0);
  * output channel ctop of bin (gh, gw) reads input channel (ctop *
    group_size + gh) * group_size + gw.

Features are NHWC (B, H, W, C) with C = output_dim * group_size^2, as in
JAX (`f.permute(0, 2, 3, 1)` of an NCHW map); the result is (N, P, P,
output_dim) float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def deform_psroi_pool(
    features: torch.Tensor,                 # (B, H, W, C)
    rois: torch.Tensor,                     # (N, 5) [batch, x1, y1, x2, y2]
    trans: Optional[torch.Tensor] = None,   # (N, num_classes, 2, part, part)
    spatial_scale: float = 1.0,
    output_dim: int = 256,
    pooled_size: int = 7,
    group_size: int = 1,
    part_size: Optional[int] = None,
    sample_per_part: int = 4,
    trans_std: float = 0.1,
    no_trans: bool = False,
) -> torch.Tensor:
    b, h, w, c = features.shape
    gs, ps, sp = group_size, pooled_size, sample_per_part
    part = part_size or ps
    if c != output_dim * gs * gs:
        raise ValueError(f"channels {c} != output_dim {output_dim} * group_size^2 {gs * gs}")
    n = rois.shape[0]
    dev = features.device
    num_classes = 1 if no_trans or trans is None else trans.shape[1]
    ch_each = output_dim // num_classes
    if trans is None:
        trans = torch.zeros(n, num_classes, 2, part, part, device=dev)
    rois, trans, feats = rois.float(), trans.float(), features.float()

    phw = np.arange(ps, dtype=np.float32)
    part_idx = torch.from_numpy(np.floor(phw / ps * part).astype(np.int64)).to(dev)
    g_idx = np.clip((phw * gs / ps).astype(np.int64), 0, gs - 1)
    phw_t = torch.from_numpy(phw).to(dev)
    sub = torch.arange(sp, dtype=torch.float32, device=dev)

    batch = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw, bh = rw / ps, rh / ps
    sbw, sbh = bw / sp, bh / sp
    e = lambda t: t[:, None, None, None]  # noqa: E731  (N,) -> (N, 1, 1, 1)

    # per class the bin's shift: (N, cls, ps, ps)
    tx = trans[:, :, 0][:, :, part_idx[:, None], part_idx[None, :]] * trans_std
    ty = trans[:, :, 1][:, :, part_idx[:, None], part_idx[None, :]] * trans_std
    wstart = phw_t[None, None, None, :] * e(bw) + e(x1) + tx * e(rw)
    hstart = phw_t[None, None, :, None] * e(bh) + e(y1) + ty * e(rh)
    # samples: (N, cls, ps, ps, sp_y, sp_x)
    sx = wstart[..., None, None] + (sub[None, :] * sbw[:, None])[:, None, None, None, None, :]
    sy = hstart[..., None, None] + (sub[None, :] * sbh[:, None])[:, None, None, None, :, None]
    shape = sx.shape[:4] + (sp, sp)
    sx, sy = sx.expand(shape), sy.expand(shape)
    valid = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    xq = sx.clamp(0.0, w - 1.0)
    yq = sy.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(xq), torch.floor(yq)
    x1c = torch.clamp(x0 + 1, max=w - 1.0)
    y1c = torch.clamp(y0 + 1, max=h - 1.0)
    dx, dy = xq - x0, yq - y0
    flat = feats.reshape(b * h * w, c)
    base = (batch * h * w)[:, None, None, None, None, None]

    def g(yy, xx):
        return flat[(base + yy.long() * w + xx.long()).reshape(-1)].reshape(*yy.shape, c)

    val = (g(y0, x0) * ((1 - dy) * (1 - dx))[..., None] + g(y0, x1c) * ((1 - dy) * dx)[..., None]
           + g(y1c, x0) * (dy * (1 - dx))[..., None] + g(y1c, x1c) * (dy * dx)[..., None])
    val = val * valid[..., None]
    cnt = valid.sum(dim=(-1, -2)).float()                  # (N, cls, ps, ps)
    avg = val.sum(dim=(4, 5)) / cnt.clamp(min=1.0)[..., None]  # (N, cls, ps, ps, C)

    ctop = np.arange(output_dim)
    cls_of = torch.from_numpy(ctop // ch_each).to(dev)
    rows = []
    for ph in range(ps):
        cols = []
        for pw in range(ps):
            ci = torch.from_numpy((ctop * gs + int(g_idx[ph])) * gs + int(g_idx[pw])).to(dev)
            cols.append(avg[:, cls_of, ph, pw, ci])        # (N, Cout)
        rows.append(torch.stack(cols, 1))
    return torch.stack(rows, 1)                           # (N, ps, ps, Cout)
