"""Anchors over an FPN pyramid (numpy, host side; the same algorithm as
`mqdet_tpu/ops/anchors.py`, reference modeling/rpn/anchor_generator.py):
Detectron cell anchors with the +1 convention, shifted over each level's
grid. GLIP: sizes 64..1024, strides 8..128, one anchor per location."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _whctrs(a):
    w = a[2] - a[0] + 1
    h = a[3] - a[1] + 1
    return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack(
        [x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1), x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)]
    )


def cell_anchors(stride: int, sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    scales = np.array(sizes, dtype=float) / stride
    w, h, x_ctr, y_ctr = _whctrs(np.array([1, 1, stride, stride], dtype=float) - 1)
    size_ratios = w * h / np.array(aspect_ratios, dtype=float)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.array(aspect_ratios, dtype=float))
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)
    out = []
    for a in ratio_anchors:
        w, h, x_ctr, y_ctr = _whctrs(a)
        out.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out)


def anchors_for_fpn(
    image_hw: Tuple[int, int],
    strides: Sequence[int] = (8, 16, 32, 64, 128),
    sizes: Sequence[float] = (64, 128, 256, 512, 1024),
    aspect_ratios: Sequence[float] = (1.0,),
) -> List[np.ndarray]:
    """Per-level (H_l * W_l * A, 4) float32 anchors for a padded (H, W) image."""
    h, w = image_hw
    out = []
    for stride, size in zip(strides, sizes):
        gh, gw = -(-h // stride), -(-w // stride)
        base = cell_anchors(stride, (size,), aspect_ratios).astype(np.float32)
        sx, sy = np.meshgrid(
            np.arange(0, gw * stride, step=stride, dtype=np.float32),
            np.arange(0, gh * stride, step=stride, dtype=np.float32),
        )
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        out.append((shifts[:, None, :] + base[None, :, :]).reshape(-1, 4))
    return out
