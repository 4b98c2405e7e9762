"""The evaluation and training transforms: resize, flip, color jitter,
normalize, pad to a bucket (counterpart of `mqdet_tpu/data/transforms.py`;
reference maskrcnn_benchmark/data/transforms/build.py:5-62).

The JAX module resizes with PIL's BILINEAR filter. The port computes that
filter in PyTorch, on the device it is given, bit for bit: PIL's separable
triangle filter (its support widened by the downscale factor), its weights
in 22-bit fixed point, a horizontal pass rounded to uint8, then a vertical
pass (Pillow's `ImagingResample`). The sums are integers below 2^53, so
float64 products are exact. `tests/test_torch_port_querybank.py` holds it
equal to PIL. The color jitter is PIL's ImageEnhance, as in the JAX module
(PIL is imported only where a jitter is configured).
"""
from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_resize_size(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    """Reference Resize.get_size: scale shorter side to min_size capped so the
    longer side <= max_size."""
    size = min_size
    if max_size is not None:
        min_orig = min(h, w)
        max_orig = max(h, w)
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if h < w:
        oh, ow = size, int(size * w / h)
    else:
        ow, oh = size, int(size * h / w)
    return oh, ow


PRECISION_BITS = 22  # Pillow's fixed point for 8-bit images (32 - 8 - 2)


def bilinear_coefficients(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fixed-point weights of PIL's BILINEAR resize along
    one axis (Pillow's `precompute_coeffs` and `normalize_coeffs_8bpc`)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support, 1, widened
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C casts truncate
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    j = np.arange(int(np.ceil(support)) * 2 + 1)
    t = np.abs(((j[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((t < 1.0) & (j[None] < (xmax - xmin)[:, None]), 1.0 - t, 0.0)
    total = w.sum(1, keepdims=True)
    w = w / np.where(total != 0.0, total, 1.0)
    out = np.zeros((out_size, in_size + len(j)))
    np.add.at(out, (np.repeat(np.arange(out_size), len(j)), (xmin[:, None] + j[None]).reshape(-1)),
              np.floor(0.5 + w * (1 << PRECISION_BITS)).reshape(-1))
    return out[:, :in_size]


def _fixed_point_pass(x: torch.Tensor, coeffs: np.ndarray, axis: int) -> torch.Tensor:
    """One PIL pass over `axis` (-1 or -2) of float64 (C, H, W) uint8 values."""
    k = torch.from_numpy(coeffs).to(x.device)
    y = x @ k.T if axis == -1 else k @ x
    return torch.floor((y + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS)).clamp(0.0, 255.0)


def resize_image(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """uint8 (H, W, 3) -> float32 (3, oh, ow) holding uint8 values: PIL's
    `Image.resize((ow, oh), Image.BILINEAR)`, horizontal pass first."""
    x = img.permute(2, 0, 1).double()
    if x.shape[-1] != ow:
        x = _fixed_point_pass(x, bilinear_coefficients(x.shape[-1], ow), -1)
    if x.shape[-2] != oh:
        x = _fixed_point_pass(x, bilinear_coefficients(x.shape[-2], oh), -2)
    return x.float()


def normalize(img: torch.Tensor, pixel_mean: Sequence[float], pixel_std: Sequence[float],
              to_bgr255: bool = True) -> torch.Tensor:
    """Detectron normalization of (3, H, W) RGB values 0..255
    (INPUT.TO_BGR255 + PIXEL_MEAN/STD in BGR)."""
    x = img.flip(0) if to_bgr255 else img / 255.0
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=img.device)[:, None, None]
    std = torch.tensor(pixel_std, dtype=torch.float32, device=img.device)[:, None, None]
    return (x - mean) / std


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]):
    """Smallest bucket that fits (h, w). Buckets are orientation-free: a
    declared (800, 1344) also serves portrait images as (1344, 800)."""
    cands = []
    for bh, bw in buckets:
        cands.append((bh, bw))
        cands.append((bw, bh))
    for bh, bw in sorted(set(cands), key=lambda b: b[0] * b[1]):
        if h <= bh and w <= bw:
            return bh, bw
    raise ValueError(
        f"image ({h}, {w}) fits no TPU.IMAGE_BUCKETS entry {list(buckets)}; "
        "add a larger bucket or lower INPUT.MIN/MAX_SIZE_TEST"
    )


def pad_to_bucket(img: torch.Tensor, bucket: Tuple[int, int]) -> torch.Tensor:
    """(C, h, w) -> (C, bh, bw), zeros right and below."""
    bh, bw = bucket
    return F.pad(img, (0, bw - img.shape[-1], 0, bh - img.shape[-2]))


def resize_boxes(boxes: np.ndarray, scale_y: float, scale_x: float) -> np.ndarray:
    out = boxes.copy()
    out[:, 0::2] *= scale_x
    out[:, 1::2] *= scale_y
    return out


def hflip(img: torch.Tensor, boxes: np.ndarray):
    """RandomHorizontalFlip of a (C, H, W) image and its xyxy boxes, with the
    TO_REMOVE = 1 convention."""
    w = img.shape[-1]
    out = boxes.copy()
    out[:, 0] = w - boxes[:, 2] - 1
    out[:, 2] = w - boxes[:, 0] - 1
    return img.flip(-1), out


def color_jitter(img: np.ndarray, brightness: float = 0.0, contrast: float = 0.0, saturation: float = 0.0,
                 hue: float = 0.0, rng=None) -> np.ndarray:
    """ColorJitter of a uint8 (H, W, 3) image by PIL's ImageEnhance, one
    uniform draw per enabled factor (hue is not applied, as in JAX)."""
    from PIL import Image, ImageEnhance

    r = rng or random
    pil = Image.fromarray(img)
    if brightness > 0:
        pil = ImageEnhance.Brightness(pil).enhance(1 + r.uniform(-brightness, brightness))
    if contrast > 0:
        pil = ImageEnhance.Contrast(pil).enhance(1 + r.uniform(-contrast, contrast))
    if saturation > 0:
        pil = ImageEnhance.Color(pil).enhance(1 + r.uniform(-saturation, saturation))
    return np.asarray(pil)


class EvalTransform:
    """Deterministic resize -> normalize -> pad-to-bucket pipeline."""

    def __init__(self, cfg):
        self.min_size = cfg.INPUT.MIN_SIZE_TEST
        self.max_size = cfg.INPUT.MAX_SIZE_TEST
        self.pixel_mean = cfg.INPUT.PIXEL_MEAN
        self.pixel_std = cfg.INPUT.PIXEL_STD
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self.buckets = tuple(tuple(b) for b in cfg.TPU.IMAGE_BUCKETS)

    def __call__(self, img: np.ndarray, device="cuda"):
        """uint8 (H, W, 3) RGB -> (padded (1, 3, bh, bw) float32 on `device`,
        resized (oh, ow), (H / oh, W / ow): the factors that map network
        coordinates back to the original image)."""
        h, w = img.shape[:2]
        oh, ow = get_resize_size(h, w, self.min_size, self.max_size)
        resized = resize_image(torch.tensor(img, device=device), oh, ow)
        normed = normalize(resized, self.pixel_mean, self.pixel_std, self.to_bgr255)
        padded = pad_to_bucket(normed, pick_bucket(oh, ow, self.buckets))
        return padded[None], (oh, ow), (h / oh, w / ow)


def train_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]):
    """The training batch's bucket: the smallest bucket AS DECLARED that fits
    (h, w), else `pick_bucket`'s. The train step's anchors are the first
    bucket's as declared; `pick_bucket`, orientation-free, can give an image
    that fits both orientations (a small scale of the multi-scale resize)
    the rotated bucket, which does not stack with its batch (the JAX
    module's behaviour, ROADMAP Queue C)."""
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if h <= bh and w <= bw:
            return bh, bw
    return pick_bucket(h, w, buckets)


class TrainTransform:
    """Color jitter -> multi-scale resize (a size drawn from
    AUGMENT.MULT_MIN_SIZE_TRAIN, else INPUT.MIN_SIZE_TRAIN) -> flip with
    probability FLIP_PROB_TRAIN -> normalize -> pad to `train_bucket`; the
    draws in the JAX module's order from `rng` (a `random.Random`)."""

    def __init__(self, cfg):
        self.min_sizes = tuple(cfg.AUGMENT.MULT_MIN_SIZE_TRAIN) or (cfg.INPUT.MIN_SIZE_TRAIN,)
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN
        self.flip_prob = cfg.AUGMENT.FLIP_PROB_TRAIN
        self.jitter = (cfg.AUGMENT.BRIGHTNESS, cfg.AUGMENT.CONTRAST, cfg.AUGMENT.SATURATION, cfg.AUGMENT.HUE)
        self.pixel_mean = cfg.INPUT.PIXEL_MEAN
        self.pixel_std = cfg.INPUT.PIXEL_STD
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self.buckets = tuple(tuple(b) for b in cfg.TPU.IMAGE_BUCKETS)

    def __call__(self, img: np.ndarray, boxes: np.ndarray, rng=None):
        """uint8 (H, W, 3) RGB and its (N, 4) boxes -> (float32 (bh, bw, 3)
        normalized and padded, the boxes in it, the resized (oh, ow))."""
        r = rng or random
        h, w = img.shape[:2]
        if any(self.jitter):
            img = color_jitter(img, *self.jitter, rng=r)
        oh, ow = get_resize_size(h, w, r.choice(self.min_sizes), self.max_size)
        x = resize_image(torch.tensor(np.ascontiguousarray(img)), oh, ow)
        boxes = resize_boxes(boxes, oh / h, ow / w)
        if r.random() < self.flip_prob:
            x, boxes = hflip(x, boxes)
        x = normalize(x, self.pixel_mean, self.pixel_std, self.to_bgr255)
        x = pad_to_bucket(x, train_bucket(oh, ow, self.buckets))
        return x.permute(1, 2, 0).contiguous().numpy(), boxes, (oh, ow)
