"""Plain PyTorch operations of the benchmark's reference models.

Everything here is written from the published descriptions (DCNv2, GLIP's
bi-attention, Deformable DETR's multi-scale deformable attention, ATSS
decoding, greedy class-aware NMS) and imports nothing of the program. The
reference computes in float32 with TF32 off; `precision("fp8")` makes every
product (`linear`, `matmul`, `conv2d`, `einsum`) round both operands to
float8 e4m3 with a per-tensor scale first: the control that the comparison
has to refuse.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MODE = ["fp32"]
E4M3_MAX = 448.0


@contextlib.contextmanager
def precision(mode: str):
    """Run the reference's products in `mode`: "fp32" or "fp8"."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(f"precision {mode!r}: fp32 or fp8")
    old, _MODE[0] = _MODE[0], mode
    try:
        yield
    finally:
        _MODE[0] = old


def q(x: torch.Tensor) -> torch.Tensor:
    """x as a product's operand: itself in fp32 mode, rounded to e4m3 with a
    per-tensor scale in fp8 mode."""
    if _MODE[0] == "fp32" or not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def linear(x, weight, bias=None):
    return F.linear(q(x), q(weight), bias)


def matmul(a, b):
    return torch.matmul(q(a), q(b))


def einsum(eq, *ops):
    return torch.einsum(eq, *(q(o) for o in ops))


def conv2d(x, weight, bias=None, stride=1, padding=0):
    return F.conv2d(q(x), q(weight), bias, stride, padding)


def gelu(x):
    return F.gelu(x, approximate="none")


def bilinear(x, py, px):
    """x (N, C, H, W) sampled at pixel coordinates py, px (N, M): the
    4-corner bilinear blend, each corner outside the map reading zero.
    -> (N, C, M) fp32."""
    n, c, h, w = x.shape
    flat = x.float().reshape(n, c, h * w)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    out = torch.zeros(n, c, py.shape[1], device=x.device)
    for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx), (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        corner = flat.gather(2, idx[:, None, :].expand(n, c, idx.shape[1]))
        out += corner * torch.where(inside, wt, 0.0)[:, None, :]
    return out


# --- modulated deformable convolution (DCNv2), offsets clipped to +-radius -----


def deform_conv(x, offset, mask, weight, bias, stride: int, radius: int):
    """3x3 DCNv2, pad 1: x (B, C, H, W); offset (B, 18, Ho, Wo) as (dy, dx)
    per tap in row-major tap order, each clamped to [-radius, radius];
    mask (B, 9, Ho, Wo); weight (Cout, C, 3, 3). Each bilinear corner
    outside the map reads zero. Returns (B, Cout, Ho, Wo)."""
    b, c, h, w = x.shape
    ho, wo = offset.shape[2:]
    dev = x.device
    off = offset.float().clamp(-radius, radius).reshape(b, 9, 2, ho, wo)
    ty, tx = torch.meshgrid(torch.arange(3, device=dev), torch.arange(3, device=dev), indexing="ij")
    base_y = (torch.arange(ho, device=dev) * stride - 1)[None, :, None] + ty.reshape(9, 1, 1)
    base_x = (torch.arange(wo, device=dev) * stride - 1)[None, None, :] + tx.reshape(9, 1, 1)
    sy = base_y[None] + off[:, :, 0]  # (B, 9, Ho, Wo)
    sx = base_x[None] + off[:, :, 1]
    cols = bilinear(x.float(), sy.reshape(b, -1), sx.reshape(b, -1)).reshape(b, c, 9, ho, wo)
    cols = cols * mask.float().reshape(b, 1, 9, ho, wo)
    out = einsum("bcthw,oct->bohw", cols, weight.float().reshape(weight.shape[0], c, 9))
    return out + bias.float()[None, :, None, None]


def strided_misread(t: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    """The original CUDA DCN's read of an (N, C, H, W) offset or mask field
    predicted on a larger level by a conv whose output grid is (ho, wo): per
    item, the first C * ho * wo values of the channel-major buffer."""
    n, c = t.shape[:2]
    return t.reshape(n, -1)[:, : c * ho * wo].reshape(n, c, ho, wo)


# --- bidirectional vision-language attention --------------------------------------


def bi_attention(q_v, k_l, v_v, v_l, text_mask, heads: int):
    """GLIP's bi-attention over one score product per head: s = q_v k_l^T
    (q pre-scaled), out_v = softmax over the text (masked tokens out) of s
    times v_l, out_l = softmax over the image tokens of s^T times v_v."""
    b, n, e = q_v.shape
    t = k_l.shape[1]
    d = e // heads

    def split(x):
        return x.reshape(b, -1, heads, d).transpose(1, 2)

    qh, kh, vvh, vlh = split(q_v), split(k_l), split(v_v), split(v_l)
    s = matmul(qh, kh.transpose(-1, -2))  # (B, H, N, T)
    bias = torch.where(text_mask[:, None, None, :] > 0, 0.0, -9e15)
    out_v = matmul(torch.softmax(s + bias, -1), vlh)
    out_l = matmul(torch.softmax(s, -2).transpose(-1, -2), vvh)
    merge = lambda x: x.transpose(1, 2).reshape(b, -1, e)  # noqa: E731
    return merge(out_v), merge(out_l)


# --- multi-scale deformable attention ----------------------------------------------

# The window each encoder query's samples are clamped to, by the ratio of its
# level to the value level (the configuration's MSDA clip): a coarser-or-equal
# value level at an exact ratio k clamps to +-R cells around the query's own
# cell there; a finer one at an exact ratio f to +-3 pixels around the
# query's centre there; any other pair samples freely.
COARSE_RADIUS = {1: 4, 2: 4, 4: 2, 8: 2}
FINER_RATIOS = (2, 4)
FINER_RADIUS = 3


def msda_windows(shapes: Sequence[Tuple[int, int]], device):
    """(L, 4, S): [y_lo, y_hi, x_lo, x_hi] in value-level pixels for every
    encoder query (the pyramid's pixels, flat), +-inf where unclamped."""
    s = sum(h * w for h, w in shapes)
    out = torch.empty(len(shapes), 4, s, device=device)
    out[:, 0::2], out[:, 1::2] = -math.inf, math.inf
    start = 0
    for lq, (hq, wq) in enumerate(shapes):
        yq = torch.arange(hq, device=device, dtype=torch.float32)[:, None].expand(hq, wq).reshape(-1)
        xq = torch.arange(wq, device=device, dtype=torch.float32)[None, :].expand(hq, wq).reshape(-1)
        for lv, (hv, wv) in enumerate(shapes):
            if lv >= lq and hq % hv == 0 and wq % wv == 0 and hq // hv == wq // wv and hq // hv in COARSE_RADIUS:
                k = hq // hv
                r = COARSE_RADIUS[k]
                lo = [torch.floor((c + 0.5) / k - 0.5) - r for c in (yq, xq)]
            elif lv < lq and hv % hq == 0 and wv % wq == 0 and hv // hq == wv // wq and hv // hq in FINER_RATIOS:
                f = hv // hq
                r = FINER_RADIUS
                lo = [f * (c + 0.5) - 0.5 - r for c in (yq, xq)]
            else:
                continue
            for axis, low in zip((0, 2), lo):
                out[lv, axis, start:start + hq * wq] = low
                out[lv, axis + 1, start:start + hq * wq] = low + 2 * r + 1
        start += hq * wq
    return out


def ms_deform_attn(value, shapes, loc, weights, windows=None):
    """value (B, S, nh, hd); loc (B, Q, nh, L, P, 2) as (x, y) in [0, 1];
    weights (B, Q, nh, L, P). Sample pixel (x W - 0.5, y H - 0.5), bilinear,
    zero outside the map; with `windows` (`msda_windows`) each sample pixel
    is clamped to its query's window first. -> (B, Q, nh * hd)."""
    b, s, nh, hd = value.shape
    _, nq, _, nl, npt, _ = loc.shape
    out = torch.zeros(b * nh, hd, nq, npt, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].float().permute(0, 2, 3, 1).reshape(b * nh, hd, h, w)
        px = loc[:, :, :, lvl, :, 0].float() * w - 0.5
        py = loc[:, :, :, lvl, :, 1].float() * h - 0.5
        if windows is not None:
            win = lambda i: windows[lvl, i][None, :, None, None]  # noqa: E731
            py = torch.minimum(torch.maximum(py, win(0)), win(1))
            px = torch.minimum(torch.maximum(px, win(2)), win(3))
        pxs = px.permute(0, 2, 1, 3).reshape(b * nh, nq * npt)
        pys = py.permute(0, 2, 1, 3).reshape(b * nh, nq * npt)
        sampled = bilinear(v, pys, pxs).reshape(b * nh, hd, nq, npt)
        wt = weights[:, :, :, lvl].float().permute(0, 2, 1, 3).reshape(b * nh, 1, nq, npt)
        out = out + q(sampled) * q(wt)
        start += h * w
    return out.sum(-1).reshape(b, nh, hd, nq).permute(0, 3, 1, 2).reshape(b, nq, nh * hd)


# --- boxes, anchors, NMS -------------------------------------------------------------

CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
XFORM_CLIP = math.log(1000.0 / 16)


def fpn_anchors(image_hw, strides, sizes, device) -> List[torch.Tensor]:
    """One square anchor a location per level (Detectron's +1 convention):
    side `size`, centred at (stride - 1) / 2 plus the location's shift."""
    h, w = image_hw
    out = []
    for stride, size in zip(strides, sizes):
        gh, gw = -(-h // stride), -(-w // stride)
        half = 0.5 * (size - 1)
        ctr = 0.5 * (stride - 1)
        ys = torch.arange(gh, device=device, dtype=torch.float32) * stride + ctr
        xs = torch.arange(gw, device=device, dtype=torch.float32) * stride + ctr
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([cx - half, cy - half, cx + half, cy + half], -1).reshape(-1, 4))
    return out


def decode(deltas, anchors):
    """ATSS's BoxCoder: (dx, dy, dw, dh) against xyxy anchors, +1 widths."""
    wa = anchors[..., 2] - anchors[..., 0] + 1
    ha = anchors[..., 3] - anchors[..., 1] + 1
    cx = (anchors[..., 2] + anchors[..., 0]) * 0.5 + deltas[..., 0] / CODER_WEIGHTS[0] * wa
    cy = (anchors[..., 3] + anchors[..., 1]) * 0.5 + deltas[..., 1] / CODER_WEIGHTS[1] * ha
    pw = torch.exp((deltas[..., 2] / CODER_WEIGHTS[2]).clamp(max=XFORM_CLIP)) * wa
    ph = torch.exp((deltas[..., 3] / CODER_WEIGHTS[3]).clamp(max=XFORM_CLIP)) * ha
    return torch.stack([cx - 0.5 * (pw - 1), cy - 0.5 * (ph - 1), cx + 0.5 * (pw - 1), cy + 0.5 * (ph - 1)], -1)


def clip_boxes(boxes, h, w):
    x = boxes[..., 0::2].clamp(0, w - 1)
    y = boxes[..., 1::2].clamp(0, h - 1)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def iou_matrix(a, b):
    """Pairwise IoU with the +1 convention: (N, 4), (M, 4) -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def greedy_nms(boxes, scores, labels, iou_threshold: float, keep_max: int):
    """Greedy class-aware NMS of one image's candidates, highest score first
    (ties to the lower index): a box is dropped if a kept box of its label
    overlaps it by more than `iou_threshold`. Returns the kept indices,
    score ordered, at most `keep_max`."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b, lab = boxes[order], labels[order]
    suppress = ((iou_matrix(b, b) > iou_threshold) & (lab[:, None] == lab[None, :])).cpu().numpy()
    alive = np.ones(len(order), bool)
    kept = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == keep_max:
            break
        alive[i + 1:] &= ~suppress[i, i + 1:]
    return order[torch.tensor(kept, dtype=torch.long, device=order.device)]
