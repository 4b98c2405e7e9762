"""Modulated deformable convolution (DCNv2), 3x3, pad 1, stride 1 or 2.

Counterpart of `mqdet_tpu/ops/deform_conv.py`. The public function keeps the
JAX package's signature and NHWC layout:

    modulated_deform_conv(x (B,H,W,C), offset (B,Ho,Wo,18), mask (B,Ho,Wo,9),
                          weight (3,3,C,Cout), bias (Cout,) or None, stride)

On a CUDA tensor it launches the hand-written kernel of `csrc/deform_conv.cu`
(bf16 in and out, fp32 accumulation) or raises; on a CPU tensor it runs the
plain PyTorch version below. Sampling is exact 4-corner bilinear with zeros
outside the image and no offset clipping (the TPU kernel's +-radius window
exists only for the TPU).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mqdet_torch.ops import kernels

launch_count = 0  # kernel launches since the caller last reset it


def _bilinear_gather(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); y, x (B, P) fractional -> (B, P, C). Zero for samples
    with y <= -1, y >= H, x <= -1 or x >= W, and for each corner outside the
    image (deformable im2col semantics)."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device)[:, None]
    oob = (y <= -1.0) | (y >= h) | (x <= -1.0) | (x >= w)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly, lx = y - y0, x - x0
    out = torch.zeros(b, y.shape[1], c, dtype=img.dtype, device=img.device)
    for yy, xx, wt in (
        (y0, x0, (1 - ly) * (1 - lx)),
        (y0, x0 + 1, (1 - ly) * lx),
        (y0 + 1, x0, ly * (1 - lx)),
        (y0 + 1, x0 + 1, ly * lx),
    ):
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1) & ~oob
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        wt = torch.where(inb, wt, torch.zeros_like(wt)).to(img.dtype)
        out += flat[bidx, idx] * wt[..., None]
    return out


def modulated_deform_conv_plain(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
    """Plain PyTorch DCNv2 (the exact gather form of the JAX package's
    `modulated_deform_conv`): bilinear im2col then one matmul."""
    b, h, w, c = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    cout = weight.shape[-1]
    dev = x.device
    ys = torch.arange(ho, device=dev, dtype=torch.float32) * stride - 1.0
    xs = torch.arange(wo, device=dev, dtype=torch.float32) * stride - 1.0
    taps = torch.arange(3, device=dev, dtype=torch.float32)
    base_y = (ys[:, None, None, None] + taps[None, None, :, None]).expand(ho, wo, 3, 3)
    base_x = (xs[None, :, None, None] + taps[None, None, None, :]).expand(ho, wo, 3, 3)
    off = offset.float().reshape(b, ho, wo, 9, 2)
    sy = (base_y.reshape(ho, wo, 9)[None] + off[..., 0]).reshape(b, -1)
    sx = (base_x.reshape(ho, wo, 9)[None] + off[..., 1]).reshape(b, -1)
    patches = _bilinear_gather(x, sy, sx).reshape(b, ho, wo, 9, c)
    patches = patches * mask.reshape(b, ho, wo, 9, 1).to(x.dtype)
    out = torch.matmul(patches.reshape(b, ho, wo, 9 * c), weight.reshape(9 * c, cout))
    if bias is not None:
        out = out + bias
    return out


def reinterpret_offsets_strided(
    offset: torch.Tensor, mask: torch.Tensor, ho: int, wo: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference CUDA kernel's read of an (offset, mask) pair predicted at
    a larger level by a conv whose output grid is (ho, wo): it indexes the
    flat channel-major buffer with the output's strides. Done PER ITEM (each
    item's own C*H*W view, then its first C*ho*wo values), as the JAX package
    does: one flat view of the whole batch would leak offsets across items,
    which are independent prompt chunks. NHWC in, NHWC out."""
    b = offset.shape[0]

    def misread(t: torch.Tensor) -> torch.Tensor:
        ch = t.shape[-1]
        flat = t.permute(0, 3, 1, 2).reshape(b, -1)
        return flat[:, : ch * ho * wo].reshape(b, ch, ho, wo).permute(0, 2, 3, 1).contiguous()

    return misread(offset), misread(mask)


def _launch(x, offset, mask, weight, bias, stride) -> torch.Tensor:
    global launch_count
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} not supported")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"bad shapes x {tuple(x.shape)} weight {tuple(weight.shape)}")
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    cout = weight.shape[-1]
    if weight.shape != (3, 3, c, cout):
        raise ValueError(f"bad shapes x {tuple(x.shape)} weight {tuple(weight.shape)}")
    if offset.shape != (b, ho, wo, 18) or mask.shape != (b, ho, wo, 9):
        raise ValueError(
            f"offset {tuple(offset.shape)} / mask {tuple(mask.shape)} do not match "
            f"output grid {(b, ho, wo)}"
        )
    if c % 8 or cout % 8:
        raise ValueError(f"C={c} and Cout={cout} must be multiples of 8")
    if x.numel() >= 2**31:
        raise ValueError("x too large for 32-bit element offsets")
    tensors = [x, offset, mask, weight] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("kernel needs 16-byte aligned tensors")
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({cout},)")
    out = torch.empty(b, ho, wo, cout, dtype=x.dtype, device=x.device)
    p = ctypes.c_void_p
    code = kernels.lib().mqdet_dcn_forward(
        p(x.data_ptr()), p(offset.data_ptr()), p(mask.data_ptr()),
        p(weight.data_ptr()), p(bias.data_ptr() if bias is not None else None),
        p(out.data_ptr()), b, h, w, c, ho, wo, cout, stride,
        p(kernels.stream_ptr(x.device)),
    )
    kernels.check(code, "mqdet_dcn_forward")
    launch_count += 1
    return out


def modulated_deform_conv(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
    """DCNv2 (see module docstring). Returns (B, Ho, Wo, Cout), Ho = ceil(H/stride)."""
    if x.device.type == "cpu":
        return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no DCN kernel for device {x.device}")
    return _launch(x, offset, mask, weight, bias, stride)
