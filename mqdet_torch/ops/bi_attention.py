"""Bidirectional vision-language cross-attention (X-MHA), eval only.

Counterpart of `mqdet_tpu/ops/pallas/bi_attention_pallas.py::
flash_bi_attention` with its signature and layouts:

    flash_bi_attention(q (B,N,E) pre-scaled, k (B,T,E), vv (B,N,E), vl (B,T,E),
                       bias_l (B,T) f32 additive or None, num_heads)
      -> out_v (B,N,E), out_l (B,T,E)

per head: s = q.k^T, out_v = softmax_T(s + bias_l).vl, out_l = softmax_N(s^T).vv.
On a CUDA tensor it launches the two kernels of `csrc/bi_attention.cu` (bf16
in and out, fp32 scores and accumulation; head width 256, T a multiple of 64
up to 256) or raises; on a CPU tensor it runs the plain PyTorch version below,
which is the JAX package's composite (`models/fusion.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mqdet_torch.ops import kernels

launch_count = 0  # wrapper launches (one per call: both kernels) since last reset
HEAD_DIM = 256


def _softmax_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp((x - m).float())
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def bi_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    vv: torch.Tensor,
    vl: torch.Tensor,
    bias_l: Optional[torch.Tensor],
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch bi-attention: both score tensors in the compute dtype,
    softmax reduced in fp32, value products accumulated in fp32."""
    b, n, e = q.shape
    t = k.shape[1]
    h = num_heads
    d = e // h
    qh = q.reshape(b, n, h, d).transpose(1, 2)    # (B, H, N, D)
    kh = k.reshape(b, t, h, d).transpose(1, 2)    # (B, H, T, D)
    vvh = vv.reshape(b, n, h, d).transpose(1, 2)
    vlh = vl.reshape(b, t, h, d).transpose(1, 2)
    attn_v = torch.matmul(qh, kh.transpose(-1, -2))   # (B, H, N, T)
    if bias_l is not None:
        attn_v = attn_v + bias_l[:, None, None, :].to(attn_v.dtype)
    attn_v = _softmax_f32(attn_v, -1)
    out_v = torch.matmul(attn_v, vlh)
    del attn_v
    attn_l = _softmax_f32(torch.matmul(kh, qh.transpose(-1, -2)), -1)  # (B, H, T, N)
    out_l = torch.matmul(attn_l, vvh)
    out_v = out_v.transpose(1, 2).reshape(b, n, e)
    out_l = out_l.transpose(1, 2).reshape(b, t, e)
    return out_v, out_l


def _launch(q, k, vv, vl, bias_l, num_heads):
    global launch_count
    b, n, e = q.shape
    t = k.shape[1]
    if e % num_heads or e // num_heads != HEAD_DIM:
        raise ValueError(f"kernel takes head width {HEAD_DIM}, got {e}/{num_heads}")
    if t % 64 or not 0 < t <= 256:
        raise ValueError(f"kernel takes T a multiple of 64 up to 256, got {t}")
    if n < 1 or vv.shape != q.shape or k.shape != (b, t, e) or vl.shape != k.shape:
        raise ValueError("bad shapes")
    if bias_l is None:
        bias_l = torch.zeros(b, t, dtype=torch.float32, device=q.device)
    if bias_l.shape != (b, t) or bias_l.dtype != torch.float32:
        raise ValueError("bias_l must be (B, T) float32")
    for x in (q, k, vv, vl, bias_l):
        if x.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
        if x.data_ptr() % 16:
            raise ValueError("kernel needs 16-byte aligned tensors")
    for x in (q, k, vv, vl):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"kernel takes bfloat16, got {x.dtype}")
    out_v = torch.empty_like(q)
    out_l = torch.empty_like(k)
    p = ctypes.c_void_p
    code = kernels.lib().mqdet_bi_attention_forward(
        p(q.data_ptr()), p(k.data_ptr()), p(vv.data_ptr()), p(vl.data_ptr()),
        p(bias_l.data_ptr()), p(out_v.data_ptr()), p(out_l.data_ptr()),
        b, n, t, e, num_heads, p(kernels.stream_ptr(q.device)),
    )
    kernels.check(code, "mqdet_bi_attention_forward")
    launch_count += 1
    return out_v, out_l


def flash_bi_attention(q, k, vv, vl, bias_l, num_heads):
    """See module docstring."""
    if q.device.type == "cpu":
        return bi_attention_plain(q, k, vv, vl, bias_l, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no bi-attention kernel for device {q.device}")
    return _launch(q, k, vv, vl, bias_l, num_heads)
