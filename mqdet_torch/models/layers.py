"""Small modules and functions shared by the model stack.

Counterpart of `mqdet_tpu/models/layers.py`. Feature maps are NCHW tensors
kept in `torch.channels_last` memory format, so that `x.permute(0, 2, 3, 1)`
is the NHWC layout the kernels take, without a copy. Norm statistics are
taken in fp32 whatever the compute dtype, as flax does; GELU is exact.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def cl(x: torch.Tensor) -> torch.Tensor:
    """Make a 4-D tensor channels_last-contiguous (a no-op if it already is)."""
    return x.contiguous(memory_format=torch.channels_last)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics for any input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float() if self.weight is not None else None
        b = self.bias.float() if self.bias is not None else None
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics; flax's default epsilon 1e-6.
    Returns channels_last."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps)
        return cl(y.to(x.dtype))


class Scale(nn.Module):
    """Learnable scalar multiplier (reference layers/scale.py)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


def training_draws(deterministic: bool, generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """The generator a training forward draws from; None when deterministic."""
    if deterministic:
        return None
    if generator is None:
        raise ValueError("deterministic=False needs a torch.Generator for its draws")
    return generator


def remat(fn: Callable, *args, enabled: bool = True, generator: Optional[torch.Generator] = None):
    """fn(*args) as one activation-checkpointed segment (the JAX package's
    `nn.remat`, `TPU.REMAT`): under `torch.utils.checkpoint` (non-reentrant)
    where `enabled` and autograd records the call, so the backward recomputes
    the segment's forward instead of keeping its activations; else, under
    `no_grad` / `inference_mode` as in evaluation, fn(*args) directly with no
    recompute. `generator`, the explicit source of the segment's draws
    (checkpoint restores only the global RNGs), is set back to its state at
    entry for the recompute and restored after it, so the backward
    differentiates the masks the forward drew."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    entry = generator.get_state()
    first = True

    def segment(*a):
        nonlocal first
        if first:  # the forward
            first = False
            return fn(*a)
        after = generator.get_state()
        generator.set_state(entry)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)

    return checkpoint(segment, *args, use_reentrant=False)


def drop_path(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Stochastic depth per sample (the JAX package's DropPath): with a
    generator and rate > 0, each item is kept with probability 1 - rate,
    drawn as uniform < 1 - rate, and scaled by 1 / (1 - rate); else x."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=x.device)
    return x * (u < keep).to(x.dtype) / keep


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """flax's nn.Dropout: keep with probability 1 - rate (uniform < 1 - rate),
    scaled by 1 / (1 - rate); the identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def h_sigmoid(x: torch.Tensor, h_max: float = 1.0) -> torch.Tensor:
    """relu6(x + 3) * h_max / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) * (h_max / 6.0)


class HSigmoid(nn.Module):
    def forward(self, x):
        return h_sigmoid(x)


class DYReLU(nn.Module):
    """Dynamic ReLU as DyConv uses it: y = max(a1 x + b1, a2 x + b2) with
    per-channel coefficients from fc(avgpool(x)). `fc` indices follow the
    reference (fc.0, fc.2)."""

    def __init__(self, channels: int, reduction: int = 4, lambda_a: float = 1.0):
        super().__init__()
        self.channels = channels
        self.lambda_a = lambda_a
        squeeze = channels // reduction
        self.fc = nn.Sequential(
            nn.Linear(channels, squeeze), nn.ReLU(), nn.Linear(squeeze, channels * 4), HSigmoid()
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        theta = self.fc(x.mean(dim=(2, 3)))  # (B, 4C)
        a1, b1, a2, b2 = torch.split(theta, self.channels, dim=-1)
        a1 = (a1 - 0.5) * 2 * self.lambda_a + 1.0
        a2 = (a2 - 0.5) * 2 * self.lambda_a
        b1 = b1 - 0.5
        b2 = b2 - 0.5
        v = lambda t: t[:, :, None, None]  # noqa: E731
        return torch.maximum(x * v(a1) + v(b1), x * v(a2) + v(b2))


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class GCPFeedForward(nn.Module):
    """GCP FeedForward: LayerNorm -> Linear(no bias) -> GELU -> Linear(no bias)."""

    def __init__(self, dim: int, mult: float = 4.0, out_dim: int = None):
        super().__init__()
        inner = int(dim * mult)
        self.norm = LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, inner, bias=False)
        self.linear2 = nn.Linear(inner, out_dim if out_dim is not None else dim, bias=False)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(self.norm(x)), approximate="none"))


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2) on NCHW (floors odd sizes, like flax's VALID pool; a
    1-pixel side gives an empty map, as there)."""
    if min(x.shape[-2:]) < 2:
        return x.new_zeros(*x.shape[:-2], x.shape[-2] // 2, x.shape[-1] // 2)
    return F.avg_pool2d(x, 2, 2)


def upsample_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Legacy F.upsample_bilinear: bilinear with align_corners=True."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return cl(F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True))
