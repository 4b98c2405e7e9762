"""Modulated deformable convolution (DCNv2), 3x3, pad 1, stride 1 or 2.

Counterpart of `mqdet_tpu/ops/deform_conv.py` and of the two Pallas DCN
kernels. The public functions keep the JAX package's signatures (without
`interpret`) and NHWC layout: x (B,H,W,C), offset (B,Ho,Wo,18) as (dy, dx) per
tap, mask (B,Ho,Wo,9), weight (3,3,C,Cout), bias (Cout,) or None.

    modulated_deform_conv            exact sampling; the gather kernel
                                     `dcn_gather_kernel`, counted as `dcn`
    modulated_deform_conv_window     offsets clipped to +-radius; the same
    modulated_deform_conv_pallas_gather  kernel's clipped mode, counted as
                                     `dcn_gather_clip` (the TPU's K2)
    modulated_deform_conv_pallas     offsets clipped to +-radius; the band
                                     kernel `dcn_band` (K1), versions
                                     1/3/5/6 (K1b) and the x_tiles wrapper

The clipped functions equal the exact one on offsets clamped to
[-radius, radius] (zero padding outside the image either way). On a CUDA
tensor each launches its hand-written kernel of `csrc/deform_conv.cu` (bf16 in
and out, fp32 accumulation) or raises; on a CPU tensor it runs the plain
PyTorch version below. `block_rows` changes no result: on the card it sets the
band kernel's tile rows.

Training. Where an input needs a gradient, each public function runs through
`DeformConvFunction`, as the JAX package's `_mdc_pallas_diff` does: the same
forward (kernel or plain version), the inputs saved, and a backward that
recomputes in fp32 the VJP of the function JAX differentiates. The clipped
routes take the window composite's VJP (`modulated_deform_conv_window_vjp`:
JAX's hat-function conventions at integer sample coordinates and the clip's
half gradient at exactly +-radius); the exact route takes PyTorch autograd of
`modulated_deform_conv_plain`, the exact composite's own. The launchers refuse
a call that needs a gradient: their output would have no `grad_fn`.

Flops. Every call of a public function reports `dcn_flops` under the JAX
package's family name `dcn_pallas` (`utils/flop_count.py`), on every route and
through `DeformConvFunction`'s forward: the exact and the gather routes too,
whose JAX counterparts are composites the compiler counts.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mqdet_torch.ops import kernels
from mqdet_torch.utils import flop_count

launch_count = 0          # exact kernel launches ("dcn") since the caller last reset it
clip_launch_count = 0     # its clipped mode ("dcn_gather_clip")
band_launch_count = 0     # the band kernel, version 2 ("dcn_band")
band_v1_launch_count = 0  # versions 1, 3, 5, 6 ("dcn_band_v1" ...)
band_v3_launch_count = 0
band_v5_launch_count = 0
band_v6_launch_count = 0
_BAND_COUNTER = {1: "band_v1_launch_count", 2: "band_launch_count", 3: "band_v3_launch_count",
                 5: "band_v5_launch_count", 6: "band_v6_launch_count"}

MAX_WINDOW_RADIUS = 8  # the largest radius the band kernel takes (and `utils/calibrate.py` uses)
# Mirror of the band kernel's shared-memory layout (csrc/deform_conv.cu,
# `band_layout`); the C entry point refuses a count that differs from its own.
SMEM_LIMIT = 232448   # dynamic shared memory a block may use
BAND_BM = 128         # output positions per block
BAND_N = 256          # output channels per block
SLAB_BYTES = 8192     # one (tap, 16-channel group) weight slab, 16 x 256 bf16
TABLE_BYTES = 23760   # the per-block tables
BAR_BYTES = 160       # the mbarriers
MAX_STAGES, MIN_STAGES = 8, 4  # the weight ring's stages
MAX_BOX = 256         # a TMA box's largest side


def _sample_patches(x, offset, mask, stride, fold_mask, exact=True):
    """(B, Ho, Wo, 9, C) modulated bilinear samples in x.dtype. Zero for
    each corner outside the image and, where `exact`, for samples with
    y <= -1, y >= H, x <= -1 or x >= W (deformable im2col semantics; for
    finite clipped offsets the corners' zero padding gives the same). As in
    JAX's composites the corner's value is zeroed, not its weight, so a NaN
    offset gives a NaN sample, unless `exact` and its other coordinate lies
    outside (JAX's exact composite zeroes it; its window composite does
    not). With fold_mask the mask multiplies each corner weight in fp32
    before the weight is cast to x.dtype; else it multiplies the blended
    sample."""
    b, h, w, c = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    dev = x.device
    ys = torch.arange(ho, device=dev, dtype=torch.float32) * stride - 1.0
    xs = torch.arange(wo, device=dev, dtype=torch.float32) * stride - 1.0
    taps = torch.arange(3, device=dev, dtype=torch.float32)
    base_y = (ys[:, None, None, None] + taps[None, None, :, None]).expand(ho, wo, 3, 3)
    base_x = (xs[None, :, None, None] + taps[None, None, None, :]).expand(ho, wo, 3, 3)
    off = offset.float().reshape(b, ho, wo, 9, 2)
    sy = (base_y.reshape(ho, wo, 9)[None] + off[..., 0]).reshape(b, -1)
    sx = (base_x.reshape(ho, wo, 9)[None] + off[..., 1]).reshape(b, -1)
    mk = mask.float().reshape(b, -1)

    flat = x.reshape(b, h * w, c)
    bidx = torch.arange(b, device=dev)[:, None]
    oob = (sy <= -1.0) | (sy >= h) | (sx <= -1.0) | (sx >= w)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    out = torch.zeros(b, sy.shape[1], c, dtype=x.dtype, device=dev)
    for yy, xx, wt in (
        (y0, x0, (1 - ly) * (1 - lx)),
        (y0, x0 + 1, (1 - ly) * lx),
        (y0 + 1, x0, ly * (1 - lx)),
        (y0 + 1, x0 + 1, ly * lx),
    ):
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = torch.nan_to_num(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()  # NaN offsets: any index
        if fold_mask:
            wt = wt * mk
        out += torch.where(inb[..., None], flat[bidx, idx], 0.0) * wt.to(x.dtype)[..., None]
    if exact:
        out = torch.where(oob[..., None], 0.0, out)
    out = out.reshape(b, ho, wo, 9, c)
    if not fold_mask:
        out = out * mask.reshape(b, ho, wo, 9, 1).to(x.dtype)
    return out


def _contract(patches, weight, bias):
    b, ho, wo, _, c = patches.shape
    out = torch.matmul(patches.reshape(b, ho, wo, 9 * c), weight.reshape(9 * c, weight.shape[-1]))
    return out + bias if bias is not None else out


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
    return _contract(_sample_patches(x, offset, mask, stride, False), weight, bias)


def modulated_deform_conv_clipped_plain(x, offset, mask, weight, bias=None, stride=1, radius=2):
    """The clipped DCNv2 of the window composite, K1 and K2: the bilinear
    im2col on offsets clamped to [-radius, radius], zero padding corner by
    corner (a NaN offset stays NaN)."""
    return _contract(_sample_patches(x, offset.clamp(-radius, radius), mask, stride, False, exact=False), weight, bias)


def modulated_deform_conv_v3_plain(x, offset, mask, weight, bias=None, stride=1, radius=2):
    """K1 version 3's function: the clipped DCNv2 with the 4-corner blend in
    x.dtype. Each corner weight (bilinear times mask, fp32) is cast to
    x.dtype, and the products and their sum are taken in x.dtype. For fp32
    inputs it is the clipped plain version up to fp32 rounding."""
    return _contract(_sample_patches(x, offset.clamp(-radius, radius), mask, stride, True, exact=False), weight, bias)


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


def resize_offsets(
    offset: torch.Tensor, mask: torch.Tensor, ho: int, wo: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DyConv's `offset_compat="resample"`: the 27-channel (offset, mask)
    field resampled to (ho, wo) by half-pixel bilinear interpolation
    (align_corners=False); offset values are not rescaled. NHWC in and out."""
    om = torch.cat([offset, mask], dim=-1).permute(0, 3, 1, 2)
    if om.shape[2:] != (ho, wo):
        om = F.interpolate(om, size=(ho, wo), mode="bilinear", align_corners=False)
    om = om.permute(0, 2, 3, 1)
    return om[..., :18].contiguous(), om[..., 18:].contiguous()


def _check(x, offset, mask, weight, bias, stride):
    """Shapes, dtype, layout and alignment the kernels take; returns
    (B, H, W, C, Ho, Wo, Cout)."""
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
    if x.numel() >= 2**31 or b * ho * wo * 18 >= 2**31:
        raise ValueError("x too large for 32-bit element offsets")
    for t in [x, offset, mask, weight] + ([bias] if bias is not None else []):
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
    return b, h, w, c, ho, wo, cout


def _pointers(x, offset, mask, weight, bias, out):
    p = ctypes.c_void_p
    return (p(x.data_ptr()), p(offset.data_ptr()), p(mask.data_ptr()), p(weight.data_ptr()),
            p(bias.data_ptr() if bias is not None else None), p(out.data_ptr()))


def _launch(x, offset, mask, weight, bias, stride, radius) -> torch.Tensor:
    """The gather kernel: exact for radius None, else clipped (K2)."""
    global launch_count, clip_launch_count
    kernels.refuse_grad("mqdet_dcn_forward", x, offset, mask, weight, bias)
    b, h, w, c, ho, wo, cout = _check(x, offset, mask, weight, bias, stride)
    if radius is not None and radius < 0:
        raise ValueError(f"radius {radius} < 0")
    out = torch.empty(b, ho, wo, cout, dtype=x.dtype, device=x.device)
    code = kernels.lib().mqdet_dcn_forward(
        *_pointers(x, offset, mask, weight, bias, out), b, h, w, c, ho, wo, cout, stride,
        -1 if radius is None else int(radius), ctypes.c_void_p(kernels.stream_ptr(x.device)),
    )
    kernels.check(code, "mqdet_dcn_forward")
    if radius is None:
        launch_count += 1
    else:
        clip_launch_count += 1
    return out


def dcn_flops(offset: torch.Tensor, x: torch.Tensor, weight: torch.Tensor) -> float:
    """The JAX package's analytic count (`deform_conv_pallas.py:636-645`): per
    output position, 9 taps of a 4-corner bilinear blend and the modulation
    (15 flops a channel), then the (9C, Cout) product."""
    b, ho, wo = offset.shape[0], offset.shape[1], offset.shape[2]
    c, cout = x.shape[-1], weight.shape[-1]
    return b * ho * wo * 9 * c * (2.0 * cout + 15.0)


def _on_device(x, plain, launch):
    return plain() if kernels.runs_plain(x) else launch()


def _reported(run):
    """`run` reporting its call's flops (`dcn_flops`, as `dcn_pallas`)."""
    def reported(x, offset, mask, weight, bias):
        with flop_count.kernel(dcn_pallas=dcn_flops(offset, x, weight)):
            return run(x, offset, mask, weight, bias)

    return reported


def modulated_deform_conv(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
    """Exact DCNv2 (the JAX package's `modulated_deform_conv`). Returns
    (B, Ho, Wo, Cout), Ho = ceil(H/stride)."""
    def run(x, offset, mask, weight, bias):
        return _on_device(
            x, lambda: modulated_deform_conv_plain(x, offset, mask, weight, bias, stride),
            lambda: _launch(x, offset, mask, weight, bias, stride, None),
        )

    return _differentiable(_reported(run), x, offset, mask, weight, bias, stride, None)


def modulated_deform_conv_window(x, offset, mask, weight, bias=None, stride=1, radius=3, block_rows=8):
    """DCNv2 with offsets clipped to [-radius, radius] (the JAX package's
    window composite, `ops/deform_conv.py:171`). On the card: the clipped
    4-corner gather kernel (K2)."""
    def run(x, offset, mask, weight, bias):
        return _on_device(
            x, lambda: modulated_deform_conv_clipped_plain(x, offset, mask, weight, bias, stride, radius),
            lambda: _launch(x, offset, mask, weight, bias, stride, radius),
        )

    return _differentiable(_reported(run), x, offset, mask, weight, bias, stride, radius)


def modulated_deform_conv_pallas_gather(x, offset, mask, weight, bias=None, stride=1, radius=2, block_rows=16):
    """The TPU's 4-corner gather kernel's entry point
    (`deform_conv_gather_pallas.py:132`): the same function and kernel as
    `modulated_deform_conv_window`, with its own default radius."""
    return modulated_deform_conv_window(x, offset, mask, weight, bias, stride, radius, block_rows)


def band_version(version: int) -> int:
    """The launcher's rule: 2, 3, 5 and 6 select that version, any other value version 1."""
    return version if version in (2, 3, 5, 6) else 1


def band_tile(block_rows: int) -> Tuple[int, int]:
    """The band kernel's tile (rows, columns) of 128 output positions: rows is
    block_rows rounded down to a power of two in [1, 128]."""
    br = 1 << (max(1, min(int(block_rows), BAND_BM)).bit_length() - 1)
    return br, BAND_BM // br


def band_layout(version: int, bk: int, band_px: int, stages: int) -> int:
    """Shared-memory bytes of a band launch (the kernel's `band_layout`): 1024
    bytes of alignment slack, the bf16 band buffers (one for versions 1 and
    6, else two), version 6's fp32 band, the weight ring, the tables, the
    barriers; each buffer a multiple of 1024 bytes."""
    up = lambda v: -(-v // 1024) * 1024  # noqa: E731
    nbuf = 1 if version in (1, 6) else 2
    band32 = up(band_px * bk * 4) if version == 6 else 0
    return 1024 + nbuf * up(band_px * bk * 2) + band32 + stages * SLAB_BYTES + TABLE_BYTES + BAR_BYTES


def band_geometry(c: int, stride: int, radius: int, block_rows: int, version: int):
    """(rows, cols, chunk, stages, shared-memory bytes) of a band launch: the
    largest channel chunk of 64, 32 and 16 that divides C and fits with at
    least MIN_STAGES weight slabs, then the most stages up to MAX_STAGES.
    Raises ValueError for a radius outside [0, MAX_WINDOW_RADIUS], a band
    wider than a TMA box, or one that does not fit a block."""
    if not 0 <= radius <= MAX_WINDOW_RADIUS:
        raise ValueError(f"radius {radius} outside [0, {MAX_WINDOW_RADIUS}]: use the gather kernel")
    br, bw = band_tile(block_rows)
    rows, cols = (br - 1) * stride + 2 * radius + 4, (bw - 1) * stride + 2 * radius + 4
    v = band_version(version)
    if max(rows, cols) <= MAX_BOX:
        for bk in (64, 32, 16):
            if c % bk == 0 and band_layout(v, bk, rows * cols, MIN_STAGES) <= SMEM_LIMIT:
                stages = max(n for n in range(MIN_STAGES, MAX_STAGES + 1)
                             if band_layout(v, bk, rows * cols, n) <= SMEM_LIMIT)
                return br, bw, bk, stages, band_layout(v, bk, rows * cols, stages)
    raise ValueError(
        f"band of radius {radius}, stride {stride}, tile {br}x{bw} ({rows}x{cols} pixels) does not fit a block's "
        f"shared memory or a TMA box (C={c})"
    )


def band_fast_share(offset: torch.Tensor, stride: int, radius: int, block_rows: int) -> float:
    """Share of (tile, tap) pairs that take version 5's fast path: those whose
    clipped floor(rel) is the same, in both axes, at every position of the
    band kernel's tile inside the output grid (the kernel's own rule)."""
    br, bw = band_tile(block_rows)
    b, ho, wo, _ = offset.shape
    taps = torch.tensor([[ky - 1, kx - 1] for ky in range(3) for kx in range(3)], dtype=torch.float32,
                        device=offset.device)
    fl = torch.floor(offset.float().reshape(b, ho, wo, 9, 2).clamp(-radius, radius) + taps)
    ty, tx = -(-ho // br), -(-wo // bw)
    pad = (0, 0, 0, tx * bw - wo, 0, ty * br - ho)  # positions past the grid take no part
    hi = F.pad(fl.reshape(b, ho, wo, 18), pad, value=float("-inf"))
    lo = F.pad(fl.reshape(b, ho, wo, 18), pad, value=float("inf"))
    hi = hi.reshape(b, ty, br, tx, bw, 9, 2).amax(dim=(2, 4))
    lo = lo.reshape(b, ty, br, tx, bw, 9, 2).amin(dim=(2, 4))
    return float((hi == lo).all(-1).float().mean())


def _launch_band(x, offset, mask, weight, bias, stride, radius, block_rows, version) -> torch.Tensor:
    kernels.refuse_grad("mqdet_dcn_band_forward", x, offset, mask, weight, bias)
    b, h, w, c, ho, wo, cout = _check(x, offset, mask, weight, bias, stride)
    v = band_version(version)
    br, bw, bk, stages, nbytes = band_geometry(c, stride, radius, block_rows, v)
    if cout % BAND_N:  # the kernel's weight slabs are 256 columns wide: zeros past Cout
        weight = F.pad(weight, (0, BAND_N - cout % BAND_N))
    out = torch.empty(b, ho, wo, cout, dtype=x.dtype, device=x.device)
    code = kernels.lib().mqdet_dcn_band_forward(
        *_pointers(x, offset, mask, weight, bias, out), b, h, w, c, ho, wo, cout, stride, int(radius),
        br, bw, v, bk, stages, nbytes, ctypes.c_void_p(kernels.stream_ptr(x.device)),
    )
    kernels.check(code, "mqdet_dcn_band_forward")
    globals()[_BAND_COUNTER[v]] += 1
    return out


def _band(x, offset, mask, weight, bias, stride, radius, block_rows, version):
    plain = modulated_deform_conv_v3_plain if band_version(version) == 3 else modulated_deform_conv_clipped_plain
    return _on_device(
        x, lambda: plain(x, offset, mask, weight, bias, stride, radius),
        lambda: _launch_band(x, offset, mask, weight, bias, stride, radius, block_rows, version),
    )


def _x_tiled(x, offset, mask, weight, bias, stride, radius, block_rows, version, t):
    """The TPU launcher's x_tiles (`_mdc_dispatch` :701): the output columns
    split into t tiles of ceil(Wo/t), each run with a halo of e outputs on
    its left and e_r on its right whose input window holds every pixel its
    real outputs read with a non-zero weight (x zero-padded past the image),
    all t tiles as extra batch entries of one call, then stitched. Each real
    output sees the same pixels, weights and products as untiled, so the
    result is bitwise the untiled one."""
    b, h, w, c = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    s = stride
    wo_t = -(-wo // t)
    e = -(-(radius + 1) // s)          # e * s >= 1 + radius: the leftmost pixel a real output reads
    e_r = -(-(radius + 2) // s) - 1    # (e_r + 1) * s >= radius + 2: the rightmost
    n = wo_t + e + e_r                 # output columns per tile
    wt_ = n * s                        # input columns per tile window
    right = max(0, (t - 1) * wo_t * s + wt_ - e * s - w)
    xpad = F.pad(x, (0, 0, e * s, right))
    xt = torch.stack([xpad[:, :, tt * wo_t * s: tt * wo_t * s + wt_] for tt in range(t)], 1)
    xt = xt.reshape(b * t, h, wt_, c)
    # halo outputs take the nearest real column's offsets and mask (edge
    # padding keeps version 5's tiles tight); they are cropped below
    cols = torch.arange(t, device=x.device)[:, None] * wo_t - e + torch.arange(n, device=x.device)[None]
    cols = cols.clamp(0, wo - 1).reshape(-1)

    def per_tile(a):
        ch = a.shape[-1]
        return a[:, :, cols].reshape(b, ho, t, n, ch).permute(0, 2, 1, 3, 4).reshape(b * t, ho, n, ch).contiguous()

    out = _band(xt, per_tile(offset), per_tile(mask), weight, bias, stride, radius, block_rows, version)
    out = out.reshape(b, t, ho, n, -1)[:, :, :, e: e + wo_t].permute(0, 2, 1, 3, 4)
    return out.reshape(b, ho, t * wo_t, -1)[:, :, :wo].contiguous()


def modulated_deform_conv_pallas(
    x, offset, mask, weight, bias=None, stride=1, radius=2, block_rows=8, version=2, x_tiles=0,
):
    """DCNv2 with offsets clipped to [-radius, radius], the function of the
    TPU's K1 launcher (`deform_conv_pallas.py:631`). On the card: the band
    kernel, version `version` (2, 3, 5, 6, anything else 1), `block_rows`
    output rows per tile; `x_tiles` > 1 splits the output columns into that
    many tiles run as extra batch entries of one launch (0 means 1). On the
    CPU: the clipped plain version (version 3: its x.dtype blend), through the
    same x_tiles wrapper."""
    def run(x, offset, mask, weight, bias):
        if x_tiles > 1:
            return _x_tiled(x, offset, mask, weight, bias, stride, radius, block_rows, version, int(x_tiles))
        return _band(x, offset, mask, weight, bias, stride, radius, block_rows, version)

    return _differentiable(_reported(run), x, offset, mask, weight, bias, stride, radius)


class DeformConvFunction(torch.autograd.Function):
    """forward: `run(x, offset, mask, weight, bias)` (a kernel or a plain
    version), saving the inputs; backward: the fp32 VJP of the clipped
    function (`radius` an int) or of the exact one (`radius` None), in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, run, stride, radius):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        ctx.stride, ctx.radius = stride, radius
        return run(x, offset, mask, weight, bias)

    @staticmethod
    def backward(ctx, g):
        ins = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with torch.profiler.record_function("dcn_backward"):  # the span chip_smoke's phase 8 reads
            if ctx.radius is None:
                grads = modulated_deform_conv_exact_vjp(*ins, g, ctx.stride, needs)
            else:
                grads = modulated_deform_conv_window_vjp(*ins, g, ctx.stride, ctx.radius, needs)
        grads = [gr.to(t.dtype) if gr is not None else None for gr, t in zip(grads, ins)]
        return (*grads, None, None, None)


def _differentiable(run, x, offset, mask, weight, bias, stride, radius):
    if kernels.needs_grad(x, offset, mask, weight, bias):
        return DeformConvFunction.apply(x, offset, mask, weight, bias, run, stride, radius)
    return run(x, offset, mask, weight, bias)


def modulated_deform_conv_exact_vjp(x, offset, mask, weight, bias, g, stride=1, needs=(True,) * 5):
    """VJP of the exact DCNv2 in fp32: PyTorch autograd of
    `modulated_deform_conv_plain`, the exact composite's autodiff (floor
    corners: a forward difference at integer sample coordinates). Returns
    (dx, doffset, dmask, dweight, dbias), None where `needs` is False."""
    ins = [t.detach().float().requires_grad_(bool(n)) if t is not None else None
           for t, n in zip((x, offset, mask, weight, bias), needs)]
    with torch.enable_grad():
        out = modulated_deform_conv_plain(*ins, stride=stride)
        wanted = [t for t in ins if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, g.float()))
    return tuple(next(got) if t is not None and t.requires_grad else None for t in ins)


def _axis_weights(rel: torch.Tensor, radius: int):
    """Per axis of the window composite at rel (tap + clipped offset, in
    [-1-r, 1+r]): floor f, the value weights (1 - frac, frac) of rows f and
    f + 1, and the derivative weights of rows f - 1, f, f + 1 under JAX's
    conventions for hat(t) = max(0, 1 - |t|): d|t|/dt = +1 at t = 0 and
    max's half gradient at its tie, so an integer rel gives (-1/2, -1, +1/2)
    (the first only where row f - 1 lies inside the window, f > -1 - r) and
    any other rel (0, -1, +1)."""
    f = torch.floor(rel)
    frac = rel - f
    integer = frac == 0
    value = (1.0 - frac, frac)
    half = torch.full_like(rel, 0.5)
    deriv = (
        torch.where(integer & (f > -1 - radius), -half, torch.zeros_like(rel)),
        torch.full_like(rel, -1.0),
        torch.where(integer, half, torch.ones_like(rel)),
    )
    return f, value, deriv


def modulated_deform_conv_window_vjp(x, offset, mask, weight, bias, g, stride=1, radius=2, needs=(True,) * 5):
    """VJP, in fp32, of the clipped DCNv2 as the JAX package's window
    composite (`mqdet_tpu/ops/deform_conv.py:171`) defines it under
    `jax.vjp`, the backward of `_mdc_pallas_diff`:

        sample(p, k) = sum_d hat(rel_y - d_y) hat(rel_x - d_x) x[p s + d]
        rel = tap + clip(offset, -r, r),  d in [-1-r, 2+r]^2

    Gradients of x and mask and the product's are those of the bilinear
    sample; the offset's follows JAX at the kinks (`_axis_weights`) and takes
    the clip's half gradient at exactly +-r (jnp.clip is max then min, each
    splitting its tie). Formula form: eight (B, P*9, C) gathers and four
    scatter-adds, no (2r+4)^2 window tensor. Returns (dx, doffset, dmask,
    dweight, dbias), None where `needs` is False."""
    b, h, w, c = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    cout = weight.shape[-1]
    dev = x.device
    xf = x.detach().float().reshape(b * h * w, c)
    gf = g.detach().float()
    m = mask.detach().float()
    off = offset.detach().float().reshape(b, ho, wo, 9, 2)
    r = float(radius)
    cg = torch.where(off.abs() < r, 1.0, torch.where(off.abs() == r, 0.5, 0.0))
    tap = torch.tensor([[ky - 1, kx - 1] for ky in range(3) for kx in range(3)], dtype=torch.float32, device=dev)
    rel = off.clamp(-r, r) + tap
    fy, vy, dy = _axis_weights(rel[..., 0], radius)
    fx, vx, dx_ = _axis_weights(rel[..., 1], radius)
    py = (torch.arange(ho, device=dev, dtype=torch.float32) * stride)[None, :, None, None]
    px = (torch.arange(wo, device=dev, dtype=torch.float32) * stride)[None, None, :, None]
    ry, rx = py + fy, px + fx  # (B, Ho, Wo, 9): input row / column of corner (0, 0)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None, None]

    def corner(a, bb):
        """(flat index, in-image mask) of the corner (f_y + a, f_x + bb)."""
        yy, xx = ry + a, rx + bb
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = base + torch.nan_to_num(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        return idx.reshape(-1), inb

    def gathered(a, bb):
        idx, inb = corner(a, bb)
        return xf.index_select(0, idx).reshape(b, ho, wo, 9, c) * inb[..., None]

    wmat = weight.detach().float().reshape(9 * c, cout)
    need_x, need_off, need_mask, need_w, need_b = (bool(n) for n in needs)
    ds = None
    if need_x or need_off or need_mask:
        ds = (gf.reshape(-1, cout) @ wmat.T).reshape(b, ho, wo, 9, c)
    grads = [None] * 5
    if need_off or need_mask:
        gs = {}
        for a, bb in ((0, 0), (0, 1), (1, 0), (1, 1), (-1, 0), (-1, 1), (0, -1), (1, -1)):
            gs[a, bb] = (gathered(a, bb) * ds).sum(-1)
        val = lambda a, bb: vy[a] * vx[bb] * gs[a, bb]  # noqa: E731
        if need_mask:
            grads[2] = val(0, 0) + val(0, 1) + val(1, 0) + val(1, 1)
        if need_off:
            d_y = sum(dy[a + 1] * vx[bb] * gs[a, bb] for a in (-1, 0, 1) for bb in (0, 1))
            d_x = sum(vy[a] * dx_[bb + 1] * gs[a, bb] for a in (0, 1) for bb in (-1, 0, 1))
            grads[1] = (torch.stack([d_y, d_x], -1) * m[..., None] * cg).reshape(b, ho, wo, 18)
    if need_x:
        gx = torch.zeros_like(xf)
        for a in (0, 1):
            for bb in (0, 1):
                idx, inb = corner(a, bb)
                coef = vy[a] * vx[bb] * m * inb
                gx.index_add_(0, idx, (ds * coef[..., None]).reshape(-1, c))
        grads[0] = gx.reshape(b, h, w, c)
    if need_w:
        s_mod = sum(gathered(a, bb) * (vy[a] * vx[bb] * m)[..., None] for a in (0, 1) for bb in (0, 1))
        grads[3] = (s_mod.reshape(-1, 9 * c).T @ gf.reshape(-1, cout)).reshape(3, 3, c, cout)
    if need_b and bias is not None:
        grads[4] = gf.sum((0, 1, 2))
    return tuple(grads)
