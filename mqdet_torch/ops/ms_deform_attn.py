"""Multi-scale deformable attention (MSDA) sampling.

Counterpart of `mqdet_tpu/ops/ms_deform_attn.py::ms_deform_attn` with its
signature and layouts:

    ms_deform_attn(value (B, S, nh, hd), spatial_shapes [(H, W)] per level,
                   sampling_locations (B, Q, nh, L, P, 2) (x, y) in [0, 1],
                   attention_weights (B, Q, nh, L, P)) -> (B, Q, nh * hd)

per (b, q, head): sum over levels and points of weight * bilinear sample of
the level's value map at pixel (x * W - 0.5, y * H - 0.5), zero padding
corner by corner (`F.grid_sample(align_corners=False)`).

Two functions, chosen at call time by `MQDET_MSDA_IMPL` with the JAX
package's rule (`mqdet_tpu/ops/ms_deform_attn.py:124-134`):

- **clipped** (the function of the TPU's encoder kernel K5,
  `mqdet_tpu/ops/pallas/msda_pallas.py::ms_deform_attn_encoder`): for
  encoder queries (Q == S == sum of H * W; query q is pixel (yq, xq) of its
  level lq) each sample pixel is clamped per axis to a window around the
  query, by the (lq, lv) pair's rule of `clip_pairs`: a coarser-or-equal
  level at an exact ratio k of DEFAULT_RADIUS_FOR_K to
  [b0 - R, b0 + R + 1], b0 = floor((yq + 0.5) / k - 0.5); a finer level at
  an exact ratio f of FINER_REFF_BY_F to [c - FINER_RV, c + FINER_RV + 1],
  c = f (yq + 0.5) - 0.5; every other pair exact. Taken when the variable is
  unset or starts with `pallas` and the queries are encoder queries, on a
  CUDA tensor; under `pallas_interpret` on any device (the CPU runs the
  clipped plain version).
- **exact** (the gather composite, `ms_deform_attn_sample`): everything
  else: `gather`, decoder queries, and a CPU tensor unless
  `pallas_interpret`, as the JAX package's CPU backend does.

On a CUDA tensor both launch a kernel of `csrc/ms_deform_attn.cu` (bf16
value and output, fp32 locations and weights, fp32 accumulation): the exact
function `msda_forward_kernel`, the clipped one `msda_band_kernel` (counted
as `ms_deform_attn_clip`), which stages each tile's band of the value levels
in shared memory by the rule of `msda_band_geometry`; or raise. On a CPU
tensor they run the plain PyTorch versions below.

Training. Where an input needs a gradient, `ms_deform_attn` runs through
`MSDeformAttnFunction`, as the JAX package's `_encoder_pallas_diff`
(`mqdet_tpu/ops/ms_deform_attn.py:81-108`) does: the same forward (kernel or
plain version, clipped or exact by the rule above), the inputs saved, and a
backward that recomputes in fp32 the VJP of the **exact** composite at the
**unclipped** locations (`ms_deform_attn_vjp`), for encoder queries too:
JAX's backward differentiates `ms_deform_attn_sample`, not the clipped
form, so a sample clamped to its window still passes its location the
gradient of where it would have sampled. The launchers refuse a call that
needs a gradient: their output would have no `grad_fn`.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from mqdet_torch.ops import kernels

launch_count = 0       # exact kernel launches since the caller last reset it
clip_launch_count = 0  # launches of its clipped mode ("ms_deform_attn_clip")
MAX_LEVELS = 4    # the kernel's level table (csrc/ms_deform_attn.cu)
HEAD_WIDTHS = (8, 32)  # the kernel's instantiations: the tiny config's and MQ-GroundingDINO-T's

# The port's copy of the TPU kernel's window rule (mqdet_tpu/ops/pallas/msda_pallas.py:69, :240-242):
# the clip radius in value pixels by exact coarser ratio k, and for finer levels the radius
# around the sampling centre and the ratios f that clip.
DEFAULT_RADIUS_FOR_K = {1: 4, 2: 4, 4: 2, 8: 2}
FINER_RV = 3
FINER_REFF_BY_F = {2: 2, 4: 1}
EXACT, COARSE, FINER = 0, 1, 2  # pair modes (the kernel's table holds the same numbers)
GATHER, BAND, WHOLE = 0, 1, 2   # the band kernel's staging of a pair
MSDA_BAND_BYTES = 24576         # a staged band's cap (csrc/ms_deform_attn.cu MAX_BAND_BYTES)
TILE_ROWS = 8                   # the band kernel's tile: 8 query rows (one per warp) ...


def clip_pairs(spatial_shapes: Sequence[Tuple[int, int]]) -> Dict[Tuple[int, int], Tuple[int, int, int]]:
    """{(lq, lv): (mode, k or f, R or FINER_RV)} for every pair of levels,
    by `ms_deform_attn_encoder`'s rule: lv >= lq at an exact integer ratio
    k = Hq / Hv = Wq / Wv in DEFAULT_RADIUS_FOR_K is COARSE with R =
    DEFAULT_RADIUS_FOR_K[k]; lv < lq at an exact f = Hv / Hq = Wv / Wq in
    FINER_REFF_BY_F is FINER; every other pair is EXACT (0, 0, 0)."""
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    out = {}
    for lq, (hq, wq) in enumerate(shapes):
        for lv, (hv, wv) in enumerate(shapes):
            rule = (EXACT, 0, 0)
            if lv >= lq:
                if hv and wv and hq % hv == 0 and wq % wv == 0 and hq // hv == wq // wv \
                        and hq // hv in DEFAULT_RADIUS_FOR_K:
                    rule = (COARSE, hq // hv, DEFAULT_RADIUS_FOR_K[hq // hv])
            elif hv % hq == 0 and wv % wq == 0 and hv // hq == wv // wq and hv // hq in FINER_REFF_BY_F:
                rule = (FINER, hv // hq, FINER_RV)
            out[lq, lv] = rule
    return out


def msda_tile(hd: int) -> Tuple[int, int]:
    """(rows, columns) of query pixels in one block of the band kernel: a
    warp per row, 32 / (hd / 8) queries of hd / 8 lanes each per warp."""
    return TILE_ROWS, 32 // (hd // 8)


def _coarse_cell(y: int, k: int) -> int:
    """c(y) = floor((y + 0.5) / k - 0.5), in fp32 as the kernel computes it."""
    f32 = np.float32
    return int(np.floor(f32(f32(y + 0.5) / f32(k)) - f32(0.5)))


def msda_band_geometry(spatial_shapes, hd: int) -> Dict[Tuple[int, int], Tuple[int, int, int]]:
    """The band kernel's rule, {(lq, lv): (stage, rows, cols)} (the table the
    host hands the kernel): a COARSE pair of `clip_pairs` (ratio k, radius R)
    is a BAND of rows [c(y_first) - R, c(y_last) + R + 2] for a tile's query
    rows y_first..y_last (`msda_tile`; c(y) = floor((y + 0.5) / k - 0.5); the
    largest over the tiles, cut at nothing: rows past the map read zeros), and
    columns likewise; an EXACT pair is WHOLE when its value level fits; FINER
    pairs, and any band over MSDA_BAND_BYTES or 256 pixels on a side, GATHER
    (0, 0, 0). Cached by shapes and head width: the launcher asks per call."""
    return dict(_band_geometry(tuple((int(h), int(w)) for h, w in spatial_shapes), int(hd)))


@functools.lru_cache(maxsize=64)
def _band_geometry(shapes, hd):
    th, tw = msda_tile(hd)
    pairs = clip_pairs(shapes)
    out = {}
    for (lq, lv), (mode, k, r) in pairs.items():
        (hq, wq), (hv, wv) = shapes[lq], shapes[lv]
        rule = (GATHER, 0, 0)
        if mode == COARSE:
            def extent(n, t):
                return max(_coarse_cell(y0 + t - 1, k) - _coarse_cell(y0, k) for y0 in range(0, n, t)) + 2 * r + 3
            rule = (BAND, extent(hq, th), extent(wq, tw))
        elif mode == EXACT:
            rule = (WHOLE, hv, wv)
        stage, rows, cols = rule
        if stage != GATHER and (rows * cols * hd * 2 > MSDA_BAND_BYTES or max(rows, cols) > 256):
            rule = (GATHER, 0, 0)
        out[lq, lv] = rule
    return tuple(out.items())


def msda_band_origin(spatial_shapes, lq: int, lv: int, ty0: int, tx0: int) -> Tuple[int, int]:
    """The value pixel (row, column) of a staged band's first element for the
    tile whose first query pixel is (ty0, tx0): (c(ty0) - R, c(tx0) - R) for
    a BAND, (0, 0) for a WHOLE level."""
    mode, k, r = clip_pairs(spatial_shapes)[lq, lv]
    if mode != COARSE:
        return 0, 0
    return _coarse_cell(ty0, k) - r, _coarse_cell(tx0, k) - r


def is_encoder(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor) -> bool:
    """Q == S == sum of the levels' H * W: the queries are the pyramid's pixels."""
    return sampling_locations.shape[1] == value.shape[1] == sum(int(h) * int(w) for h, w in spatial_shapes)


def clips(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor) -> bool:
    """The dispatch rule of the module docstring: whether this call computes the clipped function."""
    impl = os.environ.get("MQDET_MSDA_IMPL", "pallas")
    on_accel = value.device.type != "cpu" or impl == "pallas_interpret"
    return impl.startswith("pallas") and on_accel and is_encoder(value, spatial_shapes, sampling_locations)


def window_bounds(spatial_shapes, device) -> torch.Tensor:
    """(L, 4, S) fp32 [y_lo, y_hi, x_lo, x_hi]: the window of every encoder
    query (flat over the pyramid) in the pixels of value level lv, +-inf
    where its pair is exact."""
    shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    s = sum(h * w for h, w in shapes)
    pairs = clip_pairs(shapes)
    out = torch.empty(len(shapes), 4, s, dtype=torch.float32, device=device)
    out[:, 0::2] = -float("inf")
    out[:, 1::2] = float("inf")
    start = 0
    for lq, (hq, wq) in enumerate(shapes):
        yq = torch.arange(hq, device=device, dtype=torch.float32)[:, None].expand(hq, wq).reshape(-1)
        xq = torch.arange(wq, device=device, dtype=torch.float32)[None, :].expand(hq, wq).reshape(-1)
        for lv in range(len(shapes)):
            mode, k, r = pairs[lq, lv]
            if mode == EXACT:
                continue
            for axis, qc in ((0, yq), (2, xq)):
                if mode == COARSE:
                    lo = torch.floor((qc + 0.5) / k - 0.5) - r
                else:
                    lo = k * (qc + 0.5) - 0.5 - r
                out[lv, axis, start:start + hq * wq] = lo
                out[lv, axis + 1, start:start + hq * wq] = lo + (2 * r + 1)
        start += hq * wq
    return out


def _bilinear_sample(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v (N, H, W, C); x, y (N, M) pixel coordinates -> (N, M, C) in fp32,
    zero for each corner outside the map. As JAX's composite, the corner's
    value is zeroed, not its weight: a NaN coordinate (and an infinite one,
    whose fraction is inf - inf) gives NaN."""
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
        idx = torch.nan_to_num(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()  # NaN: any index
        corner = torch.where(inb[..., None], flat[nidx, idx].float(), 0.0)
        out += corner * wt[..., None]
    return out


def sample_pixels(sampling_locations, lvl: int, h: int, w: int, bounds=None):
    """(x, y), each (B, Q, nh, P) fp32: the pixel coordinates of level lvl's
    samples (loc * (W, H) - 0.5), clamped to each query's window where
    `bounds` (`window_bounds`) is given."""
    loc = sampling_locations[:, :, :, lvl].float()  # (B, Q, nh, P, 2)
    x, y = loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5
    if bounds is not None:
        per_q = lambda t: t[None, :, None, None]  # noqa: E731
        y = torch.minimum(torch.maximum(y, per_q(bounds[lvl, 0])), per_q(bounds[lvl, 1]))
        x = torch.minimum(torch.maximum(x, per_q(bounds[lvl, 2])), per_q(bounds[lvl, 3]))
    return x, y


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    bounds: torch.Tensor = None,
) -> torch.Tensor:
    """Plain PyTorch MSDA, level by level (the gather composite). Accumulates
    in fp32; returns value.dtype. `bounds` (`window_bounds`) clamps each
    query's sample pixels per level and axis."""
    b, s, nh, hd = value.shape
    q = sampling_locations.shape[1]
    p = sampling_locations.shape[4]
    out = torch.zeros(b * nh, q, hd, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v_l = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(b * nh, h, w, hd)
        x, y = (t.permute(0, 2, 1, 3).reshape(b * nh, q * p)
                for t in sample_pixels(sampling_locations, lvl, h, w, bounds))
        sampled = _bilinear_sample(v_l, x, y).reshape(b * nh, q, p, hd)
        wgt = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3).reshape(b * nh, q, p)
        out += (sampled * wgt[..., None]).sum(dim=2)
        start += h * w
    return out.reshape(b, nh, q, hd).permute(0, 2, 1, 3).reshape(b, q, nh * hd).to(value.dtype)


def ms_deform_attn_clipped_plain(value, spatial_shapes, sampling_locations, attention_weights) -> torch.Tensor:
    """The clipped function (K5's) for encoder queries: the gather composite
    at the locations clamped to each (lq, lv) pair's window."""
    if not is_encoder(value, spatial_shapes, sampling_locations):
        raise ValueError("the clipped function is defined for encoder queries (Q == S) only")
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights,
                                window_bounds(spatial_shapes, value.device))


def _launch(value, spatial_shapes, loc, attn, clip=False) -> torch.Tensor:
    global launch_count, clip_launch_count
    kernels.refuse_grad("mqdet_ms_deform_attn_forward", value, loc, attn)
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
    pairs = bands = None
    if clip:
        table = (ctypes.c_int * (3 * n_levels ** 2))
        grid = [(lq, lv) for lq in range(n_levels) for lv in range(n_levels)]
        rule, geometry = clip_pairs(shapes), msda_band_geometry(shapes, hd)
        pairs = table(*[v for key in grid for v in rule[key]])
        bands = table(*[v for key in grid for v in geometry[key]])
    ptr = ctypes.c_void_p
    code = kernels.lib().mqdet_ms_deform_attn_forward(
        ptr(value.data_ptr()), ptr(loc.data_ptr()), ptr(attn.data_ptr()), ptr(out.data_ptr()),
        hw, pairs, bands, b, s, q, nh, hd, n_levels, p, int(clip), ptr(kernels.stream_ptr(value.device)),
    )
    kernels.check(code, "mqdet_ms_deform_attn_forward")
    if clip:
        clip_launch_count += 1
    else:
        launch_count += 1
    return out


class MSDeformAttnFunction(torch.autograd.Function):
    """forward: `run(value, loc, attn)` (a kernel or a plain version),
    saving the inputs; backward: `ms_deform_attn_vjp`, the exact
    composite's fp32 VJP at the unclipped locations, in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, value, loc, attn, run, spatial_shapes):
        ctx.save_for_backward(value, loc, attn)
        ctx.spatial_shapes = spatial_shapes
        return run(value, loc, attn)

    @staticmethod
    def backward(ctx, g):
        ins = ctx.saved_tensors
        with torch.profiler.record_function("msda_backward"):  # the span chip_smoke's phase 9 reads
            grads = ms_deform_attn_vjp(ins[0], ctx.spatial_shapes, ins[1], ins[2], g, ctx.needs_input_grad[:3])
        grads = [gr.to(t.dtype) if gr is not None else None for gr, t in zip(grads, ins)]
        return (*grads, None, None)


def ms_deform_attn_vjp(value, spatial_shapes, sampling_locations, attention_weights, g, needs=(True,) * 3):
    """VJP of the exact MSDA in fp32: PyTorch autograd of
    `ms_deform_attn_plain` (the gather composite's autodiff: floor corners,
    d(frac)/d(x) = 1 everywhere, no gradient through a corner's clamp or
    in-map test), at the locations as given. Returns (dvalue, dloc, dattn),
    None where `needs` is False."""
    ins = [t.detach().float().requires_grad_(bool(n))
           for t, n in zip((value, sampling_locations, attention_weights), needs)]
    with torch.enable_grad():
        out = ms_deform_attn_plain(ins[0], spatial_shapes, ins[1], ins[2])
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, g.float()))
    return tuple(next(got) if t.requires_grad else None for t in ins)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """See module docstring."""
    plain_route = kernels.runs_plain(value)
    clip = clips(value, spatial_shapes, sampling_locations)
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)

    def run(value, loc, attn):
        if plain_route:
            plain = ms_deform_attn_clipped_plain if clip else ms_deform_attn_plain
            return plain(value, shapes, loc, attn)
        return _launch(value, shapes, loc, attn, clip)

    if kernels.needs_grad(value, sampling_locations, attention_weights):
        return MSDeformAttnFunction.apply(value, sampling_locations, attention_weights, run, shapes)
    return run(value, sampling_locations, attention_weights)
