"""The port's clipped-offset DCN family against the JAX package: the window
composite, the 4-corner gather kernel (K2) and the band kernel's versions and
x_tiles (K1, K1b) on the CPU, the DyConv dispatch on MQDET_DEFORM_IMPL, the
offset resampling, the radius calibration, the sweep tool's entry, and the
port's copy of the rule tables.

Inputs are numpy arrays from a seed, fp32 on both sides unless stated.
Tolerances: fp32 rounding, atol 1e-4 on O(1) outputs. The JAX Pallas kernels
run in interpret mode, as the JAX package's own tests run them. The kernels
themselves are tested on a card by tests/test_torch_port_cuda.py.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dcn_gather_model import gather_kernel_model as _gather_kernel_model

from mqdet_torch.ops import deform_conv as tdc

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(rng, b, h, w, c, cout, stride, radius, off_scale=3.0):
    """Offsets x3 (the clip bites) with every fifth channel exactly at
    +-radius (an integer rel, whose floor+1 corner has weight 0)."""
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((b, ho, wo, 18)) * off_scale).astype(np.float32)
    off[..., ::5] = radius * np.sign(off[..., ::5])
    mask = rng.random((b, ho, wo, 9)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, off, mask, wt, bias


def _jax_window(args, stride, radius):
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv_window

    return np.asarray(modulated_deform_conv_window(*map(jnp.asarray, args), stride=stride, radius=radius))


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_clipped_plain_matches_jax_window(stride, radius):
    """B 2, odd sizes, offsets x3 and exactly at +-radius."""
    args = _inputs(np.random.default_rng(10 * stride + radius), 2, 11, 14, 8, 16, stride, radius)
    want = _jax_window(args, stride, radius)
    got = tdc.modulated_deform_conv_window(*map(torch.from_numpy, args), stride=stride, radius=radius)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    # the clip binds: the exact function differs
    exact = tdc.modulated_deform_conv(*map(torch.from_numpy, args), stride=stride)
    assert np.abs(exact.numpy() - want).max() > 1e-1


@pytest.mark.parametrize("stride", [1, 2])
def test_gather_clip_plain_matches_jax_pallas_gather_interpret(stride):
    """K2's function, against the TPU kernel in interpret mode at
    tests/test_ops.py's shapes (block_rows 4: several row blocks)."""
    from mqdet_tpu.ops.pallas.deform_conv_gather_pallas import modulated_deform_conv_pallas_gather

    args = _inputs(np.random.default_rng(stride), 1, 12, 20, 8, 8, stride, 2, off_scale=1.5)[:4]
    want = modulated_deform_conv_pallas_gather(
        *map(jnp.asarray, args), stride=stride, radius=2, block_rows=4, interpret=True
    )
    got = tdc.modulated_deform_conv_pallas_gather(*map(torch.from_numpy, args), stride=stride, radius=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---- the gather kernel (K2 and the exact route) ----------------------------

GATHER_WIDTHS = [(8, 24), (40, 136), (64, 24)]  # (C, Cout): a chunk's tail, C past one 64-channel chunk


def _gather_inputs(seed, b, h, w, c, cout, stride, radius, where):
    """`x3`: offsets x3 (the clip bites), every fifth exactly at +-radius
    (0 for the exact mode, radius None: an integer sample position); `far`:
    offsets x12, most samples beyond the image."""
    return _inputs(np.random.default_rng(seed), b, h, w, c, cout, stride, radius or 0,
                   off_scale=3.0 if where == "x3" else 12.0)


def _gather_plain(args, stride, radius):
    t = list(map(torch.from_numpy, args))
    if radius is None:
        return tdc.modulated_deform_conv_plain(*t, stride=stride).numpy()
    return tdc.modulated_deform_conv_clipped_plain(*t, stride=stride, radius=radius).numpy()


@pytest.mark.parametrize("where", ["x3", "far"])
@pytest.mark.parametrize("c,cout", GATHER_WIDTHS)
@pytest.mark.parametrize("radius", [None, 0, 2, 8, 11])
@pytest.mark.parametrize("stride", [1, 2])
def test_gather_kernel_model_equals_the_plain_versions(stride, radius, c, cout, where):
    """One launch modelled in fp32 (tiles of 128 positions over flat m, the
    last ragged: 2 x 11 x 14 positions at stride 1, 2 x 6 x 7 at stride 2;
    each mode's corner rule; zero channels past C; the K order tap, chunk,
    group) equals the exact (radius None) or clipped plain version: atol
    1e-4, fp32 rounding on O(1) outputs."""
    args = _gather_inputs(c + cout + (radius or 0), 2, 11, 14, c, cout, stride, radius, where)
    got = _gather_kernel_model(*args, stride=stride, radius=radius)
    np.testing.assert_allclose(got, _gather_plain(args, stride, radius), atol=1e-4, rtol=1e-5)


def test_gather_kernel_model_rounds_a_and_writes_every_position():
    """The bf16-rounded A (what the kernel stores) moves the result by at
    most bf16 rounding (2^-8 relative per sample, summed over 9 C terms);
    and every position of a 3-tile launch is written."""
    args = _gather_inputs(5, 1, 17, 19, 40, 24, 1, 2, "x3")
    exact = _gather_kernel_model(*args, stride=1, radius=2)
    rounded = _gather_kernel_model(*args, stride=1, radius=2, round_a=True)
    assert 0 < np.abs(rounded - exact).max() <= 2.0**-8 * np.abs(exact).max()
    bias_only = _gather_kernel_model(args[0], args[1], np.zeros_like(args[2]), *args[3:], stride=1, radius=2)
    np.testing.assert_array_equal(bias_only, np.broadcast_to(args[4], bias_only.shape))


@pytest.mark.parametrize("stride,radius,c,cout,where", [
    (1, 0, 8, 24, "x3"), (2, 2, 40, 136, "x3"), (1, 8, 64, 24, "far"), (2, 11, 8, 136, "far"),
    (1, 2, 40, 24, "far"), (2, 0, 64, 136, "far"), (1, 11, 40, 136, "x3"), (2, 8, 8, 24, "x3"),
])
def test_gather_clip_plain_matches_jax_pallas_gather_at_every_radius(stride, radius, c, cout, where):
    """The clipped plain version (K2's function) against the TPU kernel in
    interpret mode (block_rows 4), at radius 0 to 11 (past the band kernel's
    limit of 8), C 8 / 40 / 64, Cout 24 / 136, offsets x3 and past the image.
    Tolerance against JAX: atol 1e-4 (fp32 on both sides)."""
    from mqdet_tpu.ops.pallas.deform_conv_gather_pallas import modulated_deform_conv_pallas_gather

    args = _gather_inputs(3 * radius + c, 1, 9, 13, c, cout, stride, radius, where)
    want = modulated_deform_conv_pallas_gather(*map(jnp.asarray, args), stride=stride, radius=radius,
                                               block_rows=4, interpret=True)
    got = tdc.modulated_deform_conv_pallas_gather(*map(torch.from_numpy, args), stride=stride, radius=radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("where", ["x3", "far"])
@pytest.mark.parametrize("c,cout", GATHER_WIDTHS + [(64, 136)])
@pytest.mark.parametrize("stride", [1, 2])
def test_exact_plain_matches_jax_exact(stride, c, cout, where):
    """The exact plain version against JAX's `modulated_deform_conv` (the
    XLA gather composite the exact mode replaces), offsets x3 and past the
    image. Tolerance against JAX: atol 1e-4 (fp32 on both sides)."""
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv

    args = _gather_inputs(c + cout + stride, 2, 11, 14, c, cout, stride, None, where)
    want = np.asarray(modulated_deform_conv(*map(jnp.asarray, args), stride=stride))
    got = tdc.modulated_deform_conv(*map(torch.from_numpy, args), stride=stride)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def _nan_pixel_inputs(radius):
    """Zero offsets (every sample on a pixel: its three other corners weigh
    0) and pixel (5, 6) of an 11 x 14 image NaN, away from the border that
    the plain versions clamp out-of-image corners to."""
    x, off, mask, wt, bias = _gather_inputs(7, 1, 11, 14, 8, 24, 1, radius, "x3")
    x[0, 5, 6, 3] = np.nan
    return x, np.zeros_like(off), mask, wt, bias


@pytest.mark.parametrize("radius", [None, 2])
def test_gather_kernel_model_reads_every_corner_in_the_image(radius):
    """A corner in the image is read whatever its weight, as the plain
    versions read it: position (3, 4) reaches the NaN pixel only as the
    zero-weight bottom-right corner of its tap (4, 5), and is NaN in the
    model as in the plain version; every other output agrees at atol 1e-4."""
    args = _nan_pixel_inputs(radius)
    got, want = _gather_kernel_model(*args, stride=1, radius=radius), _gather_plain(args, 1, radius)
    assert np.isnan(got[0, 3, 4]).all() and np.isfinite(got[0, 8, 10]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_v3_plain_matches_jax_v3_interpret():
    """Version 3 blends in the input dtype. bf16 on both sides at one tiny
    shape: the two round the weights and the products at different places,
    and the output is rounded to bf16: atol one bf16 ulp at max|ref|
    (2^-7 * max|ref|; the worst seen over three seeds was 0.43 of it)."""
    from mqdet_tpu.ops.pallas.deform_conv_pallas import modulated_deform_conv_pallas

    args = _inputs(np.random.default_rng(3), 1, 6, 9, 8, 8, 1, 2, off_scale=1.5)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want = np.asarray(
        modulated_deform_conv_pallas(*bf, stride=1, radius=2, interpret=True, version=3), np.float32
    )
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in bf]
    got = tdc.modulated_deform_conv_pallas(*targs, stride=1, radius=2, version=3)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0**-7 * scale)


@pytest.mark.parametrize("version,x_tiles", [(1, 0), (2, 0), (5, 0), (6, 0), (7, 1), (2, 2), (2, 3), (5, 3)])
@pytest.mark.parametrize("stride", [1, 2])
def test_band_versions_and_x_tiles_match_jax_window(stride, version, x_tiles):
    """The JAX package's slow tests hold every version and x_tiles equal to
    the window composite; so must the port's entry point (7: any other
    version runs version 1)."""
    args = _inputs(np.random.default_rng(version + 10 * x_tiles), 2, 12, 40, 16, 8, stride, 2)
    want = _jax_window(args, stride, 2)
    got = tdc.modulated_deform_conv_pallas(
        *map(torch.from_numpy, args), stride=stride, radius=2, block_rows=8, version=version, x_tiles=x_tiles
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("hw,out", [((9, 13), (5, 7)), ((4, 6), (7, 11)), ((5, 5), (5, 5))])
def test_resize_offsets_matches_jax(hw, out):
    from mqdet_tpu.ops.deform_conv import resize_offsets

    rng = np.random.default_rng(sum(hw))
    off = rng.standard_normal((2,) + hw + (18,)).astype(np.float32)
    mask = rng.random((2,) + hw + (9,)).astype(np.float32)
    jo, jm = resize_offsets(jnp.asarray(off), jnp.asarray(mask), *out)
    to, tm = tdc.resize_offsets(torch.from_numpy(off), torch.from_numpy(mask), *out)
    assert to.shape == (2,) + out + (18,) and tm.shape == (2,) + out + (9,)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)


@pytest.mark.parametrize("env,channels,route,block_rows", [
    (None, 128, "pallas", 8), ("pallas", 128, "pallas", 8), ("pallas_interpret", 128, "pallas", 8),
    ("window", 128, "window", None), ("gather", 128, "gather", None), ("other", 128, "window", None),
    (None, 16, "window", None), ("gather", 16, "gather", None),
])
def test_deform_conv_gn_dispatch_follows_deform_impl(env, channels, route, block_rows, monkeypatch):
    """vldyhead.py:140-167's rule, read at call time: gather is exact; pallas
    (default) with C % 128 == 0 takes the band kernel; anything else the
    clipped gather kernel; the radius is the module's."""
    from mqdet_torch.models import vldyhead

    if env is None:
        monkeypatch.delenv("MQDET_DEFORM_IMPL", raising=False)
    else:
        monkeypatch.setenv("MQDET_DEFORM_IMPL", env)
    used = []
    for name, tag in (("modulated_deform_conv", "gather"), ("modulated_deform_conv_pallas", "pallas"),
                      ("modulated_deform_conv_window", "window")):
        real = getattr(vldyhead, name)
        monkeypatch.setattr(vldyhead, name,
                            lambda *a, _t=tag, _r=real, **kw: used.append((_t, kw)) or _r(*a, **kw))
    conv = vldyhead.DeformConvGN(channels, 16, 1, 4, radius=3)
    with torch.no_grad():
        y = conv(torch.randn(1, channels, 6, 7), torch.randn(1, 6, 7, 18), torch.rand(1, 6, 7, 9))
    assert y.shape == (1, 16, 6, 7)
    assert [t for t, _ in used] == [route]
    kw = used[0][1]
    assert kw["stride"] == 1
    if route != "gather":
        assert kw["radius"] == 3
    assert kw.get("block_rows") == block_rows


def test_band_block_rows_follow_the_level_height(monkeypatch):
    """block_rows 16 where H // stride >= 100, else 8 (as in JAX)."""
    from mqdet_torch.models import vldyhead

    monkeypatch.delenv("MQDET_DEFORM_IMPL", raising=False)
    seen = []
    monkeypatch.setattr(vldyhead, "modulated_deform_conv_pallas",
                        lambda x, *a, **kw: seen.append(kw["block_rows"]) or torch.zeros(
                            x.shape[0], -(-x.shape[1] // kw["stride"]), -(-x.shape[2] // kw["stride"]), 8))
    for h, stride in ((100, 1), (99, 1), (200, 2), (199, 2)):
        conv = vldyhead.ModulatedDeformConv(128, 8, stride)
        ho = -(-h // stride)
        conv(torch.zeros(1, 128, h, 3), torch.zeros(1, ho, 2, 18), torch.zeros(1, ho, 2, 9), radius=2)
    assert seen == [16, 8, 16, 8]


def test_band_geometry_fits_every_radius_up_to_the_limit():
    """Every radius 0..MAX_WINDOW_RADIUS at both strides, for the block rows
    the model uses and every version, fits one block's shared memory with at
    least MIN_STAGES weight slabs (the chunk shrinks from 64 channels to 32
    and 16 where it must), as a TMA box (sides <= 256, inner bytes a
    multiple of 16); past the limit the launcher raises."""
    for radius in range(tdc.MAX_WINDOW_RADIUS + 1):
        for stride in (1, 2):
            for block_rows in (8, 16):
                for version in (1, 2, 3, 5, 6):
                    br, bw, bk, stages, nbytes = tdc.band_geometry(256, stride, radius, block_rows, version)
                    rows, cols = (br - 1) * stride + 2 * radius + 4, (bw - 1) * stride + 2 * radius + 4
                    assert br * bw == tdc.BAND_BM == 128 and bk in (16, 32, 64) and (bk * 2) % 16 == 0
                    assert tdc.MIN_STAGES <= stages <= tdc.MAX_STAGES and max(rows, cols, bk) <= tdc.MAX_BOX
                    assert nbytes == tdc.band_layout(version, bk, rows * cols, stages) <= tdc.SMEM_LIMIT
    assert tdc.band_geometry(256, 1, 2, 16, 2)[:4] == (16, 8, 64, 8)  # GLIP's level 0
    assert tdc.band_geometry(256, 2, 8, 16, 6)[2] == 16  # the largest band, 50 x 34 pixels
    with pytest.raises(ValueError):
        tdc.band_geometry(256, 1, tdc.MAX_WINDOW_RADIUS + 1, 8, 2)
    with pytest.raises(ValueError):  # a 64 x 2 tile: 146 x 22 pixels, two buffers exceed shared memory
        tdc.band_geometry(256, 2, 8, 64, 2)
    with pytest.raises(ValueError):  # a 128 x 1 tile: 274 rows, more than a TMA box
        tdc.band_geometry(256, 2, 2, 128, 1)
    assert [tdc.band_version(v) for v in (0, 1, 2, 3, 4, 5, 6, 7)] == [1, 1, 2, 3, 1, 5, 6, 1]


def test_band_tile_holds_128_positions():
    """block_rows rounded down to a power of two, times 128 / rows columns:
    GLIP's 16 (the 100-row level) and 8 give 16 x 8 and 8 x 16."""
    assert [tdc.band_tile(n) for n in (1, 8, 12, 16, 100, 300)] == [
        (1, 128), (8, 16), (8, 16), (16, 8), (64, 2), (128, 1)]
    assert all(r * c == 128 for r, c in map(tdc.band_tile, range(1, 200)))


def _band_kernel_model(x, off, mask, wt, bias, stride, radius, block_rows):
    """A plain fp32 model of one band launch: per tile, the zero-padded band
    of (br-1)*stride + 2r + 4 rows and columns, the table's top-left corner
    index and four weights times the mask, the blend in corner order, and the
    product summed in the kernel's K order: 16-channel group, then tap."""
    b, h, w, c = x.shape
    ho, wo = off.shape[1:3]
    cout = wt.shape[-1]
    br, bw = tdc.band_tile(block_rows)
    rows, cols = (br - 1) * stride + 2 * radius + 4, (bw - 1) * stride + 2 * radius + 4
    pad = 2 * radius + 4 + max(br, bw) * stride
    xp = np.zeros((b, h + 2 * pad, w + 2 * pad, c), np.float32)
    xp[:, pad:pad + h, pad:pad + w] = x
    out = np.zeros((b, ho, wo, cout), np.float32)
    py, px = np.divmod(np.arange(br * bw), bw)
    for bi in range(b):
        for oy0 in range(0, ho, br):
            for ox0 in range(0, wo, bw):
                iy0, ix0 = oy0 * stride - 1 - radius, ox0 * stride - 1 - radius
                band = xp[bi, pad + iy0:pad + iy0 + rows, pad + ix0:pad + ix0 + cols].reshape(rows * cols, c)
                oy, ox = oy0 + py, ox0 + px
                live = (oy < ho) & (ox < wo)
                o = off[bi, np.minimum(oy, ho - 1), np.minimum(ox, wo - 1)].reshape(-1, 9, 2)
                mk = mask[bi, np.minimum(oy, ho - 1), np.minimum(ox, wo - 1)] * live[:, None]
                tap = np.arange(9)
                rel_y = np.clip(o[..., 0], -radius, radius) + (tap // 3 - 1)
                rel_x = np.clip(o[..., 1], -radius, radius) + (tap % 3 - 1)
                fy, fx = np.floor(rel_y), np.floor(rel_x)
                ly, lx = rel_y - fy, rel_x - fx
                idx = ((py * stride)[:, None] + fy.astype(int) + 1 + radius) * cols \
                    + (px * stride)[:, None] + fx.astype(int) + 1 + radius
                wts = [(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx]
                corners = [idx, idx + 1, idx + cols, idx + cols + 1]
                a = np.zeros((br * bw, 9, c), np.float32)
                for q in range(4):
                    a += (wts[q] * mk)[..., None] * band[corners[q]]
                acc = np.zeros((br * bw, cout), np.float32)
                for g in range(c // 16):
                    for t in range(9):
                        acc += a[:, t, 16 * g:16 * g + 16] @ wt[t // 3, t % 3, 16 * g:16 * g + 16]
                keep = np.nonzero(live)[0]
                out[bi, oy[keep], ox[keep]] = acc[keep] + bias
    return out


@pytest.mark.parametrize("block_rows", [8, 16])
@pytest.mark.parametrize("stride,radius", [(1, 2), (2, 2), (1, 0), (2, 8)])
def test_band_kernel_k_order_model_equals_the_clipped_plain_version(stride, radius, block_rows):
    """The kernel's tile, band indexing and K order, modelled in fp32 on ragged
    tiles (13 x 21 output at stride 1), offsets x3 and exactly at +-radius:
    equal to the clipped plain version up to fp32 rounding."""
    args = _inputs(np.random.default_rng(7 * stride + radius + block_rows), 2, 13, 21, 32, 24, stride, radius)
    want = tdc.modulated_deform_conv_clipped_plain(*map(torch.from_numpy, args), stride=stride, radius=radius)
    got = _band_kernel_model(*args, stride, radius, block_rows)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=1e-5)


def test_band_fast_share_follows_the_kernels_rule():
    """The share of (tile, tap) pairs whose clipped floor(rel) is uniform
    over the tile's positions inside the grid, against a loop."""
    rng = np.random.default_rng(4)
    off = (np.kron(rng.standard_normal((2, 2, 2, 18)), np.ones((1, 8, 16, 1)))[:, :13, :27]
           + rng.standard_normal((2, 13, 27, 18)) * 0.05).astype(np.float32)
    br, bw = tdc.band_tile(8)
    fl = np.floor(np.clip(off.reshape(2, 13, 27, 9, 2), -2, 2)
                  + np.array([[ky - 1, kx - 1] for ky in range(3) for kx in range(3)]))
    fast = []
    for b in range(2):
        for y0 in range(0, 13, br):
            for x0 in range(0, 27, bw):
                t = fl[b, y0:y0 + br, x0:x0 + bw].reshape(-1, 9, 2)
                fast += list((t.max(0) == t.min(0)).all(-1))
    want = float(np.mean(fast))
    assert 0.0 < want < 1.0
    assert tdc.band_fast_share(torch.from_numpy(off), 1, 2, 8) == pytest.approx(want)


def test_clipped_wrappers_take_the_plain_path_only_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(9), 1, 5, 6, 16, 8, 1, 2)]
    before = (tdc.clip_launch_count, tdc.band_launch_count, tdc.band_v3_launch_count)
    for fn in (tdc.modulated_deform_conv_window, tdc.modulated_deform_conv_pallas_gather,
               tdc.modulated_deform_conv_pallas):
        assert fn(*args, stride=1).shape == (1, 5, 6, 8)
    tdc.modulated_deform_conv_pallas(*args, stride=1, version=3, x_tiles=2)
    assert (tdc.clip_launch_count, tdc.band_launch_count, tdc.band_v3_launch_count) == before
    meta = [a.to("meta") for a in args]
    for fn in (tdc.modulated_deform_conv_window, tdc.modulated_deform_conv_pallas):
        with pytest.raises(ValueError):
            fn(*meta, stride=1)


# ---- calibration -------------------------------------------------------------


@pytest.fixture(scope="module")
def calib_pair():
    from test_torch_port_modules import tiny_pair

    from mqdet_tpu.utils import builders as jb

    jmodel, params, tmodel, jcfg, tcfg = tiny_pair()
    b = jb.synthetic_batch(jcfg, 2, (64, 64), num_labels=3, k_shot=2, seed=2)
    return jmodel, params, tmodel, jcfg, tcfg, b


def _jax_max_offset(jmodel, params, args):
    """What the JAX package's `measure_max_deform_offset` computes (its own
    capture filter and reduction), with the two applies jitted: its eager
    applies take ~35 s to compile op by op on the CPU."""
    import jax

    from mqdet_tpu.utils import calibrate as jcal

    cls = type(jmodel)
    feats = jax.jit(lambda p, x: jmodel.apply(p, x, method=cls.encode_image))(params, args[0])
    _, inter = jax.jit(lambda p, f, *a: jmodel.apply(
        p, f, *a, method=cls.forward_head, capture_intermediates=jcal._offset_filter, mutable=["intermediates"],
    ))(params, list(feats), *args[1:])
    oms = [x for x in jax.tree.leaves(inter) if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[-1] == 27]
    assert oms
    return max(float(jnp.max(jnp.abs(om[..., :18]))) for om in oms)


def test_calibration_matches_jax(calib_pair, monkeypatch):
    """Measured max |offset| and the decision equal the JAX package's on the
    tiny pair, with the offset convs scaled so the decision keeps (x0.5),
    raises (x3) and falls back to gather (x20): at x1 the tiny config's
    offsets stay under 2."""
    from test_torch_port_modules import scale_offset_convs

    from mqdet_tpu.utils import calibrate as jcal

    from mqdet_torch.utils import calibrate as tcal

    jmodel, params, tmodel, jcfg, tcfg, b = calib_pair
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    jargs = tuple(jnp.asarray(b[k]) for k in keys)
    targs = (torch.from_numpy(b["images"]).permute(0, 3, 1, 2),) + tuple(torch.from_numpy(b[k]) for k in keys[1:])
    decisions = []
    for k in (0.5, 3.0, 20.0):
        p, tm = scale_offset_convs(params, tmodel, k)
        want_max = _jax_max_offset(jmodel, p, jargs)
        monkeypatch.setattr(jcal, "measure_max_deform_offset", lambda *a: want_max)
        want = jcal.calibrate_deform_radius(jcfg, jmodel, None, jargs)
        got = tcal.calibrate_deform_radius(tcfg, tm, targs)
        assert got.max_offset == pytest.approx(want_max, rel=1e-4)
        assert (got.radius, got.impl, got.changed) == (want.radius, want.impl, want.changed)
        decisions.append((got.impl, got.changed))
    assert decisions == [("pallas", False), ("pallas", True), ("gather", True)]


@pytest.mark.parametrize("measured", [0.3, 0.99, 1.5, 4.2, 7.0, 7.5, 30.0])
@pytest.mark.parametrize("configured", [2, 3])
def test_calibration_decision_and_apply_match_jax(measured, configured, monkeypatch):
    from mqdet_tpu.utils import builders as jb
    from mqdet_tpu.utils import calibrate as jcal

    from mqdet_torch.utils import builders as tb
    from mqdet_torch.utils import calibrate as tcal

    monkeypatch.setattr(jcal, "measure_max_deform_offset", lambda *a: measured)
    monkeypatch.setattr(tcal, "measure_max_deform_offset", lambda *a: measured)
    results = []
    for cal, cfg in ((jcal, jb.tiny_test_config()), (tcal, tb.tiny_test_config())):
        cfg.TPU.DEFORM_RADIUS = configured
        monkeypatch.delenv("MQDET_DEFORM_IMPL", raising=False)
        c = cal.calibrate_deform_radius(cfg, *((None, None, ()) if cal is jcal else (None, ())))
        rebuild = cal.apply_calibration(cfg, c)
        results.append(((c.radius, c.impl, c.changed), rebuild, cfg.TPU.DEFORM_RADIUS,
                        os.environ.get("MQDET_DEFORM_IMPL")))
    assert results[0] == results[1]
    assert tcal.MAX_WINDOW_RADIUS == jcal.MAX_WINDOW_RADIUS == 8


# ---- the sweep tool ----------------------------------------------------------


def test_sweep_parses_its_arguments():
    from mqdet_torch.tools.perf_dcn_sweep import parse_args

    assert parse_args([]) == ((2, 5), (8,))
    assert parse_args(["1,2,3,5,6", "8,16"]) == ((1, 2, 3, 5, 6), (8, 16))
    assert parse_args(["3"]) == ((3,), (8,))


def test_sweep_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "mqdet_torch.tools.perf_dcn_sweep", "1,2", "8"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_sweep_inputs_are_the_jax_tools():
    """The same draws from default_rng(0) in the same order: the smooth
    regime is a 7x11 field upsampled by 15x16, the rand regime white noise."""
    from mqdet_torch.tools.perf_dcn_sweep import sweep_inputs

    x0, offs, m0, wt, bs = sweep_inputs("cpu")
    rng = np.random.default_rng(0)
    want_x = rng.standard_normal((4, 100, 168, 256))
    want_rand = rng.standard_normal((4, 100, 168, 18)) * 0.5
    low = rng.standard_normal((4, 7, 11, 18))
    assert x0.shape == (4, 100, 168, 256) and x0.dtype == torch.bfloat16
    np.testing.assert_array_equal(x0[0, 0, :4, 0].float().numpy(),
                                  torch.tensor(want_x[0, 0, :4, 0], dtype=torch.float32).bfloat16().float().numpy())
    np.testing.assert_allclose(offs["rand"][1, 2, 3].float().numpy(), want_rand[1, 2, 3], rtol=1e-2)
    np.testing.assert_allclose(offs["smooth"][2, 30, 33].float().numpy(), low[2, 2, 2], rtol=1e-2)
    assert m0.shape == (4, 100, 168, 9) and wt.shape == (3, 3, 256, 256) and not bs.any()


@pytest.mark.parametrize("variant", ["no_product", "no_blend", "no_weights", "no_band", "product_only",
                                     "gather_no_gather", "gather_no_fill", "gather_no_product", "gather_no_weights",
                                     "gather_stages2", "gather_stages4", "gather_skip_zero"])
def test_dcn_bound_tool_variants_apply_to_the_kernel_source(variant):
    """Each build of `tools/perf_dcn_band` changes its part of the current
    csrc/deform_conv.cu (it raises when the source moved on), the gather
    variants the gather kernel's section alone."""
    from mqdet_torch.ops import kernels
    from mqdet_torch.tools import perf_dcn_band

    with open(os.path.join(kernels.CSRC, "deform_conv.cu")) as f:
        src = f.read()
    cut = perf_dcn_band.variant_source(variant)
    assert cut != src and "dcn_gather_kernel" in cut and "dcn_band_kernel" in cut
    band = src.index("dcn_band_kernel(const __grid_constant__")
    gather = src.index("// ---- the gather kernel")
    first = next(i for i, (a, b) in enumerate(zip(cut, src)) if a != b)
    assert (first > gather) == variant.startswith("gather") and first > band


def test_dcn_bound_tool_fails_without_a_card():
    out = subprocess.run([sys.executable, "-m", "mqdet_torch.tools.perf_dcn_band"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr


# ---- the port's rule tables --------------------------------------------------


def test_rule_table_copy_matches_jax():
    """Same keys and reference names; every transform gives equal results on
    a sample array of the rank it takes."""
    from mqdet_tpu.io import torch_import as J

    from mqdet_torch.io import torch_import as T

    rng = np.random.default_rng(0)
    samples = {1: rng.standard_normal(12), 2: rng.standard_normal((12, 6)), 4: rng.standard_normal((6, 3, 3, 3)),
               0: np.float32(rng.standard_normal())}
    for jt, tt in ((J.build_rule_table(), T.build_rule_table()),
                   (J.build_gdino_rule_table(), T.build_gdino_rule_table()),
                   (J.build_gdino_rule_table(2, 3), T.build_gdino_rule_table(2, 3))):
        assert list(jt) == list(tt)
        for key, (jref, jtf) in jt.items():
            tref, ttf = tt[key]
            assert jref == tref, key
            for val in samples.values():
                try:
                    want = np.asarray(jtf(val))
                except (ValueError, IndexError, TypeError):
                    with pytest.raises((ValueError, IndexError, TypeError)):
                        ttf(val)
                    continue
                np.testing.assert_array_equal(np.asarray(ttf(val)), want, err_msg=key)


def test_checkpoint_helpers_copy_matches_jax(tmp_path):
    from mqdet_tpu.io import torch_import as J

    from mqdet_torch.io import torch_import as T

    state = {"module.a.weight": torch.arange(6.0).reshape(2, 3), "module.b": torch.ones(2)}
    ema = {"module.a.weight": torch.zeros(2, 3)}
    for i, obj in enumerate(({"model": state, "model_ema": ema}, {"model": state}, {"state_dict": state}, state)):
        path = tmp_path / f"ckpt{i}.pth"
        torch.save(obj, path)
        want, got = J.load_torch_state_dict(str(path)), T.load_torch_state_dict(str(path))
        assert list(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert J.strip_prefixes(want).keys() == T.strip_prefixes(got).keys()
    flat = {"model_ema.x": np.ones(1), "module.y": np.zeros(1)}
    assert J.strip_prefixes(flat).keys() == T.strip_prefixes(flat).keys() == {"x"}

