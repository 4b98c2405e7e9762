"""The port's MSDA dispatch and its clipped function (the TPU encoder kernel
K5's, `mqdet_tpu/ops/pallas/msda_pallas.py::ms_deform_attn_encoder`) against
the JAX package, on the CPU.

Inputs are numpy arrays from a seed, fp32 on both sides. The JAX kernel runs
in interpret mode under `MQDET_MSDA_IMPL=pallas_interpret`, as the JAX
package's own tests run it; atol 2e-5 is their bound for it. The kernel's
clipped mode is tested on a card by tests/test_torch_port_cuda.py; here its
band rule (`msda_band_geometry`, `msda_band_origin`) is held against the
clamped coordinates of `ms_deform_attn_clipped_plain`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_torch.ops import ms_deform_attn as tms

torch.set_num_threads(2)

GDINO_800 = [(100, 168), (50, 84), (25, 42), (13, 21)]  # MQ-GroundingDINO-T's 800x1344 pyramid
GDINO_256 = [(32, 32), (16, 16), (8, 8), (4, 4)]


def _encoder_inputs(rng, shapes, reach, nh=2, hd=8, p=3):
    """Encoder queries (Q = S), each sampling every level around its own
    pixel centre with offsets uniform in +-`reach` level cells."""
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((1, s, nh, hd)).astype(np.float32)
    attn = rng.random((1, s, nh, len(shapes), p)).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    centre = np.concatenate([
        np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1).reshape(h * w, 2)
        for h, w in shapes
    ])
    off = rng.uniform(-reach, reach, (1, s, nh, len(shapes), p, 2))
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    loc = (centre[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]).astype(np.float32)
    return value, loc, attn


def _jax_msda(value, shapes, loc, attn):
    from mqdet_tpu.ops.ms_deform_attn import ms_deform_attn

    return np.asarray(jax.jit(lambda v, l, a: ms_deform_attn(v, shapes, l, a))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn)))


def _port(value, shapes, loc, attn):
    return tms.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn)).numpy()


@pytest.mark.parametrize("shapes", [
    [(16, 16), (8, 8), (4, 4), (2, 2)],   # k 1/2/4/8, f 2/4/8
    [(12, 20), (6, 10), (3, 5), (2, 3)],  # the last level at non-exact ratios
])
def test_clipped_msda_matches_jax_pallas_interpret(monkeypatch, shapes):
    """Offsets up to 12 cells, 2-3 cells past every window (R 4 at k 1 and
    2 is 5 cells wide on the far side): the port under pallas_interpret
    against JAX's `ms_deform_attn` under the same setting. The clip binds:
    the exact function differs by O(1)."""
    value, loc, attn = _encoder_inputs(np.random.default_rng(len(shapes[0]) + shapes[0][1]), shapes, 12.0)
    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    want = _jax_msda(value, shapes, loc, attn)
    got = _port(value, shapes, loc, attn)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    assert np.abs(_port(value, shapes, loc, attn) - want).max() > 0.1


def _jax_pairs(shapes):
    """The (lq, lv) pairs `ms_deform_attn_encoder` clips, read from the JAX
    package itself: its window helpers recorded under an abstract evaluation
    (the level heights identify the levels)."""
    from mqdet_tpu.ops.pallas import msda_pallas

    seen = set()
    heights = [h for h, _ in shapes]
    coarse, finer = msda_pallas._rel_coords, msda_pallas._rel_coords_finer

    def rec_coarse(loc, n_value, k, r, n_query):
        if n_query in heights and n_value in heights:
            seen.add((heights.index(n_query), heights.index(n_value), 1, k, r))
        return coarse(loc, n_value, k, r, n_query)

    def rec_finer(loc, n_value, f, phase, n_query):
        if n_query in heights and n_value in heights:
            seen.add((heights.index(n_query), heights.index(n_value), 2, f, msda_pallas.FINER_RV))
        return finer(loc, n_value, f, phase, n_query)

    s = sum(h * w for h, w in shapes)
    args = (jax.ShapeDtypeStruct((1, s, 1, 8), jnp.float32), jax.ShapeDtypeStruct((1, s, 1, 4, 1, 2), jnp.float32),
            jax.ShapeDtypeStruct((1, s, 1, 4, 1), jnp.float32))
    mp = pytest.MonkeyPatch()
    mp.setattr(msda_pallas, "_rel_coords", rec_coarse)
    mp.setattr(msda_pallas, "_rel_coords_finer", rec_finer)
    try:
        jax.eval_shape(lambda v, l, a: msda_pallas.ms_deform_attn_encoder(v, shapes, l, a, interpret=True), *args)
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("shapes", [GDINO_800, GDINO_256])
def test_pair_table_matches_the_encoder_rule(shapes):
    """`clip_pairs` against the pairs the JAX encoder kernel clips, at GDINO's
    800x1344 and 256x256 pyramids (distinct level heights)."""
    table = tms.clip_pairs(shapes)
    ours = {(lq, lv, *rule) for (lq, lv), rule in table.items() if rule[0] != tms.EXACT}
    assert ours == _jax_pairs(shapes)
    if shapes == GDINO_800:  # every pair with the 13x21 level is exact except (3, 3)
        assert sorted((lq, lv) for lq, lv, *_ in ours) == [
            (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2), (3, 3)]
        assert table[0, 2] == (tms.COARSE, 4, 2) and table[2, 0] == (tms.FINER, 4, tms.FINER_RV)


def test_window_bounds_follow_the_pair_rule():
    """Per query: a coarse pair's window is b0 + [-R, R + 1], a finer
    pair's c + [-RV, RV + 1], an exact pair's unbounded."""
    shapes = [(8, 6), (4, 3), (2, 2)]
    bnd = tms.window_bounds(shapes, "cpu").numpy()
    assert bnd.shape == (3, 4, 48 + 12 + 4)
    q = 48 + 2 * 3 + 1  # level 1, pixel (2, 1)
    assert list(bnd[1, :, q]) == [2 - 4, 2 + 5, 1 - 4, 1 + 5]  # k 1, R 4
    assert list(bnd[0, :, q]) == [4.5 - 3, 4.5 + 4, 2.5 - 3, 2.5 + 4]  # f 2: c = 2 (y + 0.5) - 0.5
    assert list(bnd[1, :, 6]) == [-4, 5, -5, 4]  # level 0 pixel (1, 0) at k 2: b0 = (0, -1), R 4
    assert np.isinf(bnd[2, :, q]).all()  # 4x3 -> 2x2 is not an exact ratio


def test_dispatch_follows_the_jax_rule(monkeypatch):
    """Unset on the CPU and `gather`: the exact composite; decoder queries
    (Q != S) exact under every setting; `pallas_interpret` clips encoder
    queries on the CPU; no launch is counted on the CPU."""
    from mqdet_tpu.ops.ms_deform_attn import ms_deform_attn_sample

    shapes = [(8, 8), (4, 4), (2, 2)]
    value, loc, attn = _encoder_inputs(np.random.default_rng(3), shapes, 9.0)
    exact = np.asarray(ms_deform_attn_sample(*map(jnp.asarray, (value,)), shapes, jnp.asarray(loc),
                                             jnp.asarray(attn)))
    counts = (tms.launch_count, tms.clip_launch_count)
    for impl in (None, "pallas", "gather"):
        if impl is None:
            monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
        else:
            monkeypatch.setenv("MQDET_MSDA_IMPL", impl)
        np.testing.assert_allclose(_port(value, shapes, loc, attn), exact, atol=1e-5, rtol=1e-5)
    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    clipped = _port(value, shapes, loc, attn)
    assert np.abs(clipped - exact).max() > 0.1
    np.testing.assert_array_equal(
        clipped, tms.ms_deform_attn_clipped_plain(*map(torch.from_numpy, (value,)), shapes,
                                                  torch.from_numpy(loc), torch.from_numpy(attn)).numpy())
    dec = (value, loc[:, :20].copy(), attn[:, :20].copy())
    np.testing.assert_allclose(_port(dec[0], shapes, *dec[1:]), exact[:, :20], atol=1e-5, rtol=1e-5)
    assert (tms.launch_count, tms.clip_launch_count) == counts
    with pytest.raises(ValueError):  # the clipped function needs encoder queries
        tms.ms_deform_attn_clipped_plain(torch.from_numpy(value), shapes, *map(torch.from_numpy, dec[1:]))


def test_rule_table_copy_matches_jax():
    """The port keeps its own copy of the window rule's constants (it may not
    import the JAX package); this pins the copy to the JAX module's."""
    from mqdet_tpu.ops.pallas import msda_pallas

    assert tms.DEFAULT_RADIUS_FOR_K == msda_pallas.DEFAULT_RADIUS_FOR_K
    assert tms.FINER_RV == msda_pallas.FINER_RV
    assert tms.FINER_REFF_BY_F == msda_pallas.FINER_REFF_BY_F


def _edge_locations(shapes, rng):
    """Encoder queries (B 1, nh 1) with 8 points per level, in value pixels:
    exactly at the window's lo and hi corners, 0.3 past them (the clamp puts
    them on the edge), at mixed edges, at the centre (fractional for FINER
    pairs), and two anywhere within 3 pixels of the map; as locations."""
    bnd = tms.window_bounds(shapes, "cpu")
    s = bnd.shape[2]
    loc = np.zeros((1, s, 1, len(shapes), 8, 2), np.float32)
    for lv, (h, w) in enumerate(shapes):
        ylo, yhi, xlo, xhi = (t.numpy().astype(np.float64) for t in bnd[lv])
        far = ~np.isfinite(ylo)  # exact pairs: no window
        ylo, xlo = np.where(far, -1.0, ylo), np.where(far, -1.0, xlo)
        yhi, xhi = np.where(far, h, yhi), np.where(far, w, xhi)
        pts = [(ylo, xlo), (yhi, xhi), (ylo - 0.3, xhi + 0.3), (yhi + 0.3, xlo - 0.3), (ylo, xhi),
               ((ylo + yhi) / 2, (xlo + xhi) / 2)]
        pts += [(rng.uniform(-3, h + 3, s), rng.uniform(-3, w + 3, s)) for _ in range(2)]
        for i, (y, x) in enumerate(pts):
            loc[0, :, 0, lv, i] = np.stack([(x + 0.5) / w, (y + 0.5) / h], -1)
    return torch.from_numpy(loc)


@pytest.mark.parametrize("hd", [8, 32])
@pytest.mark.parametrize("shapes", [GDINO_800, [(16, 16), (8, 8), (4, 4), (2, 2)], [(12, 20), (6, 10), (3, 5), (2, 3)]])
def test_band_rule_holds_every_clamped_corner(shapes, hd):
    """Every corner the clipped function reads: on a BAND pair all four
    corners of every clamped sample (a zero-weight corner too: the kernel
    reads it without a test) lie inside the tile's band; on a WHOLE pair
    every corner inside the map does; FINER pairs and bands over the cap
    GATHER. Edges exactly at c - R and c + R + 1, FINER fractional centres,
    queries at the maps' borders and tiles that end past them."""
    loc = _edge_locations(shapes, np.random.default_rng(hd))
    geometry, pairs = tms.msda_band_geometry(shapes, hd), tms.clip_pairs(shapes)
    bnd = tms.window_bounds(shapes, "cpu")
    th, tw = tms.msda_tile(hd)
    start = 0
    for lq, (hq, wq) in enumerate(shapes):
        yq = torch.arange(hq)[:, None].expand(hq, wq).reshape(-1)
        xq = torch.arange(wq)[None, :].expand(hq, wq).reshape(-1)
        ty0, tx0 = yq // th * th, xq // tw * tw
        for lv, (h, w) in enumerate(shapes):
            stage, rows, cols = geometry[lq, lv]
            mode = pairs[lq, lv][0]
            x, y = (t[0, start:start + hq * wq, 0] for t in tms.sample_pixels(loc, lv, h, w, bnd))  # (n, P)
            cy0, cx0 = torch.floor(y).long(), torch.floor(x).long()
            if stage == tms.GATHER:
                assert mode == tms.FINER or (mode == tms.EXACT and h * w * hd * 2 > tms.MSDA_BAND_BYTES)
                continue
            origins = {(a, c): tms.msda_band_origin(shapes, lq, lv, a, c)
                       for a, c in set(zip(ty0.tolist(), tx0.tolist()))}
            oy = torch.tensor([origins[a, c][0] for a, c in zip(ty0.tolist(), tx0.tolist())])[:, None]
            ox = torch.tensor([origins[a, c][1] for a, c in zip(ty0.tolist(), tx0.tolist())])[:, None]
            for dy in (0, 1):
                for dx in (0, 1):
                    cy, cx = cy0 + dy, cx0 + dx
                    inside = (cy >= oy) & (cy < oy + rows) & (cx >= ox) & (cx < ox + cols)
                    if stage == tms.BAND:
                        assert mode == tms.COARSE and bool(inside.all()), (lq, lv, dy, dx)
                    else:
                        in_map = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
                        assert (rows, cols) == (h, w) and bool(inside[in_map].all()), (lq, lv)
        start += hq * wq


def test_band_rule_at_gdino_800():
    """At MQ-GroundingDINO-T's 800x1344 pyramid, hd 32: the three COARSE
    ratios are bands (18 x 18 at k 1, 15 x 15 at k 2, 9 x 9 at k 4 for an
    8 x 8 tile), every pair with the 13x21 level but (3, 3) is the whole
    level, the FINER and the large exact pairs gather; and the staged pairs
    take about 92% of the encoder's samples (16 per query and head)."""
    geometry = tms.msda_band_geometry(GDINO_800, 32)
    assert tms.msda_tile(32) == (8, 8) and tms.msda_tile(8) == (8, 32)
    assert geometry[0, 0] == geometry[3, 3] == (tms.BAND, 18, 18)
    assert geometry[0, 1] == (tms.BAND, 15, 15) and geometry[0, 2] == (tms.BAND, 9, 9)
    assert all(geometry[lq, 3] == (tms.WHOLE, 13, 21) for lq in range(3))
    assert {key for key, rule in geometry.items() if rule[0] == tms.GATHER} == {
        (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)}
    sizes = [h * w for h, w in GDINO_800]
    staged = sum(sizes[lq] for (lq, _), rule in geometry.items() if rule[0] != tms.GATHER)
    assert 0.90 < staged / (4 * sum(sizes)) < 0.94
    assert tms.msda_band_origin(GDINO_800, 0, 1, 8, 16) == (3 - 4, 7 - 4)  # c(8) = 3, c(16) = 7 at k 2


@pytest.mark.parametrize("variant", ["no_tma", "no_band_reads", "no_point_loads", "no_gather"])
def test_band_tool_variants_apply_to_the_kernel_source(variant):
    """Each diagnostic build of `tools/perf_msda_band` cuts its part out of
    the current csrc/ms_deform_attn.cu (it raises when the source moved on)."""
    import os

    from mqdet_torch.ops import kernels
    from mqdet_torch.tools import perf_msda_band

    with open(os.path.join(kernels.CSRC, "ms_deform_attn.cu")) as f:
        src = f.read()
    cut = perf_msda_band.variant_source(variant)
    assert cut != src and "msda_band_kernel" in cut


def test_band_tool_fails_without_a_card():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "mqdet_torch.tools.perf_msda_band"], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr
