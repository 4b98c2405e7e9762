"""The port's MSDA dispatch and its clipped function (the TPU encoder kernel
K5's, `mqdet_tpu/ops/pallas/msda_pallas.py::ms_deform_attn_encoder`) against
the JAX package, on the CPU.

Inputs are numpy arrays from a seed, fp32 on both sides. The JAX kernel runs
in interpret mode under `MQDET_MSDA_IMPL=pallas_interpret`, as the JAX
package's own tests run it; atol 2e-5 is their bound for it. The kernel's
clipped mode is tested on a card by tests/test_torch_port_cuda.py.
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
