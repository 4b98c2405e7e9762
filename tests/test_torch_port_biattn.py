"""The decomposition of mqdet_torch's flat bi-attention kernel (K3, K3b), on
the CPU: `bi_attention_tiled_plain` (the v side as an online softmax over
64-token chunks, the l side as S contiguous ranges of N with fp32 partials)
and `combine_l_partials` (the combine kernel's plain version), against the
JAX kernel `_flash_bi_attention_jit` in interpret mode, single and dual
score forms, at tests/test_ops.py's shapes (b 2, n 700, e 256, 2 heads, q
scaled 0.1, a random text mask) with T 64, 128 and 256: atol 2e-3 in fp32,
that test's bound. S 7 at n 700 leaves the last range without rows. The
masks cover a wholly masked first 64-token chunk (bias -9e15) and a batch
item whose every token is masked (the uniform average). The levels form's
decomposition (K4: per level the flat kernel's split l side, merged with the
carried state by the combine) as `bi_attention_levels_tiled_plain` against
`bi_attention_levels_plain` and the JAX `flash_bi_attention_levels` in
interpret mode, at the JAX test's levels and with levels smaller than one
128-row tile. And `l_splits`: at
GLIP's and GroundingDINO's shapes every N row lies in exactly one range and
the l blocks fill two waves of 132 SMs. And that `tools/perf_bi_attention`'s
diagnostic builds still apply to the kernel source.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_torch.ops import bi_attention as tba

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, E, H = 2, 700, 256, 2


def inputs(t, mask, seed=0):
    """test_ops.py's inputs at T = t. mask `first`: item 0's first 64 tokens
    all masked; `all`: every token of item 1 masked."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, N, E)) * 0.1).astype(np.float32)
    k = rng.standard_normal((B, t, E)).astype(np.float32)
    vv = rng.standard_normal((B, N, E)).astype(np.float32)
    vl = rng.standard_normal((B, t, E)).astype(np.float32)
    keep = rng.uniform(0, 1, (B, t)) > 0.25
    if mask == "first":
        keep[0, :64] = False
    else:
        keep[1, :] = False
    return q, k, vv, vl, np.where(keep, 0.0, -9e15).astype(np.float32)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("t,splits,mask", [
    (128, 1, "first"), (128, 2, "all"), (128, 3, "first"), (128, 7, "all"),
    (64, 2, "first"), (256, 7, "first"), (256, 3, "all"),
])
def test_tiled_plain_matches_jax_kernel_interpret(dual, t, splits, mask):
    from mqdet_tpu.ops.pallas.bi_attention_pallas import _flash_bi_attention_jit

    args = inputs(t, mask, seed=t + splits)
    jv, jl = _flash_bi_attention_jit(*map(jnp.asarray, args), num_heads=H, block_n=256,
                                     dual_scores=dual, interpret=True)
    tv, tl = tba.bi_attention_tiled_plain(*map(torch.from_numpy, args), num_heads=H, splits=splits)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)


def test_masked_rows_follow_the_full_softmax():
    """A wholly masked first chunk leaves the full softmax's rows, and an
    item whose every token is masked gives the uniform average of vl; fp32
    rounding, atol 1e-5."""
    q, k, vv, vl, bias = map(torch.from_numpy, inputs(256, "first"))
    bias[1] = -9e15
    tv, _ = tba.bi_attention_tiled_plain(q, k, vv, vl, bias, H, splits=3)
    rv, _ = tba.bi_attention_plain(q, k, vv, vl, bias, H)
    np.testing.assert_allclose(tv.numpy(), rv.numpy(), atol=1e-5)
    uniform = vl[1].mean(dim=0).expand(N, E)
    np.testing.assert_allclose(tv[1].numpy(), uniform.numpy(), atol=1e-5)


def test_combine_weighs_a_split_without_rows_zero():
    """Partials of the ranges of S = 7 (the last has no rows: (NEG, 0, 0))
    combine to the l side of the dual plain version, and appending another
    empty partial changes no bit."""
    q, k, vv, vl, _ = map(torch.from_numpy, inputs(128, "first"))
    qh, kh, vvh = (tba._heads(x, H) for x in (q, k, vv))
    ranges = tba.split_ranges(N, 7)
    assert ranges[-1][0] == ranges[-1][1] == N
    parts = [tba._flash_rows(kh, qh[:, :, lo:hi], vvh[:, :, lo:hi], None) for lo, hi in ranges]
    m, den, acc = (torch.stack(x) for x in zip(*parts))
    assert bool((m[-1] == tba.NEG).all()) and not den[-1].any() and not acc[-1].any()
    out = tba.combine_l_partials(m, den, acc)
    _, rl = tba.bi_attention_dual_plain(q, k, vv, vl, None, H)
    np.testing.assert_allclose(out.numpy(), rl.numpy(), atol=1e-5)
    more = tba.combine_l_partials(torch.cat([m, m[-1:]]), torch.cat([den, den[-1:]]),
                                  torch.cat([acc, acc[-1:]]))
    assert torch.equal(more, out)


def test_carried_merge_is_one_more_partial():
    """The combine's carry is one more partial: merging S partials with a
    carry equals merging S + 1 partials, and an empty carry (NEG, 0, 0)
    changes no bit of the output (fp32)."""
    q, k, vv, vl, _ = map(torch.from_numpy, inputs(128, "first"))
    qh, kh, vvh = (tba._heads(x, H) for x in (q, k, vv))
    m, den, acc = tba._l_partials(kh, qh, vvh, 4)
    carry = (m[0], den[0], acc[0])
    for got, want in zip(tba.merge_l_partials(m[1:], den[1:], acc[1:], carry), tba.merge_l_partials(m, den, acc)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    empty = (torch.full_like(m[0], tba.NEG), torch.zeros_like(den[0]), torch.zeros_like(acc[0]))
    assert torch.equal(tba.combine_l_partials(m, den, acc, empty), tba.combine_l_partials(m, den, acc))


LEVELS = {"jax test": [420, 180, 70, 30], "under one tile": [77, 5], "tails": [129, 64, 1]}


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("levels", list(LEVELS))
def test_levels_tiled_plain_matches_levels_plain_and_jax_interpret(levels, splits):
    """K4's decomposition (forced 1 or 3 ranges per level, or l_splits') at
    T 128: against `bi_attention_levels_plain` at atol 1e-5 (fp32, another
    order of sums) and against the JAX levels kernel in interpret mode at
    atol 2e-3 (tests/test_ops.py's bound)."""
    from mqdet_tpu.ops.pallas.bi_attention_pallas import flash_bi_attention_levels

    sizes = LEVELS[levels]
    rng = np.random.default_rng(sum(sizes) + (splits or 0))
    n = sum(sizes)
    q = (rng.standard_normal((B, n, E)) * 0.1).astype(np.float32)
    vv = rng.standard_normal((B, n, E)).astype(np.float32)
    k, vl = (rng.standard_normal((B, 128, E)).astype(np.float32) for _ in range(2))
    keep = rng.uniform(0, 1, (B, 128)) > 0.25
    keep[0, :64] = False
    bias = np.where(keep, 0.0, -9e15).astype(np.float32)
    cut = np.cumsum(sizes)[:-1]
    qs, vvs = np.split(q, cut, axis=1), np.split(vv, cut, axis=1)
    tq, tvv = [torch.from_numpy(x.copy()) for x in qs], [torch.from_numpy(x.copy()) for x in vvs]
    tk, tvl, tb = map(torch.from_numpy, (k, vl, bias))
    tvs, tl = tba.bi_attention_levels_tiled_plain(tq, tk, tvv, tvl, tb, H, splits)
    rvs, rl = tba.bi_attention_levels_plain(tq, tk, tvv, tvl, tb, H)
    for got, want in zip(tvs + [tl], rvs + [rl]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    if splits is None:  # the JAX kernel once per level set
        jvs, jl = flash_bi_attention_levels([jnp.asarray(x) for x in qs], jnp.asarray(k),
                                            [jnp.asarray(x) for x in vvs], jnp.asarray(vl), jnp.asarray(bias),
                                            num_heads=H, interpret=True)
        for got, want in zip(tvs + [tl], list(jvs) + [jl]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("shape", [(4, 8, 256, 22400), (4, 4, 256, 22323)], ids=["glip", "gdino"])
def test_l_splits_cover_every_row_once_and_fill_two_waves(shape):
    b, h, t, n = shape
    s = tba.l_splits(b, h, t, n)
    ranges = tba.split_ranges(n, s)
    assert len(ranges) == s and 1 <= s <= tba.MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges, ranges[1:]))
    assert all(lo % 64 == 0 and lo <= hi for lo, hi in ranges)
    covered = np.zeros(n, np.int64)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert b * h * -(-t // 128) * s >= 264


@pytest.mark.parametrize("n", [1, 63, 64, 65, 700])
def test_l_splits_stay_within_the_chunks(n):
    """At most one range per 64-row chunk, so only the rounding of ceil
    leaves a range empty; the ranges still cover N once."""
    s = tba.l_splits(1, 1, 64, n)
    assert s <= -(-n // 64)
    ranges = tba.split_ranges(n, s)
    assert sum(hi - lo for lo, hi in ranges) == n


@pytest.mark.parametrize("variant", ["load_only", "compute_only", "l_only", "v_only"])
def test_bound_tool_variants_apply_to_the_kernel_source(variant):
    """Each diagnostic build of `tools/perf_bi_attention` cuts its part out of
    the current csrc/bi_attention.cu (it raises when the source moved on)."""
    from mqdet_torch.ops import kernels
    from mqdet_torch.tools import perf_bi_attention

    with open(os.path.join(kernels.CSRC, "bi_attention.cu")) as f:
        src = f.read()
    cut = perf_bi_attention.variant_source(variant)
    assert cut != src and "bi_attn_wgmma_kernel" in cut


def test_bound_tool_fails_without_a_card():
    out = subprocess.run([sys.executable, "-m", "mqdet_torch.tools.perf_bi_attention"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr
