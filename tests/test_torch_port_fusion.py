"""VLFuse's streamed and dual-score bi-attention in mqdet_torch vs the JAX
package, on the CPU, where the port's wrappers run their plain versions.

- `bi_attention_dual_plain` and `bi_attention_levels_plain` against the JAX
  Pallas kernels in interpret mode (`dual_scores=True`, and the per-level
  carried-state form), at the JAX package's own test shapes (b 2, n 700 in
  levels [420, 180, 70, 30], t 128, e 256, 2 heads, a random text mask):
  atol 2e-3 in fp32, that test's bound (tests/test_ops.py).
- The port's VLFuse under each combination of MQDET_FLASH_LEVELS and
  MQDET_FLASH_SCORES against the JAX VLFuse with the same weights at tiny
  widths (the JAX module takes its composite on the CPU): fp32 rounding of
  a few chained layers, atol 1e-5 on O(1) activations.
- The tiny MQ-GLIP-T protocol under stream and under dual against the JAX
  protocol and the port's default run, with the slice test's tolerances.
- How the switches are read, that stream runs one call per level without a
  concatenation, that GroundingDINO's fusion takes dual and ignores stream,
  and the A/B tool's records.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.engine.predict import make_protocol_fn as jax_protocol
from mqdet_torch.engine.predict import make_protocol_fn
from mqdet_torch.models import fusion as tfusion
from mqdet_torch.models.layers import cl
from mqdet_torch.ops import bi_attention as tba
from test_torch_port_modules import REPO, _levels, nchw, tiny_pair, to_nhwc
from test_torch_port_slice import G, CP, HW, setup  # noqa: F401  (setup is a fixture)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIZES = [420, 180, 70, 30]
SWITCHES = {
    "concat-single": {},
    "stream-single": {"MQDET_FLASH_LEVELS": "stream"},
    "concat-dual": {"MQDET_FLASH_SCORES": "dual"},
    "stream-dual": {"MQDET_FLASH_LEVELS": "stream", "MQDET_FLASH_SCORES": "dual"},
}
ORDER = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")


def set_switches(monkeypatch, name):
    monkeypatch.delenv("MQDET_FLASH_LEVELS", raising=False)
    monkeypatch.delenv("MQDET_FLASH_SCORES", raising=False)
    for k, v in SWITCHES[name].items():
        monkeypatch.setenv(k, v)


def bi_inputs(seed, b=2, n=700, t=128, e=256):
    """tests/test_ops.py's inputs: q scaled 0.1, a random text mask."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, n, e)) * 0.1).astype(np.float32)
    k = rng.standard_normal((b, t, e)).astype(np.float32)
    vv = rng.standard_normal((b, n, e)).astype(np.float32)
    vl = rng.standard_normal((b, t, e)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, t)) > 0.25
    return q, k, vv, vl, np.where(mask, 0.0, -9e15).astype(np.float32)


def split_levels(x):
    return np.split(x, np.cumsum(SIZES)[:-1], axis=1)


def test_dual_plain_matches_jax_dual_kernel_interpret():
    from mqdet_tpu.ops.pallas.bi_attention_pallas import flash_bi_attention

    args = bi_inputs(0)
    jv, jl = flash_bi_attention(*map(jnp.asarray, args), num_heads=2, block_n=256, interpret=True,
                                dual_scores=True)
    tv, tl = tba.bi_attention_dual_plain(*map(torch.from_numpy, args), num_heads=2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)


def test_levels_plain_matches_jax_levels_kernel_interpret():
    from mqdet_tpu.ops.pallas.bi_attention_pallas import flash_bi_attention_levels

    q, k, vv, vl, bias = bi_inputs(1)
    qs, vvs = split_levels(q), split_levels(vv)
    jvs, jl = flash_bi_attention_levels(
        [jnp.asarray(x) for x in qs], jnp.asarray(k), [jnp.asarray(x) for x in vvs], jnp.asarray(vl),
        jnp.asarray(bias), num_heads=2, interpret=True,
    )
    tvs, tl = tba.bi_attention_levels_plain(
        [torch.from_numpy(x) for x in qs], torch.from_numpy(k), [torch.from_numpy(x) for x in vvs],
        torch.from_numpy(vl), torch.from_numpy(bias), num_heads=2,
    )
    assert [x.shape[1] for x in tvs] == SIZES
    for t, j in zip(tvs, jvs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)


@pytest.mark.parametrize("plain", ["single", "dual"])
def test_levels_plain_equals_the_flat_form(plain):
    """The carried online update over the levels is the attention over their
    concatenation: fp32 rounding, atol 1e-5."""
    q, k, vv, vl, bias = map(torch.from_numpy, bi_inputs(2))
    flat = tba.bi_attention_dual_plain if plain == "dual" else tba.bi_attention_plain
    fv, fl = flat(q, k, vv, vl, bias, 2)
    tvs, tl = tba.bi_attention_levels_plain(q.split(SIZES, 1), k, vv.split(SIZES, 1), vl, bias, 2)
    np.testing.assert_allclose(torch.cat(tvs, 1).numpy(), fv.numpy(), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), fl.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()[:3]


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_vlfuse_matches_jax_under_switch(pair, switch, monkeypatch):
    from mqdet_tpu.models.fusion import VLFuse as JVLFuse

    set_switches(monkeypatch, switch)
    _, params, tmodel = pair
    rng = np.random.default_rng(9)
    feats = _levels(rng)
    lang = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 12:] = 0
    jmod = JVLFuse(num_convs=1, v_dim=16, l_dim=32, dtype=jnp.float32)
    jv, jl = jax.jit(jmod.apply)(
        {"params": params["params"]["rpn"]["fuse_0"]},
        [jnp.asarray(f) for f in feats], jnp.asarray(lang), jnp.asarray(mask),
    )
    with torch.no_grad():
        tv, tl = tmodel.rpn.head.dyhead_tower[0](
            [cl(nchw(f)) for f in feats], torch.from_numpy(lang), torch.from_numpy(mask)
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    for w, g in zip(jv, tv):
        assert g.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def protocol_runs(setup):  # noqa: F811
    """The JAX protocol's detections, and the port's under default switches."""
    cfg, tcfg, jmodel, params, tmodel, image, text, sizes = setup
    mp = pytest.MonkeyPatch()
    mp.setenv("MQDET_DEFORM_IMPL", "gather")
    try:
        want = jax_protocol(jmodel, HW, cfg)(
            params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in ORDER), jnp.asarray(sizes)
        )
    finally:
        mp.undo()
    port = make_protocol_fn(tmodel, HW, tcfg)
    inputs = (nchw(image), *(torch.from_numpy(text[k]) for k in ORDER), torch.from_numpy(sizes))
    return want, port, inputs


@pytest.mark.parametrize("switch", ["stream-single", "concat-dual"])
def test_tiny_protocol_under_switch_matches_jax_and_default(protocol_runs, switch, monkeypatch):
    want, port, inputs = protocol_runs
    set_switches(monkeypatch, "concat-single")
    base = port(*inputs)
    set_switches(monkeypatch, switch)
    got = port(*inputs)
    v = np.asarray(want.valid)
    assert got.boxes.shape == (G, CP, 20, 4) and v.sum() >= G * CP * 5
    for ref in ((np.asarray(want.valid), np.asarray(want.labels), np.asarray(want.scores),
                 np.asarray(want.boxes)),
                (base.valid.numpy(), base.labels.numpy(), base.scores.numpy(), base.boxes.numpy())):
        np.testing.assert_array_equal(got.valid.numpy(), ref[0])
        np.testing.assert_array_equal(got.labels.numpy(), ref[1])
        np.testing.assert_allclose(got.scores.numpy(), ref[2], atol=1e-5)
        np.testing.assert_allclose(got.boxes.numpy()[v], ref[3][v], atol=1e-4)


def test_stream_runs_one_call_per_level_without_concatenating(pair, monkeypatch):
    """Under stream, VLFuse hands flash_bi_attention_levels one q and one vv
    per level, never calls flash_bi_attention or torch.cat, and the per-level
    tokens it normalises are views of the channels_last maps."""
    set_switches(monkeypatch, "stream-single")
    fuse = pair[2].rpn.head.dyhead_tower[0]
    feats = [cl(nchw(f)) for f in _levels(np.random.default_rng(3))]
    calls, cats, normed = [], [], []
    levels = tfusion.flash_bi_attention_levels

    def spy_levels(qs, k, vvs, *a):
        calls.append(([tuple(x.shape) for x in qs], [tuple(x.shape) for x in vvs]))
        return levels(qs, k, vvs, *a)

    def no_flat(*a, **kw):
        raise AssertionError("flash_bi_attention called under stream")

    real_cat = torch.cat
    monkeypatch.setattr(tfusion, "flash_bi_attention_levels", spy_levels)
    monkeypatch.setattr(tfusion, "flash_bi_attention", no_flat)
    monkeypatch.setattr(torch, "cat", lambda *a, **kw: cats.append(1) or real_cat(*a, **kw))
    hook = fuse.b_attn.layer_norm_v.register_forward_pre_hook(lambda m, a: normed.append(a[0]))
    try:
        with torch.no_grad():
            outs, _ = fuse(feats, torch.randn(2, 16, 32), torch.ones(2, 16, dtype=torch.int32))
    finally:
        hook.remove()
    assert not cats
    want = [(2, f.shape[2] * f.shape[3], 2048) for f in feats]
    assert calls == [(want, want)]
    assert len(normed) == len(feats)
    for x, f in zip(normed, feats):
        assert x.data_ptr() == f.data_ptr() and x.untyped_storage().data_ptr() == f.untyped_storage().data_ptr()
    assert [o.shape for o in outs] == [f.shape for f in feats]


@pytest.mark.parametrize("env,arg,want", [
    (None, None, False), ("single", None, False), ("dual", None, True), ("DUAL", None, False),
    ("yes", None, False), ("dual", False, False), ("single", True, True), (None, True, True),
])
def test_scores_switch(env, arg, want, monkeypatch):
    """MQDET_FLASH_SCORES is read at call time: only `dual` selects the dual
    form; an explicit dual_scores overrides it."""
    if env is None:
        monkeypatch.delenv("MQDET_FLASH_SCORES", raising=False)
    else:
        monkeypatch.setenv("MQDET_FLASH_SCORES", env)
    used = []
    for name in ("bi_attention_plain", "bi_attention_dual_plain"):
        real = getattr(tba, name)
        monkeypatch.setattr(tba, name, lambda *a, _n=name, _r=real: used.append(_n) or _r(*a))
    args = [torch.from_numpy(x) for x in bi_inputs(4, b=1, n=10, t=64)]
    tba.flash_bi_attention(*args, 1, dual_scores=arg)
    assert used == ["bi_attention_dual_plain" if want else "bi_attention_plain"]


@pytest.mark.parametrize("env,stream", [
    (None, False), ("concat", False), ("stream", True), ("", True), ("levels", True),
])
def test_levels_switch(env, stream, monkeypatch):
    """MQDET_FLASH_LEVELS: anything but `concat` streams, as in JAX; under
    stream, MQDET_FLASH_SCORES=dual is ignored."""
    monkeypatch.delenv("MQDET_FLASH_LEVELS", raising=False)
    if env is not None:
        monkeypatch.setenv("MQDET_FLASH_LEVELS", env)
    monkeypatch.setenv("MQDET_FLASH_SCORES", "dual")
    used = []
    for name in ("flash_bi_attention", "flash_bi_attention_levels"):
        real = getattr(tfusion, name)
        monkeypatch.setattr(tfusion, name, lambda *a, _n=name, _r=real: used.append(_n) or _r(*a))
    dual = []
    real_dual = tba.bi_attention_dual_plain
    monkeypatch.setattr(tba, "bi_attention_dual_plain", lambda *a: dual.append(1) or real_dual(*a))
    attn = tfusion.BiMultiHeadAttention(16, 32, embed_dim=256, num_heads=1)
    with torch.no_grad():
        outs, _ = attn([torch.randn(2, 20, 16), torch.randn(2, 6, 16)], torch.randn(2, 64, 32))
    assert [tuple(o.shape) for o in outs] == [(2, 20, 16), (2, 6, 16)]
    assert used == ["flash_bi_attention_levels" if stream else "flash_bi_attention"]
    assert dual == ([] if stream else [1])


@pytest.mark.parametrize("switch", ["stream-single", "concat-dual"])
def test_gdino_fusion_takes_dual_and_ignores_stream(switch, monkeypatch):
    """GroundingDINO's fusion takes one flattened tensor: dual reaches it
    through flash_bi_attention, stream changes nothing."""
    from mqdet_torch.models.gdino import FusionLayer

    torch.manual_seed(0)
    layer = FusionLayer(16, 256, 1).eval()
    v, l = torch.randn(2, 50, 16), torch.randn(2, 64, 16)
    mask = torch.ones(2, 64, dtype=torch.int32)
    mask[1, 40:] = 0
    set_switches(monkeypatch, "concat-single")
    with torch.no_grad():
        base = layer(v, l, mask)
    set_switches(monkeypatch, switch)
    used = []
    for name in ("bi_attention_plain", "bi_attention_dual_plain", "bi_attention_levels_plain"):
        real = getattr(tba, name)
        monkeypatch.setattr(tba, name, lambda *a, _n=name, _r=real: used.append(_n) or _r(*a))
    with torch.no_grad():
        got = layer(v, l, mask)
    assert used == ["bi_attention_dual_plain" if switch == "concat-dual" else "bi_attention_plain"]
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.numpy(), b.numpy(), atol=1e-6)


def test_wrappers_take_the_plain_path_only_on_cpu():
    args = [torch.from_numpy(x) for x in bi_inputs(5, b=1, n=100, t=64)]
    counts = (tba.launch_count, tba.dual_launch_count, tba.levels_launch_count)
    tba.flash_bi_attention(*args, 1, dual_scores=True)
    ovs, ol = tba.flash_bi_attention_levels(args[0].split([60, 40], 1), args[1],
                                            args[2].split([60, 40], 1), *args[3:], 1)
    assert [o.shape for o in ovs] == [(1, 60, 256), (1, 40, 256)] and ol.shape == (1, 64, 256)
    assert (tba.launch_count, tba.dual_launch_count, tba.levels_launch_count) == counts
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        tba.flash_bi_attention(*meta, 1, dual_scores=True)
    with pytest.raises(ValueError):
        tba.flash_bi_attention_levels([meta[0]], meta[1], [meta[2]], *meta[3:], 1)


def test_launch_counts_read_and_reset_every_kernel_counter(monkeypatch):
    import importlib

    import chip_smoke
    from mqdet_torch.ops import COUNTERS, deform_conv, launch_counts, ms_deform_attn

    for _, mod, attr in COUNTERS:
        monkeypatch.setattr(importlib.import_module(f"mqdet_torch.ops.{mod}"), attr, 3)
    counts = launch_counts()
    assert list(counts) == [name for name, _, _ in chip_smoke.KERNELS]  # one name per kernel JSON entry
    assert set(counts.values()) == {3} and len(counts) == 12
    assert set(launch_counts(reset=True).values()) == {0}
    assert (deform_conv.launch_count, deform_conv.band_launch_count, tba.dual_launch_count,
            ms_deform_attn.launch_count, ms_deform_attn.clip_launch_count) == (0, 0, 0, 0, 0)


def _tool(*argv):
    return subprocess.run(
        [sys.executable, "-m", "mqdet_torch.tools.perf_fusion_ab", *argv], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )


def test_perf_tool_prints_skipped_for_stream_dual():
    out = _tool("stream", "dual")
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["levels"] == "stream" and rec["scores"] == "dual" and "skipped" in rec


def test_perf_tool_fails_without_a_card():
    out = _tool("concat", "single")
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
