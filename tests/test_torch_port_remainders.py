"""The port's remainders against the JAX package, on the CPU: GDINO at 3
feature levels (evaluation and a training step) and GDINO's inert keys,
MODEL.DYHEAD.SCORE_AGG, DyConv's merged canvas, MQDET_FUSION_IMPL, the
deformable PSRoI and RoI pooling, the demo predictor and CLI, and
MODEL.FPN.USE_GN / USE_RELU.

Both sides in fp32 with the same weights (`params_from_jax`) and numpy
inputs. Tolerances are those of the files whose fixtures are reused
(`test_torch_port_gdino.py`, `test_torch_port_gdino_train.py`,
`test_torch_port_slice.py`): atol 1e-4 on O(1) activations and pixel boxes,
1e-3 on logits of magnitude ~10, 1e-5 on scores; pooling 1e-5.
"""
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.utils import builders as jb
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import flat_params, nchw, perturb

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GDINO_HW = (96, 96)


def gdino_pair(edit=None, seed=0):
    """(jax model, params, port model, jax cfg, port cfg) of the tiny GDINO
    with `edit(cfg)` applied to both configs."""
    jcfg, tcfg = jb.tiny_gdino_config(), tb.tiny_gdino_config()
    for cfg in (jcfg, tcfg):
        if edit:
            edit(cfg)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    b = tb.synthetic_caption_batch(tcfg, 2, GDINO_HW, num_labels=3, k_shot=2, seed=0)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    params = perturb(jb.init_params_fast(jmodel, *(jnp.asarray(b[k]) for k in keys), seed=seed))
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return jmodel, params, tmodel, jcfg, tcfg


def close(got, want, atol=1e-4, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=1e-4, err_msg=err_msg)


def gdino_forward_both(jmodel, params, tmodel, tcfg, seed=9):
    """encode_image + forward_head on both sides with debug outputs."""
    b = tb.synthetic_caption_batch(tcfg, 2, GDINO_HW, num_labels=3, k_shot=2, seed=seed)
    image = np.random.default_rng(10).standard_normal((1,) + GDINO_HW + (3,)).astype(np.float32)
    text = [b[k] for k in ("input_ids", "attention_mask", "queries", "query_mask")]
    jdbg = jmodel.clone(debug_outputs=True)
    cls = type(jdbg)

    def jfn(p, x, *t):
        srcs = jdbg.apply(p, x, method=cls.encode_image)
        return srcs, jdbg.apply(p, srcs, *t, method=cls.forward_head)

    jsrcs, want = jax.jit(jfn)(params, jnp.asarray(image), *map(jnp.asarray, text))
    tmodel.debug_outputs = True
    try:
        with torch.no_grad():
            srcs = tmodel.encode_image(nchw(image))
            got = tmodel.forward_head(srcs, *map(torch.from_numpy, text))
    finally:
        tmodel.debug_outputs = False
    return jsrcs, want, srcs, got


def assert_forward_matches(jsrcs, want, srcs, got):
    assert len(srcs) == len(jsrcs)
    for w, g in zip(jsrcs, srcs):
        close(g.permute(0, 2, 3, 1), w, err_msg="srcs")
    for k in ("dbg_memory", "dbg_text", "dbg_init_ref", "pred_boxes"):
        close(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["dbg_topk_idx"].numpy(), np.asarray(want["dbg_topk_idx"]))
    for k in ("enc_logits", "pred_logits"):
        w = np.asarray(want[k])
        np.testing.assert_array_equal(np.isfinite(got[k].numpy()), np.isfinite(w), err_msg=k)
        close(torch.nan_to_num(got[k], neginf=0.0), np.nan_to_num(w, neginf=0.0), atol=1e-3, err_msg=k)


# ---- GDINO: the inert keys, 3 levels ---------------------------------------------


def test_gdino_ignores_two_stage_type_dn_number_and_query_dim():
    """JAX reads none of the three keys; the port builds the same model
    whatever they say: the same state_dict keys as the default and the
    forward of JAX's model built with the same values."""
    def edit(cfg):
        g = cfg.GROUNDINGDINO
        g.two_stage_type, g.dn_number, g.query_dim = "no", 100, 2

    jmodel, params, tmodel, _, tcfg = gdino_pair(edit)
    assert set(tmodel.state_dict()) == set(tb.build_model(tb.tiny_gdino_config()).state_dict())
    assert_forward_matches(*gdino_forward_both(jmodel, params, tmodel, tcfg))


@pytest.fixture(scope="module")
def gdino3():
    def edit(cfg):
        cfg.GROUNDINGDINO.num_feature_levels = 3

    return gdino_pair(edit)


def test_gdino_three_levels_forward_matches_jax(gdino3):
    """Three input_proj pairs, a 3-row level_embed, MSDA over 3 levels (the
    pyramid 12x12, 6x6, 3x3): every stage of the forward equals JAX's."""
    jmodel, params, tmodel, _, tcfg = gdino3
    assert len(tmodel.input_proj) == 3 and tuple(tmodel.transformer.level_embed.shape) == (3, 16)
    jsrcs, want, srcs, got = gdino_forward_both(jmodel, params, tmodel, tcfg)
    assert [tuple(s.shape[2:]) for s in srcs] == [(12, 12), (6, 6), (3, 3)]
    assert_forward_matches(jsrcs, want, srcs, got)


def test_gdino_three_levels_protocol_matches_jax(gdino3):
    """make_protocol_fn, G = 2 groups of CP = 2 chunks: every query slot's
    box, score, label and validity."""
    from mqdet_tpu.engine.predict import make_protocol_fn as jax_protocol

    from mqdet_torch.engine.predict import make_protocol_fn

    jmodel, params, tmodel, jcfg, tcfg = gdino3
    g_, cp = 2, 2
    image = np.random.default_rng(11).standard_normal((1,) + GDINO_HW + (3,)).astype(np.float32)
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    chunks = [[tb.synthetic_caption_batch(tcfg, 1, GDINO_HW, 3, 2, seed=20 + 10 * g + c) for c in range(cp)]
              for g in range(g_)]
    text = {k: np.stack([np.stack([ch[k][0] for ch in grp]) for grp in chunks]) for k in order}
    sizes = np.tile(np.array([[96, 96], [90, 70]], np.float32)[None], (g_, 1, 1))
    jcfg, tcfg = jcfg.clone(), tcfg.clone()
    for cfg in (jcfg, tcfg):
        cfg.GROUNDINGDINO.box_threshold = 0.9
    want = jax_protocol(jmodel, GDINO_HW, jcfg)(params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in order),
                                                jnp.asarray(sizes))
    got = make_protocol_fn(tmodel, GDINO_HW, tcfg)(nchw(image), *(torch.from_numpy(text[k]) for k in order),
                                                   torch.from_numpy(sizes))
    v = np.asarray(want.valid)
    assert 0 < v.sum() < v.size
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    close(got.scores, want.scores, atol=1e-5)
    close(got.boxes, want.boxes)


def test_gdino_three_levels_train_step_matches_jax(monkeypatch):
    """One training step at 3 levels, by test_torch_port_gdino_train.py's
    rule: the step's loss within rtol 1e-4 and every trainable parameter and
    its EMA within 1e-5 of its largest value of JAX's `make_gdino_train_step`."""
    import test_torch_port_gdino_train as gt
    from mqdet_tpu.engine import train as jtrain

    from mqdet_torch.engine import train as tt

    def edit(cfg):
        gt._train_mods(cfg)
        cfg.GROUNDINGDINO.num_feature_levels = 3

    jmodel, params, tmodel, jcfg, tcfg = gdino_pair(edit)
    batch = gt._gdino_batch(tcfg)
    state, tx, merge = jtrain.init_train_state(params, jcfg, gt.jax_trainable_patterns(jcfg))
    gp = dict(jmodel=jmodel, params=params, tmodel=gt.no_dropout(tmodel), jcfg=jcfg, tcfg=tcfg, batch=batch,
              state=state, tx=tx, merge=merge, jbatch={k: jnp.asarray(v) for k, v in batch.items()})
    _, jstep = gt._jax_gdino_loss_fn(jmodel, merge, tx, jcfg, monkeypatch)
    jstate, jmetrics = jax.jit(jstep)(state, gp["jbatch"], jax.random.PRNGKey(0))
    model, tstate, step = gt._port_step(gp)
    before = {n: t.clone() for n, t in tstate.trainable.items()}
    tstate, metrics = step(tstate, tt.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    assert gt.rel_err(jmetrics["loss_total"], metrics["loss_total"]) < 1e-4
    paths = gt._flax_paths(model)
    for n, t in tstate.trainable.items():
        (path,) = paths[n]
        tf = gt.rule_table(model)[path[len("params/"):]][1]
        want = np.asarray(jstate.trainable[path])
        np.testing.assert_allclose(tf(t.numpy()), want, atol=1e-5 * np.abs(want).max(), err_msg=n)
        np.testing.assert_allclose(tf(tstate.ema[n].numpy()), np.asarray(jstate.ema[path]),
                                   atol=1e-5 * np.abs(want).max(), err_msg=n)
        assert not torch.equal(t, before[n]), n


@pytest.mark.parametrize("levels", [2, 5])
def test_gdino_other_level_counts_raise_where_jax_fails(levels):
    """JAX fails at 2 (IndexError in encode_image) and 5 (a broadcast
    TypeError in the deformable layers); the port raises its own error."""
    jcfg = jb.tiny_gdino_config()
    jcfg.GROUNDINGDINO.num_feature_levels = levels
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    b = tb.synthetic_caption_batch(tb.tiny_gdino_config(), 1, GDINO_HW, num_labels=3, k_shot=2, seed=0)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    with pytest.raises((IndexError, TypeError)):
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in keys))
    tcfg = tb.tiny_gdino_config()
    tcfg.GROUNDINGDINO.num_feature_levels = levels
    with pytest.raises(ValueError, match="num_feature_levels"):
        tb.build_model(tcfg)


# ---- MQ-GLIP: SCORE_AGG, MQDET_FUSION_IMPL ---------------------------------------


@pytest.mark.parametrize("agg", ["MAX", "MEAN"])
def test_score_agg_computes_jax_mean(agg, monkeypatch):
    """JAX stores MODEL.DYHEAD.SCORE_AGG and reads it nowhere: its
    post-processor takes the MEAN whatever the key says. The port's
    protocol under the key equals JAX's detections."""
    from test_torch_port_slice import HW, build_setup

    from mqdet_tpu.engine.predict import make_protocol_fn as jax_protocol

    from mqdet_torch.engine.predict import make_protocol_fn

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    cfg, tcfg, jmodel, params, tmodel, image, text, sizes = build_setup()
    cfg, tcfg = copy.deepcopy(cfg), copy.deepcopy(tcfg)
    cfg.MODEL.DYHEAD.SCORE_AGG = tcfg.MODEL.DYHEAD.SCORE_AGG = agg
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    want = jax_protocol(jmodel, HW, cfg)(params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in order),
                                         jnp.asarray(sizes))
    got = make_protocol_fn(tmodel, HW, tcfg)(nchw(image), *(torch.from_numpy(text[k]) for k in order),
                                             torch.from_numpy(sizes))
    v = np.asarray(want.valid)
    assert v.sum() >= 10
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    close(got.scores, want.scores, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)


@pytest.mark.parametrize("impl", [None, "pallas", "xla", "composite"])
def test_fusion_impl_switch_takes_the_plain_route(impl, monkeypatch):
    """MQDET_FUSION_IMPL other than `pallas` runs the fusion's calls inside
    `plain_versions()` (on a card: no kernel), unset or `pallas` outside it;
    VLFuse's output equals JAX's under the same value."""
    from test_torch_port_modules import tiny_pair

    import mqdet_torch.models.fusion as tf
    from mqdet_torch.ops import kernels

    if impl is None:
        monkeypatch.delenv("MQDET_FUSION_IMPL", raising=False)
    else:
        monkeypatch.setenv("MQDET_FUSION_IMPL", impl)
    seen = []
    real = tf.flash_bi_attention

    def watch(*a, **kw):
        seen.append(kernels._plain_route)
        return real(*a, **kw)

    monkeypatch.setattr(tf, "flash_bi_attention", watch)
    jmodel, params, tmodel, _, _ = tiny_pair()
    from mqdet_tpu.models.fusion import VLFuse as JFuse

    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, h, w, 16)).astype(np.float32) for h, w in ((8, 8), (4, 4), (2, 2), (1, 1))]
    lang = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 12:] = 0
    wv, wl = JFuse(num_convs=1, v_dim=16, l_dim=32, dtype=jnp.float32).apply(
        {"params": params["params"]["rpn"]["fuse_0"]}, [jnp.asarray(f) for f in feats], jnp.asarray(lang),
        jnp.asarray(mask))
    with torch.no_grad():
        gv, gl = tmodel.rpn.head.dyhead_tower[0]([nchw(f) for f in feats], torch.from_numpy(lang),
                                                 torch.from_numpy(mask))
    assert seen == [impl not in (None, "pallas")]
    for g, w in zip(gv, wv):
        close(g.permute(0, 2, 3, 1), w)
    close(gl, wl)


# ---- MODEL.FPN.USE_GN / USE_RELU ---------------------------------------------------


@pytest.mark.parametrize("gn, relu", [(True, False), (False, True), (True, True)])
def test_fpn_use_gn_and_use_relu_match_jax(gn, relu, monkeypatch):
    """MQ-GLIP passes MODEL.FPN.USE_GN / USE_RELU to its FPN, which computes
    JAX's function: GroupNorm(32) at flax's eps after each lateral and output
    conv (no conv bias under it), then the ReLU. The FPN's levels and the
    head's logits equal JAX's in fp32 (the GroupNorms' weights come through
    the bridge; 32 channels, as GroupNorm(32) needs)."""
    from test_torch_port_modules import jax_init_args, tiny_pair, to_nhwc

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")

    def mods(cfg):
        cfg.MODEL.FPN.USE_GN, cfg.MODEL.FPN.USE_RELU = gn, relu
        cfg.MODEL.BACKBONE.OUT_CHANNELS = cfg.MODEL.DYHEAD.CHANNELS = 32

    jmodel, params, tmodel, jcfg, _ = tiny_pair(mods)
    sd = tmodel.state_dict()
    assert sum("_gn." in k for k in sd if k.startswith("backbone.fpn.")) == (12 if gn else 0)
    assert ("backbone.fpn.fpn_inner2.bias" in sd) == (not gn)
    _, args = jax_init_args(jcfg)
    want = jax.jit(lambda p, *a: jmodel.apply(p, *a))(params, *args)
    with torch.no_grad():
        got = tmodel(nchw(args[0]), *(torch.from_numpy(np.array(a)) for a in args[1:]))
    for w, g in zip(want["fpn_feats"], got["fpn_feats"]):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)
    if relu:
        assert all(float(g.min()) >= 0.0 for g in got["fpn_feats"][:3])
    for w, g in zip(want["dot_product_logits"], got["dot_product_logits"]):
        close(g, w, atol=1e-3)


# ---- the merged canvas ------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.8, 3.0])
@pytest.mark.parametrize("stride", [1, 2])
def test_merged_canvas_matches_jax(stride, scale, monkeypatch):
    """DeformConvGN with merge_max_positions 600 over levels (13, 21) and
    (7, 11) (both merged): the port's merged band call (its plain version
    here) against JAX's merged Pallas call in interpret mode, as
    tests/test_dcn_seam.py runs it, and against the port per level; offsets
    x0.8 (JAX's test) and x3 (past the clip radius 2). atol 2e-4, JAX's
    test's."""
    from mqdet_tpu.models.vldyhead import DeformConvGN as JD

    from mqdet_torch.models.vldyhead import DeformConvGN as TD

    rng = np.random.default_rng(3)
    c = 128
    xs, offs, msks = [], [], []
    for h, w in [(13, 21), (7, 11)]:
        ho, wo = -(-h // stride), -(-w // stride)
        xs.append(rng.standard_normal((2, h, w, c)).astype(np.float32))
        offs.append((rng.standard_normal((2, ho, wo, 18)) * scale).astype(np.float32))
        msks.append(rng.uniform(0, 1, (2, ho, wo, 9)).astype(np.float32))
    jmod = JD(features=c, stride=stride, groups=8, merge_max_positions=600)
    jx = [[jnp.asarray(a) for a in v] for v in (xs, offs, msks)]
    params = jmod.init(jax.random.PRNGKey(0), *jx)
    p = params["params"]
    tmod = TD(c, c, stride, 8, merge_max_positions=600)
    with torch.no_grad():
        tmod.conv.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()))
        tmod.conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"]) + 0.1))
        tmod.bn.weight.copy_(torch.from_numpy(np.asarray(p["gn"]["scale"])))
        tmod.bn.bias.copy_(torch.from_numpy(np.asarray(p["gn"]["bias"])))
    params = jax.tree_util.tree_map(lambda v: v, params)
    params = {"params": {**p, "bias": p["bias"] + 0.1}}
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "pallas_interpret")
    want = jmod.apply(params, *jx)
    calls = []
    real = tmod.conv.forward
    tmod.conv.forward = lambda *a: calls.append(a[0].shape) or real(*a)
    txs = [nchw(x) for x in xs]
    tos, tms = [torch.from_numpy(o) for o in offs], [torch.from_numpy(m) for m in msks]
    with torch.no_grad():
        got = tmod(txs, tos, tms)
        assert calls == [(4, c, 13, 21)]  # one call over the canvas at batch 2B
        monkeypatch.setenv("MQDET_DEFORM_IMPL", "pallas")
        one = [tmod(x, o, m) for x, o, m in zip(txs, tos, tms)]
    for g, w, o in zip(got, want, one):
        close(g.permute(0, 2, 3, 1), w, atol=2e-4)
        close(g, o.numpy(), atol=2e-4)


def test_merge_off_by_default_and_off_the_band_route(monkeypatch):
    """merge_max_positions 0 (JAX's default) runs one call per level; so
    does any positive value off the band route (`gather`, `window`) or at C
    not a multiple of 128."""
    from mqdet_torch.models.vldyhead import DeformConvGN

    rng = np.random.default_rng(0)

    def run(mod, c, impl):
        monkeypatch.setenv("MQDET_DEFORM_IMPL", impl)
        calls = []
        real = mod.conv.forward
        mod.conv.forward = lambda *a: calls.append(1) or real(*a)
        xs = [torch.from_numpy(rng.standard_normal((1, c, h, w)).astype(np.float32)) for h, w in ((5, 6), (3, 3))]
        offs = [torch.zeros(1, h, w, 18) for h, w in ((5, 6), (3, 3))]
        msks = [torch.ones(1, h, w, 9) for h, w in ((5, 6), (3, 3))]
        with torch.no_grad():
            mod(xs, offs, msks)
        return len(calls)

    assert run(DeformConvGN(128, 128, 1, 8), 128, "pallas") == 2
    assert run(DeformConvGN(128, 128, 1, 8, merge_max_positions=600), 128, "pallas") == 1
    for impl in ("gather", "window"):
        assert run(DeformConvGN(128, 128, 1, 8, merge_max_positions=600), 128, impl) == 2
    assert run(DeformConvGN(64, 64, 1, 8, merge_max_positions=600), 64, "pallas") == 2


def test_dyconv_merges_through_the_model(monkeypatch):
    """DyConv hands its three DeformConvGNs the level lists, as JAX's does,
    so `merge_max_positions` set on them takes effect in the model: over
    levels (24, 40), (12, 20), (6, 10), (3, 5) the 10 conv calls, one a
    level, become 4 with 600 (each conv's grids of at most 600 output
    positions on one canvas: 3 of 4 at the mid conv, all 3 at the lo and
    hi convs), and every level's output stays within atol 1e-5 of the
    per-level run."""
    from mqdet_torch.models.vldyhead import DeformConvGN, DyConv

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "pallas")
    torch.manual_seed(0)
    dy = DyConv(128, 16).eval()
    with torch.no_grad():
        for p in dy.parameters():
            p.normal_(0.0, 0.05)
    convs = [m for m in dy.modules() if isinstance(m, DeformConvGN)]
    calls = []
    for m in convs:
        real = m.conv.forward
        m.conv.forward = lambda *a, real=real: calls.append(a[0].shape[0]) or real(*a)
    rng = np.random.default_rng(5)
    feats = [nchw(rng.standard_normal((1, h, w, 128)).astype(np.float32)) for h, w in
             ((24, 40), (12, 20), (6, 10), (3, 5))]
    runs = {}
    for merge in (0, 600):
        for m in convs:
            m.merge_max_positions = merge
        calls.clear()
        with torch.no_grad():
            runs[merge] = (dy(feats), len(calls))
    assert runs[0][1] == 10 and runs[600][1] == 4
    for a, b in zip(runs[600][0], runs[0][0]):
        close(a, b.numpy(), atol=1e-5)


# ---- pooling -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "groups_trans", "outside"])
def test_deform_psroi_pool_matches_jax(case):
    """deform_psroi_pool: position-sensitive groups, per-class offsets, ROIs
    partly off the map (samples outside excluded from the count)."""
    from mqdet_tpu.ops.deform_pool import deform_psroi_pool as jpool

    from mqdet_torch.ops.deform_pool import deform_psroi_pool

    rng = np.random.default_rng(len(case))
    gs, od, ncls = (1, 8, 1) if case == "plain" else (3, 4, 2)
    feats = rng.standard_normal((2, 12, 14, od * gs * gs)).astype(np.float32)
    rois = np.array([[0, 1.2, 2.0, 9.6, 10.3], [1, 0.0, 0.0, 13.0, 11.0], [1, 4.4, 3.5, 6.1, 5.2]], np.float32)
    if case == "outside":
        rois = np.array([[0, -6.0, -4.0, 5.0, 7.0], [1, 10.0, 8.0, 25.0, 19.0], [0, -9.0, 3.0, -1.0, 6.0]],
                        np.float32)
    trans = None if case == "plain" else rng.standard_normal((3, ncls, 2, 3, 3)).astype(np.float32)
    kw = dict(spatial_scale=0.5 if case == "outside" else 1.0, output_dim=od, pooled_size=5, group_size=gs,
              part_size=3, sample_per_part=3, trans_std=0.2, no_trans=trans is None)
    want = jpool(jnp.asarray(feats), jnp.asarray(rois), None if trans is None else jnp.asarray(trans), **kw)
    got = deform_psroi_pool(torch.from_numpy(feats), torch.from_numpy(rois),
                            None if trans is None else torch.from_numpy(trans), **kw)
    assert got.shape == (3, 5, 5, od)
    close(got, want, atol=1e-5)


def _roi_pool_oracle(feats, rois, scale, p):
    """ROIPool in exact rational arithmetic: the pixel at c is in bin
    floor((c - start) * p / size) where that is in [0, p). Also returns, per
    (roi, bin), whether a pixel on one of the bin's edges (an exact integer
    quotient) lies in the map: a tie that fp32 division may round either way."""
    from fractions import Fraction

    h, w, c = feats.shape
    out = np.zeros((len(rois), p, p, c), np.float32)
    tie = np.zeros((len(rois), p, p), bool)
    for r, roi in enumerate(rois):
        x1, y1, x2, y2 = (int(np.round(np.float32(v) * np.float32(scale))) for v in roi)
        rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        qy = [Fraction(y - y1) * p / rh for y in range(h)]
        qx = [Fraction(x - x1) * p / rw for x in range(w)]
        ty = {int(q) for q in qy if 0 < q <= p and q.denominator == 1}
        tx = {int(q) for q in qx if 0 < q <= p and q.denominator == 1}
        for py in range(p):
            rows = [y for y in range(h) if 0 <= qy[y] and int(qy[y]) == py]
            for px in range(p):
                cols = [x for x in range(w) if 0 <= qx[x] and int(qx[x]) == px]
                tie[r, py, px] = bool({py, py + 1} & ty or {px, px + 1} & tx)
                if rows and cols:
                    out[r, py, px] = feats[np.ix_(rows, cols)].reshape(-1, c).max(0)
    return out, tie


def test_roi_pool_matches_jax():
    """roi_pool against exact rational arithmetic on every bin (the port
    computes the bin in integers), and against JAX's on every bin with no
    tie: a pixel whose quotient (c - start) * P / size is an integer sits on
    a bin edge, and JAX's fp32 quotient by the rounded bin size falls either
    side of it (on the CPU 15 / (15 / 7) = 6.9999995), so those bins depend
    on its division's rounding, not on the function."""
    from mqdet_tpu.ops.roi_align import roi_pool as jpool

    from mqdet_torch.ops.roi_align import roi_pool

    rng = np.random.default_rng(2)
    feats = rng.standard_normal((20, 24, 8)).astype(np.float32)
    rois = np.array([[2.0, 3.0, 30.0, 25.0], [0.0, 0.0, 47.0, 39.0], [40.0, 30.0, 60.0, 50.0],
                     [-10.0, -6.0, 90.0, 80.0], [12.3, 7.7, 13.1, 8.2], [9.5, 14.2, 62.0, 47.0]], np.float32)
    compared = 0
    for scale, size in ((0.5, 7), (0.25, 3)):
        want = np.asarray(jpool(jnp.asarray(feats), jnp.asarray(rois), scale, size))
        got = roi_pool(torch.from_numpy(feats), torch.from_numpy(rois), scale, size).numpy()
        exact, tie = _roi_pool_oracle(feats, rois, scale, size)
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_allclose(got[~tie], want[~tie], atol=1e-6)
        compared += int((~tie).sum())
        assert (want == 0).any() and (got == 0).any()  # an empty bin gives 0, as in JAX
    assert compared > 200


# ---- the demo -------------------------------------------------------------------


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_demo_matches_jax(family, monkeypatch):
    """MQDetDemo end to end on a (60, 80) uint8 image at threshold 0: the
    boxes in image coordinates, scores, labels and names of JAX's demo."""
    from test_torch_port_modules import tiny_pair

    from mqdet_tpu.data.tokenizer import WordPieceTokenizer as JTok
    from mqdet_tpu.engine.demo import MQDetDemo as JDemo

    from mqdet_torch.data.tokenizer import WordPieceTokenizer as TTok
    from mqdet_torch.engine.demo import MQDetDemo

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    if family == "glip":
        jmodel, params, tmodel, jcfg, tcfg = tiny_pair()
    else:
        jmodel, params, tmodel, jcfg, tcfg = gdino_pair()
    for cfg in (jcfg, tcfg):  # no 1x1 level: torch's GroupNorm refuses one value a channel at batch 1
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = (192, 256) if family == "glip" else (72, 96)
        cfg.TPU.IMAGE_BUCKETS = ((256, 256),) if family == "glip" else ((96, 96),)
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
    jdemo = JDemo(jcfg, jmodel, params, confidence_threshold=0.0)
    tdemo = MQDetDemo(tcfg, tmodel, confidence_threshold=0.0)
    jdemo.tokenizer, tdemo.tokenizer = JTok(), TTok()
    img = np.random.default_rng(0).uniform(0, 255, (60, 80, 3)).astype(np.uint8)
    want = jdemo(img, ["cat", "dog", "remote control"])
    got = tdemo(img, ["cat", "dog", "remote control"])
    assert len(want["scores"]) > 3
    assert got["names"] == want["names"]
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=2e-4)
    assert got["boxes"][:, [0, 2]].max() <= 80 + 1e-3 and got["boxes"][:, [1, 3]].max() <= 60 + 1e-3


def test_demo_cli_help():
    res = subprocess.run([sys.executable, "-m", "mqdet_torch.tools.demo", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0
    for flag in ("--config-file", "--weight", "--image", "--categories", "--threshold", "--output", "--device"):
        assert flag in res.stdout


def test_demo_cli_runs_on_the_cpu(tmp_path):
    """The CLI's main on a tiny config's yaml, a PNG read with PIL and the
    model's weights as a reference-layout .pth: the detections it prints and
    writes are those of the predictor over the same model."""
    from PIL import Image

    from mqdet_torch.data import tokenizer as T
    from mqdet_torch.engine.demo import MQDetDemo
    from mqdet_torch.tools import demo as tool

    cfg = tb.tiny_test_config()
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 192, 256
    cfg.TPU.IMAGE_BUCKETS = ((256, 256),)
    cfg.MODEL.ATSS.INFERENCE_TH = 0.0
    model = tb.init_params(tb.build_model(cfg), seed=1).eval()
    weights = str(tmp_path / "w.pth")
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}}, weights)
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(cfg.dump_yaml())
    img = np.random.default_rng(1).uniform(0, 255, (60, 80, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "x.png")
    out = str(tmp_path / "dets.json")
    dets = tool.main(["--config-file", str(yaml), "--weight", weights, "--image", str(tmp_path / "x.png"),
                      "--categories", "cat. dog", "--threshold", "0.0", "--output", out, "--device", "cpu"])
    assert json.load(open(out)) == json.loads(json.dumps(dets)) and len(dets) > 0
    demo = MQDetDemo(cfg, model, confidence_threshold=0.0)
    demo.tokenizer = T.get_tokenizer(cfg.MODEL.LANGUAGE_BACKBONE.TOKENIZER_TYPE)
    want = demo(img, ["cat", "dog"])
    assert [d["label"] for d in dets] == want["names"]
    np.testing.assert_allclose([d["score"] for d in dets], want["scores"], atol=1e-6)
    np.testing.assert_allclose([d["box"] for d in dets], want["boxes"], atol=1e-4)
