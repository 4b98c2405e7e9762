"""The head's fuse types (MHA-S, SCAN, FILM and MHA-B), the head with every
early-fusion switch off, and the MLM head with its loss, in the port against
the JAX package, on the CPU in fp32.

VLDyHead runs at the widths of the JAX package's
tests/test_models.py::test_vldyhead_fuse_type_variants (3 levels of 32
channels, text 48 wide, 2 stages), with its 16 DyConv GroupNorm groups (the
JAX MQ-GLIP's; the port fixes 16). Weights go through the bridge, SCAN's and
FILM's BatchNorm running statistics from flax's `batch_stats` included; every
JAX leaf is perturbed by normal(0.05) first. Tolerances are stated per test.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.engine import losses as jl
from mqdet_tpu.engine import train as jtrain
from mqdet_tpu.models.vldyhead import VLDyHead as JHead
from mqdet_tpu.utils import builders as jb
from mqdet_torch.engine import train as tt
from mqdet_torch.io import torch_import as TI
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.models.fusion import make_coord_channels
from mqdet_torch.models.vldyhead import VLDyHead
from mqdet_torch.utils import builders as tb
from test_torch_port_gcp_switches import levels, load_sub, perturb, rel
from test_torch_port_modules import HW, flat_params, jax_init_args, nchw
from test_torch_port_train import _anchors, _gt, jax_leaf, no_dropout, to_flax

torch.set_num_threads(2)

LEVELS = [(16, 16), (8, 8), (4, 4)]
HEADS = {  # case -> (FUSE_CONFIG.TYPE, EARLY_FUSE_ON and USE_FUSED_FEATURES_DOT_PRODUCT)
    "MHA-B": ("MHA-B", True), "MHA-S": ("MHA-S", True), "SCAN": ("SCAN", True), "FILM": ("FILM", True),
    "S8": ("MHA-B", False),
}


def head_cfg(fuse_type, fused):
    cfg = tb.tiny_test_config()
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 32
    lb = cfg.MODEL.LANGUAGE_BACKBONE
    lb.LANG_DIM = lb.HIDDEN_SIZE = 48
    lb.NUM_HEADS, lb.INTERMEDIATE_SIZE = 4, 96
    dy = cfg.MODEL.DYHEAD
    dy.NUM_CLASSES, dy.NUM_CONVS = 6, 2
    dy.USE_DFCONV = dy.USE_DYFUSE = dy.USE_DYRELU = False
    dy.FUSE_CONFIG.TYPE = fuse_type
    dy.FUSE_CONFIG.EARLY_FUSE_ON = dy.FUSE_CONFIG.USE_FUSED_FEATURES_DOT_PRODUCT = fused
    cfg.MODEL.RPN.ANCHOR_STRIDE = (8, 16, 32)
    return cfg


@pytest.mark.parametrize("case", list(HEADS))
def test_head_fuse_type_matches_jax(case):
    """VLDyHead under each fuse type and under S8 (EARLY_FUSE_ON,
    USE_FUSED_FEATURES_DOT_PRODUCT, USE_DFCONV, USE_DYFUSE, USE_DYRELU all
    off; the dot product then reads the embedding): logits, boxes,
    centerness and dot-product logits over all levels within 1e-5 of their
    largest value, SCAN's within 5e-5: its fusion output is one context
    vector broadcast over each level, so the next 3x3 conv's maps are
    constant but at their borders, and GroupNorm's rsqrt of their small
    variance amplifies fp32 rounding (2.0e-5 measured on bbox_reg); the
    text stream unchanged under MHA-S, SCAN and FILM."""
    fuse_type, fused = HEADS[case]
    rng = np.random.default_rng(11)
    feats = [rng.standard_normal((2, h, w, 32)).astype(np.float32) for h, w in LEVELS]
    lang = rng.standard_normal((2, 24, 48)).astype(np.float32)
    masks = np.ones((2, 24), np.int32)
    masks[1, 18:] = 0
    emb = rng.standard_normal((2, 24, 48)).astype(np.float32)
    agg = rng.standard_normal((2, 48)).astype(np.float32)
    jm = JHead(num_convs=2, channels=32, in_channels=32, lang_dim=48, lang_heads=4, lang_intermediate=96,
               num_classes=5, use_deform=False, use_dyfuse=False, use_dyrelu=False, fuse_type=fuse_type,
               early_fuse=fused, use_fused_dot_product=fused, gn_groups=16)
    jf = [jnp.asarray(f) for f in feats]
    kw = dict(embedding=jnp.asarray(emb), lang_aggregate=jnp.asarray(agg))
    variables = perturb(jm.init(jax.random.PRNGKey(0), jf, jnp.asarray(lang), jnp.asarray(masks), **kw))
    want = jax.jit(lambda v, f, a, b, e, g: jm.apply(v, f, a, b, embedding=e, lang_aggregate=g))(
        variables, jf, jnp.asarray(lang), jnp.asarray(masks), kw["embedding"], kw["lang_aggregate"])
    tm = VLDyHead(head_cfg(fuse_type, fused)).eval()
    load_sub(tm, variables, "rpn/", "rpn.head.")
    with torch.no_grad():
        got = tm([nchw(f) for f in feats], torch.from_numpy(lang), torch.from_numpy(masks),
                 embedding=torch.from_numpy(emb), lang_aggregate=torch.from_numpy(agg))
    tol = 5e-5 if case == "SCAN" else 1e-5
    for key in ("logits", "bbox_reg", "centerness", "dot_product_logits"):
        assert rel(levels(got[key]), np.concatenate([np.asarray(w).reshape(-1) for w in want[key]])) < tol, key
    assert rel(got["fused_lang_hidden"].numpy(), want["fused_lang_hidden"]) < 1e-5
    if fuse_type in ("MHA-S", "SCAN", "FILM"):
        assert "batch_stats" in variables or fuse_type == "MHA-S"
        assert not any(isinstance(m, torch.nn.Identity) for m in tm.dyhead_tower[:3])


def test_coord_channels_copy_jax():
    """`make_coord_channels` is JAX's, the row index divided by w included
    (a deliberate copy), at a non-square level."""
    from mqdet_tpu.models.fusion import make_coord_channels as jcoord

    got = make_coord_channels(2, 3, 5, torch.float32, "cpu").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcoord(2, 3, 5, jnp.float32)))
    assert got[0, 2, 0, 0] == (2 * 2 - 5) / 5  # row 2: x_min = (2 * row - w) / w


@pytest.mark.parametrize("fuse_type", ["MHA-S", "SCAN", "FILM"])
def test_model_under_fuse_type_matches_jax(fuse_type, monkeypatch):
    """The tiny MQ-GLIP under MHA-S, SCAN and FILM (the head's
    `lang_aggregate` from the language tower) on the exact DCN route: the
    dot-product logits within 1e-5 of their largest value."""
    from test_torch_port_modules import tiny_pair

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")

    def mods(cfg):
        cfg.MODEL.DYHEAD.FUSE_CONFIG.TYPE = fuse_type

    jmodel, params, tmodel, jcfg, _ = tiny_pair(mods)
    params = perturb(params, seed=4)  # the BatchNorm statistics off their init
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    b, args = jax_init_args(jcfg)
    want = jax.jit(jmodel.apply)(params, *args)
    with torch.no_grad():
        got = tmodel(nchw(b["images"]), torch.from_numpy(b["input_ids"]).long(),
                     torch.from_numpy(b["attention_mask"]), torch.from_numpy(b["queries"]),
                     torch.from_numpy(b["query_mask"]))
    assert rel(levels(got["dot_product_logits"]),
               np.concatenate([np.asarray(w).reshape(-1) for w in want["dot_product_logits"]])) < 1e-5


def test_jax_cannot_train_scan_or_film():
    """The JAX package's training forward (deterministic=False, no mutable
    `batch_stats`) fails on a FILM head: the reason the port refuses SCAN /
    FILM training (`engine/train.py`)."""
    jm = JHead(num_convs=1, channels=32, in_channels=32, lang_dim=48, lang_heads=4, lang_intermediate=96,
               num_classes=5, use_deform=False, use_dyfuse=False, use_dyrelu=False, fuse_type="FILM", gn_groups=16)
    feats = [jnp.ones((2, h, w, 32)) for h, w in LEVELS]
    lang, masks, agg = jnp.ones((2, 8, 48)), jnp.ones((2, 8), jnp.int32), jnp.ones((2, 48))
    variables = jm.init(jax.random.PRNGKey(0), feats, lang, masks, lang_aggregate=agg)
    with pytest.raises(Exception, match="batch_stats"):
        jm.apply(variables, feats, lang, masks, lang_aggregate=agg, deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(1)})


# ---------------------------------------------------------------- MLM


def test_mlm_mask_greenlight_matches_jax():
    """The step's random_word (`_mlm_mask`, on the raw ids) with JAX's draws
    injected: ids and labels bitwise JAX's `random_word_mask`, under
    MLM_LOSS_FOR_ONLY_POSITIVES (greenlight: the positive tokens) and
    without (every token)."""
    cfg = tb.tiny_test_config()
    b = jb.synthetic_batch(cfg, 2, HW, num_labels=3, k_shot=2, seed=1)
    ids = b["input_ids"].copy()
    ids[1, 12:] = 0
    pcm = (b["agg_map"] > 0).astype(np.float32)
    key = jax.random.PRNGKey(5)
    r1, r2, r3 = jax.random.split(key, 3)
    draws = tuple(torch.from_numpy(np.asarray(d)) for d in (
        jax.random.uniform(r1, ids.shape), jax.random.uniform(r2, ids.shape),
        jax.random.randint(r3, ids.shape, 0, 30522)))
    for only_pos in (True, False):
        cfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS_FOR_ONLY_POSITIVES = only_pos
        green = (pcm.sum(1) > 0).astype(np.int32) if only_pos else np.ones_like(ids)
        want = jtrain.random_word_mask(key, jnp.asarray(ids), jnp.asarray(green), 30522)
        got = tt._mlm_mask({"input_ids": torch.from_numpy(ids).long(), "pos_category_map": torch.from_numpy(pcm)},
                           cfg, None, draws)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (got[1] >= 0).any()


MLM_PATTERNS = ["qv_layer", "pre_select", "attn_gate", "ff_gate", "mlm_head"]


def test_glip_step_with_mlm_matches_jax(monkeypatch):
    """A GLIP train step under MLM_LOSS (coefficient 0.5, text dropout 0.5)
    against the JAX package's own `make_train_step` loss (its
    `_finish_train_step` replaced by the identity, so the step's loss
    function itself is differentiated; the model applied with
    deterministic=True, the port's dropout rates at 0), under
    MLM_LOSS_FOR_ONLY_POSITIVES on and off: JAX derives the greenlight from
    `pos_category_map`, masks the raw ids with `fold_in(rng, 2)` and drops
    text with `rng` after it; the port takes the same draws injected (its
    random_word through `mlm_draws`, its text dropout's uniforms through
    `apply_text_dropout`). Each loss term within 1e-4 relative and the
    gradient of every trainable parameter (the GCP pieces and the MLM head)
    within 2e-4 of its largest value. At this key the text dropout masks
    labelled tokens, so masking after the dropout would differ."""
    from test_torch_port_modules import tiny_pair

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")

    def mods(cfg):
        fc = cfg.MODEL.DYHEAD.FUSE_CONFIG
        fc.MLM_LOSS, fc.MLM_LOSS_COEF = True, 0.5
        cfg.VISION_QUERY.TEXT_DROPOUT = 0.5
        cfg.MODEL.SWINT.DROP_PATH_RATE = 0.0

    jmodel, params, tmodel, jcfg, tcfg = tiny_pair(mods)
    b, _ = jax_init_args(jcfg, batch=2, num_labels=3, k_shot=2, seed=3)
    gt = _gt(8, g=4, n_valid=(3, 3))
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=gt[0], gt_labels=gt[1], gt_valid=gt[2], gt_token_map=gt[3],
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32))
    anchors, level_sizes = _anchors()
    rng = jax.random.PRNGKey(2)
    r1, r2, r3 = jax.random.split(jax.random.fold_in(rng, 2), 3)
    shape = batch["input_ids"].shape
    draws = tuple(torch.from_numpy(np.array(d)) for d in (
        jax.random.uniform(r1, shape), jax.random.uniform(r2, shape), jax.random.randint(r3, shape, 0, 30522)))
    text_draws = np.array(jax.random.uniform(rng, batch["has_query"].shape))
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(rng, 0.5, text_draws.shape)), text_draws < 0.5)
    dropped = np.einsum("bl,blt->bt", (text_draws < 0.5).astype(np.float32), batch["pos_category_map"]) > 0
    orig = tt.apply_text_dropout
    monkeypatch.setattr(tt, "apply_text_dropout",
                        lambda *a, draws=None, **k: orig(*a, draws=torch.from_numpy(text_draws), **k))
    monkeypatch.setattr(jtrain, "_finish_train_step", lambda loss_fn, tx, ema_decay: loss_fn)
    state, _, merge = jtrain.init_train_state(params, jcfg, MLM_PATTERNS)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}

    def apply(p, *args, deterministic, rngs):
        return jmodel.apply(p, *args, deterministic=True)

    labelled = []
    for only_pos in (True, False):
        jcfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS_FOR_ONLY_POSITIVES = only_pos
        tcfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS_FOR_ONLY_POSITIVES = only_pos
        loss_fn = jtrain.make_train_step(apply, merge, None, jnp.asarray(anchors), level_sizes, jcfg)
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            state.trainable, state.frozen, jb_, rng)
        labels = tt._mlm_mask(tt.batch_to_device(batch, "cpu"), tcfg, None, draws)[1].numpy()
        labelled.append(labels >= 0)
        assert (labelled[-1] & dropped).any()
        model = no_dropout(copy.deepcopy(tmodel))
        tstate, tx = tt.init_train_state(model, tcfg, MLM_PATTERNS)
        step = tt.make_train_step(model, tx, tcfg)
        _, metrics = step(tstate, tt.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0),
                          mlm_draws=draws)
        assert set(jlosses) == set(metrics) - {"loss_total"} and "loss_mlm" in metrics
        for k, v in jlosses.items():
            assert abs(float(metrics[k]) - float(v)) <= 1e-4 * abs(float(v)), (only_pos, k)
        params_t = dict(model.named_parameters())
        assert any(n.startswith("rpn.head.mlm_head.") for n in tstate.trainable)
        for n in tstate.trainable:
            g = to_flax(n, params_t[n].grad)
            w = jax_leaf(jgrads, n)
            assert np.abs(g - w).max() <= 2e-4 * max(np.abs(w).max(), 1e-30), (only_pos, n)
    assert labelled[0].sum() < labelled[1].sum()  # the greenlight took tokens out of the loss


def test_mlm_head_pth_import(tmp_path):
    """A reference `.pth` with BertLMPredictionHead's names (decoder bias
    tied to `mlm_head.bias`, also saved as `mlm_head.decoder.bias`) imports
    into the MLM head as into JAX's tree: the same report (matched, missing,
    unused) and the same values; the S1 switches' leaves, which JAX's table
    does not name, are missing on both sides."""
    from mqdet_tpu.io import torch_import as JTI
    from test_torch_port_gcp_switches import bank_setup, s1_mods

    s = bank_setup(s1_mods)
    rng = np.random.default_rng(0)
    h = "rpn.head.mlm_head."
    bias = rng.standard_normal(30522).astype(np.float32)
    state = {h + "transform.dense.weight": rng.standard_normal((32, 32)).astype(np.float32),
             h + "transform.dense.bias": rng.standard_normal(32).astype(np.float32),
             h + "transform.LayerNorm.weight": rng.standard_normal(32).astype(np.float32),
             h + "transform.LayerNorm.bias": rng.standard_normal(32).astype(np.float32),
             h + "decoder.weight": rng.standard_normal((30522, 32)).astype(np.float32),
             h + "decoder.bias": bias, h + "bias": bias}
    torch.save({"model": {"module." + k: torch.from_numpy(v) for k, v in state.items()}}, str(tmp_path / "m.pth"))
    loaded = TI.load_torch_state_dict(str(tmp_path / "m.pth"))
    model = copy.deepcopy(s["tmodel"])
    report = TI.import_glip_checkpoint(model, loaded)
    _, want = JTI.import_glip_checkpoint(s["params"], JTI.load_torch_state_dict(str(tmp_path / "m.pth")))
    assert sorted(report["matched"]) == sorted(want["matched"]) and len(report["matched"]) == 6
    assert sorted(report["unused"]) == sorted(want["unused"]) == [h + "decoder.bias"]
    assert sorted(report["missing"]) == sorted(want["missing"])
    assert {"qv_layer_learnable_bank", "rpn/tunable_linear"} <= set(report["missing"])
    mlm = model.rpn.head.mlm_head
    np.testing.assert_array_equal(mlm.bias.detach().numpy(), bias)
    np.testing.assert_array_equal(mlm.decoder.weight.detach().numpy(), state[h + "decoder.weight"])
    np.testing.assert_array_equal(mlm.transform.LayerNorm.weight.detach().numpy(),
                                  state[h + "transform.LayerNorm.weight"])


@pytest.mark.parametrize("dfconv", [True, False])
def test_dyconv_conv_maps_to_its_flax_leaf_by_the_dcn_switch(dfconv):
    """A DyConv conv's port key is one reference key either way; its flax
    leaf (the optimizer's groups, the `.pth` import's report) is JAX's
    `dyconv_c/kernel` under USE_DFCONV and `dyconv_c/conv/kernel` without."""
    from mqdet_torch.engine.optim import flax_path

    cfg = tb.tiny_test_config()
    cfg.MODEL.DYHEAD.USE_DFCONV = dfconv
    model = tb.build_model(cfg)
    leaf = "conv/" if not dfconv else ""
    for key, want in (("rpn.head.dyhead_tower.2.DyConv.0.conv.weight", f"dyconv_0/{leaf}kernel"),
                      ("rpn.head.dyhead_tower.2.DyConv.2.conv.bias", f"dyconv_2/{leaf}bias"),
                      ("rpn.head.dyhead_tower.2.DyConv.1.bn.weight", "dyconv_1/gn/scale")):
        assert flax_path(key, model) == f"rpn/dyconv_tower_0/{want}"
    assert ("rpn.head.dyhead_tower.2.offset.weight" in model.state_dict()) == dfconv
