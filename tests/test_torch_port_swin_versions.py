"""The port's Swin v2 / vl / v2_vl (MODEL.SWINT.VERSION) vs the JAX package:
the backbone module at a tiny width (v2's cosine attention, CPB bias and
post-norm; vl's and v2_vl's joint image <-> text window attention in the
last stage, with and without text, the masked text invariant), tiny MQ-GLIP
under each version end to end (JAX's `encode_image` passes no text, so vl
and v2_vl compute v1's function there, with v1's parameters), and
MQ-GroundingDINO, whose JAX model reads neither MODEL_TYPE nor
SWINT.VERSION: the port builds the same model whatever they say.

Tolerances: fp32, atol 1e-4 on the backbone outputs (1e-5 for the masked
text invariance, as `tests/test_swin_vl.py`); the models as
`test_torch_port_text_towers.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.models.swin import SwinTransformer as JaxSwin
from mqdet_torch.models.swin import SwinTransformer
from mqdet_torch.utils import builders as tb
from test_torch_port_gcp_switches import load_sub
from test_torch_port_modules import flat_params, nchw, perturb, to_nhwc
from test_torch_port_text_towers import assert_end_to_end, variant_pair

torch.set_num_threads(2)

TINY = dict(embed_dim=16, depths=(1, 1, 2, 2), num_heads=(1, 2, 2, 2), window_size=4, drop_path_rate=0.0)
NTEXT, TEXT_DIM = 6, 24


def pair(version, text):
    """(jax module, its variables, the port's module with the same weights)."""
    jm = JaxSwin(**TINY, version=version)
    x = jnp.zeros((2, 40, 36, 3))
    kw = {"x_text": jnp.zeros((2, NTEXT, TEXT_DIM)), "text_masks": jnp.ones((2, NTEXT))} if text else {}
    variables = perturb(jm.init(jax.random.PRNGKey(0), x, **kw), scale=0.2)
    tm = SwinTransformer(**{k: v for k, v in TINY.items()}, version=version,
                         text_dim=TEXT_DIM if text else None, ntext=NTEXT if text else None).eval()
    load_sub(tm, variables, "backbone/", "backbone.body.")
    return jm, variables, tm


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 40, 36, 3)).astype(np.float32)  # 40 x 36: padded to /4, then windows
    xt = rng.standard_normal((2, NTEXT, TEXT_DIM)).astype(np.float32)
    tm = np.ones((2, NTEXT), np.int32)
    tm[1, 3:] = 0
    return x, xt, tm


@pytest.mark.parametrize("version", ["v1", "v2", "vl", "v2_vl"])
def test_backbone_without_text_matches_jax(version):
    jm, variables, tm = pair(version, text=False)
    x, _, _ = inputs()
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)
    if version == "v2":
        names = set(flat_params(variables))
        assert not any("relative_position_bias_table" in n for n in names)
        assert any(n.endswith("attn/logit_scale") for n in names)


@pytest.mark.parametrize("version", ["vl", "v2_vl"])
@pytest.mark.parametrize("masked", [False, True])
def test_backbone_with_text_matches_jax(version, masked):
    jm, variables, tm = pair(version, text=True)
    x, xt, mask = inputs()
    if not masked:
        mask = np.ones_like(mask)
    want_feats, want_text = jm.apply(variables, jnp.asarray(x), x_text=jnp.asarray(xt), text_masks=jnp.asarray(mask))
    with torch.no_grad():
        got_feats, got_text = tm(nchw(x), x_text=torch.from_numpy(xt), text_masks=torch.from_numpy(mask))
    for w, g in zip(want_feats, got_feats):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_text.numpy(), np.asarray(want_text), atol=1e-4, rtol=1e-4)
    assert all(k.startswith("layers.3.") for k in tm.state_dict() if "text" in k)  # the last stage only
    if masked:  # the masked text tokens' content does not reach the image stream (tests/test_swin_vl.py:68)
        xt2 = xt.copy()
        xt2[1, 3:] = 100.0
        with torch.no_grad():
            again, _ = tm(nchw(x), x_text=torch.from_numpy(xt2), text_masks=torch.from_numpy(mask))
        for a, g in zip(again, got_feats):
            np.testing.assert_allclose(a.numpy(), g.numpy(), atol=1e-5)


def test_text_needs_a_vl_backbone_with_a_text_stream():
    with pytest.raises(ValueError, match="vl or v2_vl"):
        SwinTransformer(**TINY, version="v2", text_dim=TEXT_DIM, ntext=NTEXT)
    x, xt, _ = inputs()
    with pytest.raises(ValueError, match="no text stream"):
        SwinTransformer(**TINY, version="vl")(nchw(x), x_text=torch.from_numpy(xt))
    with pytest.raises(ValueError, match="VERSION"):
        SwinTransformer(**TINY, version="v3")


def version(v):
    def mods(cfg):
        cfg.MODEL.SWINT.VERSION = v
    return mods


@pytest.mark.parametrize("v", ["v2", "vl", "v2_vl"])
def test_mq_glip_with_swin_version_matches_jax(v):
    pair_ = variant_pair(version(v))
    keys = set(pair_[2].state_dict())
    default = set(tb.build_model(tb.tiny_test_config()).state_dict())
    if v == "v2":
        assert any(k.endswith("attn.logit_scale") for k in keys) and keys != default
    else:  # no text reaches the backbone: v1's parameters
        assert keys == default
    assert_end_to_end(*pair_)


def test_gdino_ignores_language_type_and_swin_version():
    """JAX's MQGroundingDINO builds BERT and Swin v1 whatever
    MODEL.LANGUAGE_BACKBONE.MODEL_TYPE and MODEL.SWINT.VERSION say: the same
    parameters on both sides as the default, and the port's model under
    those keys, given JAX's weights, gives JAX's detections."""
    from mqdet_tpu.engine.predict import make_split_predict_fns as jax_split_fns
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.engine.predict import make_split_predict_fns
    from test_torch_port_querybank import gdino_pair

    def mods(cfg):
        cfg.MODEL.LANGUAGE_BACKBONE.MODEL_TYPE = "clip"
        cfg.MODEL.SWINT.VERSION = "v2"
        cfg.GROUNDINGDINO.box_threshold = 0.0

    jmodel, params, tmodel, jcfg, tcfg = gdino_pair(mods)
    assert list(tmodel.state_dict()) == list(tb.build_model(tb.tiny_gdino_config()).state_dict())
    b = tb.synthetic_caption_batch(tcfg, 2, (96, 96), num_labels=3, k_shot=2, seed=3)
    default = jb.build_model(jb.tiny_gdino_config())
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    tree = jax.eval_shape(lambda: default.init(jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in keys)))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map", "image_sizes")
    image = b["images"][:1]
    jenc, jhead = jax_split_fns(jmodel, (96, 96), jcfg)
    want = jhead(params, jenc(params, jnp.asarray(image)), *(jnp.asarray(b[k]) for k in order))
    tenc, thead = make_split_predict_fns(tmodel, (96, 96), tcfg)
    with torch.no_grad():
        got = thead(tenc(nchw(image)), *(torch.from_numpy(b[k]) for k in order))
    v = np.asarray(want.valid)
    assert v.sum() >= 10
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)


def test_default_weight_draw_unchanged():
    """`init_params` draws in state_dict order, so a module registered in
    another order moves every later weight (ROADMAP Queue C 4's hazard): the
    default full-width MQ-GLIP-T's seed-0 weights, keys and bytes, hash as
    they did before the Swin versions and the language towers were added."""
    import hashlib

    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_config

    h = hashlib.sha256()
    for k, t in init_params(build_model(mq_glip_t_config()), seed=0).state_dict().items():
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == "35fe8e54f33e68e5eb86cc14bb8d395f62a640f8c80dc5346d109508fa9c2964"
