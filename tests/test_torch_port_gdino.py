"""mqdet_torch's MQ-GroundingDINO evaluation path vs the JAX package at the
tiny config (`tiny_gdino_config`), module by module and end to end, plus the
GroundingDINO weight bridge.

The JAX model is built in fp32; its parameters are `init_params_fast` values
perturbed with seeded noise, and the port gets them through
`params_from_jax`. Inputs are numpy arrays from a seed; captions have
GroundingDINO's shape ([CLS], name tokens and '.', [SEP], padding), so the
sub-sentence masks have real blocks. On the CPU the JAX package's MSDA and
bi-attention take their composites, the port's wrappers their plain
versions. Images are 96x96: the pyramid is 12x12, 6x6, 3x3 and 2x2 (a
non-exact level ratio, as 25x42 -> 13x21 at 800x1344), and no level is 1x1,
where a GroupNorm group holds one element and the fused CPU kernel's
rounding is amplified by rsqrt(eps). Tolerances are fp32 rounding through
the chained layers: atol 1e-4 on O(1) activations, 1e-3 on logits of
magnitude ~10, unless stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.models import gdino as JG
from mqdet_tpu.utils import builders as jb
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.models import gdino as TG
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import flat_params, nchw, perturb

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (96, 96)
SHAPES = [(12, 12), (6, 6), (3, 3), (2, 2)]
C = 16  # tiny hidden width


def captions(cfg, batch, seed, labels=3, shots=2):
    return tb.synthetic_caption_batch(cfg, batch, HW, num_labels=labels, k_shot=shots, seed=seed)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model, jax cfg, torch cfg, flat params)."""
    jcfg, tcfg = jb.tiny_gdino_config(), tb.tiny_gdino_config()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    b = captions(tcfg, 2, seed=0)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    params = perturb(jb.init_params_fast(jmodel, *(jnp.asarray(b[k]) for k in keys), seed=0))
    flat = flat_params(params)
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat, tmodel))
    return jmodel, params, tmodel, jcfg, tcfg, flat


def sub(params, *path):
    p = params["params"]
    for k in path:
        p = p[k]
    return {"params": p}


def close(got, want, atol=1e-4, rtol=1e-4, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=err_msg)


# ---- pure functions -------------------------------------------------------


def _random_ids(trial):
    """The reference-parity cases of tests/test_gdino.py: [CLS] first, three
    '.' scattered, a [SEP] near the end; trial 3 also ends on a special."""
    rng = np.random.default_rng(3)
    for _ in range(trial + 1):
        ids = rng.integers(3, 50, (2, 16))
        ids[:, 0] = 101
        for b in range(2):
            for p in sorted(rng.choice(np.arange(2, 14), 3, replace=False)):
                ids[b, p] = 1012
            ids[b, rng.integers(13, 16)] = 102
    if trial == 3:
        ids[0, -1] = 102
    return ids


ID_CASES = {
    "cls_first": np.array([[101, 5, 6, 1012, 7, 102, 0, 0]]),
    "no_cls": np.array([[5, 6, 1012, 7, 102, 0]]),
    **{f"random{i}": _random_ids(i) for i in range(4)},
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_sub_sentence_masks_match_jax(case):
    """Exact: the block masks and position ids of every case."""
    ids = ID_CASES[case]
    want_attn, want_pos = JG.sub_sentence_masks(jnp.asarray(ids))
    attn, pos = TG.sub_sentence_masks(torch.from_numpy(ids))
    np.testing.assert_array_equal(attn.numpy(), np.asarray(want_attn))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))


def test_sine_embeddings_match_jax():
    """atol 1e-5: sin/cos of fp32 phases up to ~2*pi*16."""
    close(TG.sine_pos_embed_2d(13, 21, 128), JG.sine_pos_embed_2d(13, 21, (13, 21), 128), atol=1e-5)
    pos = np.random.default_rng(0).integers(0, 16, (2, 16)).astype(np.float32)
    close(TG.sine_embed_1d(torch.from_numpy(pos), 16), JG.sine_embed_1d(jnp.asarray(pos), 16), atol=1e-5)
    boxes = np.random.default_rng(1).random((2, 7, 4)).astype(np.float32)
    for d in (2, 4):
        close(TG.gen_sineembed_for_position(torch.from_numpy(boxes[..., :d])),
              JG.gen_sineembed_for_position(jnp.asarray(boxes[..., :d])), atol=1e-5)
    x = np.linspace(-0.5, 1.5, 41).astype(np.float32)
    close(TG.inverse_sigmoid(torch.from_numpy(x)), JG.inverse_sigmoid(jnp.asarray(x)), atol=1e-6)


def test_contrastive_embed_and_postprocess_match_jax():
    """Logits with masked tokens and the -inf padding to max_text_len; the
    postprocess drops non-finite logits before the sigmoid. Scores atol
    1e-6, boxes in pixels atol 1e-4, labels and validity exact."""
    rng = np.random.default_rng(2)
    qs = rng.standard_normal((2, 12, C)).astype(np.float32)
    text = rng.standard_normal((2, 10, C)).astype(np.float32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    want = JG.contrastive_embed(jnp.asarray(qs), jnp.asarray(text), jnp.asarray(mask), 16)
    got = TG.contrastive_embed(torch.from_numpy(qs), torch.from_numpy(text), torch.from_numpy(mask), 16)
    assert got.shape == (2, 12, 16)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(np.asarray(want)))
    close(torch.nan_to_num(got, neginf=0.0), jnp.nan_to_num(want, neginf=0.0), atol=1e-5)

    boxes = rng.uniform(0.0, 1.0, (2, 12, 4)).astype(np.float32)
    agg = np.zeros((2, 3, 10), np.float32)
    agg[:, 0, 1:3] = 0.5
    agg[:, 1, 4] = 1.0
    agg[:, 2, 6:8] = 0.5
    sizes = np.array([[60.0, 80.0], [96.0, 50.0]], np.float32)
    args = (np.array(want)[..., :16], boxes, agg, sizes)
    jd = JG.gdino_postprocess(*map(jnp.asarray, args), box_threshold=0.3)
    td = TG.gdino_postprocess(*map(torch.from_numpy, args), box_threshold=0.3)
    v = np.asarray(jd.valid)
    assert 0 < v.sum() < v.size
    np.testing.assert_array_equal(td.valid.numpy(), v)
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    close(td.scores, jd.scores, atol=1e-6)
    close(td.boxes, jd.boxes, atol=1e-4)


# ---- modules --------------------------------------------------------------


def test_bert_with_sub_sentence_masks_matches(pair):
    """The text tower with the block attention matrix alone as its mask, the
    restarted position ids, and vision queries over pooled image tokens."""
    jmodel, params, tmodel = pair[:3]
    b = captions(pair[4], 2, seed=3)
    b["attention_mask"][1, 8:] = 0
    ids = b["input_ids"]
    image_tokens = np.random.default_rng(4).standard_normal((2, 45, C)).astype(np.float32)
    attn, pos = JG.sub_sentence_masks(jnp.asarray(ids))

    def jfn(m, *a):
        return m.language_backbone(*a[:5], attention_matrix=a[5], position_ids=a[6])

    want = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=jfn))(
        params, jnp.asarray(ids), jnp.asarray(b["attention_mask"]), jnp.asarray(b["queries"]),
        jnp.asarray(b["query_mask"]), jnp.asarray(image_tokens), attn, pos,
    )
    tattn, tpos = TG.sub_sentence_masks(torch.from_numpy(ids))
    with torch.no_grad():
        got = tmodel.bert(
            torch.from_numpy(ids), torch.from_numpy(b["attention_mask"]), torch.from_numpy(b["queries"]),
            torch.from_numpy(b["query_mask"]), torch.from_numpy(image_tokens),
            attention_matrix=tattn, position_ids=tpos,
        )
    close(got["last_hidden"], want["hidden"], err_msg="hidden")
    close(got["augmented_vision"], want["augmented_vision"], err_msg="augmented_vision")


def _msda_inputs(rng, q, ref_dim):
    s = sum(h * w for h, w in SHAPES)
    query = rng.standard_normal((2, q, C)).astype(np.float32)
    value = rng.standard_normal((2, s, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, q, len(SHAPES), ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] *= 0.5
    return query, value, ref


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeformattn_matches(pair, ref_dim):
    """Encoder form (2-d reference points) and decoder form (boxes), with
    the encoder layer's weights; offsets reach past the maps' borders."""
    _, params, tmodel = pair[:3]
    query, value, ref = _msda_inputs(np.random.default_rng(5), 30, ref_dim)
    jmod = JG.MSDeformAttn(embed_dim=C, num_heads=2, num_levels=4, num_points=4)
    want = jax.jit(lambda p, *a: jmod.apply(p, *a, SHAPES))(
        sub(params, "enc_layer_0", "self_attn"), *map(jnp.asarray, (query, value, ref))
    )
    with torch.no_grad():
        got = tmodel.transformer.encoder.layers[0].self_attn(*map(torch.from_numpy, (query, value, ref)), SHAPES)
    close(got, want)


def test_text_enhancer_and_fusion_layers_match(pair):
    _, params, tmodel = pair[:3]
    rng = np.random.default_rng(6)
    text = rng.standard_normal((2, 16, C)).astype(np.float32)
    memory = rng.standard_normal((2, 193, C)).astype(np.float32)
    b = captions(pair[4], 2, seed=7)
    attn, pos = JG.sub_sentence_masks(jnp.asarray(b["input_ids"]))
    pos_text = JG.sine_embed_1d(pos.astype(jnp.float32), C)
    jtext = JG.TextEnhancerLayer(d_model=C, n_heads=1, d_ffn=16)
    want = jax.jit(jtext.apply)(sub(params, "enc_text_0"), jnp.asarray(text), attn, pos_text)
    enc = tmodel.transformer.encoder
    with torch.no_grad():
        got = enc.text_layers[0](torch.from_numpy(text), torch.from_numpy(np.array(attn)),
                                 torch.from_numpy(np.array(pos_text)))
    close(got, want, err_msg="text enhancer")

    mask = b["attention_mask"]
    jfus = JG.FusionLayer(v_dim=C, l_dim=C, embed_dim=16, num_heads=1)
    wv, wl = jax.jit(jfus.apply)(sub(params, "enc_fusion_0"), jnp.asarray(memory), jnp.asarray(text),
                                 jnp.asarray(mask))
    with torch.no_grad():
        gv, gl = enc.fusion_layers[0](torch.from_numpy(memory), torch.from_numpy(text), torch.from_numpy(mask))
    close(gv, wv, err_msg="fusion v")
    close(gl, wl, err_msg="fusion l")


def test_encoder_and_decoder_layers_match(pair):
    _, params, tmodel = pair[:3]
    rng = np.random.default_rng(8)
    s = sum(h * w for h, w in SHAPES)
    src = rng.standard_normal((2, s, C)).astype(np.float32)
    pos = rng.standard_normal((1, s, C)).astype(np.float32)
    ref2 = rng.uniform(0.05, 0.95, (2, s, 4, 2)).astype(np.float32)
    jenc = JG.DeformableEncoderLayer(d_model=C, d_ffn=32, n_heads=2)
    want = jax.jit(lambda p, *a: jenc.apply(p, *a, SHAPES))(
        sub(params, "enc_layer_0"), *map(jnp.asarray, (src, pos, ref2))
    )
    with torch.no_grad():
        got = tmodel.transformer.encoder.layers[0](*map(torch.from_numpy, (src, pos, ref2)), SHAPES)
    close(got, want, err_msg="encoder layer")

    tgt = rng.standard_normal((2, 12, C)).astype(np.float32)
    qpos = rng.standard_normal((2, 12, C)).astype(np.float32)
    ref4 = rng.uniform(0.1, 0.9, (2, 12, 4, 4)).astype(np.float32) * np.float32([1, 1, 0.5, 0.5])
    text = rng.standard_normal((2, 16, C)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 9:] = 0
    jdec = JG.DecoderLayer(d_model=C, d_ffn=32, n_heads=2)
    args = (tgt, qpos, ref4, src)
    want = jax.jit(lambda p, *a: jdec.apply(p, *a[:4], SHAPES, *a[4:]))(
        sub(params, "dec_layer_1"), *map(jnp.asarray, args + (text, mask))
    )
    with torch.no_grad():
        got = tmodel.transformer.decoder.layers[1](
            *map(torch.from_numpy, args), SHAPES, torch.from_numpy(text), torch.from_numpy(mask)
        )
    close(got, want, err_msg="decoder layer")


# ---- the model and the protocol ------------------------------------------


def test_forward_head_matches(pair):
    """encode_image + forward_head with debug outputs: the encoder's memory
    and text, the two-stage selection (exact indices), and every decoder
    layer's logits and boxes."""
    jmodel, params, tmodel = pair[:3]
    b = captions(pair[4], 2, seed=9)
    b["attention_mask"][1, 8:] = 0
    image = np.random.default_rng(10).standard_normal((1,) + HW + (3,)).astype(np.float32)
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
    assert [tuple(s.shape[2:]) for s in srcs] == SHAPES
    for w, g in zip(jsrcs, srcs):
        close(g.permute(0, 2, 3, 1), w, err_msg="srcs")
    for k in ("dbg_memory", "dbg_text", "dbg_output_memory", "dbg_init_ref", "pred_boxes"):
        close(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["dbg_topk_idx"].numpy(), np.asarray(want["dbg_topk_idx"]))
    for k in ("enc_logits", "pred_logits"):
        w = np.asarray(want[k])
        np.testing.assert_array_equal(np.isfinite(got[k].numpy()), np.isfinite(w), err_msg=k)
        close(torch.nan_to_num(got[k], neginf=0.0), np.nan_to_num(w, neginf=0.0), atol=1e-3, err_msg=k)
    assert len(got["aux_boxes"]) == len(want["aux_boxes"]) == 1
    close(got["aux_boxes"][0], want["aux_boxes"][0], err_msg="aux_boxes")


def test_forward_head_matches_jax_with_the_msda_clip(pair, monkeypatch):
    """encode_image + forward_head on both sides under
    MQDET_MSDA_IMPL=pallas_interpret (JAX: the TPU encoder kernel in
    interpret mode; the port: its clipped plain version), with the encoder's
    sampling offsets scaled x40 so that the clip binds (the exact route's
    memory differs by more than 1e-3, ten times the tolerance): the
    encoder's memory, enc_logits and the final boxes."""
    import copy

    import flax

    jmodel, params, tmodel = pair[:3]
    scale = 40.0
    jp = flax.core.unfreeze(copy.deepcopy(params))
    so = jp["params"]["enc_layer_0"]["self_attn"]["sampling_offsets"]
    so["kernel"], so["bias"] = so["kernel"] * scale, so["bias"] * scale
    tm = copy.deepcopy(tmodel)
    with torch.no_grad():
        for layer in tm.transformer.encoder.layers:
            layer.self_attn.sampling_offsets.weight.mul_(scale)
            layer.self_attn.sampling_offsets.bias.mul_(scale)
    b = captions(pair[4], 2, seed=9)
    image = np.random.default_rng(10).standard_normal((1,) + HW + (3,)).astype(np.float32)
    text = [b[k] for k in ("input_ids", "attention_mask", "queries", "query_mask")]
    jdbg = jmodel.clone(debug_outputs=True)
    cls = type(jdbg)

    def jfn(p, x, *t):
        return jdbg.apply(p, jdbg.apply(p, x, method=cls.encode_image), *t, method=cls.forward_head)

    def port():
        tm.debug_outputs = True
        with torch.no_grad():
            return tm.forward_head(tm.encode_image(nchw(image)), *map(torch.from_numpy, text))

    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    want = jax.jit(jfn)(jp, jnp.asarray(image), *map(jnp.asarray, text))
    got = port()
    close(got["dbg_memory"], want["dbg_memory"], err_msg="memory")
    close(got["pred_boxes"], want["pred_boxes"], err_msg="pred_boxes")
    w = np.asarray(want["enc_logits"])
    np.testing.assert_array_equal(np.isfinite(got["enc_logits"].numpy()), np.isfinite(w))
    close(torch.nan_to_num(got["enc_logits"], neginf=0.0), np.nan_to_num(w, neginf=0.0), atol=1e-3)
    monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    exact = port()["dbg_memory"].numpy()
    assert np.abs(exact - np.asarray(want["dbg_memory"])).max() > 1e-3  # 10x the tolerance above


def test_protocol_matches_jax(pair):
    """make_protocol_fn for G = 2 groups of CP = 2 chunks, one 96x96 image:
    boxes, scores, labels and validity of every query slot."""
    from mqdet_tpu.engine.predict import make_protocol_fn as jax_protocol

    from mqdet_torch.engine.predict import make_protocol_fn

    jmodel, params, tmodel, jcfg, tcfg, _ = pair
    g_, cp = 2, 2
    image = np.random.default_rng(11).standard_normal((1,) + HW + (3,)).astype(np.float32)
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    chunks = [[captions(tcfg, 1, seed=20 + 10 * g + c) for c in range(cp)] for g in range(g_)]
    text = {k: np.stack([np.stack([ch[k][0] for ch in grp]) for grp in chunks]) for k in order}
    sizes = np.tile(np.array([[96, 96], [90, 70]], np.float32)[None], (g_, 1, 1))
    jcfg, tcfg = jcfg.clone(), tcfg.clone()
    for cfg in (jcfg, tcfg):
        cfg.GROUNDINGDINO.box_threshold = 0.9  # about half of the slots pass
    want = jax_protocol(jmodel, HW, jcfg)(
        params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in order), jnp.asarray(sizes)
    )
    got = make_protocol_fn(tmodel, HW, tcfg)(
        nchw(image), *(torch.from_numpy(text[k]) for k in order), torch.from_numpy(sizes)
    )
    assert got.boxes.shape == (g_, cp, 12, 4) and got.valid.shape == (g_, cp, 12)
    v = np.asarray(want.valid)
    assert 0 < v.sum() < v.size
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    close(got.scores, want.scores, atol=1e-5)
    close(got.boxes, want.boxes, atol=1e-4)


def test_grad_mode_msda_after_protocol(pair):
    """The protocol runs under torch.inference_mode(); a grad-mode
    MSDeformAttn forward and backward at the same pyramid shapes afterwards
    must not meet an inference tensor made there (the level sizes are made
    per call, not cached). The level sizes are exact, and the gradient
    reaches the query."""
    from mqdet_torch.engine.predict import make_protocol_fn

    tmodel, tcfg = pair[2], pair[4]
    b = captions(tcfg, 1, seed=30)
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    image = np.random.default_rng(12).standard_normal((1,) + HW + (3,)).astype(np.float32)
    make_protocol_fn(tmodel, HW, tcfg)(
        nchw(image), *(torch.from_numpy(b[k][None]) for k in order), torch.tensor([[[96.0, 96.0]]])
    )
    np.testing.assert_array_equal(TG.level_wh(SHAPES, "cpu").numpy(), [[w, h] for h, w in SHAPES])
    query, value, ref = (torch.from_numpy(a) for a in _msda_inputs(np.random.default_rng(13), 30, 2))
    query.requires_grad_(True)
    out = tmodel.transformer.encoder.layers[0].self_attn(query, value, ref, SHAPES)
    out.square().sum().backward()
    assert out.shape == (2, 30, C) and query.grad is not None and torch.isfinite(query.grad).all()
    assert query.grad.abs().sum() > 0


# ---- the weight bridge ----------------------------------------------------


def test_gdino_bridge_fills_every_key(pair):
    """Every JAX leaf fills a model key; the three q/k/v leaves of an
    attention make one in_proj tensor; layouts come back in torch's."""
    _, _, tmodel, _, _, flat = pair
    sd = params_from_jax(flat, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    n_inproj = sum(k.endswith(("in_proj_weight", "in_proj_bias")) for k in sd)
    assert n_inproj == 2 * (1 + 2 * 2)  # (1 text layer + 2 decoder layers x 2 attentions) x (w, b)
    assert len(sd) == len(flat) - 2 * n_inproj
    np.testing.assert_array_equal(
        sd["transformer.encoder.layers.0.self_attn.value_proj.weight"].numpy(),
        flat["enc_layer_0/self_attn/value_proj/kernel"].T,
    )
    np.testing.assert_array_equal(sd["input_proj.3.0.weight"].numpy(), flat["input_proj_3_conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["bbox_embed.1.layers.2.bias"].numpy(), flat["bbox_embed_1/layers_2/bias"])


def test_gdino_inproj_round_trips(pair):
    """The assembled in_proj tensors give back each q/k/v leaf through the
    rule table's own slicing transforms."""
    from mqdet_tpu.io import torch_import as TI

    _, _, tmodel, _, _, flat = pair
    sd = params_from_jax(flat, tmodel)
    w = sd["transformer.decoder.layers.1.ca_text.in_proj_weight"].numpy()
    bias = sd["transformer.decoder.layers.1.ca_text.in_proj_bias"].numpy()
    for i, n in enumerate(("ca_text_q", "ca_text_k", "ca_text_v")):
        np.testing.assert_array_equal(TI._t_inproj_w(i)(w), flat[f"dec_layer_1/{n}/kernel"])
        np.testing.assert_array_equal(TI._t_inproj_b(i)(bias), flat[f"dec_layer_1/{n}/bias"])
    # the text enhancer's q/k/v are rows [0, C), [C, 2C), [2C, 3C) of in_proj_weight
    w = sd["transformer.encoder.text_layers.0.self_attn.in_proj_weight"].numpy()
    np.testing.assert_array_equal(w[C : 2 * C], flat["enc_text_0/k/kernel"].T)


def test_gdino_bridge_raises_on_missing_leaf_and_shape(pair):
    _, _, tmodel, _, _, flat = pair
    missing = dict(flat)
    del missing["dec_layer_0/sa_v/kernel"]  # one third of an in_proj
    with pytest.raises(KeyError):
        params_from_jax(missing, tmodel)
    missing = dict(flat)
    del missing["tgt_embed"]
    with pytest.raises(KeyError):
        params_from_jax(missing, tmodel)
    bad = dict(flat)
    bad["enc_text_0/q/bias"] = np.zeros(C + 1, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, tmodel)
    bad = dict(flat)
    bad["level_embed"] = np.zeros((3, C), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, tmodel)
    with pytest.raises(KeyError):
        params_from_jax({**flat, "enc_layer_0/not_a_param/kernel": np.zeros((2, 2), np.float32)}, tmodel)


def test_gdino_state_dict_keys_are_rule_table_keys():
    """At full width and depth (MQ-GroundingDINO-T): the port's state_dict
    is exactly the set of reference keys that the JAX model's leaves reach
    through the GroundingDINO rule table, with the same shapes (the JAX
    tree is traced abstractly, nothing is computed)."""
    from mqdet_tpu.io import torch_import as TI

    jcfg = jb.mq_groundingdino_t_config()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    tcfg = tb.mq_groundingdino_t_config()
    b = tb.synthetic_caption_batch(tcfg, 1, (256, 256), num_labels=2, k_shot=1)  # >= 900 cells
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in keys))
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path).replace("params/", "", 1): s.shape
        for path, s in jax.tree_util.tree_leaves_with_path(shapes)
    }
    rules = TI.build_gdino_rule_table()
    reached = {}
    for name, shape in flat.items():
        ref = rules[name][0]
        ref = ref[0] if isinstance(ref, tuple) else ref
        reached.setdefault(ref, []).append(shape)
    sd = tb.build_model(tcfg).state_dict()
    assert set(sd) == set(reached)
    for ref, t in sd.items():
        if ref.endswith("in_proj_weight"):
            assert [s[::-1] for s in reached[ref]] == [(t.shape[0] // 3, t.shape[1])] * 3, ref
        elif ref.endswith("in_proj_bias"):
            assert reached[ref] == [(t.shape[0] // 3,)] * 3, ref
        else:
            assert len(reached[ref]) == 1 and int(np.prod(reached[ref][0])) == t.numel(), ref
    assert "backbone.0.layers.2.blocks.5.attn.qkv.weight" in sd
    assert "transformer.decoder.layers.5.ca_text.in_proj_weight" in sd
    assert "bert.encoder.qv_layer.5.ff_gate" in sd


def test_init_params_follows_init_params_fast_rule():
    """Ones / zeros / normals on the same leaves as the JAX package's
    `init_params_fast` (its rule is on flax names, mapped by the
    GroundingDINO rule table): an `in_proj_bias` holds three flax biases and
    is zero, an `in_proj_weight` three kernels and is drawn."""
    from mqdet_torch.io.from_jax import rule_table

    def jax_rule(flax_name):
        if flax_name.endswith(("scale", "/gamma_v", "/gamma_l")):
            return "ones"
        return "zeros" if flax_name.endswith("bias") else "normal"

    model = tb.init_params(tb.build_model(tb.tiny_gdino_config()), seed=3)
    flax_of = {}
    for flax_name, (ref, _) in rule_table(model).items():
        flax_of.setdefault(ref[0] if isinstance(ref, tuple) else ref, flax_name)
    normals = []
    for key, t in model.state_dict().items():
        want = jax_rule(flax_of[key])
        if want == "normal":
            normals.append(t.reshape(-1))
        else:
            assert torch.all(t == (1.0 if want == "ones" else 0.0)), key
    assert {"transformer.tgt_embed.weight", "transformer.level_embed"} <= {
        k for k in model.state_dict() if jax_rule(flax_of[k]) == "normal"
    }
    normals = torch.cat(normals)
    assert abs(normals.std().item() - 0.02) < 1e-3 and abs(normals.mean().item()) < 1e-3
