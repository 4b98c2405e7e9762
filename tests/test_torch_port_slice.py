"""The port's LVIS-protocol slice vs the JAX package, end to end at the tiny
config: one 64x64 image, G = 2 groups of CP = 2 prompt chunks, both sides in
fp32 with the same weights (through `params_from_jax`) and the same numpy
inputs. Compared: the FPN features, the dot-product logits of a head
forward, and the protocol's boxes, scores, labels and validity.

INFERENCE_TH is lowered so the detections are not empty. The tests pinned to
MQDET_DEFORM_IMPL=gather cover the exact DCN route on both sides; at the tiny
config the offsets stay inside the clip radius, so
`test_slice_matches_jax_on_the_clipped_route` covers the clipped routes
(unset, the default, and `window`, at TPU.DEFORM_RADIUS 2 and 3) with every
DyConv offset conv x20, which puts the offsets far past the radius.
Tolerances: fp32 rounding through the whole network, atol 1e-4 on features
and boxes in pixels, 1e-3 on logits of magnitude ~10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.engine.predict import make_protocol_fn as jax_protocol
from mqdet_tpu.utils import builders as jb
from mqdet_torch.engine.predict import make_protocol_fn
from test_torch_port_modules import (
    CLIPPED_ROUTES, max_offset_seen, nchw, scale_offset_convs, set_deform_impl, tiny_pair, to_nhwc,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

G, CP, LABELS, SHOTS = 2, 2, 3, 2
HW = (64, 64)


def build_setup(radius=None):
    """The tiny pair and the protocol's inputs; `radius` sets TPU.DEFORM_RADIUS
    on both sides (None keeps the default, 2)."""
    def mods(cfg):
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
        cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 20
        if radius is not None:
            cfg.TPU.DEFORM_RADIUS = radius

    jmodel, params, tmodel, cfg, tcfg = tiny_pair(mods)
    image = np.random.default_rng(21).standard_normal((1,) + HW + (3,)).astype(np.float32)

    def group_stack(key):
        return np.stack([
            np.stack([
                jb.synthetic_batch(cfg, 1, HW, LABELS, SHOTS, seed=10 * g + c)[key][0]
                for c in range(CP)
            ])
            for g in range(G)
        ])

    text = {k: group_stack(k) for k in ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")}
    text["attention_mask"][1, 0, 12:] = 0  # one chunk with a padded tail
    sizes = np.tile(np.array([[64, 64], [60, 52]], np.float32)[None], (G, 1, 1))
    return cfg, tcfg, jmodel, params, tmodel, image, text, sizes


@pytest.fixture(scope="module")
def setup():
    return build_setup()


@pytest.fixture(scope="module")
def setup_r3():
    return build_setup(radius=3)


def test_protocol_matches_jax(setup, monkeypatch):
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    cfg, tcfg, jmodel, params, tmodel, image, text, sizes = setup
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    want = jax_protocol(jmodel, HW, cfg)(
        params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in order), jnp.asarray(sizes)
    )
    got = make_protocol_fn(tmodel, HW, tcfg)(
        nchw(image), *(torch.from_numpy(text[k]) for k in order), torch.from_numpy(sizes)
    )
    assert got.boxes.shape == (G, CP, 20, 4) and got.valid.shape == (G, CP, 20)
    v = np.asarray(want.valid)
    assert v.sum() >= G * CP * 5, "too few detections to compare"
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)


def test_features_and_head_logits_match(setup, monkeypatch):
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    _, _, jmodel, params, tmodel, image, text, _ = setup
    cls = type(jmodel)
    feats = jax.jit(lambda p, x: jmodel.apply(p, x, method=cls.encode_image))(params, jnp.asarray(image))
    g = 1
    head = jax.jit(lambda p, f, *a: jmodel.apply(p, f, *a, method=cls.forward_head))(
        params, feats, *(jnp.asarray(text[k][g]) for k in ("input_ids", "attention_mask", "queries", "query_mask"))
    )
    with torch.no_grad():
        tfeats = tmodel.encode_image(nchw(image))
        thead = tmodel.forward_head(
            tfeats, *(torch.from_numpy(text[k][g]) for k in ("input_ids", "attention_mask", "queries", "query_mask"))
        )
    for w, t in zip(feats, tfeats):
        np.testing.assert_allclose(to_nhwc(t), np.asarray(w), atol=1e-4, rtol=1e-4)
    for w, t in zip(head["dot_product_logits"], thead["dot_product_logits"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
    for w, t in zip(head["bbox_reg"], thead["bbox_reg"]):
        np.testing.assert_allclose(to_nhwc(t), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl,radius", CLIPPED_ROUTES)
def test_slice_matches_jax_on_the_clipped_route(request, impl, radius, monkeypatch):
    """The protocol's detections and one head forward's logits, with every
    DyConv offset conv x20 on both sides: offsets far past the radius."""
    set_deform_impl(monkeypatch, impl)
    cfg, tcfg, jmodel, params, tmodel, image, text, sizes = request.getfixturevalue(
        "setup" if radius == 2 else "setup_r3")
    params, tmodel = scale_offset_convs(params, tmodel, 20.0)
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    want = jax_protocol(jmodel, HW, cfg)(
        params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in order), jnp.asarray(sizes)
    )
    got, seen = max_offset_seen(tmodel, lambda: make_protocol_fn(tmodel, HW, tcfg)(
        nchw(image), *(torch.from_numpy(text[k]) for k in order), torch.from_numpy(sizes)))
    assert seen > 3 * radius
    v = np.asarray(want.valid)
    assert v.sum() >= G * CP * 5, "too few detections to compare"
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)

    cls = type(jmodel)
    args = [text[k][1] for k in order[:4]]
    feats = jax.jit(lambda p, x: jmodel.apply(p, x, method=cls.encode_image))(params, jnp.asarray(image))
    head = jax.jit(lambda p, f, *a: jmodel.apply(p, f, *a, method=cls.forward_head))(
        params, feats, *map(jnp.asarray, args))
    with torch.no_grad():
        thead = tmodel.forward_head(tmodel.encode_image(nchw(image)), *map(torch.from_numpy, args))
    for w, t in zip(head["dot_product_logits"], thead["dot_product_logits"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
