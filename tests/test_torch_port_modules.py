"""mqdet_torch modules vs the JAX package at the tiny config, plus the
weight bridge and the import rule.

The JAX model is built in fp32 (`TPU.COMPUTE_DTYPE = float32`; conftest
forces highest matmul precision), its parameters are `init_params_fast`
values perturbed with seeded noise (so zero-initialised biases and unit norm
scales are exercised too), and the port gets the same values through
`params_from_jax`. Inputs are numpy arrays from a seed. Both sides compute
in fp32 on the CPU, so tolerances are fp32 rounding of a few chained layers:
atol 1e-4 on O(1) activations unless stated.

The deformable convs follow MQDET_DEFORM_IMPL on both sides. The tests
pinned to `gather` cover the exact route. At the tiny config the offsets
stay inside the clip radius (max |offset| 1.41 against 2), so the clipped
routes (unset, the default: JAX's window composite off the TPU, the port's
clipped plain version; and `window`) are covered by the `_clipped_route`
tests, whose offsets go far past the radius (DyConv's input features x20;
the head normalises its input, so there the offset convs are x20), at
TPU.DEFORM_RADIUS 2 and 3. TF32 is off on the torch side (it only
matters on a card; the CPU never uses it).
"""
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

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (64, 64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat_params(params) -> dict:
    return {
        "/".join(str(getattr(k, "key", k)) for k in path).replace("params/", "", 1): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(params)
    }


def perturb(params, seed=1, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32) * scale),
        params,
    )


def jax_init_args(cfg, batch=2, num_labels=3, k_shot=2, seed=0):
    b = jb.synthetic_batch(cfg, batch, HW, num_labels=num_labels, k_shot=k_shot, seed=seed)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    return b, tuple(jnp.asarray(b[k]) for k in keys)


def tiny_pair(mods=None, seed=0):
    """(jax model, jax params, torch model, jax cfg, torch cfg) holding the
    same weights; `mods(cfg)` edits both configs alike."""
    jcfg, tcfg = jb.tiny_test_config(), tb.tiny_test_config()
    if mods is not None:
        mods(jcfg)
        mods(tcfg)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    _, args = jax_init_args(jcfg)
    params = perturb(jb.init_params_fast(jmodel, *args, seed=seed))
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return jmodel, params, tmodel, jcfg, tcfg


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()[:3]


@pytest.fixture(scope="module")
def pair_r3():
    """The tiny pair built with TPU.DEFORM_RADIUS = 3 on both sides."""
    def mods(cfg):
        cfg.TPU.DEFORM_RADIUS = 3

    return tiny_pair(mods)[:3]


# the clipped routes: (MQDET_DEFORM_IMPL, TPU.DEFORM_RADIUS); None is unset, the default
CLIPPED_ROUTES = [(None, 2), ("window", 2), (None, 3)]


def set_deform_impl(monkeypatch, impl):
    if impl is None:
        monkeypatch.delenv("MQDET_DEFORM_IMPL", raising=False)
    else:
        monkeypatch.setenv("MQDET_DEFORM_IMPL", impl)


def scale_offset_convs(params, tmodel, k):
    """(JAX params, deep copy of the port model) with every DyConv offset
    conv's kernel and bias times k, so the offsets they predict scale by k."""
    import copy

    from mqdet_torch.models.vldyhead import DyConv

    scaled = jax.tree_util.tree_map_with_path(
        lambda p, v: v * k if any(getattr(e, "key", None) == "offset" for e in p) else v, params
    )
    tmodel = copy.deepcopy(tmodel)
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, DyConv):
                m.offset.weight.mul_(k)
                m.offset.bias.mul_(k)
    return scaled, tmodel


def max_offset_seen(tmodel, run):
    """run() under forward hooks on every DyConv offset conv; returns
    (run's result, the max |offset| they produced)."""
    from mqdet_torch.models.vldyhead import DyConv

    seen = []
    hooks = [m.offset.register_forward_hook(lambda mod, a, out: seen.append(out[:, :18].abs().max().item()))
             for m in tmodel.modules() if isinstance(m, DyConv)]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, max(seen)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).standard_normal((2,) + HW + (3,)).astype(np.float32)


def test_state_dict_keys_are_rule_table_reference_keys():
    from mqdet_torch.io.from_jax import reference_rules

    model = tb.build_model(tb.mq_glip_t_config())
    keys = set(model.state_dict())
    refs = set(reference_rules())
    assert keys <= refs, sorted(keys - refs)[:10]
    # spot checks at full depth: Swin-T, 6 head stages, 6 qv layers
    assert "backbone.body.layers.0.blocks.0.attn.qkv.weight" in keys
    assert "rpn.head.dyhead_tower.17.DyConv.2.conv.weight" in keys
    assert "language_backbone.body.model.encoder.qv_layer.5.ff_gate" in keys


def test_params_from_jax_covers_every_leaf(pair):
    _, params, tmodel = pair
    flat = flat_params(params)
    sd = params_from_jax(flat, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    assert len(sd) == len(flat)
    # layouts: flax (in, out) Dense and HWIO conv come back as torch (out, in) / OIHW
    k = "backbone/patch_embed_proj/kernel"
    np.testing.assert_array_equal(
        sd["backbone.body.patch_embed.proj.weight"].numpy(), flat[k].transpose(3, 2, 0, 1)
    )
    k = "rpn/fuse_0/b_attn/attn/v_proj/kernel"
    np.testing.assert_array_equal(
        sd["rpn.head.dyhead_tower.0.b_attn.attn.v_proj.weight"].numpy(), flat[k].T
    )
    assert sd["language_backbone.body.model.encoder.qv_layer.0.ff_gate"].shape == (1,)


def test_params_from_jax_raises_on_unknown_leaf_and_shape(pair):
    _, params, tmodel = pair
    flat = flat_params(params)
    with pytest.raises(KeyError):
        params_from_jax({**flat, "rpn/not_a_param/kernel": np.zeros((2, 2), np.float32)}, tmodel)
    bad = dict(flat)
    bad["rpn/bbox_pred/bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, tmodel)
    missing = dict(flat)
    del missing["rpn/bias0"]
    with pytest.raises(KeyError):
        params_from_jax(missing, tmodel)


def test_init_params_follows_init_params_fast_rule():
    """Ones / zeros / normals*0.02 on the same leaves as the JAX package's
    `init_params_fast` (its rule is on flax names, mapped by the rule table)."""
    from mqdet_torch.io.from_jax import reference_rules

    def jax_rule(flax_name):
        if flax_name.endswith(("scale", "/gamma_v", "/gamma_l", "var")):
            return "ones"
        if flax_name.endswith(("bias", "mean")):
            return "zeros"
        return "normal"

    model = tb.init_params(tb.build_model(tb.tiny_test_config()), seed=3)
    rules = reference_rules()
    normals = []
    for key, t in model.state_dict().items():
        want = jax_rule(rules[key][0])
        if want == "normal":
            normals.append(t.reshape(-1))
        else:
            assert torch.all(t == (1.0 if want == "ones" else 0.0)), key
    normals = torch.cat(normals)
    assert abs(normals.std().item() - 0.02) < 1e-3 and abs(normals.mean().item()) < 1e-3
    again = tb.init_params(tb.build_model(tb.tiny_test_config()), seed=3).state_dict()
    for key, t in model.state_dict().items():
        assert torch.equal(t, again[key]), key


def test_port_config_matches_jax_defaults():
    """The port's own config copy holds the JAX package's whole tree, keys
    and values both ways, with one stated exception: MQ-GroundingDINO-T's
    TPU.IMAGE_BUCKETS. The JAX builder sets (832, 1408), a TPU-only bucket
    chosen for its Pallas MSDA kernel's exact level ratios
    (`mqdet_tpu/utils/builders.py:41-48`; ROADMAP: no counterpart); the port
    runs GDINO at the yaml's (800, 1344)."""
    def leaves(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict) and v:
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    for tcfg, jcfg, skip in (
        (tb.tiny_test_config(), jb.tiny_test_config(), ()),
        (tb.mq_glip_t_config(), jb.mq_glip_t_config(), ()),
        (tb.tiny_gdino_config(), jb.tiny_gdino_config(), ()),
        (tb.mq_groundingdino_t_config(), jb.mq_groundingdino_t_config(), ("TPU.IMAGE_BUCKETS",)),
    ):
        tl, jl = dict(leaves(tcfg)), dict(leaves(jcfg))
        assert set(tl) == set(jl), (sorted(set(tl) - set(jl)), sorted(set(jl) - set(tl)))
        n = 0
        for key, val in tl.items():
            if key in skip:
                assert val == ((800, 1344),) and jl[key] == ((832, 1408),)
                continue
            assert jl[key] == val and type(jl[key]).__name__ == type(val).__name__, key
            n += 1
        assert n >= 259  # the JAX package's 260 leaves (an empty subtree counts as one)


def test_anchors_match_jax():
    from mqdet_tpu.ops.anchors import anchors_for_fpn as jax_anchors

    from mqdet_torch.ops.anchors import anchors_for_fpn

    for hw in ((800, 1344), (64, 96)):
        for a, b in zip(anchors_for_fpn(hw), jax_anchors(hw)):
            np.testing.assert_array_equal(a, b)


def test_synthetic_batch_matches_jax():
    a = jb.synthetic_batch(jb.tiny_test_config(), 2, HW, num_labels=3, k_shot=2, seed=4)
    b = tb.synthetic_batch(tb.tiny_test_config(), 2, HW, num_labels=3, k_shot=2, seed=4)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _fresh_import(code):
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_port_never_imports_jax():
    out = _fresh_import(
        "import importlib, pkgutil, sys\n"
        "import mqdet_torch\n"
        "for m in pkgutil.walk_packages(mqdet_torch.__path__, 'mqdet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib', 'mqdet_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('mqdet_torch')]))\n"
    )
    assert int(out.split()[0]) >= 96  # with the legacy detector family, the demo and the nine perf tools


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py, the main path it drives and the port's tools import
    neither JAX nor any module of mqdet_tpu (the weight bridge reads the
    port's own copy of the rule tables, `mqdet_torch/io/torch_import.py`),
    nor PyYAML or PIL, which the card's machine lacks: every shipped config
    merges through the port's own yaml reader."""
    _fresh_import(
        "import sys\n"
        "import chip_smoke\n"
        "from mqdet_torch.engine import evaluator, inference, predict\n"
        "from mqdet_torch.data import coco, grounding, tokenizer, transforms\n"
        "from mqdet_torch.mq import bank, extract, selector\n"
        "from mqdet_torch.ops import roi_align\n"
        "from mqdet_torch.ops import bi_attention, deform_conv, kernels, ms_deform_attn\n"
        "from mqdet_torch.io import from_jax\n"
        "from mqdet_torch.tools import perf_dcn_sweep, perf_fusion_ab\n"
        "from mqdet_torch.utils import calibrate, metric_logger\n"
        "from mqdet_torch.engine import losses, optim, train, trainer\n"
        "from mqdet_torch.data import loader, samplers\n"
        "from mqdet_torch.io import checkpoints\n"
        "from mqdet_torch.ops import focal_loss\n"
        "from mqdet_torch.tools import train as train_tool\n"
        "from mqdet_torch.tools import eval as eval_tool, extract_queries\n"
        "from mqdet_torch.core import yaml_lite\n"
        "from mqdet_torch.engine import eval_dispatch, flickr_eval\n"
        "from mqdet_torch.data import datasets_extra, tsv\n"
        "from mqdet_torch.utils import profiling\n"
        "from mqdet_torch.core.config import default_config\n"
        "import glob\n"
        "for path in glob.glob('configs/**/*.yaml', recursive=True):\n"
        "    default_config().merge_from_file(path)\n"
        "from mqdet_torch.utils import builders\n"
        "builders.init_params(builders.build_model(builders.tiny_test_config()))\n"
        "builders.init_params(builders.build_model(builders.tiny_gdino_config()))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib', 'mqdet_tpu', 'yaml', 'PIL')]\n"
        "assert not bad, bad\n"
    )


def test_swin_stages_match(pair, images):
    jmodel, params, tmodel = pair
    want = jax.jit(lambda p, x: jmodel.apply(p, x, method=lambda m, x: m.backbone(x)))(
        params, jnp.asarray(images)
    )
    with torch.no_grad():
        got = tmodel.backbone.body(nchw(images))
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_encode_image_fpn_matches(pair, images):
    jmodel, params, tmodel = pair
    want = jax.jit(lambda p, x: jmodel.apply(p, x, method=type(jmodel).encode_image))(
        params, jnp.asarray(images)
    )
    with torch.no_grad():
        got = tmodel.encode_image(nchw(images))
    assert [tuple(g.shape[2:]) for g in got] == [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_language_backbone_with_queries_matches(pair):
    jmodel, params, tmodel = pair
    cfg = jb.tiny_test_config()
    b, _ = jax_init_args(cfg, batch=2, seed=7)
    am = b["attention_mask"].copy()
    am[1, 11:] = 0  # a padded tail
    rng = np.random.default_rng(8)
    image_tokens = rng.standard_normal((2, 21, 16)).astype(np.float32)

    def jfn(m, ii, a, q, qm, it):
        return m.language_backbone(ii, a, queries=q, query_mask=qm, image_tokens=it)

    want = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=jfn))(
        params, jnp.asarray(b["input_ids"]), jnp.asarray(am), jnp.asarray(b["queries"]),
        jnp.asarray(b["query_mask"]), jnp.asarray(image_tokens),
    )
    with torch.no_grad():
        got = tmodel.language_backbone(
            torch.from_numpy(b["input_ids"]), torch.from_numpy(am), torch.from_numpy(b["queries"]),
            torch.from_numpy(b["query_mask"]), torch.from_numpy(image_tokens),
        )
    for k in ("hidden", "embedded", "aggregate", "augmented_vision"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k)


def _levels(rng, b=2, c=16):
    return [rng.standard_normal((b, h, w, c)).astype(np.float32) for h, w in ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))]


def test_vlfuse_matches(pair):
    from mqdet_tpu.models.fusion import VLFuse as JVLFuse

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
            [nchw(f) for f in feats], torch.from_numpy(lang), torch.from_numpy(mask)
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for w, g in zip(jv, tv):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_dyconv_matches(pair, monkeypatch):
    from mqdet_tpu.models.vldyhead import DyConv as JDyConv

    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    _, params, tmodel = pair
    feats = _levels(np.random.default_rng(10))
    jmod = JDyConv(channels=16, dtype=jnp.float32)
    want = jax.jit(jmod.apply)(
        {"params": params["params"]["rpn"]["dyconv_tower_0"]}, [jnp.asarray(f) for f in feats]
    )
    with torch.no_grad():
        got = tmodel.rpn.head.dyhead_tower[2]([nchw(f) for f in feats])
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_vldyhead_matches(pair, monkeypatch):
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(11)
    feats = _levels(rng)
    lang = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0

    def jfn(m, f, l, ms):
        return m.rpn(f, l, ms, embedding=l)

    want = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=jfn))(
        params, [jnp.asarray(f) for f in feats], jnp.asarray(lang), jnp.asarray(mask)
    )
    with torch.no_grad():
        got = tmodel.rpn.head([nchw(f) for f in feats], torch.from_numpy(lang), torch.from_numpy(mask))
    np.testing.assert_allclose(
        got["fused_lang_hidden"].numpy(), np.asarray(want["fused_lang_hidden"]), atol=1e-4, rtol=1e-4
    )
    for key in ("logits", "bbox_reg", "centerness"):
        for w, g in zip(want[key], got[key]):
            np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=key)
    for w, g in zip(want["dot_product_logits"], got["dot_product_logits"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("impl,radius", CLIPPED_ROUTES)
def test_dyconv_matches_on_the_clipped_route(request, impl, radius, monkeypatch):
    """Input features x20: offsets reach far past the radius, so the clip
    decides the result."""
    from mqdet_tpu.models.vldyhead import DyConv as JDyConv

    set_deform_impl(monkeypatch, impl)
    _, params, tmodel = request.getfixturevalue("pair" if radius == 2 else "pair_r3")
    feats = [f * 20.0 for f in _levels(np.random.default_rng(10))]
    jmod = JDyConv(channels=16, deform_radius=radius, dtype=jnp.float32)
    want = jax.jit(jmod.apply)(
        {"params": params["params"]["rpn"]["dyconv_tower_0"]}, [jnp.asarray(f) for f in feats]
    )
    dyconv = tmodel.rpn.head.dyhead_tower[2]
    assert all(m.radius == radius for m in dyconv.DyConv)
    with torch.no_grad():
        got, seen = max_offset_seen(dyconv, lambda: dyconv([nchw(f) for f in feats]))
    assert seen > 3 * radius
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl,radius", CLIPPED_ROUTES)
def test_vldyhead_matches_on_the_clipped_route(request, impl, radius, monkeypatch):
    """Every stage's offset conv x20: offsets reach far past the radius."""
    set_deform_impl(monkeypatch, impl)
    jmodel, params, tmodel = request.getfixturevalue("pair" if radius == 2 else "pair_r3")
    params, tmodel = scale_offset_convs(params, tmodel, 20.0)
    rng = np.random.default_rng(11)
    feats = _levels(rng)
    lang = rng.standard_normal((2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0

    def jfn(m, f, l, ms):
        return m.rpn(f, l, ms, embedding=l)

    want = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=jfn))(
        params, [jnp.asarray(f) for f in feats], jnp.asarray(lang), jnp.asarray(mask)
    )
    with torch.no_grad():
        got, seen = max_offset_seen(tmodel, lambda: tmodel.rpn.head(
            [nchw(f) for f in feats], torch.from_numpy(lang), torch.from_numpy(mask)))
    assert seen > 3 * radius
    np.testing.assert_allclose(
        got["fused_lang_hidden"].numpy(), np.asarray(want["fused_lang_hidden"]), atol=1e-4, rtol=1e-4
    )
    for key in ("logits", "bbox_reg", "centerness"):
        for w, g in zip(want[key], got[key]):
            np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=key)
    for w, g in zip(want["dot_product_logits"], got["dot_product_logits"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
