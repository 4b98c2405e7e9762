"""MQ-GLIP-L in the port against the JAX package, on the CPU in fp32 at
`tiny_l_config` (MQ-GLIP-L's shape at small widths: Swin window 12, so a
small image pads at every stage and the last stages are smaller than the
window; depths (2, 2, 3, 2); drop path 0.4; 8 head stages).

Compared: `mq_glip_l_config` and the tiny config against the JAX package's;
Swin's padding to the window at every stage of the 800x1344 bucket, its
shift-mask cache and drop-path rates; Swin's stages at 256x256 (the last
stage 8x8 under the 12x12 window, its cyclic shift kept); the forward (FPN
features, dot-product logits, box regressions) and the LVIS protocol's
detections; and a reference-layout `.pth` made from the JAX-initialised
weights through both imports (`test_torch_port_glip_l_cli.py` holds the
evaluation CLI on the MQ-GLIP-L yamls).

The weights are the JAX package's `init_params_fast` values perturbed with
seeded noise, given to the port through `params_from_jax`; inputs are numpy
arrays from a seed. The JAX side's functions are compiled with XLA's
backend optimisation off (`O0`: the same fp32 arithmetic, a quarter of the
compile time at 8 head stages). Tolerances: fp32 rounding through the whole
network, atol 1e-4 on features and box regressions, 1e-3 on logits of
magnitude ~10 (as `test_torch_port_slice.py`), detection boxes 1e-4 px and
scores 1e-5.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.core import config as jconfig
from mqdet_tpu.engine.predict import make_protocol_fn as jax_protocol
from mqdet_tpu.io import torch_import as JI
from mqdet_tpu.utils import builders as jb
from mqdet_torch.core import config as tconfig
from mqdet_torch.engine.predict import make_protocol_fn
from mqdet_torch.io import torch_import as TI
from mqdet_torch.io.from_jax import params_from_jax, reference_rules
from mqdet_torch.models.swin import SwinBlock, SwinTransformer
from mqdet_torch.utils import builders as tb
from test_torch_port_cli import same_tree
from test_torch_port_modules import flat_params, jax_init_args, nchw, perturb, to_nhwc

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 64)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
L_YAML = os.path.join(REPO, "configs", "pretrain", "mq-glip-l.yaml")


def jax_tiny_l():
    """The JAX package's tiny config with `tiny_l_config`'s edits."""
    cfg = jb.tiny_test_config()
    cfg.MODEL.SWINT.DEPTHS = (2, 2, 3, 2)
    cfg.MODEL.SWINT.WINDOW_SIZE = 12
    cfg.MODEL.SWINT.OUT_CHANNELS = (16, 32, 64, 128)
    cfg.MODEL.SWINT.DROP_PATH_RATE = 0.4
    cfg.MODEL.DYHEAD.NUM_CONVS = 8
    return cfg


def compiled(fn, *args):
    """fn jitted and compiled at O0 for these arguments."""
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)


@contextlib.contextmanager
def jit_at_o0():
    """`jax.jit` compiling at O0 inside the block (the JAX package's
    functions that jit at call time, where no jit nests in another: its
    init and its CLI's split functions)."""
    real = jax.jit

    def jit(fun=None, **kw):
        kw.setdefault("compiler_options", O0)
        return (lambda f: real(f, **kw)) if fun is None else real(fun, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", jit)
        yield


def l_pair(mods=None):
    """(jax model, jax params, torch model, jax cfg, torch cfg) at the tiny L
    config holding the same weights; `mods(cfg)` edits both configs alike."""
    jcfg, tcfg = jax_tiny_l(), tb.tiny_l_config()
    if mods is not None:
        mods(jcfg)
        mods(tcfg)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    _, args = jax_init_args(jcfg)
    with jit_at_o0():
        params = perturb(jb.init_params_fast(jmodel, *args, seed=0))
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return jmodel, params, tmodel, jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    def mods(cfg):
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
        cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 20

    return l_pair(mods)


def test_mq_glip_l_config_matches_jax():
    """`mq_glip_l_config` is the JAX package's; the tiny L config is the JAX
    tiny config with the same edits; the shipped mq-glip-l.yaml gives
    `mq_glip_l_config`'s Swin and head."""
    same_tree(tb.mq_glip_l_config(), jb.mq_glip_l_config())
    same_tree(tb.tiny_l_config(), jax_tiny_l())
    shipped = tconfig.default_config()
    shipped.merge_from_file(L_YAML)
    want = tb.mq_glip_l_config()
    same_tree(shipped.MODEL.SWINT, want.MODEL.SWINT)
    assert shipped.MODEL.DYHEAD.NUM_CONVS == want.MODEL.DYHEAD.NUM_CONVS == 8
    jshipped = jconfig.default_config()
    jshipped.merge_from_file(L_YAML)
    same_tree(shipped, jshipped)


def test_swin_l_drop_path_rates_and_shifts():
    """Swin-L's blocks (built on the meta device: no weights): drop-path
    rates np.linspace(0, 0.4, 24) in block order, the shift 0 / 6 in turn
    within each stage, window 12; the tiny L model's rates linspace(0, 0.4, 9)."""
    sw = tb.mq_glip_l_config().MODEL.SWINT
    with torch.device("meta"):
        swin = SwinTransformer(sw.EMBED_DIM, tuple(sw.DEPTHS), tuple(sw.NUM_HEADS), sw.WINDOW_SIZE, sw.MLP_RATIO,
                               sw.DROP_PATH_RATE)
    blocks = [b for layer in swin.layers for b in layer.blocks]
    assert len(blocks) == 24
    np.testing.assert_array_equal([b.drop_path for b in blocks], np.linspace(0, 0.4, 24))
    for layer in swin.layers:
        assert [b.shift_size for b in layer.blocks] == [0, 6] * (len(layer.blocks) // 2)
        assert all(b.window_size == 12 and b.attn.window_size == 12 for b in layer.blocks)
    tiny = tb.build_model(tb.tiny_l_config())
    rates = [m.drop_path for m in tiny.modules() if isinstance(m, SwinBlock)]
    np.testing.assert_array_equal(rates, np.linspace(0, 0.4, 9))


def _padded_maps(swin):
    """{(hp, wp)} of the shift masks each stage's shifted blocks cached."""
    return [sorted({k[:2] for b in layer.blocks for k in b._masks}) for layer in swin.layers]


def test_swin_pads_every_stage_of_the_800x1344_bucket():
    """At window 12 the 800x1344 bucket's stage maps 200x336, 100x168, 50x84
    and 25x42 pad to 204x336, 108x168, 60x84 and 36x48 (the JAX module's
    `-(-h // ws) * ws`), and each shifted block caches one mask per padded
    size, reused by the next call."""
    torch.manual_seed(0)
    swin = tb.build_model(tb.tiny_l_config()).backbone.body.eval()
    with torch.no_grad():
        outs = swin(torch.randn(1, 3, 800, 1344))
        assert [tuple(o.shape[2:]) for o in outs] == [(200, 336), (100, 168), (50, 84), (25, 42)]
        assert _padded_maps(swin) == [[(204, 336)], [(108, 168)], [(60, 84)], [(36, 48)]]
        masks = [b._masks[k] for layer in swin.layers for b in layer.blocks for k in b._masks]
        swin(torch.randn(1, 3, 800, 1344))
    again = [b._masks[k] for layer in swin.layers for b in layer.blocks for k in b._masks]
    assert len(again) == len(masks) and all(a is m for a, m in zip(again, masks))


def test_swin_stages_match_jax_where_the_map_is_smaller_than_the_window(pair):
    """Swin's four stages at 256x256 (maps 64, 32, 16, 8, padded to 72, 36,
    24, 12: the last stage's 8x8 map keeps its cyclic shift inside one
    12x12 window), atol 1e-4."""
    jmodel, params, tmodel = pair[:3]
    images = np.random.default_rng(4).standard_normal((2, 256, 256, 3)).astype(np.float32)
    want = compiled(lambda p, x: jmodel.apply(p, x, method=lambda m, x: m.backbone(x)), params,
                    jnp.asarray(images))(params, jnp.asarray(images))
    swin = tmodel.backbone.body
    with torch.no_grad():
        got = swin(nchw(images))
    assert _padded_maps(swin)[-1] == [(12, 12)] and tuple(got[-1].shape[2:]) == (8, 8)
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


TEXT = ("input_ids", "attention_mask", "queries", "query_mask")


def test_forward_matches_jax(pair):
    """FPN features and box regressions atol 1e-4, dot-product logits 1e-3,
    through the 8 head stages, on the default DCN route (clipped; at this
    config the offsets stay inside the radius)."""
    jmodel, params, tmodel, jcfg = pair[:4]
    b = jb.synthetic_batch(jcfg, 2, HW, num_labels=3, k_shot=2, seed=3)
    cls = type(jmodel)

    def fwd(p, x, *text):
        feats = jmodel.apply(p, x, method=cls.encode_image)
        head = jmodel.apply(p, feats, *text, method=cls.forward_head)
        return feats, head["dot_product_logits"], head["bbox_reg"]

    args = (params, jnp.asarray(b["images"]), *(jnp.asarray(b[k]) for k in TEXT))
    feats, logits, regs = compiled(fwd, *args)(*args)
    with torch.no_grad():
        tfeats = tmodel.encode_image(nchw(b["images"]))
        head = tmodel.forward_head(tfeats, *(torch.from_numpy(b[k]) for k in TEXT))
    assert len(tmodel.rpn.head.dyhead_tower) == 24
    for w, t in zip(feats, tfeats):
        np.testing.assert_allclose(to_nhwc(t), np.asarray(w), atol=1e-4, rtol=1e-4)
    for w, t in zip(logits, head["dot_product_logits"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
    for w, t in zip(regs, head["bbox_reg"]):
        np.testing.assert_allclose(to_nhwc(t), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_protocol_detections_match_jax(pair):
    """The LVIS protocol (one image, 2 groups of 2 chunks): validity and
    labels exactly, scores atol 1e-5, boxes 1e-4 px."""
    jmodel, params, tmodel, jcfg, tcfg = pair
    image = np.random.default_rng(21).standard_normal((1,) + HW + (3,)).astype(np.float32)
    text = {k: np.stack([np.stack([jb.synthetic_batch(jcfg, 1, HW, 3, 2, seed=10 * g + c)[k][0] for c in range(2)])
                         for g in range(2)]) for k in (*TEXT, "agg_map")}
    sizes = np.tile(np.array([[64, 64], [60, 52]], np.float32)[None], (2, 1, 1))
    order = (*TEXT, "agg_map")
    jargs = (params, jnp.asarray(image), *(jnp.asarray(text[k]) for k in order), jnp.asarray(sizes))
    want = jax_protocol(jmodel, HW, jcfg).lower(*jargs).compile(compiler_options=O0)(*jargs)
    got = make_protocol_fn(tmodel, HW, tcfg)(nchw(image), *(torch.from_numpy(text[k]) for k in order),
                                             torch.from_numpy(sizes))
    v = np.asarray(want.valid)
    assert v.sum() >= 10, "too few detections to compare"
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)


def save_reference_pth(path, model):
    """The model's state dict as a reference-layout `.pth` (`module.` keys)."""
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    return str(path)


def test_glip_l_pth_import_matches_jax(pair, tmp_path):
    """A reference-layout `.pth` of the JAX-initialised tiny L weights
    through both imports, each into a model initialised otherwise: the same
    report, 0 missing and 0 unused, with Swin's stage-2 blocks 0..2 and the
    head stages 0..7 matched; the port's weights after it equal JAX's
    imported parameters. The full MQ-GLIP-L layout (built on the meta
    device) has a rule for every key: stage-2 blocks 0..17, head stages 0..7."""
    jmodel, params, tmodel, jcfg, tcfg = pair
    path = save_reference_pth(tmp_path / "glip_l.pth", tmodel)
    _, args = jax_init_args(jcfg)
    with jit_at_o0():
        other = jb.init_params_fast(jmodel, *args, seed=1)
    jparams, jrep = JI.import_glip_checkpoint(other, JI.load_torch_state_dict(path))
    fresh = tb.init_params(tb.build_model(tcfg), seed=7)
    trep = TI.import_glip_checkpoint(fresh, TI.load_torch_state_dict(path))
    for k in ("matched", "missing", "unused"):
        assert sorted(trep[k]) == sorted(jrep[k]), k
    assert not trep["missing"] and not trep["unused"]
    matched = set(trep["matched"])
    assert {"backbone/layers_2_blocks_2/attn/qkv/kernel", "rpn/dyconv_tower_7/dyconv_2/kernel",
            "rpn/fuse_7/b_attn/gamma_v", "rpn/lang_layer_7/output_ln/scale"} <= matched
    want = params_from_jax(flat_params(jparams), fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    with torch.device("meta"):
        full = tb.build_model(tb.mq_glip_l_config())
    keys = set(full.state_dict())
    rules = reference_rules()
    assert {"backbone.body.layers.2.blocks.17.attn.qkv.weight", "rpn.head.dyhead_tower.23.offset.weight"} <= keys
    assert not sorted(keys - set(rules))
