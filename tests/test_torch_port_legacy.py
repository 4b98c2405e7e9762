"""The port's legacy detector family against the JAX package, on the CPU:
FrozenBatchNorm and SELayer, TF SAME padding, ResNet, EfficientNet, BiFPN,
EffNetFPN, the backbone registry, the FCOS / RetinaNet / ATSS heads, their
losses, post-processor and one SGD step, and the class-aware NMS they call.

Both sides run in fp32. The JAX parameters are drawn host side on the tree
that `eval_shape` gives (no init compile): kernels normal with std
sqrt(1 / fan_in), so a deep trunk keeps O(1) activations where
`init_params_fast`'s 0.02 would shrink them to nothing; norm scales and
FrozenBatchNorm vectors near their identity values, biases, BiFPN blends and
Scales perturbed. The port takes them through `params_from_jax`. Inputs come
from numpy seeds. Tolerances: atol 1e-4 on O(1) activations, relative to
the output's largest value where it is larger (rtol 1e-4 in assert_allclose
terms); ResNet-101's 33 bottlenecks take rtol 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.core.config import default_config as j_default_config
from mqdet_torch.core.config import default_config as t_default_config
from mqdet_torch.io.from_jax import params_from_jax, reference_rules
from test_torch_port_modules import flat_params

torch.set_num_threads(2)

HW = (64, 64)


def legacy_params(jmodel, *args, seed=0):
    """Parameters on the tree of jmodel.init, drawn host side (module docstring)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return jnp.asarray(n / np.sqrt(fan_in))
        if name.endswith("var"):
            return jnp.asarray(1.0 + 0.2 * np.abs(n))
        if name.endswith(("scale", "_w1", "_w2")):
            return jnp.asarray(1.0 + 0.1 * n)
        return jnp.asarray(0.1 * n)  # biases, means

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(tmodel, params):
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return tmodel.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def close(got, want, rtol=1e-4, err_msg=""):
    """|got - want| <= rtol * max(1, max |want|) elementwise (module docstring)."""
    got = got.detach().permute(0, 2, 3, 1).numpy() if got.ndim == 4 else got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


def images(b=1, hw=HW, seed=5):
    return np.random.default_rng(seed).standard_normal((b,) + hw + (3,)).astype(np.float32)


def configs(body, arch=None, ncls=6, **bifpn):
    out = []
    for cfg in (j_default_config(), t_default_config()):
        cfg.MODEL.BACKBONE.CONV_BODY = body
        cfg.MODEL.ATSS.NUM_CLASSES = ncls
        cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 10
        if arch:
            cfg.MODEL.RPN_ARCHITECTURE = arch
        for k, v in bifpn.items():
            setattr(cfg.MODEL.BIFPN, k, v)
        out.append(cfg)
    out[0].TPU.COMPUTE_DTYPE = "float32"  # the JAX registry computes in it (bf16 by default)
    return out


# ---- layers ------------------------------------------------------------------


def test_frozen_batchnorm_and_se_layer_match_jax():
    from mqdet_tpu.models import layers as JL

    from mqdet_torch.models import layers as TL

    x = images(2, (7, 9)) * 3.0
    x = np.concatenate([x] * 6, -1)  # 18 channels
    for jmod, tmod in ((JL.FrozenBatchNorm(18), TL.FrozenBatchNorm(18)), (JL.SELayer(18, 3), TL.SELayer(18, 3))):
        p = legacy_params(jmod, jnp.asarray(x), seed=2)
        tmod.load_state_dict(_load_flat(tmod, p))
        close(tmod(nchw(x)), jmod.apply(p, jnp.asarray(x)), err_msg=type(tmod).__name__)


@pytest.mark.parametrize("hw", [(13, 16), (12, 15), (9, 9), (10, 10)])
def test_tf_same_padding_matches_flax(hw):
    """Stride-2 convs (k 3 and 5, depthwise too) and the BiFPN's 3x3/2 max
    pool at odd and even sizes: flax's "SAME" pads the odd pixel after;
    a symmetric padding would move every output."""
    from flax import linen as nn

    from mqdet_tpu.models.efficientnet import _max_pool_s2_same as j_pool

    from mqdet_torch.models.efficientnet import SameConv2d, _max_pool_s2_same

    x = images(2, hw) * 2.0
    x = np.concatenate([x, x[..., ::-1] * 0.5], -1)  # 6 channels
    for k, groups in ((3, 1), (5, 1), (3, 6), (5, 6)):
        jconv = nn.Conv(6, (k, k), strides=(2, 2), padding="SAME", feature_group_count=groups, use_bias=False)
        p = legacy_params(jconv, jnp.asarray(x), seed=k)
        tconv = SameConv2d(6, 6, k, 2, groups=groups, bias=False)
        tconv.weight.data = torch.from_numpy(np.ascontiguousarray(np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1)))
        close(tconv(nchw(x)), jconv.apply(p, jnp.asarray(x)), err_msg=f"conv k{k} groups {groups} at {hw}")
        sym = torch.nn.functional.conv2d(nchw(x), tconv.weight, stride=2, padding=k // 2, groups=groups)
        if hw[0] % 2 == 0:  # an even size: symmetric padding differs
            assert not np.allclose(sym.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jconv.apply(p, jnp.asarray(x))),
                                   atol=1e-3)
    close(_max_pool_s2_same(nchw(x - 5.0)), j_pool(jnp.asarray(x - 5.0)), err_msg=f"max pool at {hw}")


# ---- trunks ------------------------------------------------------------------


def test_efficientnet_spec_matches_jax():
    from mqdet_tpu.models import efficientnet as JE

    from mqdet_torch.models import efficientnet as TE

    for v in JE._VERSION_FACTORS:
        assert TE.efficientnet_spec(v) == JE.efficientnet_spec(v), v
    for c in np.linspace(3.0, 700.0, 97):
        assert TE.round_channels(c) == JE.round_channels(c)
    with pytest.raises(ValueError):
        TE.efficientnet_spec("b9")


@pytest.mark.parametrize("depth,rtol", [(50, 1e-4), (101, 2e-4)])
def test_resnet_matches_jax(depth, rtol):
    """C2..C5 of ResNet-50 / -101 (stem max pool padded with -inf: the input
    is shifted negative, so zero padding would show)."""
    from mqdet_tpu.models import resnet as JR

    from mqdet_torch.models import resnet as TR

    x = images(1, (64, 64)) - 2.0
    jm, tm = (JR.resnet50(), TR.resnet50()) if depth == 50 else (JR.resnet101(), TR.resnet101())
    p = legacy_params(jm, jnp.asarray(x), seed=depth)
    tm.load_state_dict(_load_flat(tm, p))
    want = jax.jit(jm.apply)(p, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [(256, 16, 16), (512, 8, 8), (1024, 4, 4), (2048, 2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, rtol, err_msg=f"C{i + 2}")


@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_bottleneck_stride_placement_matches_jax(stride_in_1x1):
    from mqdet_tpu.models import resnet as JR

    from mqdet_torch.models import resnet as TR

    x = images(2, (9, 11))
    x = np.concatenate([x] * 4, -1)
    jm = JR.Bottleneck(out_channels=16, bottleneck_channels=8, stride=2, stride_in_1x1=stride_in_1x1)
    p = legacy_params(jm, jnp.asarray(x), seed=7)
    tm = TR.Bottleneck(12, 16, 8, 2, stride_in_1x1)
    tm.load_state_dict(_load_flat(tm, p))
    close(tm(nchw(x)), jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("attention", [True, False])
def test_bifpn_cells_match_jax(attention):
    """A first cell over three body maps (odd sizes: 9x13 -> 5x7 -> 3x4)
    and a repeat over its five outputs."""
    from mqdet_tpu.models import efficientnet as JE

    from mqdet_torch.models import efficientnet as TE

    rng = np.random.default_rng(11)
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32) for (h, w), c in
             (((9, 13), 12), ((5, 7), 20), ((3, 4), 24))]
    j1 = JE.BiFPN(out_channels=16, first_time=True, attention=attention)
    p1 = legacy_params(j1, [jnp.asarray(f) for f in feats], seed=1)
    t1 = TE.BiFPN(16, (12, 20, 24), True, attention)
    t1.load_state_dict(_load_flat(t1, p1))
    want1 = j1.apply(p1, [jnp.asarray(f) for f in feats])
    got1 = t1.eval()([nchw(f) for f in feats])
    for g, w in zip(got1, want1):
        close(g, w, err_msg="first cell")
    j2 = JE.BiFPN(out_channels=16, attention=attention)
    p2 = legacy_params(j2, list(want1), seed=2)
    t2 = TE.BiFPN(16, (), False, attention)
    t2.load_state_dict(_load_flat(t2, p2))
    for g, w in zip(t2.eval()(list(got1)), j2.apply(p2, list(want1))):
        close(g, w, err_msg="repeat")


def _load_flat(tmod, params):
    """A standalone module's state_dict from its flax leaves through the
    legacy rules (the module's own names)."""
    from mqdet_torch.io.from_jax import inverse_transform, legacy_rules

    rules = legacy_rules(tmod)
    flat = flat_params(params)
    assert set(flat) == set(rules), (sorted(set(flat) ^ set(rules)))[:10]
    shapes = {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    return {key: torch.from_numpy(inverse_transform(tf, flat[name], shapes[key]).copy())
            for name, (key, tf) in rules.items()}


def test_registry_surface_matches_reference():
    """The port's registry holds JAX's names; CVT raises JAX's dead-code
    error and an unknown name KeyError."""
    from mqdet_tpu.models import backbones as JB

    from mqdet_torch.models import backbones as TB

    assert set(TB.BACKBONES) == set(JB.BACKBONES)
    cfg = t_default_config()
    cfg.MODEL.BACKBONE.CONV_BODY = "CVT-FPN-RETINANET"
    with pytest.raises(NotImplementedError, match="dead code"):
        TB.build_backbone(cfg)
    cfg.MODEL.BACKBONE.CONV_BODY = "NOT-A-BODY"
    with pytest.raises(KeyError):
        TB.build_backbone(cfg)


# ---- whole detectors -----------------------------------------------------------

DETECTORS = [
    ("R-50-RETINANET", "FCOS", {}),
    ("R-50-RETINANET", "RETINA", {}),
    ("R-50-RETINANET", "ATSS", {}),
    ("EFFICIENT3-FPN-RETINANET", "RETINA", {}),
    ("EFFICIENT3-BIFPN-FCOS", "FCOS", {"NUM_REPEATS": 2}),
    ("EFFICIENT3-BIFPN-FCOS", "ATSS", {"NUM_REPEATS": 1, "USE_ATTENTION": False}),
    ("EFFICIENT-DET", "ATSS", {}),
    ("SWINT-FPN-RETINANET", "FCOS", {}),
]


def detector_pair(body, arch, bifpn=None, seed=0, hw=HW, batch=1, edit=None):
    from mqdet_tpu.models.legacy_heads import build_legacy_detector as jbuild

    from mqdet_torch.models.legacy_heads import build_legacy_detector as tbuild

    jcfg, tcfg = configs(body, arch, **(bifpn or {}))
    if edit:
        edit(jcfg)
        edit(tcfg)
    jm = jbuild(jcfg)
    params = legacy_params(jm, jnp.asarray(images(batch, hw)), seed=seed)
    return jm, params, load(tbuild(tcfg), params), jcfg, tcfg


@pytest.mark.parametrize("body,arch,bifpn", DETECTORS, ids=[f"{b}-{a}-{len(x)}" for b, a, x in DETECTORS])
def test_legacy_detector_forward_matches_jax(body, arch, bifpn):
    """Every head output at every level, the rule table covering every leaf."""
    jm, params, tm, _, _ = detector_pair(body, arch, bifpn)
    assert set(reference_rules(tm)) == set(tm.state_dict())
    x = images(2)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert set(got) == set(want)
    for k in want:
        assert len(got[k]) == len(want[k]) == 5
        for lvl, (g, w) in enumerate(zip(got[k], want[k])):
            close(g, w, err_msg=f"{k} level {lvl}")


@pytest.mark.parametrize("body", ["R-101-C4", "R-50-C5"])
def test_resnet_registry_bodies_match_jax(body):
    from mqdet_tpu.models.backbones import build_backbone as jbuild

    from mqdet_torch.models.backbones import build_backbone as tbuild

    jcfg, tcfg = configs(body)
    jm = jbuild(jcfg)
    x = images(1)
    params = legacy_params(jm, jnp.asarray(x), seed=3)
    tm = tbuild(tcfg)
    tm.load_state_dict(_load_flat(tm, params))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    for g, w in zip(got, jax.jit(jm.apply)(params, jnp.asarray(x))):
        close(g, w, 2e-4)


def test_effnetfpn_start_from_2_matches_jax():
    jm, params, tm, _, _ = detector_pair(
        "EFFICIENT-DET", "RETINA", edit=lambda c: setattr(c.MODEL.BACKBONE, "EFFICIENT_DET_START_FROM", 2))
    x = images(1)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert tuple(got["cls_logits"][0].shape[2:]) == (16, 16)  # stride 4
    for k in want:
        for g, w in zip(got[k], want[k]):
            close(g, w, err_msg=k)


def test_efficientdet_attention_off_past_compound_5():
    from mqdet_torch.models.efficientnet import EffNetFPN

    assert EffNetFPN(6).bifpn0.attention is False and EffNetFPN(5).bifpn0.attention is True
    assert not any("_w1" in k or "_w2" in k for k in EffNetFPN(6).state_dict())


# ---- losses, post-processor, the training step ---------------------------------


def test_fcos_locations_copy_is_pinned():
    from mqdet_tpu.engine import legacy_losses as JL

    from mqdet_torch.engine import legacy_losses as TL

    assert TL.FCOS_SIZE_RANGES == JL.FCOS_SIZE_RANGES and TL.INF == JL.INF and TL.NEG_INF == JL.NEG_INF
    for hw, strides in (((64, 64), (8, 16)), ((800, 1344), (8, 16, 32, 64, 128)), ((77, 101), (8, 16, 32))):
        for a, b in zip(TL.fcos_locations(hw, strides), JL.fcos_locations(hw, strides)):
            np.testing.assert_array_equal(a, b)


LEVELS = [(8, 8), (4, 4)]
STRIDES = (8, 16)


def head_out(rng, num_classes, with_ctr=True, na=1, exp_reg=False, b=2):
    out = {"cls_logits": [rng.standard_normal((b, h, w, num_classes * na)).astype(np.float32) - 2.0
                          for h, w in LEVELS],
           "bbox_reg": [rng.standard_normal((b, h, w, 4 * na)).astype(np.float32) for h, w in LEVELS]}
    if exp_reg:
        out["bbox_reg"] = [np.exp(x) * 8.0 for x in out["bbox_reg"]]
    if with_ctr:
        out["centerness"] = [rng.standard_normal((b, h, w, na)).astype(np.float32) for h, w in LEVELS]
    return out


def gt(b=2):
    boxes = np.zeros((b, 3, 4), np.float32)
    boxes[:, 0] = [2.0, 2.0, 30.0, 30.0]
    boxes[:, 1] = [20.0, 10.0, 60.0, 50.0]
    boxes[1, 2] = [5.0, 30.0, 25.0, 62.0]
    labels = np.array([[1, 4, 0], [2, 4, 5]], np.int32)[:b]
    valid = np.array([[True, True, False], [True, True, True]])[:b]
    return boxes, labels, valid


@pytest.mark.parametrize("kind", ["fcos", "retina", "atss"])
def test_legacy_losses_and_gradients_match_jax(kind):
    """Each loss and its gradient with respect to every head map, on random
    maps and padded ground truth (one padded row)."""
    from mqdet_tpu.engine import legacy_losses as JL
    from mqdet_tpu.ops.anchors import anchors_for_fpn as janchors

    from mqdet_torch.engine import legacy_losses as TL

    rng = np.random.default_rng(3)
    na = 3 if kind == "retina" else 1
    out = head_out(rng, 5, with_ctr=kind != "retina", na=na, exp_reg=kind == "fcos")
    gb, gl, gv = gt()
    if kind == "fcos":
        refs = JL.fcos_locations((64, 64), STRIDES)
        jfn = lambda o: JL.fcos_losses(o, refs, jnp.asarray(gb), jnp.asarray(gl), jnp.asarray(gv), 5)  # noqa: E731
        tfn = lambda o: TL.fcos_losses(o, refs, torch.from_numpy(gb), torch.from_numpy(gl), torch.from_numpy(gv), 5)  # noqa: E731
    else:
        refs = janchors((64, 64), STRIDES, sizes=(16, 32), aspect_ratios=(0.5, 1.0, 2.0)[:na] if na > 1 else (1.0,))
        if kind == "retina":
            jfn = lambda o: JL.retina_losses(o, refs, jnp.asarray(gb), jnp.asarray(gl), jnp.asarray(gv), 5, na)  # noqa: E731
            tfn = lambda o: TL.retina_losses(o, refs, torch.from_numpy(gb), torch.from_numpy(gl),  # noqa: E731
                                             torch.from_numpy(gv), 5, na)
        else:
            jfn = lambda o: JL.atss_legacy_losses(o, refs, jnp.asarray(gb), jnp.asarray(gl), jnp.asarray(gv), 5)  # noqa: E731
            tfn = lambda o: TL.atss_legacy_losses(o, refs, torch.from_numpy(gb), torch.from_numpy(gl),  # noqa: E731
                                                  torch.from_numpy(gv), 5)
    jout = jax.tree_util.tree_map(jnp.asarray, out)
    want = jfn(jout)
    wgrad = jax.grad(lambda o: sum(jfn(o).values()))(jout)
    tout = {k: [nchw(x).requires_grad_() for x in v] for k, v in out.items()}
    got = tfn(tout)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        assert float(want[k]) > 0 or k != "loss_cls"
    sum(got.values()).backward()
    for k in out:
        for lvl, (t, w) in enumerate(zip(tout[k], wgrad[k])):
            np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4, atol=1e-7,
                                       err_msg=f"d {k} level {lvl}")


def test_matchers_match_jax():
    """fcos_match and retina_match (batched in the port) against JAX's per
    image; retina's force-matched low-quality anchors included."""
    from mqdet_tpu.engine import legacy_losses as JL

    from mqdet_torch.engine import legacy_losses as TL

    locs = np.concatenate(JL.fcos_locations((64, 64), STRIDES))
    gb, gl, gv = gt()
    got = TL.fcos_match(torch.from_numpy(locs), (64, 16), torch.from_numpy(gb), torch.from_numpy(gl),
                        torch.from_numpy(gv))
    rng = np.random.default_rng(0)
    anchors = rng.uniform(0, 60, (96, 2))
    anchors = np.concatenate([anchors, anchors + rng.uniform(4, 30, (96, 2))], 1).astype(np.float32)
    rgot = TL.retina_match(torch.from_numpy(anchors), torch.from_numpy(gb), torch.from_numpy(gl),
                           torch.from_numpy(gv))
    for i in range(2):
        want = JL.fcos_match(jnp.asarray(locs), (64, 16), *(jnp.asarray(a[i]) for a in (gb, gl, gv)))
        np.testing.assert_array_equal(got.cls_labels[i].numpy(), np.asarray(want.cls_labels))
        np.testing.assert_allclose(got.reg_targets[i].numpy(), np.asarray(want.reg_targets), atol=1e-5)
        np.testing.assert_allclose(got.centerness[i].numpy(), np.asarray(want.centerness), atol=1e-6)
        rwant = JL.retina_match(jnp.asarray(anchors), *(jnp.asarray(a[i]) for a in (gb, gl, gv)))
        for g, w in zip(rgot, rwant):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=1e-6)
    assert (rgot[0] == -1).any() and (rgot[0] > 0).any()


@pytest.mark.parametrize("kind", ["fcos", "retina", "atss"])
def test_legacy_postprocess_matches_jax(kind):
    """Detections of both batch items equal JAX's: indices through the
    top-k (ties to the lower index) and the matrix NMS, scores and boxes to
    fp32 rounding."""
    from mqdet_tpu.engine import legacy_losses as JL
    from mqdet_tpu.models.postprocess import PostprocessParams as JP
    from mqdet_tpu.ops.anchors import anchors_for_fpn as janchors

    from mqdet_torch.engine import legacy_losses as TL
    from mqdet_torch.models.postprocess import PostprocessParams as TP

    rng = np.random.default_rng(8)
    out = head_out(rng, 5, with_ctr=kind != "retina", exp_reg=kind == "fcos")
    out["cls_logits"] = [x + 1.5 for x in out["cls_logits"]]
    refs = JL.fcos_locations((64, 64), STRIDES) if kind == "fcos" else janchors((64, 64), STRIDES, sizes=(16, 32))
    args = (0.05, 40, 0.5, 12)
    for item in (0, 1):
        want = JL.legacy_postprocess_single(jax.tree_util.tree_map(jnp.asarray, out), refs, kind, 60, 64,
                                            JP(*args), 5, item)
        got = TL.legacy_postprocess_single({k: [nchw(x) for x in v] for k, v in out.items()}, refs, kind, 60, 64,
                                           TP(*args), 5, item)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert got.valid.sum() > 2
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
        np.testing.assert_allclose(got.boxes.numpy()[got.valid.numpy()], np.asarray(want.boxes)[np.asarray(want.valid)],
                                   atol=1e-4)


@pytest.mark.parametrize("row_block", [512, 7])
def test_class_aware_nms_matrix_matches_jax_and_the_greedy_loop(row_block):
    """Random boxes in clusters with tied scores and 3 labels: the keep
    indices of the port's `class_aware_nms` (which the legacy post-processor
    calls) equal those of JAX's `class_aware_nms_matrix` at the same row
    block; a small row block exercises JAX's cross-block suppression."""
    from mqdet_tpu.ops.nms import class_aware_nms_matrix as jnms

    from mqdet_torch.ops.nms import class_aware_nms

    rng = np.random.default_rng(4)
    n = 60
    centers = rng.uniform(10, 80, (6, 2))[rng.integers(0, 6, n)] + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(8, 20, (n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)  # ties
    labels = rng.integers(1, 4, n).astype(np.int32)
    valid = rng.uniform(0, 1, n) > 0.1
    wi, wv = jnms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid), 0.4, 30,
                  row_block=row_block)
    args = tuple(torch.from_numpy(a)[None] for a in (boxes, scores, labels, valid))
    gi, gv = class_aware_nms(*args, 0.4, 30, row_block=row_block)
    np.testing.assert_array_equal(gv[0].numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi[0].numpy()[gv[0].numpy()], np.asarray(wi)[np.asarray(wv)])
    assert 3 < int(gv.sum()) < int(valid.sum())


def sgd_step_pair(arch, lr=0.05):
    import optax

    from mqdet_tpu.engine.legacy_losses import build_legacy_machinery as jmach
    from mqdet_tpu.engine.legacy_losses import make_legacy_train_step as jstep

    from mqdet_torch.engine.legacy_losses import build_legacy_machinery, make_legacy_train_step

    jm, params, tm, jcfg, tcfg = detector_pair("R-50-RETINANET", arch, batch=2)
    x = images(2)
    gb, gl, gv = (a.copy() for a in gt())
    tx = optax.sgd(lr)
    jp, _, jloss, jlosses = jstep(jm, jmach(jcfg, HW)[0], tx)(params, tx.init(params), jnp.asarray(x),
                                                               *map(jnp.asarray, (gb, gl, gv)))
    opt = torch.optim.SGD(tm.parameters(), lr=lr)
    step = make_legacy_train_step(tm.train(), build_legacy_machinery(tcfg, HW)[0], opt)
    loss, losses = step(nchw(x), *map(torch.from_numpy, (gb, gl, gv)))
    return params, jp, jloss, jlosses, tm, loss, losses


@pytest.mark.parametrize("arch", ["FCOS", "RETINA", "ATSS"])
def test_legacy_sgd_step_matches_jax(arch):
    """One step of plain SGD (optax.sgd against torch.optim.SGD, lr 0.05) on
    R-50-RETINANET at batch 2: the losses, and every parameter's update
    (after - before, FrozenBatchNorm's statistics included: JAX's step moves
    them, so the port's does), against JAX's. Both start from the same
    parameters. Updates within 1e-3 of the largest of the tensor's JAX
    update, plus the fp32 rounding of the parameter's largest entry (2
    ulps); losses rtol 1e-4."""
    params, jp, jloss, jlosses, tm, loss, losses = sgd_step_pair(arch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    before, after = flat_params(params), flat_params(jp)
    rules = reference_rules(tm)
    sd = tm.state_dict()
    moved, moved_stats = 0, 0
    for key, (name, tf) in rules.items():
        b = np.asarray(before[name], np.float64)
        want = np.asarray(after[name], np.float64) - b
        got = np.asarray(tf(sd[key].numpy()), np.float64) - b
        ulp = 2 * np.finfo(np.float32).eps * float(np.abs(b).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * float(np.abs(want).max()) + ulp, err_msg=key)
        if np.abs(want).max() > 0:
            moved += 1
            moved_stats += name.endswith(("/mean", "/var"))
    assert moved > len(rules) // 2
    assert moved_stats > 0  # the JAX step moves the "frozen" statistics
    assert np.isfinite(loss.item())
