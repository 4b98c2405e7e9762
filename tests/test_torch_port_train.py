"""MQ-GLIP modulated pre-training in the port against the JAX package, on the
CPU in fp32 at `tiny_test_config`.

Inputs are made from numpy seeds and fed to both packages; each test states
its tolerance. Where the JAX side draws random numbers (text dropout, the
MLM mask), its draws are taken from its key and injected into the port. The
JAX train step runs `deterministic=False` (dropout); the parity tests
compare against the same loss with `deterministic=True`, which on the CPU is
the fusion's composite without dropout, and run the port's training forward
with its dropout rates at 0 (`no_dropout`).
"""
from __future__ import annotations

import copy
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mqdet_tpu.core.config import trainable_patterns as jax_trainable_patterns
from mqdet_tpu.engine import losses as jl
from mqdet_tpu.engine import optim as jo
from mqdet_tpu.engine import train as jtrain
from mqdet_tpu.ops import focal_loss as jfocal
from mqdet_tpu.ops.anchors import anchors_for_fpn as jax_anchors
from mqdet_torch.core.config import trainable_patterns
from mqdet_torch.engine import losses as tl
from mqdet_torch.engine import optim as to
from mqdet_torch.engine import train as tt
from mqdet_torch.io.from_jax import reference_rules
from mqdet_torch.ops import deform_conv as tdc
from mqdet_torch.ops import focal_loss as tfocal
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import HW, jax_init_args, tiny_pair
from test_torch_port_querybank import write_coco

torch.set_num_threads(2)


def to_flax(name: str, t: torch.Tensor) -> np.ndarray:
    """A port tensor in its flax counterpart's layout (the bridge's rule)."""
    return np.asarray(reference_rules()[name][1](t.detach().float().numpy()))


def jax_leaf(tree: dict, name: str):
    path = to.flax_path(name)
    return np.asarray(tree[path] if path in tree else tree["params/" + path])


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def no_dropout(model):
    """The port model with its training dropout rates at 0 (the fusion's
    attention dropout, Swin's stochastic depth)."""
    from mqdet_torch.models.fusion import BiMultiHeadAttention
    from mqdet_torch.models.swin import SwinBlock

    for m in model.modules():
        if isinstance(m, BiMultiHeadAttention):
            m.dropout = 0.0
        if isinstance(m, SwinBlock):
            m.drop_path = 0.0
    return model


# ---------------------------------------------------------------- losses


def test_focal_losses_match_jax():
    """Elementwise focal losses: rtol 1e-6."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 50, 12)) * 4).astype(np.float32)
    targets = (rng.uniform(0, 1, (2, 50, 12)) > 0.7).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 12)) > 0.2).astype(np.int32)
    for alpha in (0.25, -1.0):
        want = jfocal.token_sigmoid_binary_focal_loss(*map(jnp.asarray, (logits, targets, mask)), alpha=alpha)
        got = tfocal.token_sigmoid_binary_focal_loss(*map(torch.from_numpy, (logits, targets, mask)), alpha=alpha)
        assert rel_err(want, got) < 1e-6
    cls = rng.integers(0, 13, (50,)).astype(np.int32)
    want = jfocal.sigmoid_focal_loss(jnp.asarray(logits[0]), jnp.asarray(cls))
    got = tfocal.sigmoid_focal_loss(torch.from_numpy(logits[0]), torch.from_numpy(cls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _anchors():
    al = jax_anchors(HW)
    return np.concatenate(al), tuple(a.shape[0] for a in al)


def _gt(seed, b=2, g=5, t=16, n_valid=(3, 4), hw=HW):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    tok = np.zeros((b, g, t), np.float32)
    for i in range(b):
        for j in range(n_valid[i % len(n_valid)]):
            x0, y0 = rng.uniform(0, hw[1] * 0.6), rng.uniform(0, hw[0] * 0.6)
            bw, bh = rng.uniform(6, hw[1] - x0), rng.uniform(6, hw[0] - y0)
            boxes[i, j] = [x0, y0, x0 + bw, y0 + bh]
            labels[i, j], valid[i, j] = j + 1, True
            tok[i, j, 2 * j + 1: 2 * j + 3] = 0.5
    return boxes, labels, valid, tok


def _atss_both(anchors, level_sizes, gt, topk):
    want = jax.vmap(lambda bb, ll, vv, tm: jl.atss_match(jnp.asarray(anchors), level_sizes, bb, ll, vv, tm,
                                                         topk=topk))(*map(jnp.asarray, gt))
    got = tl.atss_match(torch.from_numpy(anchors), level_sizes, *map(torch.from_numpy, gt), topk=topk)
    return want, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_atss_match_matches_jax(seed):
    """Labels and matched boxes exactly; targets within atol 1e-5."""
    anchors, level_sizes = _anchors()
    want, got = _atss_both(anchors, level_sizes, _gt(seed), 9)
    np.testing.assert_array_equal(got.cls_labels.numpy(), np.asarray(want.cls_labels))
    np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets), atol=1e-5)
    np.testing.assert_array_equal(got.token_labels.numpy(), np.asarray(want.token_labels))
    assert (got.cls_labels > 0).sum() > 0


def test_atss_topk_ties_take_the_lower_index_first():
    """Ground truth centred between anchor centres, so that whole rings of
    anchors are equidistant and the top-k cut falls inside a ring: the port
    picks the lower indices first, as `jax.lax.top_k` does. Exact."""
    anchors, level_sizes = _anchors()
    # level-0 anchors sit on centres 8 px apart: a box centred on a cell corner has 4 equidistant nearest
    boxes = np.array([[[12.0, 12.0, 27.0, 27.0], [4.0, 20.0, 27.0, 43.0]]], np.float32)
    gt = (boxes, np.array([[1, 2]], np.int32), np.ones((1, 2), bool), np.eye(2, 16, 1, dtype=np.float32)[None])
    a_c = (anchors[:, :2] + anchors[:, 2:]) / 2
    d = np.linalg.norm(a_c[: level_sizes[0], None] - ((boxes[0, :, :2] + boxes[0, :, 2:]) / 2)[None], axis=-1)
    assert (np.sort(d[:, 0])[1] == np.sort(d[:, 0])[2])  # the tie exists
    for topk in (1, 2, 3, 5):
        want, got = _atss_both(anchors, level_sizes, gt, topk)
        np.testing.assert_array_equal(got.cls_labels.numpy(), np.asarray(want.cls_labels))
        np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))


def test_centerness_targets_match_jax():
    """rtol 1e-5 against JAX on the matched targets."""
    anchors, level_sizes = _anchors()
    want, got = _atss_both(anchors, level_sizes, _gt(4), 9)
    w = jax.vmap(lambda rt: jl.centerness_targets(rt, jnp.asarray(anchors)))(want.reg_targets)
    g = tl.centerness_targets(got.reg_targets, torch.from_numpy(anchors))
    pos = np.asarray(want.cls_labels) > 0
    np.testing.assert_allclose(g.numpy()[pos], np.asarray(w)[pos], rtol=1e-5, atol=1e-6)


def _head_out(seed, level_sizes, b=2, t=16):
    """Random head outputs: the JAX layout (NHWC per level) and the port's (NCHW)."""
    rng = np.random.default_rng(seed)
    sizes = [(-(-HW[0] // s), -(-HW[1] // s)) for s in (8, 16, 32, 64, 128)]
    bbox = [(rng.standard_normal((b, h, w, 4)) * 0.5).astype(np.float32) for h, w in sizes]
    ctr = [rng.standard_normal((b, h, w, 1)).astype(np.float32) for h, w in sizes]
    dot = [(rng.standard_normal((b, h * w, t)) * 3).astype(np.float32) for h, w in sizes]
    jax_out = {"bbox_reg": [jnp.asarray(x) for x in bbox], "centerness": [jnp.asarray(x) for x in ctr],
               "dot_product_logits": [jnp.asarray(x) for x in dot]}
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))  # noqa: E731
    port_out = {"bbox_reg": [nchw(x) for x in bbox], "centerness": [nchw(x) for x in ctr],
                "dot_product_logits": [torch.from_numpy(x) for x in dot]}
    return jax_out, port_out


@pytest.mark.parametrize("seed", [0, 1])
def test_glip_losses_match_jax(seed):
    """Every loss term within rtol 1e-5 on the same head outputs, and their
    gradients w.r.t. the head outputs within 1e-5 of max |grad|."""
    anchors, level_sizes = _anchors()
    jo_, po = _head_out(seed, level_sizes)
    gt = _gt(seed + 7)
    mask = np.ones((2, 16), np.int32)
    mask[1, 12:] = 0
    want = jl.glip_losses(jo_, jnp.asarray(anchors), level_sizes, *map(jnp.asarray, gt), jnp.asarray(mask))
    for x in po["bbox_reg"] + po["dot_product_logits"]:
        x.requires_grad_(True)
    got = tl.glip_losses(po, torch.from_numpy(anchors), level_sizes, *map(torch.from_numpy, gt),
                         torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert rel_err(want[k], got[k].detach()) < 1e-5, k
    jg = jax.grad(lambda bb, dd: sum(jl.glip_losses(
        {**jo_, "bbox_reg": bb, "dot_product_logits": dd}, jnp.asarray(anchors), level_sizes,
        *map(jnp.asarray, gt), jnp.asarray(mask)).values()), argnums=(0, 1))(jo_["bbox_reg"], jo_["dot_product_logits"])
    sum(got.values()).backward()
    for w, g in zip(jg[0], po["bbox_reg"]):
        assert rel_err(w, g.grad.permute(0, 2, 3, 1)) < 1e-5
    for w, g in zip(jg[1], po["dot_product_logits"]):
        assert rel_err(w, g.grad) < 1e-5


def test_mlm_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 8, 50)).astype(np.float32)
    labels = rng.integers(-1, 50, (2, 8))
    labels[labels < 0] = -100
    want = jl.mlm_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert rel_err(want, tl.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels))) < 1e-6


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.mark.parametrize("regularize", [False, True])
def test_gate_set_and_loss_match_jax(pair, regularize):
    """The gates the port collects are JAX's (`ndim == 0` ff_gate /
    attn_gate leaves) through the bridge; the loss within 1e-6 and, under
    GATE_REGULARIZATION, its gradient too."""
    _, params, tmodel, jcfg, _ = pair
    state, _, _ = jtrain.init_train_state(params, jcfg, [""])
    want_names = []
    jax.tree_util.tree_map_with_path(
        lambda p, v: want_names.append("/".join(str(getattr(k, "key", k)) for k in p))
        if "/".join(str(getattr(k, "key", k)) for k in p).endswith(("ff_gate", "attn_gate")) and v.ndim == 0
        else None, params)
    gates = tl.gate_parameters(tmodel.named_parameters())
    assert sorted("params/" + to.flax_path(n) for n in gates) == sorted(want_names) and len(gates) >= 1
    model = copy.deepcopy(tmodel)
    tr = state.trainable
    want, jgrad = jax.value_and_grad(lambda t: jl.gate_loss_from_params(t, scale=0.7, regularize=regularize))(tr)
    got = tl.gate_loss_from_params(model.named_parameters(), scale=0.7, regularize=regularize)
    assert rel_err(want, got.detach()) < 1e-6
    assert got.requires_grad == regularize
    if regularize:
        got.backward()
        for n in gates:
            np.testing.assert_allclose(dict(model.named_parameters())[n].grad.numpy().reshape(()),
                                       np.asarray(jgrad["params/" + to.flax_path(n)]), rtol=1e-6)


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize("recipe", ["vision_query", "full", "full_frozen_image", "language_prompt_v3"])
def test_trainable_set_and_groups_match_jax(pair, recipe):
    """The trainable set of each recipe and every parameter's LR and WD group
    equal `partition_params` / `lr_group_for` / `wd_group_for` on the flax
    counterpart's path. Exact."""
    _, params, tmodel, jcfg, tcfg = pair
    model = copy.deepcopy(tmodel)
    jtr, jfz, _ = jo.partition_params(params, jax_trainable_patterns(_recipe(jcfg, recipe)))
    names, frozen = to.partition_params(model, trainable_patterns(_recipe(tcfg, recipe)))
    assert sorted("params/" + to.flax_path(n) for n in names) == sorted(jtr)
    assert sorted("params/" + to.flax_path(n) for n in frozen) == sorted(jfz)
    assert all(p.requires_grad == (n in names) for n, p in model.named_parameters())
    tx = to.AdamW(tcfg, names)
    for n in names:
        path = "params/" + to.flax_path(n)
        assert tx.lr[n] == jo.lr_group_for(path, jcfg) and tx.wd[n] == jo.wd_group_for(path, jcfg), n
    if recipe == "vision_query":
        assert names and all(any(p in to.flax_path(n) for p in ("qv_layer", "pre_select")) for n in names)


def _recipe(cfg, recipe):
    cfg = cfg.clone()
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = recipe
    return cfg


def _solver(cfg, **kw):
    cfg = cfg.clone()
    s = cfg.SOLVER
    s.MAX_ITER, s.STEPS, s.WARMUP_ITERS, s.WARMUP_FACTOR, s.GAMMA = 100, (0.3, 0.8), 10, 1e-3, 0.1
    for k, v in kw.items():
        s[k] = v
    return cfg


@pytest.mark.parametrize("kind", ["multistep", "cosine", "wd"])
def test_schedules_match_jax(pair, kind):
    """The LR and WD factors at steps 0-99: rtol 1e-6."""
    jcfg, tcfg = pair[3], pair[4]
    kw = {"WEIGHT_DECAY_SCHEDULE": True} if kind == "wd" else {}
    jc, tc = _solver(jcfg, **kw), _solver(tcfg, **kw)
    if kind == "cosine":  # a key neither config declares: the JAX module reads it with getattr
        jc.SOLVER["USE_COSINE"] = True
        tc.SOLVER["USE_COSINE"] = True
    fj, ft = {"multistep": (jo.warmup_multistep_schedule, to.warmup_multistep_schedule),
              "cosine": (jo.cosine_schedule, to.cosine_schedule),
              "wd": (jo.wd_schedule, to.wd_schedule)}[kind]
    fj, ft = fj(jc), ft(tc)
    for step in range(100):
        np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("optimizer,clip,lr_scale", [("ADAMW", True, 1.0), ("ADAMW", False, 0.1), ("SGD", True, 1.0)])
def test_optimizer_matches_optax_chain(pair, optimizer, clip, lr_scale):
    """Three steps of the port's chain against the JAX package's optax chain
    on the same gradients (clipping binding, weight decay with norm groups,
    warmup, `lr_scale`), full recipe: parameters within rtol 1e-5 of their
    largest value."""
    _, params, tmodel, jcfg, tcfg = pair
    kw = dict(OPTIMIZER=optimizer, WEIGHT_DECAY=0.05, WEIGHT_DECAY_NORM_FACTOR=0.5, WARMUP_ITERS=2)
    jc, tc = _solver(jcfg, **kw), _solver(tcfg, **kw)
    jc.SOLVER.CLIP_GRADIENTS.ENABLED = tc.SOLVER.CLIP_GRADIENTS.ENABLED = clip
    jc.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = tc.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.5
    model = copy.deepcopy(tmodel)
    names, _ = to.partition_params(model, [""])
    tr = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    jtr = {"params/" + to.flax_path(n): jnp.asarray(to_flax(n, t)) for n, t in tr.items()}
    tx_j, _ = jo.make_optimizer(jc, jtr)
    st_j = tx_j.init(jtr)
    update_j = jax.jit(tx_j.update)
    tx_t = to.AdamW(tc, names)
    st_t = tx_t.init(tr)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = {n: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)) for n, t in tr.items()}
        gj = {"params/" + to.flax_path(n): jnp.asarray(to_flax(n, v)) for n, v in g.items()}
        u_j, st_j = update_j(gj, st_j, jtr)
        jtr = jax.tree.map(lambda p, u: p + lr_scale * u, jtr, u_j)
        u_t, st_t = tx_t.update(g, st_t, tr)
        for n in tr:
            tr[n] += lr_scale * u_t[n]
    for n, t in tr.items():
        want = np.asarray(jtr["params/" + to.flax_path(n)])
        np.testing.assert_allclose(to_flax(n, t), want, atol=1e-5 * max(np.abs(want).max(), 1e-3), err_msg=n)


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    e = {"a": rng.standard_normal((3, 4)).astype(np.float32)}
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32)}
    want = jo.ema_update({k: jnp.asarray(v) for k, v in e.items()}, {k: jnp.asarray(v) for k, v in p.items()}, 0.99)
    got = to.ema_update({k: torch.from_numpy(v.copy()) for k, v in e.items()},
                        {k: torch.from_numpy(v) for k, v in p.items()}, 0.99)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=1e-6)


# --------------------------------------------------------- text dropout


def test_apply_text_dropout_matches_jax():
    """With JAX's own uniforms injected (its bernoulli is uniform < p): exact."""
    rng = np.random.default_rng(5)
    ids = rng.integers(1000, 2000, (3, 16)).astype(np.int32)
    pcm = np.zeros((3, 4, 16), np.float32)
    for l in range(4):
        pcm[:, l, 2 * l + 1: 2 * l + 3] = 1
    hq = rng.integers(0, 2, (3, 4)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = jtrain.apply_text_dropout(key, *map(jnp.asarray, (ids, pcm, hq)), 0.4)
    u = np.asarray(jax.random.uniform(key, (3, 4)))
    got = tt.apply_text_dropout(*map(torch.from_numpy, (ids, pcm, hq)), 0.4, draws=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == tt.MASK_TOKEN_ID).any()
    assert torch.equal(tt.apply_text_dropout(torch.from_numpy(ids), None, None, 0.0), torch.from_numpy(ids))


def test_random_word_mask_matches_jax():
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 30000, (4, 32)).astype(np.int32)
    ids[:, 28:] = 0
    green = rng.integers(-1, 2, (4, 32)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want_ids, want_labels = jtrain.random_word_mask(key, jnp.asarray(ids), jnp.asarray(green), 30522)
    r1, r2, r3 = jax.random.split(key, 3)
    draws = (np.asarray(jax.random.uniform(r1, ids.shape)), np.asarray(jax.random.uniform(r2, ids.shape)),
             np.asarray(jax.random.randint(r3, ids.shape, 0, 30522)))
    got_ids, got_labels = tt.random_word_mask(torch.from_numpy(ids), torch.from_numpy(green), 30522,
                                              draws=tuple(map(torch.from_numpy, draws)))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(want_labels))


# ---------------------------------------------------------------- DCN VJP


OFFSETS = ["zero", "integer", "radius", "past", "random"]


def _dcn_inputs(kind, stride, radius=2, b=2, h=7, w=9, c=8, cout=16, seed=0):
    rng = np.random.default_rng(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    off = {
        "zero": lambda: np.zeros((b, ho, wo, 18)),
        "integer": lambda: rng.integers(-radius - 1, radius + 2, (b, ho, wo, 18)),
        "radius": lambda: rng.choice([-radius, radius, -1.0, 0.5], (b, ho, wo, 18)),
        "past": lambda: rng.standard_normal((b, ho, wo, 18)) * 3 * radius,
        "random": lambda: rng.uniform(-radius - 0.5, radius + 0.5, (b, ho, wo, 18)),
    }[kind]().astype(np.float32)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32), off,
            rng.uniform(0, 1, (b, ho, wo, 9)).astype(np.float32),
            (rng.standard_normal((3, 3, c, cout)) * 0.1).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32),
            rng.standard_normal((b, ho, wo, cout)).astype(np.float32))


def _port_vjp(fn, args, **kw):
    """The port's public DCN function under autograd (its Function)."""
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args[:5]]
    fn(*ins, **kw).backward(torch.from_numpy(args[5]))
    return [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_clipped_vjp_matches_jax_window_composite(kind, stride):
    """The band route's and K2's backward (the window composite's VJP with
    JAX's conventions at the kinks) against `jax.vjp` of
    `modulated_deform_conv_window`, at zero, integer, exactly +-radius, past
    the window and random offsets: every gradient within 1e-5 of its max."""
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv_window

    args = _dcn_inputs(kind, stride)
    _, vjp = jax.vjp(lambda *a: modulated_deform_conv_window(*a, stride=stride, radius=2), *map(jnp.asarray, args[:5]))
    want = vjp(jnp.asarray(args[5]))
    for fn in (tdc.modulated_deform_conv_pallas, tdc.modulated_deform_conv_window):
        got = _port_vjp(fn, args, stride=stride, radius=2)
        for name, w, g in zip(("x", "offset", "mask", "weight", "bias"), want, got):
            assert rel_err(w, g) < 1e-5, (fn.__name__, name)


@pytest.mark.parametrize("kind", ["zero", "integer", "radius"])
def test_dcn_band_vjp_matches_jax_pallas_diff_interpret(kind):
    """Against `jax.vjp` of the TPU kernel's differentiable wrapper
    (`_mdc_pallas_diff`: the Pallas forward in interpret mode, the window
    composite's backward), the function MQDET_DEFORM_IMPL=pallas_interpret
    differentiates: within 1e-5 of each gradient's max."""
    from mqdet_tpu.ops.pallas.deform_conv_pallas import modulated_deform_conv_pallas

    args = _dcn_inputs(kind, 1, b=1, h=6, w=7)
    out, vjp = jax.vjp(lambda *a: modulated_deform_conv_pallas(*a, stride=1, radius=2, block_rows=4, interpret=True),
                       *map(jnp.asarray, args[:5]))
    want = vjp(jnp.asarray(args[5]))
    got = _port_vjp(tdc.modulated_deform_conv_pallas, args, stride=1, radius=2)
    for w, g in zip(want, got):
        assert rel_err(w, g) < 1e-5


@pytest.mark.parametrize("kind", ["zero", "integer", "random"])
@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_exact_vjp_matches_jax_exact_composite(kind, stride):
    """The gather route's backward: autograd of the exact composite, against
    `jax.vjp` of `modulated_deform_conv`: within 1e-5 of each max."""
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv

    args = _dcn_inputs(kind, stride)
    _, vjp = jax.vjp(lambda *a: modulated_deform_conv(*a, stride=stride), *map(jnp.asarray, args[:5]))
    want = vjp(jnp.asarray(args[5]))
    got = _port_vjp(tdc.modulated_deform_conv, args, stride=stride)
    for w, g in zip(want, got):
        assert rel_err(w, g) < 1e-5


@pytest.mark.parametrize("kind", ["zero", "integer"])
def test_plain_autograd_of_the_clipped_form_misses_the_window_gradient(kind):
    """The difference the Function repairs: PyTorch autograd of the clipped
    plain version (bilinear with floor corners) gives the offsets a forward
    difference at integer coordinates, where the window composite's VJP
    takes JAX's hat-function conventions. Off by more than 10% of the max."""
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv_window

    args = _dcn_inputs(kind, 1)
    _, vjp = jax.vjp(lambda *a: modulated_deform_conv_window(*a, stride=1, radius=2), *map(jnp.asarray, args[:5]))
    want = np.asarray(vjp(jnp.asarray(args[5]))[1])
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args[:5]]
    tdc.modulated_deform_conv_clipped_plain(*ins, stride=1, radius=2).backward(torch.from_numpy(args[5]))
    assert rel_err(want, ins[1].grad.numpy()) > 0.1
    assert rel_err(want, _port_vjp(tdc.modulated_deform_conv_pallas, args, stride=1, radius=2)[1]) < 1e-5


def test_dcn_function_saves_inputs_and_skips_unneeded_grads():
    """Only the inputs that need a gradient get one; outside autograd the
    public function returns no graph."""
    args = _dcn_inputs("random", 1)
    x = torch.from_numpy(args[0]).requires_grad_(True)
    rest = [torch.from_numpy(a) for a in args[1:5]]
    y = tdc.modulated_deform_conv_pallas(x, *rest, stride=1, radius=2)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("DeformConvFunction")
    y.backward(torch.from_numpy(args[5]))
    assert x.grad is not None and all(t.grad is None for t in rest)
    with torch.no_grad():
        assert tdc.modulated_deform_conv_pallas(x, *rest, stride=1, radius=2).grad_fn is None


@pytest.mark.parametrize("launcher", ["dcn", "dcn_band", "bi_attention", "bi_attention_levels", "msda"])
def test_launchers_refuse_a_call_that_needs_a_gradient(launcher):
    """A launcher's output has no grad_fn, so under autograd it raises
    before it touches the card (checked here on CPU tensors)."""
    from mqdet_torch.ops import bi_attention as tba
    from mqdet_torch.ops import ms_deform_attn as tmsda

    a = torch.zeros(1, 4, 4, 8, requires_grad=True)
    calls = {
        "dcn": lambda: tdc._launch(a, a, a, a, None, 1, None),
        "dcn_band": lambda: tdc._launch_band(a, a, a, a, None, 1, 2, 8, 2),
        "bi_attention": lambda: tba._launch(a, a, a, a, None, 8, False),
        "bi_attention_levels": lambda: tba._launch_levels([a], a, [a], a, None, 8),
        "msda": lambda: tmsda._launch(a, [(4, 4)], a, a),
    }
    with pytest.raises(RuntimeError, match="no gradient"):
        calls[launcher]()


# ------------------------------------------------------- model and step


def _train_mods(cfg):
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = "vision_query"
    cfg.SOLVER.MODEL_EMA = 0.999
    cfg.SOLVER.WARMUP_ITERS = 3
    cfg.MODEL.SWINT.DROP_PATH_RATE = 0.0


@pytest.fixture(scope="module")
def train_pair():
    """JAX and port models with the same weights, the offset convs x20 so
    the clip binds, a batch with 3 boxes per image, and the JAX step with a
    deterministic loss."""
    from test_torch_port_modules import scale_offset_convs

    jmodel, params, tmodel, jcfg, tcfg = tiny_pair(_train_mods)
    params, tmodel = scale_offset_convs(params, tmodel, 20.0)
    b, _ = jax_init_args(jcfg, batch=2, num_labels=3, k_shot=2, seed=3)
    gt = _gt(8, g=4, n_valid=(3, 3))
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=gt[0], gt_labels=gt[1], gt_valid=gt[2], gt_token_map=gt[3],
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32))
    anchors, level_sizes = _anchors()
    state, tx, merge = jtrain.init_train_state(params, jcfg, jax_trainable_patterns(jcfg))

    def loss_fn(trainable, frozen, batch, rng):
        p = merge(trainable, jax.lax.stop_gradient(frozen))
        out = jmodel.apply(p, batch["images"], batch["input_ids"], batch["attention_mask"], batch["queries"],
                           batch["query_mask"], deterministic=True)
        losses = jl.glip_losses(out, jnp.asarray(anchors), level_sizes, batch["gt_boxes"], batch["gt_labels"],
                                batch["gt_valid"], batch["gt_token_map"], batch["attention_mask"])
        losses["loss_gate"] = jl.gate_loss_from_params(trainable)
        total = sum(losses.values())
        return jnp.where(jnp.isfinite(total), total, 0.0), losses

    return dict(jmodel=jmodel, state=state, tx=tx, merge=merge, loss_fn=loss_fn, tmodel=no_dropout(tmodel),
                jcfg=jcfg, tcfg=tcfg, batch=batch, jbatch={k: jnp.asarray(v) for k, v in batch.items()})


def _port_step(tp, model=None):
    model = model if model is not None else copy.deepcopy(tp["tmodel"])
    state, tx = tt.init_train_state(model, tp["tcfg"], trainable_patterns(tp["tcfg"]))
    return model, state, tt.make_train_step(model, tx, tp["tcfg"])


def test_gcp_gradients_match_jax(train_pair):
    """The gradient of the GLIP loss w.r.t. every GCP parameter (the
    `vision_query` trainable set), the port's training forward with dropout
    at 0 against JAX's deterministic one, offsets past the clip: each within
    2e-4 of its largest value; the loss terms within rtol 1e-4."""
    tp = train_pair
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(tp["loss_fn"], has_aux=True))(
        tp["state"].trainable, tp["state"].frozen, tp["jbatch"], None)
    model, state, step = _port_step(tp)
    _, metrics = step(state, tt.batch_to_device(tp["batch"], "cpu"), torch.Generator().manual_seed(0))
    for k, v in jlosses.items():
        assert rel_err(v, metrics[k]) < 1e-4, k
    params = dict(model.named_parameters())
    assert len(state.trainable) == len(jgrads) > 10
    for n in state.trainable:
        assert rel_err(jax_leaf(jgrads, n), to_flax(n, params[n].grad)) < 2e-4, n
    assert all(p.grad is None for n, p in params.items() if n not in state.trainable)


def test_train_step_matches_jax(train_pair):
    """Two full steps (NaN guard, the optax chain, EMA) against the JAX
    package's `_finish_train_step` on its deterministic loss: trainable
    parameters and EMA within 1e-5 of their largest value; frozen
    parameters bitwise unchanged."""
    tp = train_pair
    jstep = jax.jit(jtrain._finish_train_step(tp["loss_fn"], tp["tx"], tp["jcfg"].SOLVER.MODEL_EMA))
    jstate = tp["state"]
    model, state, step = _port_step(tp)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in state.trainable}
    before = {n: t.clone() for n, t in state.trainable.items()}
    batch = tt.batch_to_device(tp["batch"], "cpu")
    for _ in range(2):
        jstate, _ = jstep(jstate, tp["jbatch"], jax.random.PRNGKey(0))
        state, _ = step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 2 and state.opt_state["count"] == 2
    for n, t in state.trainable.items():
        want = jax_leaf(jstate.trainable, n)
        np.testing.assert_allclose(to_flax(n, t), want, atol=1e-5 * np.abs(want).max(), err_msg=n)
        np.testing.assert_allclose(to_flax(n, state.ema[n]), jax_leaf(jstate.ema, n), atol=1e-5 * np.abs(want).max())
        assert not torch.equal(t, before[n]), n
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


def test_nonfinite_loss_zeroes_the_step(train_pair):
    """A non-finite loss gives zero gradients (the JAX guard): Adam's moments
    stay 0, the parameters move only by the weight decay."""
    tp = train_pair
    model, state, step = _port_step(tp)
    batch = tt.batch_to_device(tp["batch"], "cpu")
    batch["queries"] = batch["queries"].clone()
    batch["queries"][0, 0, 0] = float("nan")
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert float(metrics["loss_total"]) == 0.0
    assert all(float(m.abs().max()) == 0.0 for m in state.opt_state["mu"].values())


def test_training_forward_draws_from_its_generator(pair):
    """deterministic=False needs a generator; with dropout the output moves,
    the same generator seed gives the same output, and with the rates at 0
    it equals the deterministic forward within 1e-5."""
    jmodel, params, tmodel, jcfg, tcfg = pair
    b, _ = jax_init_args(jcfg, batch=2, num_labels=3, k_shot=2)
    args = (torch.from_numpy(np.ascontiguousarray(b["images"].transpose(0, 3, 1, 2))),
            torch.from_numpy(b["input_ids"]).long(), torch.from_numpy(b["attention_mask"]),
            torch.from_numpy(b["queries"]), torch.from_numpy(b["query_mask"]))
    model = copy.deepcopy(tmodel)
    from mqdet_torch.models.swin import SwinBlock

    for m in model.modules():
        if isinstance(m, SwinBlock):
            m.drop_path = 0.5
    with torch.no_grad():
        ref = model(*args)["dot_product_logits"][0]
        with pytest.raises(ValueError, match="Generator"):
            model(*args, deterministic=False)
        d1 = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))["dot_product_logits"][0]
        d2 = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))["dot_product_logits"][0]
        assert torch.equal(d1, d2) and rel_err(ref, d1) > 1e-3
        z = no_dropout(model)(*args, deterministic=False, generator=torch.Generator())["dot_product_logits"][0]
    assert rel_err(ref, z) < 1e-5


def test_unported_training_options_are_refused(pair, coco, tmp_path):
    """SCAN and FILM training raise, with the reason (the JAX step has no
    mutable batch_stats; `test_torch_port_fusions_mlm.py` shows JAX's
    failing); MQ-GroundingDINO, once refused here (ROADMAP Queue A 2), builds
    its own step: the set criterion's, with no anchors. (REMAT and MLM_LOSS,
    once refused here too, are ported: `test_torch_port_remat.py`,
    `test_torch_port_fusions_mlm.py`.)"""
    tcfg = pair[4].clone()
    model = copy.deepcopy(pair[2])
    state, tx = tt.init_train_state(model, tcfg, [""])
    for fuse_type in ("SCAN", "FILM"):
        c = tcfg.clone()
        c.MODEL.DYHEAD.FUSE_CONFIG.TYPE = fuse_type
        with pytest.raises(NotImplementedError, match="batch_stats"):
            tt.make_train_step(model, tx, c)
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.models.gdino import MQGroundingDINO
    from mqdet_torch.tools.train import build_training

    model, _, state, step, _ = build_training(tb.tiny_gdino_config(), CocoDetectionDataset(*coco), None,
                                              str(tmp_path), device="cpu", tokenizer=WordPieceTokenizer())
    assert isinstance(model, MQGroundingDINO) and state.trainable
    assert hasattr(step, "assignment") and step.assignment is None  # make_gdino_train_step's, not yet run


# ------------------------------------------------------- data and loop


def test_samplers_and_metric_logger_copies_match(tmp_path):
    """The numpy copies give the JAX modules' results. Exact."""
    from mqdet_tpu.data import samplers as js
    from mqdet_tpu.utils import metric_logger as jm
    from mqdet_torch.data import samplers as ts
    from mqdet_torch.utils import metric_logger as tm

    ids = list(range(37))
    for args in ((3, 1, True, 5, 2), (4, 3, False, 0, 0)):
        assert js.distributed_shard(ids, *args) == ts.distributed_shard(ids, *args)
    assert js.grouped_by_bucket(ids, lambda i: i % 3, 4, True) == ts.grouped_by_bucket(ids, lambda i: i % 3, 4, True)
    assert list(js.iteration_based([[1], [2], [3]], 7, 2)) == list(ts.iteration_based([[1], [2], [3]], 7, 2))
    kw = dict(rank=3, world_size=4, node_rank=1, node_number=2, rank_within_node=1, process_num_per_node=2, seed=4)
    assert js.distributed_shard_chunk_by_node([5, 7, 3, 4], [True, False, True, False], **kw) == \
        ts.distributed_shard_chunk_by_node([5, 7, 3, 4], [True, False, True, False], **kw)
    a, b = jm.MetricLogger(), tm.MetricLogger()
    for v in (3.0, 1.0, 2.0):
        a.update(loss=v, t=v * 2)
        b.update(loss=v, t=v * 2)
    assert str(a) == str(b)
    tm.JsonlLogger(str(tmp_path)).log(3, loss=1.5)
    rec = json.loads(open(os.path.join(tmp_path, "metrics.jsonl")).read())
    assert rec["step"] == 3 and rec["loss"] == 1.5


def test_grounding_training_half_matches_jax():
    """Negative sampling (with control probabilities) and overflow trimming
    give the JAX module's results from the same seeds. Exact."""
    from mqdet_tpu.data import grounding as jg
    from mqdet_tpu.data import tokenizer as jtok
    from mqdet_torch.data import grounding as tg
    from mqdet_torch.data import tokenizer as ttok

    labels = list(range(1, 60))
    for seed, cp in ((0, None), (1, (0.2, 0.2, 0.3, 0.0)), (2, (0.0, 0.0, 0.0, 0.0))):
        for pos in ([3, 7], [5], list(range(10, 30))):
            assert jg.sample_negatives(pos, labels, 12, random.Random(seed), cp) == \
                tg.sample_negatives(pos, labels, 12, random.Random(seed), cp)
    names = {i: f"name_{i} of a class" for i in labels}
    assert jg.check_for_positive_overflow(labels, names, jtok.WordPieceTokenizer(), 40) == \
        tg.check_for_positive_overflow(labels, names, ttok.WordPieceTokenizer(), 40)


def _loader_cfg(cfg):
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = 48, 64
    cfg.AUGMENT.MULT_MIN_SIZE_TRAIN = (40, 48)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.DATASETS.RANDOM_SAMPLE_NEG = 4
    cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT = 4
    cfg.VISION_QUERY.NUM_QUERY_PER_CLASS = 2
    cfg.VISION_QUERY.TEXT_DROPOUT = 0.4
    return cfg


def _banks(labels, channels, seed=0):
    """Equal JAX and port banks holding 3 queries of every other label."""
    from mqdet_tpu.mq.bank import QueryBank as JBank
    from mqdet_torch.mq.bank import QueryBank as TBank

    rng = np.random.default_rng(seed)
    jb, tbk = JBank(channels), TBank(channels)
    for label in sorted(labels)[::2]:
        f = rng.standard_normal((3, 1, channels)).astype(np.float32)
        jb.add(label, f)
        tbk.add(label, f)
    return jb, tbk


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    ann, img_dir = write_coco(root, [(30, 40), (40, 30), (32, 32), (36, 44), (44, 36)], boxes_per_image=3)
    return ann, img_dir


@pytest.mark.parametrize("jitter", [False, True])
def test_grounding_train_loader_matches_jax(coco, jitter):
    """Two batches (caption synthesis with negatives, the multi-scale resize,
    flips, optionally PIL's color jitter, the query selection) from the same
    seed: every array equal to JAX's loader's, images within 1e-6."""
    from mqdet_tpu.data.coco import CocoDetectionDataset as JDS
    from mqdet_tpu.data.loader import GroundingTrainLoader as JLoader
    from mqdet_tpu.data.tokenizer import WordPieceTokenizer as JTok
    from mqdet_tpu.mq.selector import QuerySelector as JSel
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.data.coco import CocoDetectionDataset as TDS
    from mqdet_torch.data.loader import GroundingTrainLoader as TLoader
    from mqdet_torch.data.tokenizer import WordPieceTokenizer as TTok
    from mqdet_torch.mq.selector import QuerySelector as TSel

    jcfg, tcfg = _loader_cfg(jb.tiny_test_config()), _loader_cfg(tb.tiny_test_config())
    if jitter:
        for c in (jcfg, tcfg):
            c.AUGMENT.BRIGHTNESS = c.AUGMENT.CONTRAST = c.AUGMENT.SATURATION = 0.3
    jds, tds = JDS(*coco), TDS(*coco)
    jbank, tbank = _banks(tds.ind_to_class, 16)
    jl_ = JLoader(jds, jcfg, JTok(), JSel(jbank, 2, max_labels=4), num_hosts=1, host_id=0, seed=3)
    tl_ = TLoader(tds, tcfg, TTok(), TSel(tbank, 2, max_labels=4), seed=3)
    assert jl_.steps_per_epoch() == tl_.steps_per_epoch() == 2
    for want, got in zip(jl_, tl_):
        assert set(want) == set(got) and got["has_query"].any()
        for k in want:
            if k == "images":
                np.testing.assert_allclose(got[k], want[k], atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jl_.epoch == tl_.epoch == 1


def test_loader_keeps_the_positives_under_the_label_cap(coco):
    """RANDOM_SAMPLE_NEG past MAX_CLASSES_PER_PROMPT (mq-glip-t.yaml: 85
    against 40; here 10 against 4): the port's caption keeps every positive
    label (the reference's caption holds them all), where the JAX loader caps
    (negatives + positives) and drops them, so each of its batches is
    negative. Counted exactly."""
    from mqdet_tpu.data.coco import CocoDetectionDataset as JDS
    from mqdet_tpu.data.loader import GroundingTrainLoader as JLoader
    from mqdet_tpu.data.tokenizer import WordPieceTokenizer as JTok
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.data.coco import CocoDetectionDataset as TDS
    from mqdet_torch.data.loader import GroundingTrainLoader as TLoader
    from mqdet_torch.data.tokenizer import WordPieceTokenizer as TTok

    jcfg, tcfg = _loader_cfg(jb.tiny_test_config()), _loader_cfg(tb.tiny_test_config())
    jcfg.DATASETS.RANDOM_SAMPLE_NEG = tcfg.DATASETS.RANDOM_SAMPLE_NEG = 10
    jcfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = tcfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 64
    got_port = [n for b in TLoader(TDS(*coco), tcfg, TTok(), None, seed=1) for n in b["num_positive"]]
    got_jax = [n for b in JLoader(JDS(*coco), jcfg, JTok(), None, num_hosts=1, host_id=0, seed=1)
               for n in b["num_positive"]]
    assert len(got_port) == len(got_jax) == 4
    assert all(int(n) == 0 for n in got_jax) and all(int(n) == 3 for n in got_port)


def test_train_transform_matches_jax():
    """Resize (PIL's BILINEAR bit for bit), flip, normalize, pad: within
    1e-6; boxes and sizes exactly."""
    from mqdet_tpu.data import transforms as jtf
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.data import transforms as ttf

    jcfg, tcfg = _loader_cfg(jb.tiny_test_config()), _loader_cfg(tb.tiny_test_config())
    jcfg.AUGMENT.FLIP_PROB_TRAIN = tcfg.AUGMENT.FLIP_PROB_TRAIN = 0.5
    rng = np.random.default_rng(0)
    for seed, hw in enumerate(((30, 40), (40, 30), (50, 61))):
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        boxes = np.array([[1.0, 2.0, 20.0, 25.0], [5.5, 3.0, 9.0, 12.0]], np.float32)
        want = jtf.TrainTransform(jcfg)(img, boxes, rng=random.Random(seed))
        got = ttf.TrainTransform(tcfg)(img, boxes, rng=random.Random(seed))
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_train_bucket_takes_the_declared_orientation_first():
    """A resized image that fits the declared bucket and its rotation gets
    the declared one (the train step's anchors are its); one that fits only
    the rotation gets that, as `pick_bucket` gives it."""
    from mqdet_torch.data.transforms import pick_bucket, train_bucket

    buckets = ((800, 1344),)
    assert train_bucket(480, 640, buckets) == (800, 1344)
    assert train_bucket(1066, 800, buckets) == pick_bucket(1066, 800, buckets) == (1344, 800)
    assert train_bucket(30, 40, ((32, 48), (64, 64))) == (32, 48)


def _train_cfg(tmp):
    cfg = _loader_cfg(tb.tiny_test_config())
    _train_mods(cfg)
    cfg.SOLVER.MAX_ITER = 4
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.MAX_TO_KEEP = 2
    cfg.SOLVER.MAX_NEG_PER_BATCH = 1.0
    cfg.VISION_QUERY.TEXT_DROPOUT = 0.4
    cfg.MODEL.SWINT.DROP_PATH_RATE = 0.2
    return cfg


def _run_train(coco, out, max_iter, resume, cfg_fn=_train_cfg):
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.tools.train import train

    cfg = cfg_fn(out)
    cfg.SOLVER.MAX_ITER = max_iter
    ds = CocoDetectionDataset(*coco)
    _, tbank = _banks(ds.ind_to_class, 16)
    logs = []
    state, _ = train(cfg, ds, tbank, str(out), resume=resume, device="cpu",
                     tokenizer=WordPieceTokenizer(), log=logs.append)
    return state, logs


def test_do_train_runs_and_checkpoints(coco, tmp_path):
    """`train` on the CPU for 4 iterations (text dropout, stochastic depth,
    attention dropout on): every logged loss finite, the trainable set moved,
    the EMA apart from it, the newest MAX_TO_KEEP checkpoints kept, metrics
    logged."""
    from mqdet_torch.io.checkpoints import Checkpointer

    state, logs = _run_train(coco, tmp_path, 4, False)
    assert state.step == 4 and logs and "iter 4/4" in logs[-1]
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert recs and all(np.isfinite(v) for r in recs for k, v in r.items() if k.startswith("loss"))
    ck = Checkpointer(str(tmp_path), 2)
    assert ck.steps() == [2, 4] and ck.last_step() == 4
    assert ck.load_arguments(4)["final"] is True
    init = tb.init_params(tb.build_model(_train_cfg(tmp_path)), seed=0)
    p0 = dict(init.named_parameters())
    for n, t in state.trainable.items():
        assert not torch.equal(t, p0[n].detach()), n
    assert any(not torch.equal(state.ema[n], t) for n, t in state.trainable.items())


def test_checkpoint_resume_ends_where_the_uninterrupted_run_does(coco, tmp_path):
    """4 iterations (2 epochs) straight against 1, then a resumed run to 4
    (the loader fast-forwarded inside its epoch, the per-step generator
    replayed): the trainable set, the optimizer state and the EMA equal,
    bitwise. (As in the JAX package, the loader's host rng is not saved: a
    run resumed at an epoch boundary draws its augmentations afresh.)"""
    full, _ = _run_train(coco, tmp_path / "a", 4, False)
    _run_train(coco, tmp_path / "b", 1, False)
    resumed, logs = _run_train(coco, tmp_path / "b", 4, True)
    assert any("resumed from iteration 1" in line for line in logs)
    assert resumed.step == full.step == 4 and resumed.opt_state["count"] == 4
    for n, t in full.trainable.items():
        assert torch.equal(t, resumed.trainable[n]), n
        assert torch.equal(full.ema[n], resumed.ema[n]), n
        assert torch.equal(full.opt_state["nu"][n], resumed.opt_state["nu"][n]), n


# ------------------------------------------------ portrait images (Queue C 1)


def test_portrait_batch_trains_against_its_own_buckets_anchors(train_pair):
    """ROADMAP Queue C 1, repaired: with a landscape bucket declared, an
    all-portrait batch (padded to the rotated bucket) gives the port's step
    the losses of JAX's deterministic loss with the anchors of the rotated
    bucket, rtol 1e-4; the JAX CLI's anchors, the declared bucket's, give
    other losses (both orientations hold the same number of anchors a level,
    so nothing else catches it)."""
    tp = train_pair
    portrait, landscape = (HW[0] + 32, HW[1]), (HW[1], HW[0] + 32)
    b, _ = jax_init_args(tp["jcfg"], batch=2, num_labels=3, k_shot=2, seed=5)
    images = np.random.default_rng(5).standard_normal((2,) + portrait + (3,)).astype(np.float32)
    gt = _gt(9, g=4, n_valid=(3, 2), hw=portrait)
    batch = {k: b[k] for k in ("input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(images=images, gt_boxes=gt[0], gt_labels=gt[1], gt_valid=gt[2], gt_token_map=gt[3],
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32))
    jmodel, state = tp["jmodel"], tp["state"]

    def jax_losses(anchors, level_sizes):
        out = jmodel.apply(tp["merge"](state.trainable, state.frozen), *(jnp.asarray(batch[k]) for k in (
            "images", "input_ids", "attention_mask", "queries", "query_mask")), deterministic=True)
        losses = jl.glip_losses(out, jnp.asarray(anchors), level_sizes, *(jnp.asarray(batch[k]) for k in (
            "gt_boxes", "gt_labels", "gt_valid", "gt_token_map", "attention_mask")))
        return {k: float(v) for k, v in losses.items()}

    def anchors_of(hw):
        al = jax_anchors(hw)
        return np.concatenate(al), tuple(a.shape[0] for a in al)

    want, declared = jax_losses(*anchors_of(portrait)), jax_losses(*anchors_of(landscape))
    tp["tcfg"].TPU.IMAGE_BUCKETS = (landscape,)
    try:
        model, tstate, step = _port_step(tp)
        _, metrics = step(tstate, tt.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    finally:
        tp["tcfg"].TPU.IMAGE_BUCKETS = (HW,)
    for k, v in want.items():
        assert rel_err(v, metrics[k]) < 1e-4, k
    assert max(rel_err(want[k], declared[k]) for k in want) > 1e-2


def test_mixed_orientations_batch_by_bucket_and_train(coco, tmp_path):
    """A dataset of landscape and portrait images with a landscape bucket
    declared: every batch of the port's loader holds one bucket, both
    buckets come up, and `train` runs 4 steps on them (where the JAX loader
    fails to stack a mixed batch)."""
    from mqdet_tpu.data.coco import CocoDetectionDataset as JDS
    from mqdet_tpu.data.loader import GroundingTrainLoader as JLoader
    from mqdet_tpu.data.tokenizer import WordPieceTokenizer as JTok
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.data.coco import CocoDetectionDataset as TDS
    from mqdet_torch.data.loader import GroundingTrainLoader as TLoader
    from mqdet_torch.data.tokenizer import WordPieceTokenizer as TTok

    mixed = write_coco(tmp_path, [(30, 40), (40, 30), (30, 40), (40, 30), (36, 44), (44, 36)], boxes_per_image=2,
                       seed=4)

    def mixed_cfg(cfg):
        cfg = _loader_cfg(cfg)
        cfg.TPU.IMAGE_BUCKETS = ((48, 64),)
        return cfg

    loader = TLoader(TDS(*mixed), mixed_cfg(tb.tiny_test_config()), TTok(), None, seed=2)
    shapes = [b["images"].shape[1:3] for _ in range(3) for b in loader]
    assert set(shapes) == {(48, 64), (64, 48)} and len(shapes) >= 3
    with pytest.raises(ValueError):
        for _ in range(3):
            list(JLoader(JDS(*mixed), mixed_cfg(jb.tiny_test_config()), JTok(), None, num_hosts=1, host_id=0, seed=2))

    state, logs = _run_train(mixed, tmp_path / "run", 4, False, cfg_fn=lambda out: mixed_cfg(_train_cfg(out)))
    assert state.step == 4 and "iter 4/4" in logs[-1]
    recs = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert recs and all(np.isfinite(v) for r in recs for k, v in r.items() if k.startswith("loss"))
