"""`TPU.REMAT` in the port (`models/layers.py::remat`: the language tower's
BertLayers and each head stage's VLFuse, BertLayer and DyConv checkpointed)
at `tiny_l_config` on the CPU in fp32.

- Against the JAX package's REMAT (the counterpart of
  `tests/test_train.py::test_remat_gradients_match`): the loss
  sum |dot-product logits| of a deterministic forward and its gradient with
  respect to every parameter, both models built with TPU.REMAT, the same
  weights (`init_params_fast` perturbed, through `params_from_jax`) and
  inputs. Under MQDET_DEFORM_IMPL=gather on both sides (the exact DCN: the
  JAX gradient's compile takes half the time of the window composite's);
  the JAX function compiled at O0. Tolerance: the loss rtol 1e-5; each
  gradient within 1e-3 of the larger of its own largest value and 1e-3 of
  the model's largest gradient entry. fp32 rounding through Swin's 9 blocks,
  2 BERT layers and 8 head stages moves the FPN's gradients by up to 2.3e-4
  of their largest value; the JAX package holds its own REMAT gradients to
  its plain ones at rtol 2e-3. The floor: a gradient that is 0 in exact
  arithmetic (a conv bias before GroupNorm, an attention key bias) holds
  rounding noise of the model's gradient scale.
- Port only: a training step (the fusion's attention dropout drawn from the
  step's generator) with REMAT on equals the same step with REMAT off under
  one generator seed: the loss bitwise, every trainable gradient within
  1e-5 of its largest value; the same step through a checkpoint that does
  not replay the generator differs (the check sees what it guards); each
  checkpointed segment runs twice in a REMAT step and once without; under
  `no_grad` a REMAT model's protocol never enters the checkpoint and gives
  the plain model's detections bitwise.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mqdet_torch.core.config import trainable_patterns
from mqdet_torch.engine import train as tt
from mqdet_torch.engine.predict import make_protocol_fn
from mqdet_torch.models import layers, vldyhead
from mqdet_torch.models.bert import BertLayer
from mqdet_torch.models.fusion import VLFuse
from mqdet_torch.models.vldyhead import DyConv
from mqdet_torch.utils import builders as tb
from test_torch_port_glip_l import HW, compiled, l_pair
from test_torch_port_modules import jax_init_args, nchw
from test_torch_port_train import _gt, jax_leaf, rel_err, to_flax

torch.set_num_threads(2)

TEXT = ("images", "input_ids", "attention_mask", "queries", "query_mask")


def test_remat_gradients_match_jax_remat(monkeypatch):
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")

    def remat_on(cfg):
        cfg.TPU.REMAT = True

    jmodel, params, tmodel, jcfg, tcfg = l_pair(remat_on)
    assert tmodel.rpn.head.remat and tmodel.language_backbone.body.model.remat
    b, jargs = jax_init_args(jcfg, batch=2, num_labels=3, k_shot=2, seed=3)

    def loss(p):
        out = jmodel.apply(p, *jargs, deterministic=True)
        return sum(jnp.sum(jnp.abs(x.astype(jnp.float32))) for x in out["dot_product_logits"])

    jloss, jgrads = compiled(jax.value_and_grad(loss), params)(params)
    out = tmodel(nchw(b["images"]), *(torch.from_numpy(b[k]) for k in TEXT[1:]))
    tloss = sum(x.abs().sum() for x in out["dot_product_logits"])
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    # the class / box / centerness convs do not reach the loss: no torch gradient, JAX's zeros
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in tmodel.named_parameters()}
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert len(grads) == len(flat)
    # a gradient that is 0 in exact arithmetic (a conv bias before GroupNorm,
    # an attention key bias) holds rounding noise of the model's gradient scale
    want = {n: jax_leaf(flat, n) for n in grads}
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    ratios = {n: float(np.abs(want[n] - to_flax(n, g)).max()) / max(float(np.abs(want[n]).max()), floor)
              for n, g in grads.items()}
    for n, r in ratios.items():
        assert r < 1e-3, (n, r)


def _train_case(remat: bool):
    """The tiny L model (REMAT on or off; the same init_params weights) with
    the `vision_query` recipe and a batch of 2 images with 3 boxes each."""
    cfg = tb.tiny_l_config()
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = "vision_query"
    cfg.TPU.REMAT = remat
    model = tb.init_params(tb.build_model(cfg), seed=0)
    b = tb.synthetic_batch(cfg, 2, HW, num_labels=3, k_shot=2, seed=3)
    gt = _gt(8, g=4, n_valid=(3, 3))
    batch = {k: b[k] for k in TEXT}
    batch.update(gt_boxes=gt[0], gt_labels=gt[1], gt_valid=gt[2], gt_token_map=gt[3],
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32))
    return cfg, model, tt.batch_to_device(batch, "cpu")


def _step(cfg, model, batch, seed=5):
    """(loss, {trainable name: gradient}) of one training step drawn from a
    generator of `seed`."""
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    _, metrics = tt.make_train_step(model, tx, cfg)(state, batch, torch.Generator().manual_seed(seed))
    params = dict(model.named_parameters())
    return float(metrics["loss_total"]), {n: params[n].grad.clone() for n in state.trainable}


def _segment_calls(model):
    """Forward pre-hooks counting the calls of each checkpointed module type
    (a recompute stops once it has what the backward needs, before the
    module returns)."""
    counts = {"VLFuse": 0, "BertLayer": 0, "DyConv": 0}
    for m in model.modules():
        if isinstance(m, (VLFuse, BertLayer, DyConv)):
            key = type(m).__name__
            m.register_forward_pre_hook(lambda *a, key=key: counts.__setitem__(key, counts[key] + 1))
    return counts


def test_remat_training_step_equals_the_plain_step(monkeypatch):
    cfg0, model0, batch = _train_case(False)
    cfg1, model1, _ = _train_case(True)
    calls0, calls1 = _segment_calls(model0), _segment_calls(model1)
    loss0, g0 = _step(cfg0, model0, batch)
    loss1, g1 = _step(cfg1, model1, batch)
    assert loss0 == loss1
    assert len(g0) == len(g1) > 0
    for n in g0:
        assert rel_err(g0[n], g1[n]) < 1e-5, n
    # 8 head stages (VLFuse, BertLayer, DyConv) and the language tower's 2
    # BertLayers, each recomputed in the backward; but the tower's layer 0
    # (before the first GCP block) holds nothing that needs a gradient
    assert calls0 == {"VLFuse": 8, "BertLayer": 10, "DyConv": 8}
    assert calls1 == {"VLFuse": 16, "BertLayer": 19, "DyConv": 16}

    def no_replay(fn, *args, enabled=True, generator=None):
        return layers.remat(fn, *args, enabled=enabled)

    monkeypatch.setattr(vldyhead, "remat", no_replay)
    loss2, g2 = _step(cfg1, copy.deepcopy(model1), batch)
    assert loss2 == loss0
    assert max(rel_err(g0[n], g2[n]) for n in g0) > 1e-3  # the recompute drew other dropout masks


def test_remat_protocol_runs_no_checkpoint_under_no_grad(monkeypatch):
    cfg0, model0, _ = _train_case(False)
    cfg1, model1, _ = _train_case(True)
    for cfg in (cfg0, cfg1):
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
    image = np.random.default_rng(21).standard_normal((1,) + HW + (3,)).astype(np.float32)
    text = [torch.from_numpy(np.stack([np.stack([tb.synthetic_batch(cfg0, 1, HW, 3, 2, seed=c)[k][0]
                                                 for c in range(2)])]))
            for k in ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")]
    sizes = torch.tensor([[[64.0, 64.0], [60.0, 52.0]]])
    want = make_protocol_fn(model0, HW, cfg0)(nchw(image), *text, sizes)

    def refuse(*a, **kw):
        raise AssertionError("checkpoint entered under no_grad")

    monkeypatch.setattr(layers, "checkpoint", refuse)
    got = make_protocol_fn(model1, HW, cfg1)(nchw(image), *text, sizes)
    assert int(got.valid.sum()) > 0
    for a, b in zip((got.boxes, got.scores, got.labels, got.valid), (want.boxes, want.scores, want.labels, want.valid)):
        assert torch.equal(a, b)
