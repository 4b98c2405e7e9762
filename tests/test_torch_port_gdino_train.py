"""MQ-GroundingDINO modulated pre-training in the port against the JAX
package, on the CPU in fp32 at `tiny_gdino_config`: the MSDA autograd
Function, the Hungarian matcher and set criterion, the model's training
switch and stop-gradients, the train step, the rule tables of the
partition, and `tools/train.py`'s GroundingDINO branch.

Inputs are numpy arrays from a seed, fed to both packages; each test states
its tolerance. The JAX train step runs `deterministic=False` (dropout); the
parity tests take JAX's own loss function out of `make_gdino_train_step`
over a model call with `deterministic=True` (on the CPU the fusion's
composite without dropout), with text dropout at 0, and run the port's
training forward with its dropout rates at 0 (`no_dropout`). Images are
96x96, as in tests/test_torch_port_gdino.py (no 1x1 pyramid level).
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.core.config import trainable_patterns as jax_trainable_patterns
from mqdet_tpu.engine import gdino_losses as jg
from mqdet_tpu.engine import optim as jo
from mqdet_tpu.engine import train as jtrain
from mqdet_tpu.utils import builders as jb
from mqdet_torch.core.config import trainable_patterns
from mqdet_torch.engine import gdino_losses as tg
from mqdet_torch.engine import losses as tl
from mqdet_torch.engine import optim as to
from mqdet_torch.engine import train as tt
from mqdet_torch.io.from_jax import params_from_jax, rule_table
from mqdet_torch.ops import ms_deform_attn as tms
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import flat_params, perturb
from test_torch_port_msda import _encoder_inputs
from test_torch_port_train import _loader_cfg, _recipe, _run_train, coco, no_dropout, rel_err  # noqa: F401

torch.set_num_threads(2)

HW = (96, 96)
T = 16  # the tiny config's caption length (and max_text_len)
BOX_SCALE = 10.0


# ------------------------------------------------------------ MSDA VJP


def _jax_vjp(fn, value, loc, attn, g):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (value, loc, attn)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_vjp(value, shapes, loc, attn, g, needs=(True, True, True)):
    ins = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((value, loc, attn), needs)]
    out = tms.ms_deform_attn(ins[0], shapes, ins[1], ins[2])
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() if t.grad is not None else None for t in ins]


ENC_SHAPES = [(8, 8), (4, 4), (2, 2), (1, 1)]  # k 1/2/4/8, f 2/4/8


def _encoder_case(seed=0, reach=12.0):
    rng = np.random.default_rng(seed)
    value, loc, attn = _encoder_inputs(rng, ENC_SHAPES, reach)
    g = rng.standard_normal((1, value.shape[1], value.shape[2] * value.shape[3])).astype(np.float32)
    return value, loc, attn, g


def test_msda_function_vjp_matches_jax_encoder_pallas_diff(monkeypatch):
    """Encoder queries under MQDET_MSDA_IMPL=pallas_interpret, offsets up to
    12 cells (past every window): the forward is K5's clipped function
    (against JAX's kernel in interpret mode, atol 2e-5, its own tests'
    bound), the backward the exact composite's VJP at the unclipped
    locations: (dvalue, dloc, dattn) against `jax.vjp` of
    `_encoder_pallas_diff`, each within 1e-5 of its largest value."""
    from mqdet_tpu.ops.ms_deform_attn import _encoder_pallas_diff

    value, loc, attn, g = _encoder_case()
    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    fn = jax.jit(lambda v, l, a: _encoder_pallas_diff(tuple(ENC_SHAPES), True, v, l, a))
    want_out = np.asarray(fn(*map(jnp.asarray, (value, loc, attn))))
    want = _jax_vjp(fn, value, loc, attn, g)
    got_out, got = _port_vjp(value, ENC_SHAPES, loc, attn, g)
    np.testing.assert_allclose(got_out, want_out, atol=2e-5, rtol=2e-5)
    for name, w, gr in zip(("value", "loc", "attn"), want, got):
        assert rel_err(w, gr) < 1e-5, name
    assert tms.clips(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(loc))


@pytest.mark.parametrize("case", ["decoder", "encoder under gather"])
def test_msda_function_vjp_matches_jax_exact_composite(monkeypatch, case):
    """The exact route (decoder queries, Q != S; encoder queries under
    `gather`): forward and (dvalue, dloc, dattn) against `jax.vjp` of
    `ms_deform_attn_sample`, each within 1e-5 of its largest value."""
    from mqdet_tpu.ops.ms_deform_attn import ms_deform_attn_sample

    value, loc, attn, g = _encoder_case(seed=1)
    if case == "decoder":
        rng = np.random.default_rng(2)
        loc = rng.uniform(-0.3, 1.3, (1, 7) + loc.shape[2:]).astype(np.float32)
        attn = rng.random((1, 7) + attn.shape[2:]).astype(np.float32)
        g = g[:, :7]
    else:
        monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    fn = jax.jit(lambda v, l, a: ms_deform_attn_sample(v, ENC_SHAPES, l, a))
    want = _jax_vjp(fn, value, loc, attn, g)
    got_out, got = _port_vjp(value, ENC_SHAPES, loc, attn, g)
    assert rel_err(np.asarray(fn(*map(jnp.asarray, (value, loc, attn)))), got_out) < 1e-5
    assert not tms.clips(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(loc))
    for name, w, gr in zip(("value", "loc", "attn"), want, got):
        assert rel_err(w, gr) < 1e-5, name


def test_plain_autograd_of_the_clipped_form_misses_the_exact_gradient(monkeypatch):
    """The difference the Function keeps from JAX: autograd of the clipped
    plain version gives a clamped sample's location no gradient (the clamp
    cuts it), where JAX's backward differentiates the exact composite at the
    unclipped location. Off by more than 10% of the largest dloc; the
    Function within 1e-5."""
    from mqdet_tpu.ops.ms_deform_attn import ms_deform_attn_sample

    value, loc, attn, g = _encoder_case(seed=3)
    want = _jax_vjp(jax.jit(lambda v, l, a: ms_deform_attn_sample(v, ENC_SHAPES, l, a)), value, loc, attn, g)[1]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, attn)]
    tms.ms_deform_attn_clipped_plain(ins[0], ENC_SHAPES, ins[1], ins[2]).backward(torch.from_numpy(g))
    assert rel_err(want, ins[1].grad.numpy()) > 0.1
    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    assert rel_err(want, _port_vjp(value, ENC_SHAPES, loc, attn, g)[1][1]) < 1e-5


def test_msda_function_saves_inputs_and_skips_unneeded_grads():
    """Only the inputs that need a gradient get one; the output's grad_fn is
    the Function's; outside autograd the public function returns no graph."""
    value, loc, attn, g = _encoder_case(seed=4)
    _, grads = _port_vjp(value, ENC_SHAPES, loc, attn, g, needs=(False, True, False))
    assert grads[0] is None and grads[2] is None and np.abs(grads[1]).max() > 0
    v = torch.from_numpy(value).requires_grad_(True)
    out = tms.ms_deform_attn(v, ENC_SHAPES, torch.from_numpy(loc), torch.from_numpy(attn))
    assert type(out.grad_fn).__name__.startswith("MSDeformAttnFunction")
    with torch.no_grad():
        assert tms.ms_deform_attn(v, ENC_SHAPES, torch.from_numpy(loc), torch.from_numpy(attn)).grad_fn is None


@pytest.mark.parametrize("fn", ["exact", "clipped"])
def test_plain_msda_gives_nan_where_jax_does(fn):
    """A NaN location gives NaN at its query's head through both plain
    versions (the clamps of the clipped one propagate it), and an infinite
    one through the exact version (its bilinear fraction is inf - inf), as
    JAX's composite `ms_deform_attn_sample` gives, where the clipped one
    clamps it; every other output is finite and equal to the clean run's
    within 1e-6."""
    from mqdet_tpu.ops.ms_deform_attn import ms_deform_attn_sample

    value, loc, attn, _ = _encoder_case(seed=5)
    bad = loc.copy()
    bad[0, 3, 1, 2, 1, 0] = np.nan
    bad[0, 40, 0, 1, 2, 1] = np.inf
    plain = tms.ms_deform_attn_plain if fn == "exact" else tms.ms_deform_attn_clipped_plain
    got = plain(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(bad), torch.from_numpy(attn)).numpy()
    clean = plain(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    heads = np.isnan(got.reshape(1, -1, 2, 8)).any(-1)
    want_at = {(3, 1), (40, 0)} if fn == "exact" else {(3, 1)}
    assert {(int(q), int(h)) for q, h in zip(*np.nonzero(heads[0]))} == want_at
    if fn == "exact":
        want = np.asarray(ms_deform_attn_sample(*map(jnp.asarray, (value,)), ENC_SHAPES, jnp.asarray(bad),
                                                jnp.asarray(attn)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(got)
    np.testing.assert_allclose(got[keep], clean[keep], atol=1e-6)


def test_plain_dcn_gives_nan_where_jax_does():
    """NaN offsets through the exact and the clipped plain DCN against JAX's
    composites (`modulated_deform_conv`, `modulated_deform_conv_window`):
    NaN at the same output positions. One NaN dy inside the image gives NaN
    through both; a NaN dx whose dy puts the sample past the bottom edge
    gives 0 through the exact function (its out-of-image rule drops the
    sample) and NaN through the clipped one (the window's hat weights are
    NaN); an infinite dy lies outside (exact: zero) or clamps (clipped)."""
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv, modulated_deform_conv_window
    from mqdet_torch.ops import deform_conv as tdc

    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 6, 7, 8)).astype(np.float32)
    off = (rng.standard_normal((1, 6, 7, 18)) * 2).astype(np.float32)
    off[0, 2, 3, 4] = np.nan
    off[0, 5, 6, 16:18] = (2.0, np.nan)  # tap 8: y = 5 - 1 + 2 + 2 = 8, past the 6 rows
    off[0, 4, 1, 6] = np.inf
    mask = rng.uniform(0, 1, (1, 6, 7, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 8)) * 0.1).astype(np.float32)
    for jfn, tfn, want_at in (
        (lambda *a: modulated_deform_conv(*a), tdc.modulated_deform_conv_plain, {(2, 3)}),
        (lambda *a: modulated_deform_conv_window(*a, radius=2), tdc.modulated_deform_conv_clipped_plain,
         {(2, 3), (5, 6)}),
    ):
        want = np.asarray(jfn(*map(jnp.asarray, (x, off, mask, w))))
        got = tfn(*map(torch.from_numpy, (x, off, mask, w))).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert {(int(i), int(j)) for i, j in zip(*np.nonzero(np.isnan(got[0]).all(-1)))} == want_at
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), atol=1e-5)


# ------------------------------------------------------ matcher and loss


def _set_outputs(seed, b=2, q=12, layers=3, pad=4):
    """Decoder outputs of `layers` layers: logits with the last `pad` tokens
    -inf, boxes cxcywh in (0, 1)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((layers, b, q, T)) * 3).astype(np.float32)
    logits[..., T - pad:] = -np.inf
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (layers, b, q, 2)), rng.uniform(0.05, 0.5, (layers, b, q, 2))],
                           -1).astype(np.float32)
    return logits, boxes


def _set_targets(seed, b=2, g=6, n_valid=(4, 2)):
    rng = np.random.default_rng(seed + 100)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.5, (b, g, 2))], -1).astype(np.float32)
    valid = np.zeros((b, g), bool)
    tok = np.zeros((b, g, T), np.float32)
    for i in range(b):
        valid[i, rng.permutation(g)[: n_valid[i]]] = True
        for j in range(g):
            start = rng.integers(1, T - 6)
            tok[i, j, start: start + rng.integers(1, 3)] = 0.5
    mask = np.zeros((b, T), np.int32)
    mask[:, : T - 4] = 1
    return gt, valid, tok, mask


@pytest.mark.parametrize("seed", range(20))
def test_hungarian_match_matches_jax(seed):
    """One image's assignment, invalid gt slots and -inf padded logits: the
    query of every valid gt equal to JAX's `hungarian_match` (optax's
    Hungarian algorithm); -1 on the invalid slots."""
    logits, boxes = _set_outputs(seed, b=1, layers=1, q=12 + seed % 5)
    gt, valid, tok, _ = _set_targets(seed, b=1, n_valid=(1 + seed % 6,))
    args = (logits[0, 0], boxes[0, 0], tok[0], gt[0], valid[0])
    want, want_valid = jax.jit(jg.hungarian_match)(*map(jnp.asarray, args))
    got, got_valid = tg.hungarian_match(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    np.testing.assert_array_equal(got[valid[0]], np.asarray(want)[valid[0]])
    assert (got[~valid[0]] == -1).all() and len(set(got[valid[0]].tolist())) == valid[0].sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_gdino_set_loss_matches_jax(seed):
    """Final + 2 auxiliary layers, each matched anew: every key within rtol
    1e-5 of JAX's `gdino_set_loss`, and the gradients of their sum w.r.t.
    the logits and boxes within 1e-5 of their largest value."""
    logits, boxes = _set_outputs(seed)
    gt, valid, tok, mask = _set_targets(seed)

    def jax_loss(lg, bx):
        out = {"pred_logits": lg[-1], "pred_boxes": bx[-1], "aux_logits": list(lg[:-1]), "aux_boxes": list(bx[:-1])}
        return jg.gdino_set_loss(out, *map(jnp.asarray, (gt, valid, tok, mask)))

    want = jax_loss(jnp.asarray(logits), jnp.asarray(boxes))
    jgrads = jax.grad(lambda lg, bx: sum(jax_loss(lg, bx).values()), argnums=(0, 1))(jnp.asarray(logits),
                                                                                    jnp.asarray(boxes))
    lg, bx = (torch.from_numpy(a).requires_grad_(True) for a in (logits, boxes))
    out = {"pred_logits": lg[-1], "pred_boxes": bx[-1], "aux_logits": list(lg[:-1]), "aux_boxes": list(bx[:-1])}
    got = tg.gdino_set_loss(out, *map(torch.from_numpy, (gt, valid, tok, mask)))
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    assert rel_err(jgrads[0], np.nan_to_num(lg.grad.numpy())) < 1e-5
    assert rel_err(jgrads[1], bx.grad.numpy()) < 1e-5


def test_set_loss_takes_a_given_assignment():
    """`assignment` replaces the matcher: its own gives the same losses; a
    permuted one gives others; a wrong shape raises."""
    logits, boxes = _set_outputs(7)
    gt, valid, tok, mask = _set_targets(7)
    out = {"pred_logits": torch.from_numpy(logits[-1]), "pred_boxes": torch.from_numpy(boxes[-1]),
           "aux_logits": [torch.from_numpy(x) for x in logits[:-1]],
           "aux_boxes": [torch.from_numpy(x) for x in boxes[:-1]]}
    targets = tuple(map(torch.from_numpy, (gt, valid, tok, mask)))
    own = tg.match_layers(out, targets[0], targets[1], targets[2])
    assert own.shape == (3, 2, 6) and ((own >= 0) == valid[None]).all()
    base = tg.gdino_set_loss(out, *targets)
    same = tg.gdino_set_loss(out, *targets, assignment=own)
    assert all(torch.equal(base[k], same[k]) for k in base)
    other = own.copy()
    other[0, 0, valid[0]] = np.roll(other[0, 0, valid[0]], 1)
    assert float(tg.gdino_set_loss(out, *targets, assignment=other)["loss_bbox"]) != float(base["loss_bbox"])
    with pytest.raises(ValueError):
        tg.gdino_set_loss(out, *targets, assignment=own[:2])


def test_cxcywh_to_xyxy_matches_jax():
    from mqdet_tpu.core import boxes as jboxes
    from mqdet_torch.core import boxes as tboxes

    b = np.random.default_rng(8).uniform(0, 1, (3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(tboxes.cxcywh_to_xyxy(torch.from_numpy(b)).numpy(),
                                  np.asarray(jboxes.cxcywh_to_xyxy(jnp.asarray(b))))


# ------------------------------------------------------ model and step


def _train_mods(cfg):
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = "vision_query"
    cfg.SOLVER.MODEL_EMA = 0.999
    cfg.SOLVER.WARMUP_ITERS = 0  # one step: with the warmup's 1e-3 the fp32 norm weights would not move
    cfg.VISION_QUERY.TEXT_DROPOUT = 0.0


def _gdino_batch(cfg, g=14, seed=3):
    """A caption batch of 2 at 96x96 with gt in slots 0-2 and 13 (past the
    12 queries: the cut drops it), pixel xyxy boxes, two image sizes."""
    b = tb.synthetic_caption_batch(cfg, 2, HW, num_labels=3, k_shot=2, seed=seed)
    rng = np.random.default_rng(seed)
    boxes = np.zeros((2, g, 4), np.float32)
    valid = np.zeros((2, g), bool)
    tok = np.zeros((2, g, T), np.float32)
    for i in range(2):
        for j in (0, 1, 2, g - 1):
            x0, y0 = rng.uniform(0, 50, 2)
            boxes[i, j] = [x0, y0, x0 + rng.uniform(8, 40), y0 + rng.uniform(8, 40)]
            valid[i, j] = True
            tok[i, j] = b["agg_map"][i, j % 3]
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=boxes, gt_labels=np.ones((2, g), np.int32), gt_valid=valid, gt_token_map=tok,
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32),
                 image_sizes=np.array([[96, 96], [90, 80]], np.float32))
    return batch


def _jax_gdino_loss_fn(jmodel, merge, tx, jcfg, monkeypatch):
    """JAX's own GDINO loss function, taken out of `make_gdino_train_step`,
    over a deterministic model call."""
    captured = {}
    real = jtrain._finish_train_step

    def capture(loss_fn, tx_, ema):
        captured["loss_fn"] = loss_fn
        return real(loss_fn, tx_, ema)

    monkeypatch.setattr(jtrain, "_finish_train_step", capture)
    step = jtrain.make_gdino_train_step(
        lambda p, *a, deterministic, rngs: jmodel.apply(p, *a, deterministic=True), merge, tx, jcfg)
    return captured["loss_fn"], step


@pytest.fixture(scope="module")
def gpair():
    """JAX and port tiny GDINO models with the same (perturbed) weights, the
    decoder's box heads x BOX_SCALE (at init their deltas are too small for
    the box chain to reach the GCP gradients past 1e-5 of their size; at x10
    the missing stop-gradients move one by 1e-2, and no box saturates the
    inverse sigmoid's clamp), the vision_query recipe, the batch, and JAX's
    state."""
    jcfg, tcfg = jb.tiny_gdino_config(), tb.tiny_gdino_config()
    for c in (jcfg, tcfg):
        _train_mods(c)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    batch = _gdino_batch(tcfg)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    params = perturb(jb.init_params_fast(jmodel, *(jnp.asarray(batch[k]) for k in keys), seed=0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * BOX_SCALE if str(getattr(p[1], "key", "")).startswith("bbox_embed_") else v, params)
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    state, tx, merge = jtrain.init_train_state(params, jcfg, jax_trainable_patterns(jcfg))
    return dict(jmodel=jmodel, params=params, tmodel=no_dropout(tmodel), jcfg=jcfg, tcfg=tcfg, batch=batch,
                state=state, tx=tx, merge=merge, jbatch={k: jnp.asarray(v) for k, v in batch.items()})


def _port_step(gp):
    model = copy.deepcopy(gp["tmodel"])
    state, tx = tt.init_train_state(model, gp["tcfg"], trainable_patterns(gp["tcfg"]))
    return model, state, tt.make_gdino_train_step(model, tx, gp["tcfg"])


def _flax_paths(model):
    """{port parameter name: every flax path (with 'params/') its tensor fills}."""
    out = {}
    for path, (ref, _) in rule_table(model).items():
        out.setdefault(ref[0] if isinstance(ref, tuple) else ref, []).append("params/" + path)
    return out


def test_gcp_gradients_match_jax(gpair, monkeypatch):
    """The GDINO loss (set criterion over both decoder layers, gate loss) and
    its gradient w.r.t. every GCP parameter (the `vision_query` set): the
    port's training forward with dropout at 0 against JAX's loss function on
    its deterministic forward: the loss terms within rtol 1e-4, each
    gradient within 2e-4 of its largest value. It needs the decoder's two
    stop-gradients: without them the box losses reach BERT through the
    two-stage proposals."""
    gp = gpair
    loss_fn, _ = _jax_gdino_loss_fn(gp["jmodel"], gp["merge"], gp["tx"], gp["jcfg"], monkeypatch)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        gp["state"].trainable, gp["state"].frozen, gp["jbatch"], jax.random.PRNGKey(0))
    model, state, step = _port_step(gp)
    _, metrics = step(state, tt.batch_to_device(gp["batch"], "cpu"), torch.Generator().manual_seed(0))
    assert set(jlosses) <= set(metrics) and len(jlosses) == 7
    for k, v in jlosses.items():
        assert rel_err(v, metrics[k]) < 1e-4, k
    params = dict(model.named_parameters())
    paths = _flax_paths(model)
    assert len(state.trainable) == len(jgrads) > 10
    for n in state.trainable:
        (path,) = paths[n]
        want = np.asarray(jgrads[path])
        got = rule_table(model)[path[len("params/"):]][1](params[n].grad.numpy())
        assert rel_err(want, got) < 2e-4, n
    assert all(p.grad is None for n, p in params.items() if n not in state.trainable)


def test_gdino_train_step_matches_jax(gpair, monkeypatch):
    """One full step (the NaN guard, the optax chain, EMA) against JAX's
    `make_gdino_train_step` over the deterministic model call: trainable
    parameters and EMA within 1e-5 of their largest value; frozen
    parameters bitwise unchanged."""
    gp = gpair
    _, jstep = _jax_gdino_loss_fn(gp["jmodel"], gp["merge"], gp["tx"], gp["jcfg"], monkeypatch)
    jstate, jmetrics = jax.jit(jstep)(gp["state"], gp["jbatch"], jax.random.PRNGKey(0))
    model, state, step = _port_step(gp)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in state.trainable}
    before = {n: t.clone() for n, t in state.trainable.items()}
    state, metrics = step(state, tt.batch_to_device(gp["batch"], "cpu"), torch.Generator().manual_seed(0))
    assert rel_err(jmetrics["loss_total"], metrics["loss_total"]) < 1e-4
    assert state.step == 1 and state.opt_state["count"] == 1 and step.assignment.shape == (2, 2, 12)
    paths = _flax_paths(model)
    for n, t in state.trainable.items():
        (path,) = paths[n]
        tf = rule_table(model)[path[len("params/"):]][1]
        want = np.asarray(jstate.trainable[path])
        np.testing.assert_allclose(tf(t.numpy()), want, atol=1e-5 * np.abs(want).max(), err_msg=n)
        np.testing.assert_allclose(tf(state.ema[n].numpy()), np.asarray(jstate.ema[path]),
                                   atol=1e-5 * np.abs(want).max(), err_msg=n)
        assert not torch.equal(t, before[n]), n
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


def test_gdino_targets_cut_and_normalise(gpair):
    """Pixel xyxy -> cxcywh over (w, h) of `image_sizes` (JAX's formula,
    `make_gdino_train_step`), then the cut to G <= num_queries: the valid
    gt in slot 13 of 14 is dropped (12 queries), exactly."""
    batch = gpair["batch"]
    gt, valid, tok = tt.gdino_targets(tt.batch_to_device(batch, "cpu"), 12)
    b = batch["gt_boxes"]
    wh = batch["image_sizes"][:, None, ::-1]
    want = np.concatenate([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]], -1) / np.concatenate([wh, wh], -1)
    np.testing.assert_allclose(gt.numpy(), want[:, :12], rtol=1e-6)
    assert valid.shape == (2, 12) and tok.shape == (2, 12, T) and int(valid.sum()) == 6 == batch["gt_valid"].sum() - 2


def test_training_forward_draws_from_its_generator(gpair):
    """deterministic=False needs a generator; with dropout (stochastic depth
    0.5 here) the output moves, the same generator seed gives the same
    output, and with the rates at 0 it equals the deterministic forward
    within 1e-5."""
    from mqdet_torch.models.swin import SwinBlock

    batch = gpair["batch"]
    args = (torch.from_numpy(np.ascontiguousarray(batch["images"].transpose(0, 3, 1, 2))),
            torch.from_numpy(batch["input_ids"]).long(), torch.from_numpy(batch["attention_mask"]),
            torch.from_numpy(batch["queries"]), torch.from_numpy(batch["query_mask"]))
    model = copy.deepcopy(gpair["tmodel"])
    assert all(m.drop_path == 0.0 for m in model.modules() if isinstance(m, SwinBlock))  # no_dropout
    for m in model.modules():
        if isinstance(m, SwinBlock):
            m.drop_path = 0.5
    with torch.no_grad():
        ref = model(*args)["pred_boxes"]
        with pytest.raises(ValueError, match="Generator"):
            model(*args, deterministic=False)
        d1 = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))["pred_boxes"]
        d2 = model(*args, deterministic=False, generator=torch.Generator().manual_seed(1))["pred_boxes"]
        assert torch.equal(d1, d2) and rel_err(ref, d1) > 1e-3
        z = no_dropout(model)(*args, deterministic=False, generator=torch.Generator())["pred_boxes"]
    assert rel_err(ref, z) < 1e-5
    fresh = tb.build_model(gpair["tcfg"])
    rates = [m.drop_path for m in fresh.modules() if isinstance(m, SwinBlock)]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, len(rates)))  # the JAX model's Swin default


@pytest.mark.parametrize("recipe", ["vision_query", "full", "full_frozen_image", "language_prompt_v3"])
def test_partition_gates_and_groups_match_jax_on_gdino(gpair, recipe):
    """On a GroundingDINO model (its own rule table, chosen by the model):
    the trainable and frozen sets equal JAX's `partition_params` split of
    the flax tree (a torch in-proj tensor stands for its q, k and v
    leaves), every LR and WD group is JAX's for each of its leaves, and the
    gates are JAX's 0-d ff_gate / attn_gate leaves. Exact."""
    model = copy.deepcopy(gpair["tmodel"])
    params = gpair["params"]
    jtr, jfz, _ = jo.partition_params(params, jax_trainable_patterns(_recipe(gpair["jcfg"], recipe)))
    names, frozen = to.partition_params(model, trainable_patterns(_recipe(gpair["tcfg"], recipe)))
    paths = _flax_paths(model)
    assert sorted(p for n in names for p in paths[n]) == sorted(jtr)
    assert sorted(p for n in frozen for p in paths[n]) == sorted(jfz)
    tx = to.AdamW(_recipe(gpair["tcfg"], recipe), names, model)
    for n in names:
        for path in paths[n]:
            assert tx.lr[n] == jo.lr_group_for(path, gpair["jcfg"]), (n, path)
            assert tx.wd[n] == jo.wd_group_for(path, gpair["jcfg"]), (n, path)
    want_gates = [k for k, v in flat_params(params).items() if k.endswith(("ff_gate", "attn_gate")) and v.ndim == 0]
    gates = tl.gate_parameters(model.named_parameters(), model)
    assert sorted(p for n in gates for p in paths[n]) == sorted("params/" + k for k in want_gates)
    assert len(gates) >= 1
    with pytest.raises(KeyError, match="no flax counterpart"):  # MQ-GLIP's table does not know GDINO's names
        to.flax_path("bert.embeddings.word_embeddings.weight")


def _gdino_train_cfg(tmp):
    cfg = _loader_cfg(tb.tiny_gdino_config())
    _train_mods(cfg)
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    cfg.SOLVER.MAX_TO_KEEP = 2
    cfg.SOLVER.MAX_NEG_PER_BATCH = 1.0
    cfg.VISION_QUERY.TEXT_DROPOUT = 0.4
    return cfg


def test_train_runs_gdino_and_resumes(coco, tmp_path):
    """`tools/train.py::train` on tiny MQ-GroundingDINO, CPU: two iterations
    (text dropout, stochastic depth, attention dropout on) with every logged
    loss finite and the trainable set moved; then one iteration and a
    resumed run to two, equal to the straight run bitwise (parameters,
    Adam's moments, EMA)."""
    full, logs = _run_train(coco, tmp_path / "a", 2, False, _gdino_train_cfg)
    assert full.step == 2 and "iter 2/2" in logs[-1] and "loss_giou_0" in logs[-1]
    init = tb.init_params(tb.build_model(_gdino_train_cfg(tmp_path)), seed=0)
    p0 = dict(init.named_parameters())
    assert all(not torch.equal(t, p0[n].detach()) for n, t in full.trainable.items())
    _run_train(coco, tmp_path / "b", 1, False, _gdino_train_cfg)
    resumed, logs = _run_train(coco, tmp_path / "b", 2, True, _gdino_train_cfg)
    assert any("resumed from iteration 1" in line for line in logs)
    for n, t in full.trainable.items():
        assert torch.equal(t, resumed.trainable[n]), n
        assert torch.equal(full.ema[n], resumed.ema[n]), n
        assert torch.equal(full.opt_state["nu"][n], resumed.opt_state["nu"][n]), n


def test_ab_tool_fails_without_a_card(tmp_path):
    """`tools/perf_ab.py` measures only on a card: without one it exits
    non-zero and prints no result."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "mqdet_torch.tools.perf_ab", str(tmp_path)], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr
