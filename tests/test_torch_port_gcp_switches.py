"""MQ-Det's GCP switches in the port against the JAX package, on the CPU in
fp32: the Gated Class-scalable Perceiver's VISION_QUERY variants, the
learnable query bank, gate telemetry, and the gate loss and trainable sets
they change.

Weights go through the bridge (`io/from_jax.py`, the JAX package's rule table
plus `port_rules`); inputs are made from numpy seeds. Every parameter of the
JAX side is perturbed by normal(0.05) first, so that zero-initialised gates
and prompts are not zero. Tolerances are stated per test: 1e-5 on modules
and on the tiny model's logits relative to their largest value.
"""
from __future__ import annotations

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.core.config import trainable_patterns as jax_trainable_patterns
from mqdet_tpu.engine import losses as jl
from mqdet_tpu.engine import optim as jo
from mqdet_tpu.models import bert as jbert
from mqdet_tpu.mq import bank as jbank
from mqdet_tpu.mq import selector as jsel
from mqdet_tpu.utils import builders as jb
from mqdet_torch.core.config import trainable_patterns
from mqdet_torch.engine import losses as tl
from mqdet_torch.engine import optim as to
from mqdet_torch.io.from_jax import inverse_transform, params_from_jax, rule_table
from mqdet_torch.models import bert as tbert
from mqdet_torch.mq import bank as tbank
from mqdet_torch.mq import selector as tsel
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import HW, flat_params, nchw

torch.set_num_threads(2)

OB, LB = "language_backbone/bert/", "language_backbone.body.model."


def perturb(variables, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32) * scale)
        if np.issubdtype(np.asarray(v).dtype, np.floating) else v, variables)


def load_sub(module: torch.nn.Module, variables, flax_prefix: str, port_prefix: str) -> None:
    """Fill a standalone port module from a standalone JAX module's variables
    by the bridge's rules at the prefixes the full model gives them."""
    rules, sd, out = rule_table(), module.state_dict(), {}
    for name, val in flat_params(variables).items():
        full = ("batch_stats/" + flax_prefix + name[len("batch_stats/"):] if name.startswith("batch_stats/")
                else flax_prefix + name)
        ref, tf = rules[full]
        key = ref[len(port_prefix):]
        out[key] = torch.from_numpy(inverse_transform(tf, val, tuple(sd[key].shape)).copy())
    assert sorted(out) == sorted(sd)
    module.load_state_dict(out)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_gates(inter) -> list:
    return [float(np.mean(np.asarray(v, np.float32))) for v in jax.tree_util.tree_leaves(inter)]


# ------------------------------------------------------------ GCP variants

BLOCK = {
    "no_cat_off": dict(no_cat=False),
    "fix_attn_gate": dict(fix_attn_gate=0.25),
    "add_adapt_layer": dict(add_adapt_layer=True),
    "share_kv": dict(share_kv=True),
    "condition_gate_off": dict(condition_gate=False),
    "nonlinear_gate_off": dict(nonlinear_gate=False),
}


def _block_case(kw, rng):
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    vision = rng.standard_normal((2, 5, 24)).astype(np.float32)
    mask = (rng.random((2, 5, 6)) > 0.4).astype(np.float32)
    mask[0, :, 0] = 0  # a token no query may be attended by
    jm = jbert.GatedCrossAttentionBlock(dim=32, **kw)
    args = tuple(map(jnp.asarray, (x, vision, mask)))
    variables = perturb(jm.init(jax.random.PRNGKey(0), *args))
    want, inter = jm.apply(variables, *args, mutable=["intermediates"])
    tm = tbert.GatedCrossAttentionBlock(32, 24, **kw)
    load_sub(tm, variables, OB + "qv_layer_0/", LB + "encoder.qv_layer.0.")
    with torch.no_grad(), tbert.gate_telemetry() as gates:
        got = tm(*map(torch.from_numpy, (x, vision, mask)))
    return got, want, [float(g) for g in gates], jax_gates(inter)


def _preselect_case(rng):
    vision = rng.standard_normal((2, 5, 16)).astype(np.float32)
    image = rng.standard_normal((2, 12, 16)).astype(np.float32)
    jm = jbert.PreSelectModule(dim=16, out_dim=32, num_layers=2, augment_image_with_query=True)
    variables = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(vision), jnp.asarray(image)))
    want = jm.apply(variables, jnp.asarray(vision), jnp.asarray(image))
    tm = tbert.PreSelectModule(16, 32, 2, 1.0, augment_image_with_query=True)
    load_sub(tm, variables, OB + "pre_select/", LB + "pre_select.")
    with torch.no_grad():
        got = tm(torch.from_numpy(vision), torch.from_numpy(image))
    return got, want, [], []


def _mask_token_case(rng):
    cfg = tb.tiny_test_config()
    cfg.MODEL.LANGUAGE_BACKBONE.VOCAB_SIZE = 200
    cfg.VISION_QUERY.NEW_MASK_TOKEN = True
    ids = rng.integers(1, 200, (2, 8)).astype(np.int32)
    ids[:, 2] = ids[1, 5] = 103
    am = np.ones((2, 8), np.int32)
    am[1, 6:] = 0
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    qm = (rng.random((2, 4, 8)) > 0.3).astype(np.float32)
    image = rng.standard_normal((2, 12, 16)).astype(np.float32)
    jm = jbert.QVBertModel(num_layers=2, hidden_size=32, num_heads=2, intermediate_size=64, vocab_size=200,
                           start_qv_layer=1, vision_dim=16, new_mask_token=True)
    args = tuple(map(jnp.asarray, (ids, am, q, qm, image)))
    variables = perturb(jm.init(jax.random.PRNGKey(3), *args))
    want, inter = jm.apply(variables, *args, mutable=["intermediates"])
    tm = tbert.QVBertModel(cfg, vision_dim=16)
    load_sub(tm, variables, OB, LB)
    with torch.no_grad(), tbert.gate_telemetry() as gates:
        got = tm(*(torch.from_numpy(a) for a in (ids.astype(np.int64), am, q, qm, image)))
    assert not np.allclose(np.asarray(variables["params"]["mask_token"]), 0)
    return got["last_hidden"], want["last_hidden"], [float(g) for g in gates], jax_gates(inter)


@pytest.mark.parametrize("variant", [*BLOCK, "preselect_augment_image_with_query", "qvbert_new_mask_token"])
def test_gcp_variant_matches_jax(variant):
    """Each GCP variant against its JAX module, the weights carried by the
    bridge: the output within 1e-5 of its largest value, and each block's
    gate telemetry (JAX's sown `attn_gate_value`) within 1e-6."""
    rng = np.random.default_rng(7)
    if variant in BLOCK:
        got, want, gates, want_gates = _block_case(BLOCK[variant], rng)
    elif variant.startswith("preselect"):
        got, want, gates, want_gates = _preselect_case(rng)
    else:
        got, want, gates, want_gates = _mask_token_case(rng)
    assert rel(got.numpy(), want) < 1e-5
    assert len(gates) == len(want_gates)
    np.testing.assert_allclose(gates, want_gates, rtol=1e-6, atol=1e-7)
    if variant == "fix_attn_gate":
        assert gates == [0.25]


def test_telemetry_is_off_outside_its_context():
    """Outside `gate_telemetry` a GCP block records nothing and its output
    is bitwise the one inside."""
    tm = tbert.GatedCrossAttentionBlock(16, 8)
    x, v = torch.randn(1, 3, 16), torch.randn(1, 2, 8)
    with torch.no_grad():
        a = tm(x, v)
        with tbert.gate_telemetry() as gates:
            b = tm(x, v)
    assert tbert._TELEMETRY is None and len(gates) == 1 and torch.equal(a, b)


# ------------------------------------------------------- the S1 model

S1_VQ = dict(NO_CAT=False, ADD_ADAPT_LAYER=True, SHARE_KV=True, AUGMENT_IMAGE_WITH_QUERY=True,
             NEW_MASK_TOKEN=True, ADD_VISION_LAYER=True, QUERY_FUSION=True, LEARNABLE_BANK=True)
LABELS = (3, 7, 9)


def s1_mods(cfg):
    for k, v in S1_VQ.items():
        cfg.VISION_QUERY[k] = v
    cfg.MODEL.DYHEAD.FUSE_CONFIG.ADD_LINEAR_LAYER = True
    cfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS = True


def bank_pair(channels=16, seed=0):
    """The same bank in both packages: 3 labels x 4 queries."""
    rng = np.random.default_rng(seed)
    banks = jbank.QueryBank(channels=channels, capacity=6), tbank.QueryBank(channels=channels, capacity=6)
    for lab in LABELS:
        for _ in range(4):
            f = rng.standard_normal((1, 1, channels)).astype(np.float32)
            for b in banks:
                b.add(lab, f)
    return banks


def bank_setup(mods, batch=2, seed=0):
    """JAX and port MQ-GLIP on the tiny config with `mods` (LEARNABLE_BANK
    among them): the selectors' int32 indices for a caption of LABELS, the
    JAX bank installed by JAX's `install_learnable_bank`, then the weights
    carried across. Returns a dict."""
    jcfg, tcfg = jb.tiny_test_config(), tb.tiny_test_config()
    for c in (jcfg, tcfg):
        mods(c)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jbk, tbk = bank_pair()
    js = jsel.QuerySelector(jbk, num_query_per_class=2, max_labels=4, emit_indices=True)
    ts = tsel.QuerySelector(tbk, num_query_per_class=2, max_labels=4, emit_indices=True)
    b = jb.synthetic_batch(jcfg, batch, HW, num_labels=3, k_shot=2, seed=seed)
    loc = np.zeros((4, b["input_ids"].shape[1]), np.float32)
    for j in range(3):
        loc[j, 2 * j + 1:2 * j + 3] = 1
    qs, qms = [], []
    for i, labels in enumerate((LABELS, LABELS[1:])):
        random.seed(i)  # both selectors draw from the module-level `random`
        a = js.select(list(labels), loc)
        random.seed(i)
        t = ts.select(list(labels), loc)
        for x, y in zip(a, t):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        qs.append(t[0])
        qms.append(t[1])
    q, qm = np.stack(qs)[:batch], np.stack(qms)[:batch]
    ids = b["input_ids"].copy()
    ids[:, 3] = 103
    jmodel = jb.build_model(jcfg, bank_shape=js.bank_table_shape())
    args = (b["images"], ids, b["attention_mask"], q, qm)
    params = perturb(jb.init_params_fast(jmodel, *map(jnp.asarray, args)))
    params = jb.install_learnable_bank(jax.tree_util.tree_map(lambda v: v, params), js)
    tmodel = tb.build_model(tcfg, bank_shape=ts.bank_table_shape()).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, jcfg=jcfg, tcfg=tcfg, args=args, js=js, ts=ts,
                tbank=tbk)


@pytest.fixture(scope="module")
def s1():
    return bank_setup(s1_mods)


def torch_args(args):
    images, ids, am, q, qm = args
    return nchw(images), torch.from_numpy(ids).long(), torch.from_numpy(am), torch.from_numpy(q), \
        torch.from_numpy(qm)


def levels(ts) -> np.ndarray:
    """A head output's levels (NCHW maps or (B, N, T)) flattened in JAX's NHWC order."""
    return np.concatenate([(t if t.dim() == 3 else t.permute(0, 2, 3, 1)).numpy().reshape(-1) for t in ts])


def test_s1_model_matches_jax(s1, monkeypatch):
    """The tiny MQ-GLIP with every S1 switch (NO_CAT off, ADD_ADAPT_LAYER,
    SHARE_KV, AUGMENT_IMAGE_WITH_QUERY, NEW_MASK_TOKEN, ADD_VISION_LAYER,
    QUERY_FUSION, LEARNABLE_BANK with int32 queries, ADD_LINEAR_LAYER,
    MLM_LOSS) end to end on the exact DCN route: dot-product logits, boxes,
    centerness (all levels) and `mlm_logits`, each within 1e-5 of its
    largest value;
    the gate telemetry (the query-fusion block's included) within 1e-6."""
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    jmodel, params, tmodel = s1["jmodel"], s1["params"], s1["tmodel"]
    want, inter = jax.jit(lambda p, *a: jmodel.apply(p, *a, mutable=["intermediates"]))(
        params, *map(jnp.asarray, s1["args"]))
    with torch.no_grad(), tbert.gate_telemetry() as gates:
        got = tmodel(*torch_args(s1["args"]))
    assert rel(got["mlm_logits"].numpy(), want["mlm_logits"]) < 1e-5
    assert got["mlm_logits"].shape == (2, 16, 30522)
    for key in ("dot_product_logits", "bbox_reg", "centerness"):
        assert rel(levels(got[key]), np.concatenate([np.asarray(w).reshape(-1) for w in want[key]])) < 1e-5, key
    want_gates = jax_gates(inter)
    assert len(gates) == len(want_gates) == 2  # one qv layer + the query-fusion block
    np.testing.assert_allclose([float(g) for g in gates], want_gates, rtol=1e-6)


def test_learnable_bank_indices_install_and_gradients(monkeypatch):
    """LEARNABLE_BANK on the tiny config (JAX tests/test_mq.py:242-300): the
    selectors' indices bitwise equal (checked in `bank_setup`), padded slots
    (0, 0) with an all-zero mask row; `install_learnable_bank` writes JAX's
    table; with every gate nudged by +0.3, the bank's gradient of
    sum |level-0 dot-product logits| equals JAX's within 1e-5 of its largest
    value and is non-zero exactly on the entries either image selected."""
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")

    def mods(cfg):
        cfg.VISION_QUERY.LEARNABLE_BANK = True

    s = bank_setup(mods)  # batch 2: torch's GroupNorm refuses one value a group at the 1x1 level
    q, qm = s["args"][3], s["args"][4]
    assert q.dtype == np.int32 and q.shape == (2, 8, 2)
    padded = ~qm.any(-1)
    assert padded.any() and (q[padded] == 0).all()
    fresh = tb.build_model(s["tcfg"], bank_shape=s["ts"].bank_table_shape())
    tb.install_learnable_bank(fresh, s["ts"])
    np.testing.assert_array_equal(fresh.qv_layer_learnable_bank.detach().numpy(),
                                  np.asarray(s["params"]["params"]["qv_layer_learnable_bank"]))
    np.testing.assert_array_equal(fresh.qv_layer_learnable_bank[0, 0].detach().numpy(),
                                  s["tbank"].get(3)[0, 0])

    def nudge(path, v):
        return v + 0.3 if "gate" in "/".join(str(getattr(k, "key", k)) for k in path) else v

    params = jax.tree_util.tree_map_with_path(nudge, s["params"])
    jmodel = s["jmodel"]

    def loss(p):
        o = jmodel.apply(p, *map(jnp.asarray, s["args"]), deterministic=True)
        return jnp.sum(jnp.abs(o["dot_product_logits"][0].astype(jnp.float32)))

    want = np.asarray(jax.jit(jax.grad(loss))(params)["params"]["qv_layer_learnable_bank"])
    tmodel = tb.build_model(s["tcfg"], bank_shape=s["ts"].bank_table_shape())
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    out = tmodel(*torch_args(s["args"]))
    out["dot_product_logits"][0].abs().sum().backward()
    got = tmodel.qv_layer_learnable_bank.grad.numpy()
    assert rel(got, want) < 1e-5
    selected = {tuple(int(i) for i in r) for r, m in zip(q.reshape(-1, 2), qm.reshape(-1, qm.shape[-1])) if m.any()}
    hit = {tuple(int(i) for i in ix) for ix in np.argwhere(np.abs(got).sum(-1) > 0)}
    assert hit == selected and len(selected) < 12


def test_init_params_fills_only_the_keys_given():
    """`init_params(..., keys=)` fills only those entries, by the same rule
    and in state_dict order from its own generator; the others stay."""
    cfg = tb.tiny_test_config()
    cfg.VISION_QUERY.CONDITION_GATE = False
    model = tb.build_model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gates = [k for k in before if k.endswith(("attn_gate", "ff_gate"))]
    keys = set(gates) | {gates[0].replace("attn_gate", "attn.norm.weight"), gates[0].replace("attn_gate", "attn.norm.bias")}
    assert len(gates) >= 2 and keys <= set(before)
    tb.init_params(model, seed=3, keys=keys)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k not in keys)
    draws = np.random.default_rng(3).standard_normal(len(gates)).astype(np.float32) * 0.02
    np.testing.assert_array_equal(np.array([float(after[k]) for k in gates]), draws)
    assert (after[gates[0].replace("attn_gate", "attn.norm.weight")] == 1).all()
    assert (after[gates[0].replace("attn_gate", "attn.norm.bias")] == 0).all()


# ------------------------------------------------------ gate loss, recipes


GATE_MODES = {"condition_gate_off": ("CONDITION_GATE", False), "fix_attn_gate": ("FIX_ATTN_GATE", 0.25)}


@pytest.mark.parametrize("mode", list(GATE_MODES))
def test_gate_loss_under_gate_switches_matches_jax(mode):
    """CONDITION_GATE off: the gate set is JAX's (every 0-d ff_gate and
    attn_gate leaf; `flax_is_scalar` holds for both), the loss within 1e-6
    and its gradient under GATE_REGULARIZATION. FIX_ATTN_GATE: no gate
    parameter, a zero loss, as JAX's."""
    key, value = GATE_MODES[mode]
    from test_torch_port_modules import tiny_pair

    def mods(cfg):
        cfg.VISION_QUERY[key] = value

    _, params, tmodel, _, _ = tiny_pair(mods)
    want_names = [n for n, v in flat_params(params).items() if n.endswith(("ff_gate", "attn_gate")) and v.ndim == 0]
    gates = tl.gate_parameters(tmodel.named_parameters(), tmodel)
    assert sorted(to.flax_path(n, tmodel) for n in gates) == sorted(want_names)
    for n, p in gates.items():
        assert to.flax_is_scalar(n, p.shape, tmodel)
    trainable = {"params/" + n: jnp.asarray(v) for n, v in flat_params(params).items()}
    want, jgrad = jax.value_and_grad(lambda t: jl.gate_loss_from_params(t, scale=0.7, regularize=True))(trainable)
    got = tl.gate_loss_from_params(tmodel.named_parameters(), scale=0.7, regularize=True, model=tmodel)
    if mode == "fix_attn_gate":
        assert not gates and float(want) == float(got) == 0.0
        return
    assert len(gates) == 2 and abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    got.backward()
    for n, p in gates.items():
        np.testing.assert_allclose(p.grad.numpy().reshape(()), np.asarray(jgrad["params/" + to.flax_path(n, tmodel)]),
                                   rtol=1e-6)


RECIPES = ["vision_query_v3", "vision_query_v5", "query_prompt", "query_prompt_v2", "vision_language_prompt",
           "language_prompt_v1", "language_prompt_v2", "language_prompt_v3", "language_prompt_v4",
           "language_prompt_v5"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_trainable_set_under_recipes_matches_jax(s1, recipe):
    """The finetuning recipes over the S1 model's parameters (bank, prompts,
    adaptor, mask token, query-fusion block, MLM head): the trainable set,
    each LR and WD group, exactly JAX's on the flax paths."""
    jcfg, tcfg = s1["jcfg"].clone(), s1["tcfg"].clone()
    jcfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = tcfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = recipe
    model = copy.deepcopy(s1["tmodel"])
    jtr, jfz, _ = jo.partition_params(s1["params"], jax_trainable_patterns(jcfg))
    names, frozen = to.partition_params(model, trainable_patterns(tcfg))
    assert sorted("params/" + to.flax_path(n, model) for n in names) == sorted(jtr)
    assert sorted("params/" + to.flax_path(n, model) for n in frozen) == sorted(jfz)
    tx = to.AdamW(tcfg, names, model)
    for n in names:
        path = "params/" + to.flax_path(n, model)
        assert tx.lr[n] == jo.lr_group_for(path, jcfg) and tx.wd[n] == jo.wd_group_for(path, jcfg), n
    if recipe == "vision_query_v5":
        assert {"qv_layer_learnable_bank", "rpn.head.tunable_linear.weight"} <= set(names)


# ------------------------------------------------------------- telemetry


def test_run_inference_attn_gate_value_matches_jax(tmp_path, monkeypatch):
    """RETURN_ATTN_GATE_VALUE through `run_inference` (test_torch_port_eval's
    setting, 2 landscape images: 8 classes in chunks of 3, groups of 2):
    `attn_gate_value` within 1e-6 of JAX's; the detections bitwise those of
    the same run without the flag, the AP fields equal."""
    monkeypatch.setenv("MQDET_DEFORM_IMPL", "gather")
    from mqdet_torch.data import coco as tcoco
    from mqdet_torch.data import tokenizer as ttok
    from mqdet_torch.engine import evaluator as tev
    from mqdet_torch.engine import inference as tinf
    from test_torch_port_eval import CATEGORIES, both_runs, eval_settings, recording, seeded_banks, selectors
    from test_torch_port_modules import tiny_pair
    from test_torch_port_querybank import write_coco

    def settings(cfg):
        eval_settings(cfg, "glip")

    def flag(cfg):
        cfg.VISION_QUERY.RETURN_ATTN_GATE_VALUE = True

    ann, img = write_coco(tmp_path, [(60, 80)] * 2, boxes_per_image=3, categories=CATEGORIES, seed=5)
    ds = tcoco.CocoDetectionDataset(ann, img)
    data = ann, img, {ds.cat_id_to_contiguous[c["id"]]: c["frequency"] for c in ds.categories}
    pair = tiny_pair(settings)
    want, got, _, trec = both_runs(pair, data, flag)
    assert abs(got["attn_gate_value"] - want["attn_gate_value"]) <= 1e-6 * abs(want["attn_gate_value"])
    assert got["attn_gate_value"] > 0
    trec_off = recording(tev.DetectionEvaluator)(style="lvis_fixed", max_dets=300, category_frequency=data[2])
    random.seed(0)
    off = tinf.run_inference(pair[4], pair[2], ds, ttok.WordPieceTokenizer(), selectors(pair[4], seeded_banks())[1],
                             evaluator=trec_off, verbose=False)
    assert "attn_gate_value" not in off
    assert trec.seen.keys() == trec_off.seen.keys()
    for img_id, dets in trec.seen.items():
        for a, b in zip(dets, trec_off.seen[img_id]):
            np.testing.assert_array_equal(a, b)
    for key in ("AP", "APr", "APc", "APf"):
        assert got[key] == off[key] or (np.isnan(got[key]) and np.isnan(off[key])), key
