"""The port's other language towers vs the JAX package: the copy of
`data/bpe_tokenizer.py` on hand-built merge tables (the CLIP merge file is
not in the repository), `CLIPTextTransformer` and `RNNEncoder` (LSTM and
GRU, both directions, padded rows) against the flax modules, and tiny
MQ-GLIP with MODEL.LANGUAGE_BACKBONE.MODEL_TYPE `clip` and `rnn` end to end
(features, head logits and boxes, the decoded detections of one chunk
group). Vision queries with those towers raise on both sides. A `.pth`
import reports the towers' and Swin v2's parameters missing as JAX's does
(its rule table names none).

Tolerances: the BPE copy must be equal; the towers in fp32 atol 1e-5 (the
RNN's states are bounded by 1); the models as `test_torch_port_slice.py`
(atol 1e-4 on features and boxes, 1e-3 on logits), the detections' scores
atol 1e-5 and boxes atol 1e-4 in pixels, labels and validity equal.
"""
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.data import bpe_tokenizer as jbpe
from mqdet_tpu.engine.predict import make_split_predict_fns as jax_split_fns
from mqdet_tpu.models import text_towers as jtt
from mqdet_tpu.utils import builders as jb
from mqdet_torch.data import bpe_tokenizer as tbpe
from mqdet_torch.engine.predict import make_split_predict_fns
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.models import text_towers as ttt
from mqdet_torch.utils import builders as tb
from test_torch_port_gcp_switches import load_sub
from test_torch_port_modules import flat_params, nchw, perturb, to_nhwc

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

MERGES = [("l", "o"), ("lo", "w</w>"), ("h", "e"), ("e", "r</w>"), ("lo", "w"), ("low", "er</w>"), ("c", "a"),
          ("ca", "t</w>"), ("Ã", "©")]
TEXTS = ["low lower", "hello, the lower cat!", "Crème brûlée &amp; cats' toys", "<|startoftext|>cat<|endoftext|>",
         "  spaced\tout\n  text  ", "éàü 123 ça"]


# ---- the BPE tokenizer copy ----------------------------------------------------


def test_bpe_copy_matches():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    jt, tt = jbpe.BPETokenizer(MERGES), tbpe.BPETokenizer(MERGES)
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert tt.decode(ids) == jt.decode(ids)
        for word in text.split():
            assert tt.bpe(word) == jt.bpe(word)
    assert tt.decode(tt.encode("low lower")).strip() == "low lower"
    for a, b in zip(tt.tokenize(TEXTS, context_length=12), jt.tokenize(TEXTS, context_length=12)):
        np.testing.assert_array_equal(a, b)


def test_bpe_vocab_file_copy_matches(tmp_path):
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    jt, tt = jbpe.BPETokenizer.from_vocab_file(str(path)), tbpe.BPETokenizer.from_vocab_file(str(path))
    assert tt.encoder == jt.encoder
    assert [tt.encode(t) for t in TEXTS] == [jt.encode(t) for t in TEXTS]


# ---- the towers ------------------------------------------------------------------


def tower_inputs(vocab, b=3, t=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, t))
    mask = np.ones((b, t), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def test_clip_tower_matches_flax():
    jm = jtt.CLIPTextTransformer(context_length=16, width=32, layers=2, heads=4, vocab_size=60)
    ids, mask = tower_inputs(60)
    params = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)), scale=0.1)
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    tm = ttt.CLIPTextTransformer(context_length=16, width=32, layers=2, heads=4, vocab_size=60).eval()
    load_sub(tm, params, "language_backbone/", "language_backbone.body.")
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in ("hidden", "aggregate", "embedded"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(want["masks"]))


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_rnn_tower_matches_flax(rnn_type, bidirectional):
    kw = dict(vocab_size=50, word_embedding_size=12, word_vec_size=16, hidden_size=8, rnn_type=rnn_type,
              bidirectional=bidirectional)
    jm = jtt.RNNEncoder(**kw)
    ids, mask = tower_inputs(50, seed=1)
    params = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)), scale=0.3)
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), deterministic=True)
    tm = ttt.RNNEncoder(**kw).eval()
    load_sub(tm, params, "language_backbone/", "language_backbone.body.")
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert set(got) == set(want) and got["hidden"].shape == (3, 10, 16 if bidirectional else 8)
    for k in ("hidden", "output", "embedded", "final_output", "aggregate"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)
    with torch.no_grad():  # no mask: the last step of every row
        np.testing.assert_allclose(tm(torch.from_numpy(ids))["final_output"].numpy(),
                                   np.asarray(jm.apply(params, jnp.asarray(ids))["final_output"]), atol=1e-5)


# ---- MQ-GLIP with the towers -------------------------------------------------------


HW = (64, 64)


def variant_pair(mods):
    """(jax model, jax params, torch model, jax cfg, torch cfg, batch) of tiny
    MQ-GLIP under `mods(cfg)` with the same weights (perturbed from JAX's
    init), and the numpy batch (2 chunks, 3 labels, 2 shots)."""
    jcfg, tcfg = jb.tiny_test_config(), tb.tiny_test_config()
    for cfg in (jcfg, tcfg):
        mods(cfg)
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
        cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 20
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    batch = jb.synthetic_batch(jcfg, 2, HW, num_labels=3, k_shot=2, seed=0)
    batch["attention_mask"][1, 12:] = 0
    q = jcfg.VISION_QUERY.ENABLED
    args = (jnp.asarray(batch["images"]), jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]),
            jnp.asarray(batch["queries"]) if q else None, jnp.asarray(batch["query_mask"]) if q else None)
    params = perturb(jb.init_params_fast(jmodel, *args, seed=0))
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return jmodel, params, tmodel, jcfg, tcfg, batch


def assert_end_to_end(jmodel, params, tmodel, jcfg, tcfg, batch):
    """Features, head logits and boxes of a forward, and the split
    functions' detections of one group of 2 chunks, against JAX."""
    cls = type(jmodel)
    q = jcfg.VISION_QUERY.ENABLED
    keys = ("input_ids", "attention_mask") + (("queries", "query_mask") if q else ())
    image = batch["images"][:1]
    feats = jmodel.apply(params, jnp.asarray(image), method=cls.encode_image)
    head = jmodel.apply(params, feats, *(jnp.asarray(batch[k]) for k in keys), method=cls.forward_head)
    with torch.no_grad():
        tfeats = tmodel.encode_image(nchw(image))
        thead = tmodel.forward_head(tfeats, *(torch.from_numpy(batch[k]) for k in keys))
    for w, t in zip(feats, tfeats):
        np.testing.assert_allclose(to_nhwc(t), np.asarray(w), atol=1e-4, rtol=1e-4)
    for w, t in zip(head["dot_product_logits"], thead["dot_product_logits"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4)
    for w, t in zip(head["bbox_reg"], thead["bbox_reg"]):
        np.testing.assert_allclose(to_nhwc(t), np.asarray(w), atol=1e-4, rtol=1e-4)

    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map", "image_sizes")
    jenc, jhead = jax_split_fns(jmodel, HW, jcfg)
    want = jhead(params, jenc(params, jnp.asarray(image)), *(jnp.asarray(batch[k]) for k in order))
    tenc, thead_fn = make_split_predict_fns(tmodel, HW, tcfg)
    got = thead_fn(tenc(nchw(image)), *(torch.from_numpy(batch[k]) for k in order))
    v = np.asarray(want.valid)
    assert v.sum() >= 10, "too few detections to compare"
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)


def tower(kind):
    def mods(cfg):
        cfg.MODEL.LANGUAGE_BACKBONE.MODEL_TYPE = kind
        cfg.VISION_QUERY.ENABLED = False  # the towers take no vision queries
    return mods


@pytest.mark.parametrize("kind", ["clip", "rnn"])
def test_mq_glip_with_tower_matches_jax(kind):
    pair = variant_pair(tower(kind))
    body = pair[2].language_backbone.body
    assert isinstance(body, ttt.CLIPTextTransformer if kind == "clip" else ttt.RNNEncoder)
    if kind == "rnn":  # a direction is LANG_DIM // 2 wide
        assert body.cell_fwd.hidden == pair[4].MODEL.LANGUAGE_BACKBONE.LANG_DIM // 2
    assert_end_to_end(*pair)


@pytest.mark.parametrize("kind", ["clip", "rnn"])
def test_vision_queries_with_tower_raise(kind):
    jmodel, params, tmodel, jcfg, _, batch = variant_pair(tower(kind))
    keys = ("input_ids", "attention_mask", "queries", "query_mask")
    cls = type(jmodel)
    feats = jmodel.apply(params, jnp.asarray(batch["images"][:1]), method=cls.encode_image)
    with pytest.raises(AssertionError, match="vision queries require the bert language backbone"):
        jmodel.apply(params, feats, *(jnp.asarray(batch[k]) for k in keys), method=cls.forward_head)
    with torch.no_grad(), pytest.raises(ValueError, match="vision queries require the bert language backbone"):
        tmodel.forward_head(tmodel.encode_image(nchw(batch["images"][:1])), *(torch.from_numpy(batch[k])
                                                                              for k in keys))


@pytest.mark.parametrize("variant", ["clip", "rnn", "Swin v2"])
def test_pth_import_reports_the_new_parameters_missing_as_jax(variant, tmp_path):
    """The JAX package's rule table names no CLIP / RNN tower or Swin v2
    parameter: a reference-layout `.pth` of the model (its own keys) imports
    with those leaves missing and their keys unused, on both sides alike."""
    from mqdet_tpu.io import torch_import as JI
    from mqdet_torch.io import torch_import as TI

    def mods(cfg):
        if variant == "Swin v2":
            cfg.MODEL.SWINT.VERSION = "v2"
        else:
            tower(variant)(cfg)

    jmodel, params, tmodel, *_ = variant_pair(mods)
    path = tmp_path / "w.pth"
    torch.save({"model": {k: v.clone() for k, v in tmodel.state_dict().items()}}, path)
    _, jrep = JI.import_glip_checkpoint(params, JI.load_torch_state_dict(str(path)))
    trep = TI.import_glip_checkpoint(tmodel, TI.load_torch_state_dict(str(path)))
    for k in ("matched", "missing", "unused"):
        assert sorted(trep[k]) == sorted(jrep[k]), k
    new = "language_backbone" if variant != "Swin v2" else "attn/"
    assert trep["missing"] and all(new in n for n in trep["missing"])
    assert trep["unused"] and len(trep["matched"]) > 100
