"""The port's evaluation CLI slice vs the JAX package: the yaml reader
(against PyYAML on every shipped config, and its refusals), every shipped
config merged into the port's tree against the JAX package's, the dotted
overrides, `dump_yaml`, the `.pth` import's report and the forward after it,
`load_params_npz` on a JAX `save_params_npz` file, the copies of
`flickr_eval`, `tsv` and `datasets_extra`, `check_expected_results`, the
extraction presets, and `mqdet_torch.tools.eval.main` against the JAX
package's `tools/eval.py` `main`.

The CLI cases run both CLIs in process on the CPU on one yaml (a
`dump_yaml` of the tiny config with `test_torch_port_eval.py`'s evaluation
settings, thresholds at 0), one reference-layout `.pth` (a `module.` prefix
and a `model_ema` sibling holding the weights evaluated), one bank and the
same files on disk (PNG / JPEG images both read with PIL): COCO and LVIS
fixed AP for both families, VOC and phrase grounding for MQ-GLIP. Tiny
configs in fp32. The JAX side's split functions and model init are built
once per family and bucket for the module (their jit compiles dominate).
Tolerances: results and bbox.csv values 1e-6; the forward after the
import: features and scores atol 1e-5, boxes atol 1e-5 of the bucket's
longer side.
"""
import ast
import csv
import glob
import importlib
import json
import math
import os
import sys
import xml.etree.ElementTree as ET

import jax
import numpy as np
import pytest
import torch
import yaml

from mqdet_tpu.core import config as jconfig
from mqdet_tpu.engine import eval_dispatch as jdisp
from mqdet_tpu.engine import evaluator as jev
from mqdet_tpu.engine import inference as jinf
from mqdet_tpu.engine import predict as jpredict
from mqdet_tpu.io import checkpoints as jckpt
from mqdet_tpu.io import torch_import as JI
from mqdet_tpu.mq import bank as jbank
from mqdet_tpu.utils import builders as jb
from mqdet_torch.core import config as tconfig
from mqdet_torch.core import yaml_lite
from mqdet_torch.engine import evaluator as tev
from mqdet_torch.engine import predict as tpredict
from mqdet_torch.io import torch_import as TI
from mqdet_torch.io.checkpoints import load_params_npz
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.utils import builders as tb
from test_torch_port_eval import eval_settings
from test_torch_port_modules import flat_params, nchw
from test_torch_port_querybank import LVIS_NAMES, SCALES, write_coco

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                                               recursive=True))
CATEGORIES = [{"id": 10 + 3 * i, "name": n, "frequency": "rcf"[i % 3]} for i, n in enumerate(LVIS_NAMES[:8])]


def same_tree(a, b, path=""):
    """Equal keys, values and value types (tuples and lists apart), read as
    plain dicts."""
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            same_tree(a[k], b[k], f"{path}.{k}")
        return
    assert type(a).__name__ == type(b).__name__ and a == b, (path, a, b)


# ---- (a) the yaml reader ------------------------------------------------------


def test_every_shipped_config_is_counted():
    assert len(CONFIGS) == 61


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_lite_reads_every_shipped_config_as_pyyaml(path):
    """The reader's tree equals PyYAML's, value types included (a wrong fold
    of a multi-line quoted scalar would still give valid JSON with a wrong
    class name, so the tree is compared, not "it parses")."""
    text = open(os.path.join(REPO, path), encoding="utf-8").read()
    want = yaml.safe_load(text)
    same_tree(yaml_lite.safe_load(text), want)
    if isinstance(want.get("DATASETS", {}).get("OVERRIDE_CATEGORY"), str):
        json.loads(yaml_lite.safe_load(text)["DATASETS"]["OVERRIDE_CATEGORY"])


ACCEPTED = {
    "resolution": "a: 1e-4\nb: 1.0e-4\nc: 010\nd: 0x1F\ne: 1_000\nf: 1:30\ng: .inf\nh: -.Inf\ni: ~\nj:\n"
                  "k: Yes\nl: off\nm: +12\nn: -1.5e+3\no: 1.5:30.2\np: 0b101\nq: .NaN_\nr: 0.\n",
    "quoted": "n: \"x\\ty\\u00e9\\x41\\N\\L\\\\\"\no: 'it''s'\ns: \"a\n  b\n\n  c\"\nt: 'a \n   b'\n"
              "u: \"x\\\n   y\"\nv: ''\nw: \"\"\n",
    "flow": "p: [1, [2, 3], {a: b, c: [d]}]\nq: {}\nr: []\nk: [a, b\n  , c]\nz: [a,]\n",
    "sequences": "A:\n- x\n- y\nB:\n  - 1\n  -\n  - [a]\nC: 2\n",
    "keys and comments": "# c\n\n  # c2\n\"q k\": 1\n's k': 2\ntrue: 3\n1: 4\na: b # c\nd: b#c\n",
    "nesting": "a:\n  b:\n    - 1\n  c: 2\nd: 3\n",
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_yaml_lite_matches_pyyaml_inside_its_subset(case):
    got, want = yaml_lite.safe_load(ACCEPTED[case]), yaml.safe_load(ACCEPTED[case])
    assert repr(got) == repr(want)


REFUSED = {
    "anchor": "a: &x 1\n", "alias": "a: *x\n", "tag": "a: !!str 1\n", "literal block": "a: |\n  x\n",
    "folded block": "a: >\n  x\n", "complex key": "? a\n: b\n", "multi-line plain": "a: [b\n  c]\n",
    "compact mapping in a sequence": "- a: 1\n", "document marker": "--- \na: 1\n",
    "timestamp": "a: 2001-01-01\n", "tab indentation": "a:\n\t- b\n", "directive": "%YAML 1.1\na: 1\n",
    "pair in a flow sequence": "a: [b: c]\n", "unterminated quote": "a: \"x\n", "nested entry": "- - 1\n",
    "merge key": "<<: 1\n", "flow set": "a: {b}\n",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_yaml_lite_refuses_outside_its_subset(case):
    with pytest.raises(ValueError, match=r"^line \d+: "):
        yaml_lite.safe_load(REFUSED[case])


def test_dump_yaml_reads_back_equal():
    """The port's dump of the default tree, the tiny configs and a tree of
    awkward scalars: `yaml_lite` and PyYAML both read it back equal (tuples
    as lists), and merged into a default tree it gives the config back."""
    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return [plain(x) for x in v] if isinstance(v, (list, tuple)) else v

    odd = {"s": ["yes", "null", "1e-4", "a: b", "#x", "'q'", '"d"', "tab\there", "nl\nx", "é ✓", "\x85\u2028",
                 "", " lead", "trail "],
           "f": [1e-05, 1e16, -2.5e-300, 0.1, 3.0, float("inf"), -float("inf")], "i": [0, -7, 10**12],
           "n": None, "b": [True, False], "e": {}, "l": [], "nested": [[800, 1344], [1344, 800]],
           "odd key": 1, "true": 2}
    for tree in (tconfig.default_config(), tb.tiny_test_config(), tb.tiny_gdino_config(), odd):
        text = yaml_lite.dump(tree)
        assert plain(yaml_lite.safe_load(text)) == plain(tree) == plain(yaml.safe_load(text))
    cfg = tb.tiny_gdino_config()
    back = tconfig.default_config()
    back.merge_from_other(yaml_lite.safe_load(cfg.dump_yaml()))
    assert plain(back) == plain(cfg)  # nested sequences come back as lists in a tuple, as in JAX
    assert math.isnan(yaml_lite.safe_load(yaml_lite.dump({"x": float("nan")}))["x"])


# ---- (b) shipped configs and overrides ------------------------------------------


@pytest.mark.parametrize("path", CONFIGS)
def test_shipped_config_merges_into_the_port_tree_as_into_jax(path):
    t, j = tconfig.default_config(), jconfig.default_config()
    t.merge_from_file(os.path.join(REPO, path))
    j.merge_from_file(os.path.join(REPO, path))
    same_tree(t, j)


OPTS = [
    ["SOLVER.BASE_LR", "1e-4"], ["SOLVER.MAX_ITER", "10"], ["SOLVER.MAX_ITER", "10.0"],
    ["TPU.IMAGE_BUCKETS", "[[800, 1344]]"], ["TPU.IMAGE_BUCKETS", "((64, 96),)"],
    ["VISION_QUERY.ENABLED", "True"], ["VISION_QUERY.ENABLED", "false"], ["VISION_QUERY.ENABLED", "1"],
    ["MODEL.ATSS.INFERENCE_TH", "0"], ["DATASETS.TEST", "['lvis_val']"], ["DATASETS.TEST", "lvis_val"],
    ["MODEL.WEIGHT", "x.pth"], ["MODEL.WEIGHT", "123"], ["TEST.EXPECTED_RESULTS", "[['AP', 0.3, 0.01]]"],
    ["DATASETS.OVERRIDE_CATEGORY", '[{"id": 1, "name": "a"}]'], ["AUGMENT.MULT_MIN_SIZE_TRAIN", "(480, 800)"],
    ["GROUNDINGDINO.box_threshold", "0"], ["SOLVER.CLIP_GRADIENTS.ENABLED", "no"],
]


@pytest.mark.parametrize("opts", OPTS, ids=["=".join(o) for o in OPTS])
def test_merge_from_list_coerces_as_jax(opts):
    t, j = tconfig.default_config(), jconfig.default_config()
    t.merge_from_list(opts)
    j.merge_from_list(opts)
    same_tree(t, j)


def test_unknown_keys_and_the_open_registry():
    """An unknown key raises KeyError on both merges; DATASETS.REGISTER takes
    new entries (the JAX package's open subtree); an odd override list is
    refused."""
    for cfg in (tconfig.default_config(), jconfig.default_config()):
        with pytest.raises(KeyError):
            cfg.merge_from_list(["SOLVER.NOT_A_KEY", "1"])
        with pytest.raises(KeyError):
            cfg.merge_from_other({"MODEL": {"NOT_A_KEY": 1}})
        cfg.merge_from_other({"DATASETS": {"REGISTER": {"mine": {"img_dir": "a", "ann_file": "b.json"}}}})
        assert cfg.DATASETS.REGISTER["mine"]["ann_file"] == "b.json"
    with pytest.raises(ValueError):
        tconfig.default_config().merge_from_list(["SOLVER.BASE_LR"])


# ---- (d) the .pth import ----------------------------------------------------------


FAMILIES = {
    # family -> (tiny config builder of each package, bucket)
    "glip": (tb.tiny_test_config, jb.tiny_test_config, (64, 96)),
    "gdino": (tb.tiny_gdino_config, jb.tiny_gdino_config, (96, 96)),
}


def family_cfg(family, package="port"):
    """The tiny config of the family with test_torch_port_eval.py's
    evaluation settings, in fp32."""
    cfg = (FAMILIES[family][0] if package == "port" else FAMILIES[family][1])()
    eval_settings(cfg, family)
    if family == "gdino":
        cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES = SCALES[:4]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def reference_state(family, seed):
    """A reference-layout state dict (the port's keys, fp32) of seeded
    weights: normals x0.02 and norms near 1, each tensor perturbed."""
    model = tb.init_params(tb.build_model(family_cfg(family)), seed=seed)
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.02 * torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}


def save_pth(path, state, decoy=None):
    """torch.save of a DetectronCheckpointer-like file: "model" (the decoy
    weights) and its sibling "model_ema" (the weights), keys under
    `module.`."""
    wrap = lambda s: {f"module.{k}": v for k, v in s.items()}  # noqa: E731
    torch.save({"model": wrap(decoy if decoy is not None else state), "model_ema": wrap(state),
                "iteration": 7}, path)
    return str(path)


def jax_init(family, cfg):
    model = jb.build_model(cfg)
    bucket = FAMILIES[family][2]
    b = jb.synthetic_batch(cfg, 1, bucket, num_labels=2, k_shot=cfg.VISION_QUERY.NUM_QUERY_PER_CLASS)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    return model, jb.init_params_fast(model, *(jax.numpy.asarray(b[k]) for k in keys), seed=0)


def damaged(family, state):
    """The state with one key gone, one of a wrong shape and one unknown
    (and, for GDINO, a decoder alias and a box-head layer that only the
    candidate `bbox_embed.0` fills)."""
    state = dict(state)
    if family == "glip":
        del state["rpn.head.bias0"]
        state["rpn.head.bbox_pred.bias"] = torch.zeros(5)
    else:
        del state["transformer.decoder.layers.0.self_attn.in_proj_weight"]
        del state["bbox_embed.1.layers.0.weight"]
        state["transformer.level_embed"] = torch.zeros(3, 16)
        state["transformer.decoder.bbox_embed.0.layers.0.bias"] = state["bbox_embed.0.layers.0.bias"]
    state["some.unknown.weight"] = torch.zeros(2)
    return state


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("variant", ["whole", "damaged"])
def test_pth_import_report_counts_as_jax(family, variant, tmp_path):
    """The same .pth through both imports: matched / missing / unused
    counted alike (and the same flax paths), the EMA sibling taken."""
    state = reference_state(family, 1)
    if variant == "damaged":
        state = damaged(family, state)
    path = save_pth(tmp_path / "w.pth", state, decoy={k: torch.zeros_like(v) for k, v in state.items()})
    jcfg = family_cfg(family, "jax")
    jmodel, params = jax_init(family, jcfg)
    ref = JI.load_torch_state_dict(path)
    if family == "glip":
        _, jrep = JI.import_glip_checkpoint(params, ref)
    else:
        _, jrep = JI.import_gdino_checkpoint(params, ref, enc_layers=jcfg.GROUNDINGDINO.enc_layers,
                                             dec_layers=jcfg.GROUNDINGDINO.dec_layers)
    tmodel = tb.build_model(family_cfg(family))
    imp = TI.import_glip_checkpoint if family == "glip" else TI.import_gdino_checkpoint
    trep = imp(tmodel, TI.load_torch_state_dict(path))
    assert {k: len(v) for k, v in trep.items()} == {k: len(v) for k, v in jrep.items()}
    for k in trep:
        assert sorted(trep[k]) == sorted(jrep[k]), k
    if variant == "whole":
        assert not trep["missing"] and not trep["unused"] and len(trep["matched"]) > 200
        for k, v in tmodel.state_dict().items():
            assert torch.equal(v, state[k]), k
    else:
        assert len(trep["missing"]) in (2, 4) and len(trep["unused"]) == 2


def test_pth_import_refuses_missing_under_strict_and_casts_to_the_model_dtype(tmp_path):
    state = reference_state("glip", 2)
    model = tb.build_model(family_cfg("glip")).to(torch.bfloat16)
    TI.import_glip_checkpoint(model, state)
    sd = model.state_dict()
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    assert torch.equal(sd["rpn.head.bbox_pred.weight"], state["rpn.head.bbox_pred.weight"].to(torch.bfloat16))
    with pytest.raises(KeyError, match="not found"):
        TI.import_glip_checkpoint(model, damaged("glip", state), strict=True)


# ---- the JAX side's cached split functions and init -----------------------------


@pytest.fixture(scope="module")
def jax_cached():
    """make_split_predict_fns and the CLI's model init built once per
    (family, bucket) for the module: each build is a new jit, compiled anew.
    The cached functions take the params they are given, so they serve every
    model of the same config."""
    built = {}
    mp = pytest.MonkeyPatch()
    original = jpredict.make_split_predict_fns

    def cached(model, bucket, cfg):
        key = ("split", type(model).__name__, tuple(bucket))
        if key not in built:
            built[key] = original(model, bucket, cfg)
        return built[key]

    jit = jax.jit

    def cached_jit(fn, *a, **kw):
        owner = getattr(fn, "__self__", None)
        if getattr(fn, "__name__", "") != "init" or owner is None or a or kw:
            return jit(fn, *a, **kw)
        key = ("init", type(owner).__name__)
        if key not in built:
            built[key] = jit(fn)
        return built[key]

    mp.setattr(jinf, "make_split_predict_fns", cached)
    mp.setattr(jpredict, "make_split_predict_fns", cached)
    mp.setattr(jax, "jit", cached_jit)
    # the JAX CLI configures the compile cache at import: keep the tests' own
    mp.setenv("JAX_COMPILATION_CACHE_DIR", jax.config.jax_compilation_cache_dir or os.path.join(REPO, ".jax_cache"))
    if REPO not in sys.path:
        mp.syspath_prepend(REPO)
    yield cached
    mp.undo()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_after_import_matches_jax(family, jax_cached, tmp_path):
    """The forward after each package's import of one .pth: the image
    tower's maps and the head's detections on one image and one prompt."""
    path = save_pth(tmp_path / "w.pth", reference_state(family, 3))
    jcfg, tcfg = family_cfg(family, "jax"), family_cfg(family)
    jmodel, params = jax_init(family, jcfg)
    ref = JI.load_torch_state_dict(path)
    if family == "glip":
        params, _ = JI.import_glip_checkpoint(params, ref)
    else:
        params, _ = JI.import_gdino_checkpoint(params, ref, enc_layers=1, dec_layers=2)
    tmodel = tb.build_model(tcfg).eval()
    imp = TI.import_glip_checkpoint if family == "glip" else TI.import_gdino_checkpoint
    imp(tmodel, TI.load_torch_state_dict(path))
    bucket = FAMILIES[family][2]
    make = tb.synthetic_batch if family == "glip" else tb.synthetic_caption_batch
    b = make(tcfg, 2, bucket, num_labels=3, k_shot=2, seed=4)  # two prompts on the first image
    b["images"] = b["images"][:1]
    order = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    sizes = np.array([[bucket[0] - 4, bucket[1] - 8]] * 2, np.float32)
    j_enc, j_head = jax_cached(jmodel, bucket, jcfg)
    t_enc, t_head = tpredict.make_split_predict_fns(tmodel, bucket, tcfg)
    jf = j_enc(params, jax.numpy.asarray(b["images"]))
    tf = t_enc(nchw(b["images"]))
    for a, c in zip(jf, tf):
        np.testing.assert_allclose(c.permute(0, 2, 3, 1).numpy(), np.asarray(a), atol=1e-5)
    want = j_head(params, jf, *(jax.numpy.asarray(b[k]) for k in order), jax.numpy.asarray(sizes))
    got = t_head(tf, *(torch.from_numpy(b[k]) for k in order), torch.from_numpy(sizes))
    v = np.asarray(want.valid)
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[v] / max(bucket), np.asarray(want.boxes)[v] / max(bucket), atol=1e-5)


# ---- (e) load_params_npz ---------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_params_npz_reads_a_jax_save_params_npz_file(family, tmp_path):
    jcfg = family_cfg(family, "jax")
    _, params = jax_init(family, jcfg)
    path = str(tmp_path / "params.npz")
    jckpt.save_params_npz(path, params)
    model = tb.build_model(family_cfg(family))
    assert load_params_npz(path, model) is model
    want = params_from_jax(flat_params(params), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---- (f) the copies -----------------------------------------------------------------


def _code(path):
    """The module's AST without docstrings, with the package's name made
    neutral."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("mqdet_torch", "PKG").replace("mqdet_tpu", "PKG")


@pytest.mark.parametrize("module", ["engine/flickr_eval.py", "data/tsv.py", "data/datasets_extra.py"])
def test_copies_are_the_originals(module):
    """Statement for statement the JAX package's module (docstrings and the
    package's name apart)."""
    assert _code(os.path.join(REPO, "mqdet_torch", module)) == _code(os.path.join(REPO, "mqdet_tpu", module))


def test_voc_and_flickr_evaluators_agree():
    from mqdet_tpu.engine import flickr_eval as jf
    from mqdet_torch.engine import eval_dispatch as tdisp
    from mqdet_torch.engine import flickr_eval as tf

    rng = np.random.default_rng(0)
    boxes = lambda n: np.sort(rng.uniform(0, 50, (n, 4)).astype(np.float32).reshape(n, 2, 2), 1).reshape(n, 4)  # noqa
    evs = (jdisp.VOCEvaluator(), tdisp.VOCEvaluator(use_07_metric=False))
    fl = (jf.FlickrEvaluator(), tf.FlickrEvaluator())
    for e in evs:
        e.register_categories([1, 2, 3])
    for i in range(4):
        args = (i, boxes(3), rng.integers(1, 4, 3), boxes(6), rng.uniform(0, 1, 6), rng.integers(1, 4, 6))
        preds, gts = [boxes(5) for _ in range(2)], [{"boxes": boxes(2), "category": "all"} for _ in range(2)]
        for e in evs:
            e.add_image(*args)
        for f in fl:
            f.add(preds, gts)
    assert evs[0].summarize() == evs[1].summarize()
    assert fl[0].summarize() == fl[1].summarize()
    for metric in (False, True):
        r = rng.uniform(0, 1, 9).cumsum() / 9
        p = rng.uniform(0, 1, 9)
        assert jf.voc_ap(r, p, metric) == tf.voc_ap(r, p, metric)


@pytest.mark.parametrize("results", [{"AP": 0.31}, {"AP": 0.5}, {"AP50": 0.3}])
def test_check_expected_results_as_jax(results):
    expected = [("AP", 0.3, 0.01)]
    outcomes = []
    for check in (jev.check_expected_results, tev.check_expected_results):
        try:
            check(results, expected, 4)
            outcomes.append("ok")
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_extract_queries_presets_as_jax(tmp_path):
    """The preset command: the JAX tool's overrides and save path, run
    through the port's training CLI; and that CLI's --extract-query branch on
    the CPU banks every GT class of a dataset."""
    from mqdet_torch.tools import extract_queries, train as ttrain

    cmd = extract_queries.command(["--config-file", "c.yaml", "--dataset", "lvis", "--num_vision_queries", "3",
                                   "--add_name", "t", "X.Y", "1"])
    assert cmd[1:3] == ["-m", "mqdet_torch.tools.train"]
    assert cmd[3:] == ["--config-file", "c.yaml", "--extract-query", "VISION_QUERY.QUERY_BANK_SAVE_PATH",
                       "MODEL/lvis_query_3_pool7_selt.npz",
                       "VISION_QUERY.MAX_QUERY_NUMBER", "3", "DATASETS.FEW_SHOT", "3", "X.Y", "1"]
    assert extract_queries.command(["--config-file", "c", "--dataset", "objects365"])[-3:] == [
        "5000", "DATASETS.FEW_SHOT", "0"]
    ann, img_dir = write_coco(tmp_path, [(60, 80), (80, 60)], categories=CATEGORIES, seed=3)
    cfg = family_cfg("glip")
    cfg.DATASETS.REGISTER = {"train": {"ann_file": ann, "img_dir": img_dir}}
    cfg.DATASETS.TRAIN = ("train",)
    cfg.DATASETS.DATA_ROOT = ""
    yml = tmp_path / "c.yaml"
    yml.write_text(cfg.dump_yaml())
    out = tmp_path / "bank.npz"
    path = ttrain.main(["--config-file", str(yml), "--extract-query", "--device", "cpu", "OUTPUT_DIR",
                        str(tmp_path / "o"), "VISION_QUERY.QUERY_BANK_SAVE_PATH", str(out)])
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.mq.bank import QueryBank

    ds = CocoDetectionDataset(ann, img_dir)
    bank = QueryBank.load(path)
    assert path == str(out) and set(bank.labels) == {int(l) for i in ds.ids for l in ds.annotations(i)[1]}
    assert (tmp_path / "o" / "config.yml").exists()


# ---- (g) the CLI against the JAX CLI ---------------------------------------------------


def write_voc(root, sizes, seed=0):
    """A VOC directory: JPEGs, XML annotations (1-based boxes, one
    difficult object), ImageSets/Main/test.txt."""
    from PIL import Image

    from mqdet_torch.data.datasets_extra import VOC_CLASSES

    rng = np.random.default_rng(seed)
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (root / d).mkdir(parents=True, exist_ok=True)
    ids = []
    for i, (h, w) in enumerate(sizes):
        name = f"im{i}"
        ids.append(name)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / "JPEGImages" / f"{name}.jpg")
        ann = ET.Element("annotation")
        for j in range(3):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = VOC_CLASSES[1 + int(rng.integers(0, 6))]
            ET.SubElement(obj, "difficult").text = "1" if j == 2 else "0"
            bb = ET.SubElement(obj, "bndbox")
            x0, y0 = rng.uniform(1, w / 2), rng.uniform(1, h / 2)
            corners = (("xmin", x0), ("ymin", y0), ("xmax", rng.uniform(x0 + 6, w)), ("ymax", rng.uniform(y0 + 6, h)))
            for k, v in corners:
                ET.SubElement(bb, k).text = f"{v:.1f}"
        ET.ElementTree(ann).write(root / "Annotations" / f"{name}.xml")
    (root / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids) + "\n")


def write_grounding(root, sizes, seed=0):
    """A ModulatedDataset json: per image a caption, per box its
    tokens_positive spans; the first image also lists tokens_positive_eval."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    captions = [("a cat near a dog", [[(2, 5)], [(13, 16)]]), ("the red ball and a cat", [[(8, 12)], [(19, 22)]])]
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"g{i}.png")
        cap, spans = captions[i % 2]
        im = {"id": i + 1, "file_name": f"g{i}.png", "height": h, "width": w, "caption": cap}
        if i == 0:
            im["tokens_positive_eval"] = [[list(s) for s in sp] for sp in spans]
        images.append(im)
        for sp in spans + spans[:1]:
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1, "iscrowd": 0,
                         "bbox": [x0, y0, rng.uniform(8, w - x0), rng.uniform(8, h - y0)],
                         "tokens_positive": [list(s) for s in sp]})
    (root / "grounding.json").write_text(json.dumps({"images": images, "annotations": anns,
                                                     "categories": [{"id": 1, "name": "object"}]}))


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """The files both CLIs read: per family a yaml (the dump of its tiny
    config with every dataset registered), a .pth and a bank."""
    root = tmp_path_factory.mktemp("cli")
    ann, img_dir = write_coco(root, [(60, 80)] * 2 + [(80, 60)], boxes_per_image=3, categories=CATEGORIES, seed=5)
    (root / "voc").mkdir()
    write_voc(root / "voc", [(60, 80), (56, 84)], seed=6)
    (root / "grounding").mkdir()
    write_grounding(root / "grounding", [(60, 80), (48, 72)], seed=7)
    bank = jbank.QueryBank(channels=16)
    rng = np.random.default_rng(0)
    for lab in (1, 2, 4, 5, 7, 12, 15):
        bank.add(lab, rng.standard_normal((3, 1, 16)).astype(np.float32))
    bank.save(str(root / "bank.npz"))
    out = {}
    for family in FAMILIES:
        cfg = family_cfg(family)
        cfg.DATASETS.DATA_ROOT = str(root)
        cfg.DATASETS.REGISTER = {
            "coco_val": {"ann_file": ann, "img_dir": img_dir},
            "lvis_val": {"ann_file": ann, "img_dir": img_dir},
            "voc_test": {"factory": "PascalVOCDataset", "data_dir": "voc", "split": "test"},
            "flickr_val": {"factory": "ModulatedDataset", "ann_file": "grounding/grounding.json",
                           "img_dir": "grounding"},
        }
        cfg.DATASETS.TEST = ("coco_val",)
        cfg.VISION_QUERY.QUERY_BANK_PATH = str(root / "bank.npz")
        yml = root / f"{family}.yaml"
        yml.write_text(cfg.dump_yaml())
        state = reference_state(family, 5)
        out[family] = (str(yml), save_pth(root / f"{family}.pth", state, decoy={k: v * 0 for k, v in state.items()}))
    return root, out


def jax_cli(argv):
    """JAX's tools/eval.py main in process; its results dict and bbox.csv."""
    jeval = importlib.import_module("tools.eval")
    seen = {}
    original = jdisp.run_evaluation

    def capture(*a, **kw):
        seen["results"] = original(*a, **kw)
        return seen["results"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jdisp, "run_evaluation", capture)
    mp.setattr(sys, "argv", ["tools/eval.py", *argv])
    try:
        jeval.main()
    finally:
        mp.undo()
    return seen["results"]


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [float(x) for x in rows[1]]


def same_results(got, want, path="results"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            same_results(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
        return
    assert abs(got - want) <= 1e-6, (path, got, want)


CLI_CASES = [("glip", "coco_val"), ("glip", "lvis_val"), ("gdino", "coco_val"), ("gdino", "lvis_val"),
             ("glip", "voc_test"), ("glip", "flickr_val")]


@pytest.mark.parametrize("family,dataset", CLI_CASES, ids=[f"{f}-{d}" for f, d in CLI_CASES])
def test_eval_cli_matches_the_jax_cli(family, dataset, cli_data, jax_cached, tmp_path):
    """`mqdet_torch.tools.eval.main` and the JAX package's `tools/eval.py`
    `main` on the same yaml, .pth, bank and data: the same evaluation style,
    results (timing apart) and bbox.csv within 1e-6."""
    from mqdet_torch.tools import eval as teval

    _, (yml, pth) = cli_data[0], cli_data[1][family]
    opts = ["DATASETS.TEST", f"['{dataset}']"]
    if dataset == "flickr_val":
        # one prompt a forward: a bucket whose last level is not 1x1 (torch's
        # GroupNorm refuses one value a channel at batch 1)
        opts += ["TPU.IMAGE_BUCKETS", "[[160, 224]]", "INPUT.MIN_SIZE_TEST", "150", "INPUT.MAX_SIZE_TEST", "210"]
    want = jax_cli(["--config-file", yml, "--weight", pth, *opts, "OUTPUT_DIR", str(tmp_path / "jax")])
    got = teval.main(["--config-file", yml, "--weight", pth, "--device", "cpu", *opts, "OUTPUT_DIR",
                      str(tmp_path / "port")], device="cuda")
    timing = ("images_per_second", "seconds")
    same_results({k: v for k, v in got.items() if k not in timing}, {k: v for k, v in want.items() if k not in timing})
    keys, values = read_csv(tmp_path / "port" / "bbox.csv")
    jkeys, jvalues = read_csv(tmp_path / "jax" / "bbox.csv")
    assert keys == jkeys and keys[0] == "AP"
    np.testing.assert_allclose(values, jvalues, atol=1e-6, rtol=0)
    style = {"coco_val": "AP75", "lvis_val": "AP75", "voc_test": "mAP", "flickr_val": "recall@10"}[dataset]
    assert style in keys


OPTION_CASES = [("glip", "lvis_val", "tta"), ("gdino", "coco_val", "tta"), ("glip", "coco_val", "knowledge")]


@pytest.mark.parametrize("family,dataset,option", OPTION_CASES, ids=["-".join(c) for c in OPTION_CASES])
def test_eval_cli_options_match_the_jax_cli(family, dataset, option, cli_data, jax_cached, tmp_path):
    """TEST.USE_MULTISCALE (three scales over two buckets, flip, soft-vote)
    and GLIPKNOW.KNOWLEDGE_FILE (a knowledge yaml of the dataset's classes)
    given as KEY VALUE overrides to both CLIs on the same yaml, .pth and
    bank: the same results (timing apart) and bbox.csv within 1e-6."""
    from mqdet_torch.tools import eval as teval

    _, (yml, pth) = cli_data[0], cli_data[1][family]
    opts = ["DATASETS.TEST", f"['{dataset}']"]
    if option == "tta":
        buckets, scales = {"glip": ("[[48, 64], [64, 96]]", "[40, 48, 56]"),
                           "gdino": ("[[64, 96], [96, 96]]", "[60, 64, 72]")}[family]
        opts += ["TEST.USE_MULTISCALE", "True", "TEST.SCALES", scales, "TEST.MAX_SIZE", "96",
                 "TPU.IMAGE_BUCKETS", buckets, "TEST.SPECIAL_NMS", "soft-vote"]
    else:
        know = {c["name"]: {"clean_name": c["name"].replace("_", " "),
                            "def_wiki": f"the seeded description number {i} of a {c['name']}, long enough to wrap"}
                for i, c in enumerate(CATEGORIES)}
        (tmp_path / "know.yaml").write_text(yaml.safe_dump(know))
        opts += ["GLIPKNOW.KNOWLEDGE_FILE", str(tmp_path / "know.yaml"), "GLIPKNOW.KNOWLEDGE_TYPE", "def_wiki",
                 "MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN", "64"]
    want = jax_cli(["--config-file", yml, "--weight", pth, *opts, "OUTPUT_DIR", str(tmp_path / "jax")])
    got = teval.main(["--config-file", yml, "--weight", pth, "--device", "cpu", *opts, "OUTPUT_DIR",
                      str(tmp_path / "port")], device="cuda")
    timing = ("images_per_second", "seconds")
    same_results({k: v for k, v in got.items() if k not in timing}, {k: v for k, v in want.items() if k not in timing})
    keys, values = read_csv(tmp_path / "port" / "bbox.csv")
    jkeys, jvalues = read_csv(tmp_path / "jax" / "bbox.csv")
    assert keys == jkeys
    np.testing.assert_allclose(values, jvalues, atol=1e-6, rtol=0)
