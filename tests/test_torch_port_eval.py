"""The port's evaluation loop vs the JAX package: `ChunkedEvaluationPlan`'s
arrays, the `DetectionEvaluator` copy, `run_inference` for tiny MQ-GLIP and
tiny MQ-GroundingDINO (detections per image and AP), MASK_DURING_INFERENCE,
a fake detector through the whole loop (AP 1, two buckets), one
`online_update` turn per family from an empty bank, and the refused options.

Both sides read one synthetic LVIS-format dataset (PNG files, LVIS names and
frequencies, neg and not-exhaustive ids), take a `WordPieceTokenizer()` of
their own package and the same bank, and run the tiny configs in fp32 with
the same weights. The port's transform reproduces PIL's resize bit for bit,
so both see the same pixels. Thresholds are 0 (INFERENCE_TH, box_threshold,
SCORE_THRESHOLD) so every slot reaches the evaluator and the update.
Tolerances (those of `test_torch_port_slice.py`): scores atol 1e-5, boxes
atol 1e-4 in pixels, pooled features atol and rtol 1e-4; AP fields 1e-6;
the evaluator copy 1e-9. The JAX side's split functions are built once per
model and bucket for the whole module (their jit compiles dominate).
"""
import copy
import json
import random

import numpy as np
import pytest
import torch

from mqdet_tpu.data import coco as jcoco
from mqdet_tpu.data import tokenizer as jtok
from mqdet_tpu.engine import evaluator as jev
from mqdet_tpu.engine import inference as jinf
from mqdet_tpu.engine import predict as jpredict
from mqdet_tpu.mq import bank as jbank
from mqdet_tpu.mq import extract as jext
from mqdet_tpu.mq import selector as jsel
from mqdet_torch.core.detections import Detections
from mqdet_torch.data import coco as tcoco
from mqdet_torch.data import tokenizer as ttok
from mqdet_torch.engine import evaluator as tev
from mqdet_torch.engine import inference as tinf
from mqdet_torch.mq import bank as tbank
from mqdet_torch.mq import extract as text
from mqdet_torch.mq import selector as tsel
from test_torch_port_modules import tiny_pair
from test_torch_port_querybank import LVIS_NAMES, gdino_pair, write_coco

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# family -> (bucket, (MIN_SIZE_TEST, MAX_SIZE_TEST)): 60x80 images go to 48x64
# (downscale) for GLIP and 72x96 (upscale) for GDINO, whose pyramid then has
# no 1x1 level
GEOMETRY = {"glip": ((64, 96), (48, 80)), "gdino": ((96, 96), (72, 96))}
CATEGORIES = [{"id": 10 + 3 * i, "name": n, "frequency": "rcf"[i % 3]} for i, n in enumerate(LVIS_NAMES[:8])]


def eval_settings(cfg, family):
    bucket, (lo, hi) = GEOMETRY[family]
    cfg.TPU.IMAGE_BUCKETS = (bucket,)
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = lo, hi
    cfg.TEST.CHUNKED_EVALUATION = 3       # 8 classes: chunks of 3, 3, 2
    cfg.TEST.CHUNK_PARALLELISM = 2        # groups [0, 1] and [2, 2]: the last padded
    cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT = 3
    cfg.VISION_QUERY.NUM_QUERY_PER_CLASS = 2
    cfg.VISION_QUERY.SCORE_THRESHOLD = 0.0
    cfg.MODEL.ATSS.INFERENCE_TH = 0.0
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 6
    cfg.GROUNDINGDINO.box_threshold = 0.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(ann_file, img_dir, {contiguous label: frequency}) of 2 landscape
    images of 60x80 and a portrait one of 80x60 (the transposed bucket)."""
    ann_file, img_dir = write_coco(tmp_path_factory.mktemp("lvis"), [(60, 80)] * 2 + [(80, 60)], boxes_per_image=3,
                                   categories=CATEGORIES, seed=5)
    ds = tcoco.CocoDetectionDataset(ann_file, img_dir)
    freq = {ds.cat_id_to_contiguous[c["id"]]: c["frequency"] for c in ds.categories}
    return ann_file, img_dir, freq


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX package's make_split_predict_fns, built once per (model,
    bucket) for the module: each build is a new jit, compiled anew."""
    built = {}
    original = jpredict.make_split_predict_fns

    def cached(model, bucket, cfg):
        key = (id(model), tuple(bucket))
        if key not in built:
            built[key] = original(model, bucket, cfg)
        return built[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(jinf, "make_split_predict_fns", cached)
    yield
    mp.undo()


def _pair(family):
    def mods(cfg):
        eval_settings(cfg, family)

    return tiny_pair(mods) if family == "glip" else gdino_pair(mods)


@pytest.fixture(scope="module")
def glip():
    return _pair("glip")


@pytest.fixture(scope="module")
def gdino():
    return _pair("gdino")


def seeded_banks(channels=16, labels=(1, 2, 4, 5, 7), n=3, seed=0):
    """The same bank in both packages; labels 3, 6 and 8 have no queries."""
    rng = np.random.default_rng(seed)
    banks = jbank.QueryBank(channels=channels), tbank.QueryBank(channels=channels)
    for lab in labels:
        f = rng.standard_normal((n, 1, channels)).astype(np.float32)
        for b in banks:
            b.add(lab, f)
    return banks


def selectors(cfg, banks):
    k, m = cfg.VISION_QUERY.NUM_QUERY_PER_CLASS, cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT
    return (jsel.QuerySelector(banks[0], num_query_per_class=k, max_labels=m),
            tsel.QuerySelector(banks[1], num_query_per_class=k, max_labels=m))


def recording(cls):
    """`cls` (a DetectionEvaluator) that keeps each image's detections."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen = {}

        def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw):
            self.seen[image_id] = (det_boxes, det_scores, det_labels)
            super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw)

    return Recording


# ---- the plan --------------------------------------------------------------


PLAN_KEYS = ("input_ids", "attention_mask", "all_map", "agg_map", "slot_to_label", "queries", "query_mask")


@pytest.mark.parametrize("variant", ["plain", "prompt list", "prompt dict", "select classes", "no bank"])
def test_plan_matches_jax(data, variant):
    ann_file, img_dir, _ = data
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.utils import builders as tb

    jcfg, tcfg = jb.tiny_test_config(), tb.tiny_test_config()
    for cfg in (jcfg, tcfg):
        eval_settings(cfg, "glip")
        cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 24
        if variant == "prompt list":
            cfg.DATASETS.CAPTION_PROMPT = json.dumps(
                [{"prefix": f"p{i} ", "name": c["name"], "suffix": " s"} for i, c in enumerate(CATEGORIES)])
        elif variant == "prompt dict":
            cfg.DATASETS.CAPTION_PROMPT = {"cat": {"prefix": "a ", "name": "small cat", "suffix": ""},
                                           "hot_dog": {"prefix": "", "name": "sausage", "suffix": " bun"}}
        elif variant == "select classes":
            cfg.TEST.SELECT_CLASSES = (2, 3, 5, 8)
    jds, tds = jcoco.CocoDetectionDataset(ann_file, img_dir), tcoco.CocoDetectionDataset(ann_file, img_dir)
    sels = selectors(tcfg, seeded_banks()) if variant != "no bank" else (None, None)
    random.seed(0)  # both selectors sample from the module-level random (3 queries, k = 2)
    a = jinf.ChunkedEvaluationPlan(jcfg, jds, jtok.WordPieceTokenizer(), sels[0])
    random.seed(0)
    b = tinf.ChunkedEvaluationPlan(tcfg, tds, ttok.WordPieceTokenizer(), sels[1])
    assert len(a) == len(b) and a.chunks == b.chunks and a.max_labels == b.max_labels
    for key in PLAN_KEYS:
        x, y = getattr(a, key), getattr(b, key)
        if variant == "no bank" and key.startswith("quer"):
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def test_group_inputs_feed_the_head_as_by_hand(glip, data):
    """The queries' dtype: one group's head output from `group_inputs`
    (the plan's arrays as tensors, queries fp32) equals the head fed the same
    numpy arrays by hand."""
    from mqdet_torch.engine.predict import make_split_predict_fns

    _, _, tmodel, _, tcfg = glip
    ann_file, img_dir, _ = data
    tds = tcoco.CocoDetectionDataset(ann_file, img_dir)
    plan = tinf.ChunkedEvaluationPlan(tcfg, tds, ttok.WordPieceTokenizer(), selectors(tcfg, seeded_banks())[1])
    groups = tinf.chunk_groups(plan, 2)
    assert groups == [[0, 1], [2, 2]]
    inputs = tinf.group_inputs(tcfg, plan, groups, torch.device("cpu"))
    assert inputs[1]["queries"].dtype == inputs[1]["query_mask"].dtype == torch.float32
    encode_fn, head_fn = make_split_predict_fns(tmodel, (64, 96), tcfg)
    feats = encode_fn(torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(0)))
    sizes = torch.tensor([[48.0, 64.0]] * 2)
    g = inputs[1]
    got = head_fn(feats, g["input_ids"], g["attention_mask"], g["queries"], g["query_mask"], g["agg_map"], sizes)
    sel = groups[1]
    want = head_fn(feats, *(torch.from_numpy(getattr(plan, k)[sel]) for k in
                            ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")), sizes)
    for f in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- the evaluator copy ------------------------------------------------------


@pytest.mark.parametrize("style", ["coco", "lvis_fixed"])
def test_evaluator_copy_matches(style):
    """Seeded detections near and far from seeded GT over 12 images, 6
    categories with frequencies, ignored GT, neg and not-exhaustive ids: the
    copy's numpy matcher against the JAX module (its native matcher where it
    is built), summary within 1e-9."""
    rng = np.random.default_rng(3)
    freq = {c: "rcf"[c % 3] for c in range(1, 7)}
    evs = [m.DetectionEvaluator(style=style, max_dets=20, per_cat_cap=60, category_frequency=freq)
           for m in (jev, tev)]
    for img in range(12):
        ng = int(rng.integers(0, 5))
        xy = rng.uniform(0, 200, (ng, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 80, (ng, 2))], 1).astype(np.float32)
        gl = rng.integers(1, 7, ng).astype(np.int32)
        ig = rng.random(ng) < 0.2
        nd = int(rng.integers(0, 30))
        src = rng.integers(0, max(ng, 1), nd)
        near = gt[src] + rng.normal(0, 6, (nd, 4)).astype(np.float32) if ng else np.zeros((nd, 4), np.float32)
        far = rng.uniform(0, 250, (nd, 4)).astype(np.float32)
        db = np.where(rng.random((nd, 1)) < 0.6, near, np.sort(far.reshape(nd, 2, 2), 1).reshape(nd, 4))
        ds = rng.random(nd).astype(np.float32)
        dl = np.where(rng.random(nd) < 0.7, gl[src] if ng else 1, rng.integers(1, 7, nd)).astype(np.int32)
        neg = rng.choice(6, 2, replace=False) + 1
        nel = rng.choice(6, 1) + 1
        for ev in evs:
            ev.add_image(img, gt, gl, db, ds, dl, neg_category_ids=neg, not_exhaustive_category_ids=nel,
                         gt_ignore=ig)
    for ev in evs:
        ev.register_categories(range(1, 8))
    want, got = (ev.summarize() for ev in evs)
    assert set(got) == set(want) and {"APr", "APc", "APf"} <= set(got)
    for key in want:
        if key == "per_category_AP":
            assert got[key].keys() == want[key].keys()
            for c in want[key]:
                assert abs(got[key][c] - want[key][c]) <= 1e-9
        else:
            assert abs(got[key] - want[key]) <= 1e-9, key


# ---- run_inference -------------------------------------------------------------


def both_runs(pair, data, mods=None, bank_labels=(1, 2, 4, 5, 7)):
    """run_inference on both sides with the LVIS evaluator: (JAX results,
    port results, JAX recorder, port recorder)."""
    jmodel, params, tmodel, jcfg, tcfg = pair
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    if mods is not None:
        mods(jcfg)
        mods(tcfg)
    ann_file, img_dir, freq = data
    sels = selectors(tcfg, seeded_banks(labels=bank_labels))
    evs = [recording(m.DetectionEvaluator)(style="lvis_fixed", max_dets=300, category_frequency=freq)
           for m in (jev, tev)]
    random.seed(0)  # the plans' query draws (3 queries a class, k = 2)
    want = jinf.run_inference(jcfg, jmodel, params, jcoco.CocoDetectionDataset(ann_file, img_dir),
                              jtok.WordPieceTokenizer(), sels[0], evaluator=evs[0], verbose=False)
    random.seed(0)
    got = tinf.run_inference(tcfg, tmodel, tcoco.CocoDetectionDataset(ann_file, img_dir),
                             ttok.WordPieceTokenizer(), sels[1], evaluator=evs[1], verbose=False)
    return want, got, evs[0], evs[1]


def assert_same_detections(jrec, trec, min_per_image):
    assert jrec.seen.keys() == trec.seen.keys()
    for img_id, (jb_, js, jl) in jrec.seen.items():
        tb_, ts, tl = trec.seen[img_id]
        assert len(tl) >= min_per_image, "too few detections to compare"
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tb_, jb_, atol=1e-4, rtol=0)
        assert np.isfinite(tb_).all() and (tb_ >= 0).all() and (tb_[:, 2:] < 80).all()


def assert_same_ap(want, got):
    for key in ("AP", "AP50", "AP75", "APr", "APc", "APf"):
        if key in want:
            assert abs(got[key] - want[key]) <= 1e-6, key
    assert got["images_per_second"] > 0
    assert set(got["seconds"]) == {"transform", "encode", "head", "fetch", "evaluator"}


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_run_inference_matches_jax(request, jax_fns, data, family):
    want, got, jrec, trec = both_runs(request.getfixturevalue(family), data)
    # 3 chunk rows in 2 groups of 2 (the last chunk twice): 4 rows per image
    assert_same_detections(jrec, trec, 4 * (6 if family == "glip" else 12) // 2)
    assert_same_ap(want, got)


def test_run_inference_matches_jax_with_mask_during_inference(glip, jax_fns, data):
    """MASK_DURING_INFERENCE: the spans of classes with a query become [MASK]
    with probability TEXT_DROPOUT, RandomState(SOLVER.SEED) in the JAX order."""
    def mods(cfg):
        cfg.VISION_QUERY.MASK_DURING_INFERENCE = True
        cfg.VISION_QUERY.TEXT_DROPOUT = 0.5
        cfg.SOLVER.SEED = 3

    want, got, jrec, trec = both_runs(glip, data, mods)
    assert_same_detections(jrec, trec, 12)
    assert_same_ap(want, got)
    # the masking changed the ids the head saw
    _, _, _, _, tcfg = glip
    ann_file, img_dir, _ = data
    plan = tinf.ChunkedEvaluationPlan(tcfg, tcoco.CocoDetectionDataset(ann_file, img_dir),
                                      ttok.WordPieceTokenizer(), selectors(tcfg, seeded_banks())[1])
    cfg = copy.deepcopy(tcfg)
    mods(cfg)
    groups = tinf.chunk_groups(plan, 2)
    masked = tinf.masked_input_ids(cfg, plan, groups, 103)
    assert any((m == 103).any() for m in masked)
    assert all(((m == 103) | (m == plan.input_ids[sel])).all() for m, sel in zip(masked, groups))


# ---- a fake detector through the loop ---------------------------------------------


def fake_fns(boxes, scores, labels):
    """A make_split_predict_fns stand-in whose head gives fixed detections
    (network coordinates) in row 0 of every group; records the buckets."""
    created = []

    def make(model, bucket, cfg):
        created.append(tuple(bucket))
        cp = cfg.TEST.CHUNK_PARALLELISM
        n = len(scores)

        def encode_fn(images):
            return [torch.zeros(1, 1, 1, 1)]

        def head_fn(feats, ii, am, q, qm, agg, sizes):
            out = Detections(torch.zeros(cp, n, 4), torch.zeros(cp, n), torch.zeros(cp, n, dtype=torch.int32),
                             torch.zeros(cp, n, dtype=torch.bool))
            out.boxes[0], out.scores[0] = torch.from_numpy(boxes), torch.from_numpy(scores)
            out.labels[0], out.valid[0] = torch.from_numpy(labels), True
            return out

        return encode_fn, head_fn

    return make, created


@pytest.fixture
def simple_coco(tmp_path):
    """4 images of 60x80, GT cat @ [5, 5, 25, 30] and dog @ [15, 5, 35, 30]."""
    from PIL import Image

    (tmp_path / "img").mkdir()
    images, anns = [], []
    for i in range(4):
        Image.fromarray(np.full((60, 80, 3), 40 * i, np.uint8)).save(tmp_path / "img" / f"{i}.png")
        images.append({"id": i, "file_name": f"{i}.png", "height": 60, "width": 80})
        for j in range(2):
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": j + 1,
                         "bbox": [5.0 + 10 * j, 5.0, 20.0, 25.0], "area": 500.0, "iscrowd": 0})
    cats = [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}, {"id": 3, "name": "hot_dog"}]
    (tmp_path / "ann.json").write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return tcoco.CocoDetectionDataset(str(tmp_path / "ann.json"), str(tmp_path / "img"))


def fake_cfg(buckets):
    from mqdet_torch.utils.builders import tiny_test_config

    cfg = tiny_test_config()
    cfg.TPU.IMAGE_BUCKETS = buckets
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 80
    cfg.TEST.CHUNK_PARALLELISM = 2
    return cfg


def test_run_inference_perfect_detector(simple_coco, monkeypatch):
    """Detections equal to the GT in network coordinates come out of the
    whole loop (plan, groups, scale back, slot -> label, COCO evaluator)
    with AP 1."""
    from mqdet_torch.data.transforms import get_resize_size

    oh, ow = get_resize_size(60, 80, 48, 80)
    gt = np.array([[5.0, 5.0, 25.0, 30.0], [15.0, 5.0, 35.0, 30.0]], np.float32)
    net = gt * np.array([ow / 80, oh / 60, ow / 80, oh / 60], np.float32)
    make, created = fake_fns(net, np.array([0.9, 0.8], np.float32), np.array([1, 2], np.int32))
    monkeypatch.setattr(tinf, "make_split_predict_fns", make)
    res = tinf.run_inference(fake_cfg(((64, 96),)), torch.nn.Linear(1, 1), simple_coco,
                             ttok.WordPieceTokenizer(), verbose=False)
    assert res["AP"] == pytest.approx(1.0) and res["AP50"] == pytest.approx(1.0)
    assert created == [(64, 96)]


def test_run_inference_two_buckets(simple_coco, monkeypatch):
    """Each image takes the smallest bucket that fits (the second declared),
    and its functions are built once."""
    make, created = fake_fns(np.zeros((1, 4), np.float32), np.array([0.5], np.float32), np.array([1], np.int32))
    monkeypatch.setattr(tinf, "make_split_predict_fns", make)
    tinf.run_inference(fake_cfg(((96, 128), (48, 64))), torch.nn.Linear(1, 1), simple_coco,
                       ttok.WordPieceTokenizer(), verbose=False)
    assert created == [(48, 64)]


# ---- the online update ---------------------------------------------------------


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_online_update_matches_jax(request, jax_fns, data, family):
    """One turn over 2 images from an empty bank, MAX_TEST_QUERY_NUMBER 4:
    the same labels and counts, the features within tolerance."""
    jmodel, params, tmodel, jcfg, tcfg = request.getfixturevalue(family)
    ann_file, img_dir, _ = data
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    for cfg in (jcfg, tcfg):
        cfg.VISION_QUERY.MAX_TEST_QUERY_NUMBER = 4
    banks = jbank.QueryBank(channels=16), tbank.QueryBank(channels=16)
    sels = selectors(tcfg, banks)
    bucket = GEOMETRY[family][0]
    jinf.online_update(jcfg, jmodel, params, jcoco.CocoDetectionDataset(ann_file, img_dir),
                       jtok.WordPieceTokenizer(), sels[0], jext.make_extract_fn(jmodel, bucket, jcfg), max_images=2)
    tinf.online_update(tcfg, tmodel, tcoco.CocoDetectionDataset(ann_file, img_dir), ttok.WordPieceTokenizer(),
                       sels[1], text.make_extract_fn(tmodel, tcfg), max_images=2)
    want, got = banks
    assert got.labels == want.labels and len(got.labels) >= 3
    for lab in got.labels:
        assert got.count(lab) == want.count(lab), lab
        np.testing.assert_allclose(got.get(lab), want.get(lab), atol=1e-4, rtol=1e-4)


# ---- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("levels", [3, 5])
def test_unported_options_raise(levels):
    """The options the port still refuses name their ROADMAP item: GDINO at
    other than 4 feature levels (JAX builds min(levels, 4) projections;
    Queue A 5.4). TEST.USE_MULTISCALE and GLIPKNOW.KNOWLEDGE_FILE, refused
    before, are ported (`test_torch_port_tta.py`, `test_torch_port_knowledge.py`)."""
    from mqdet_torch.utils.builders import build_model, tiny_gdino_config

    cfg = tiny_gdino_config()
    cfg.GROUNDINGDINO.num_feature_levels = levels
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 5.4"):
        build_model(cfg)
