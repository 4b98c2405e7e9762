"""The port's vision-query path vs the JAX package: the copies of the
framework-free modules (tokenizer, prompts, QueryBank, QuerySelector,
CocoDetectionDataset) pinned to the originals, the evaluation transform,
expand_boxes, ROIAlign in both routes, and query extraction into a bank for
tiny MQ-GLIP (S = 1 and S = 5) and tiny MQ-GroundingDINO.

Both sides get a `WordPieceTokenizer()` from their own package (the hash
vocab): `get_tokenizer()` may resolve a local HF tokenizer on one side only.
Models are the tiny configs in fp32 with the same weights (through
`params_from_jax`). The port's transform computes PIL's BILINEAR resize bit
for bit, so both sides see the same pixels. Tolerances: ROIAlign atol 1e-5
(fp32 rounding of one bilinear blend and a mean), pooled features atol and
rtol 1e-4 (the features' tolerance of `test_torch_port_slice.py`).
"""
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.data import coco as jcoco
from mqdet_tpu.data import grounding as jg
from mqdet_tpu.data import tokenizer as jtok
from mqdet_tpu.data import transforms as jtf
from mqdet_tpu.mq import bank as jbank
from mqdet_tpu.mq import extract as jext
from mqdet_tpu.mq import selector as jsel
from mqdet_tpu.ops import roi_align as jroi
from mqdet_tpu.utils import builders as jb
from mqdet_torch.core.boxes import expand_boxes
from mqdet_torch.data import coco as tcoco
from mqdet_torch.data import grounding as tg
from mqdet_torch.data import tokenizer as ttok
from mqdet_torch.data import transforms as ttf
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.mq import bank as tbank
from mqdet_torch.mq import extract as text
from mqdet_torch.mq import selector as tsel
from mqdet_torch.ops import roi_align as troi
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import flat_params, perturb, tiny_pair

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CAPTIONS = [
    "cat. dog. hot dog",
    "bow-tie (necktie). ski_pole. Crème brûlée",
    "person. bicycle's wheel, 3-D glasses; (unusual) name!",
    "a_b_c. x(y)z. " * 12,  # long enough to truncate at T
]
LVIS_NAMES = ["aerosol_can", "bow_(weapon)", "hot_dog", "ski pole", "crème_brûlée", "cat",
              "bicycle", "glass_(drink_container)", "person", "dog", "tie", "frisbee"]
SCALES = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)


# ---- the framework-free copies ---------------------------------------------


def test_tokenizer_copy_matches():
    jt, tt = jtok.WordPieceTokenizer(), ttok.WordPieceTokenizer()
    for cap in CAPTIONS + [tg.clean_name(n) for n in LVIS_NAMES]:
        assert jt.tokenize(cap) == tt.tokenize(cap)
        a, b = jt(cap, max_length=32), tt(cap, max_length=32)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
        for c in range(len(cap) + 1):
            assert a.char_to_token(c) == b.char_to_token(c), (cap, c)
    assert jt.convert_tokens_to_ids(["[MASK]", "x"]) == tt.convert_tokens_to_ids(["[MASK]", "x"])


def test_prompt_copies_match():
    ind_to_class = {i + 1: n for i, n in enumerate(LVIS_NAMES)}
    for name in LVIS_NAMES:
        assert jg.clean_name(name) == tg.clean_name(name)
    assert jg.chunk_classes(list(ind_to_class), 5) == tg.chunk_classes(list(ind_to_class), 5)
    assert jg.chunk_classes([1, 2], -1) == tg.chunk_classes([1, 2], -1)
    prompts = [{"prefix": "a ", "name": n, "suffix": " thing"} for n in LVIS_NAMES[:4]]
    for labels, prompt, t in (([1, 2, 3], None, 32), ([2, 5, 6, 8], prompts, 32), (list(ind_to_class), None, 24)):
        a = jg.build_prompt(labels, ind_to_class, jtok.WordPieceTokenizer(), max_text_len=t, caption_prompt=prompt)
        b = tg.build_prompt(labels, ind_to_class, ttok.WordPieceTokenizer(), max_text_len=t, caption_prompt=prompt)
        assert a.caption == b.caption and a.label_ids == b.label_ids
        for key in ("input_ids", "attention_mask", "all_map", "agg_map", "positive_category_map"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
        for pa, pb in zip(jg.pad_prompt_maps(a, 16), tg.pad_prompt_maps(b, 16)):
            np.testing.assert_array_equal(pa, pb)


def _same_bank(a, b):
    assert a.labels == b.labels
    for lab in a.labels:
        np.testing.assert_array_equal(a.get(lab), b.get(lab))


def test_query_bank_copy_matches(tmp_path):
    rng = np.random.default_rng(0)
    banks = [jbank.QueryBank(channels=8, num_scales=2), tbank.QueryBank(channels=8, num_scales=2)]
    base = rng.standard_normal((6, 2, 8)).astype(np.float32)
    near = base + 0.01 * rng.standard_normal(base.shape).astype(np.float32)  # cosine > 0.85
    other = rng.standard_normal((2, 2, 8)).astype(np.float32)
    for bank in banks:
        assert bank.add(3, base[:4], capacity=3) == 3
        assert bank.add(3, near[:2], exclude_similar=True) == 0
        assert bank.add(5, base.reshape(-1, 8)[:, None].repeat(2, 1)) == 12
        assert bank.add(7, other, exclude_similar=True) == 2
    _same_bank(*banks)
    for x, y in zip(banks[0].pack([3, 9, 5], 4), banks[1].pack([3, 9, 5], 4)):
        np.testing.assert_array_equal(x, y)
    # save -> the other package's load, both ways
    banks[1].save(str(tmp_path / "port.npz"))
    _same_bank(jbank.QueryBank.load(str(tmp_path / "port.npz")), banks[1])
    banks[0].save(str(tmp_path / "jax.npz"))
    _same_bank(tbank.QueryBank.load(str(tmp_path / "jax.npz")), banks[0])
    # merge with a cap
    extra = [jbank.QueryBank(channels=8, num_scales=2), tbank.QueryBank(channels=8, num_scales=2)]
    for e, bank in zip(extra, banks):
        e.add(3, base[3:6])
        e.add(11, base[:1])
        bank.merge(e, capacity=5)
    _same_bank(*banks)
    # a reference .pth bank: (n, C) and (n, S, C) entries
    raw = {3: torch.randn(4, 8), 9: torch.randn(2, 8), 12: torch.zeros(0, 8)}
    torch.save(raw, str(tmp_path / "bank.pth"))
    a, b = jbank.QueryBank.from_torch_pth(str(tmp_path / "bank.pth")), tbank.QueryBank.from_torch_pth(
        str(tmp_path / "bank.pth"))
    _same_bank(a, b)
    assert b.labels == [3, 9] and b.num_scales == 1


def test_query_selector_copy_matches():
    """One seed on both sides: `random.seed(s)` right before each call, because
    both selectors draw from the one module-level `random` when given no rng;
    the feature form and the learnable bank's index form (`emit_indices`)."""
    rng = np.random.default_rng(1)
    feats = {lab: rng.standard_normal((n, 1, 8)).astype(np.float32) for lab, n in ((1, 9), (2, 3), (4, 7))}
    jbk, tbk = jbank.QueryBank(channels=8), tbank.QueryBank(channels=8)
    for lab, f in feats.items():
        jbk.add(lab, f)
        tbk.add(lab, f)
    loc = (rng.random((5, 16)) > 0.7).astype(np.float32) * 0.5
    for kwargs, training in (({}, False), ({"random_kshot": True, "pure_text_rate": 0.3}, True)):
        js = jsel.QuerySelector(jbk, num_query_per_class=4, max_labels=5, **kwargs)
        ts = tsel.QuerySelector(tbk, num_query_per_class=4, max_labels=5, **kwargs)
        for seed in range(4):
            random.seed(seed)
            a = js.select([1, 2, 3, 4, 9], loc, training=training)
            random.seed(seed)
            b = ts.select([1, 2, 3, 4, 9], loc, training=training)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert js.max_queries == ts.max_queries
    # the learnable bank's index form: int32 (row, slot) pairs, the table's shape and values
    js = jsel.QuerySelector(jbk, num_query_per_class=4, max_labels=5, emit_indices=True)
    ts = tsel.QuerySelector(tbk, num_query_per_class=4, max_labels=5, emit_indices=True)
    assert js.bank_table_shape() == ts.bank_table_shape() == (3, 9, 8)
    np.testing.assert_array_equal(js.bank_table(), ts.bank_table())
    for seed in range(3):
        random.seed(seed)
        a = js.select([1, 2, 3, 4, 9], loc, training=bool(seed))
        random.seed(seed)
        b = ts.select([1, 2, 3, 4, 9], loc, training=bool(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert b[0].dtype == np.int32 and b[0].shape == (20, 2)


def write_coco(root, sizes, boxes_per_image=3, categories=None, seed=0):
    """A COCO/LVIS-format json with PNG images of `sizes` ((h, w) each),
    seeded uint8 pixels, LVIS names and frequencies, crowd and empty boxes,
    neg_category_ids and not_exhaustive_category_ids. Returns (ann_file,
    img_dir)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    categories = categories or [
        {"id": 10 + 3 * i, "name": n, "frequency": "rcf"[i % 3]} for i, n in enumerate(LVIS_NAMES)
    ]
    img_dir = root / "images"
    img_dir.mkdir(exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(img_dir / f"{i}.png")
        cats = rng.choice(len(categories), boxes_per_image + 2, replace=False)
        images.append({"id": 100 + i, "file_name": f"{i}.png", "height": h, "width": w,
                       "neg_category_ids": [categories[cats[-1]]["id"]],
                       "not_exhaustive_category_ids": [categories[cats[-2]]["id"]]})
        for j in range(boxes_per_image):
            x0, y0 = rng.uniform(0, w * 0.5), rng.uniform(0, h * 0.5)
            bw, bh = rng.uniform(6, w - x0), rng.uniform(6, h - y0)
            anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": categories[cats[j]]["id"],
                         "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0})
    anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": categories[0]["id"],
                 "bbox": [1, 1, 5, 5], "area": 25, "iscrowd": 1})
    anns.append({"id": len(anns) + 1, "image_id": 100, "category_id": categories[0]["id"],
                 "bbox": [1, 1, 0, 5], "area": 0, "iscrowd": 0})
    ann_file = root / "ann.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns, "categories": categories}))
    return str(ann_file), str(img_dir)


def test_coco_dataset_copy_matches(tmp_path):
    ann_file, img_dir = write_coco(tmp_path, [(60, 80)] * 5 + [(80, 60)], seed=2)
    for kwargs in ({}, {"few_shot": 1, "shuffle_seed": 3}, {"exclude_crowd": False}):
        a, b = jcoco.CocoDetectionDataset(ann_file, img_dir, **kwargs), tcoco.CocoDetectionDataset(
            ann_file, img_dir, **kwargs)
        assert a.ids == b.ids and len(a) == len(b)
        for key in ("ind_to_class", "cat_id_to_contiguous", "contiguous_to_cat_id", "categories",
                    "img_neg_cats", "img_not_exhaustive"):
            assert getattr(a, key) == getattr(b, key), key
        for img_id in b.ids:
            for x, y in zip(a.annotations(img_id), b.annotations(img_id)):
                np.testing.assert_array_equal(x, y)
            assert a.image_size(img_id) == b.image_size(img_id)
            np.testing.assert_array_equal(a.load_image(img_id), b.load_image(img_id))


# ---- the evaluation transform ----------------------------------------------


@pytest.mark.parametrize("hw,min_max,buckets", [
    ((60, 80), (48, 80), ((48, 64),)),        # downscale into a 48-class bucket
    ((80, 60), (48, 80), ((48, 64),)),        # portrait: the transposed bucket
    ((60, 80), (72, 96), ((80, 96),)),        # upscale, padded below
    ((60, 80), (64, 80), ((64, 96), (48, 64))),  # upscale, padded right; the larger of two buckets
    ((480, 640), (800, 1333), ((800, 1344),)),  # the LVIS protocol's landscape and portrait
    ((640, 480), (800, 1333), ((800, 1344),)),
    ((37, 53), (48, 80), ((64, 96),)),        # odd sizes, both factors non-integer
])
def test_eval_transform_matches_jax(hw, min_max, buckets):
    """The port's transform against the JAX module's (PIL): the resized uint8
    pixels equal (the share that differs is printed; it is 0), the padded,
    normalized output within 1e-6, the sizes and scale factors equal."""
    cfg_j, cfg_t = jb.tiny_test_config(), tb.tiny_test_config()
    for cfg in (cfg_j, cfg_t):
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = min_max
        cfg.TPU.IMAGE_BUCKETS = buckets
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    want, size_j, scale_j = jtf.EvalTransform(cfg_j)(img)
    got, size_t, scale_t = ttf.EvalTransform(cfg_t)(img, "cpu")
    assert size_t == size_j and scale_t == scale_j
    assert tuple(got.shape) == (1, 3) + want.shape[:2]
    pixels_j = jtf.resize_image(img, *size_j).astype(np.float32)
    pixels_t = ttf.resize_image(torch.from_numpy(img), *size_t).permute(1, 2, 0).numpy()
    differ = float((pixels_j != pixels_t).mean())
    print(f"{hw} -> {size_t}: share of resized values that differ from PIL {differ}")
    assert differ == 0.0
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want, atol=1e-6, rtol=0)
    assert jtf.pick_bucket(*size_j, buckets) == ttf.pick_bucket(*size_t, buckets)
    assert jtf.get_resize_size(*hw, *min_max) == ttf.get_resize_size(*hw, *min_max)


def test_expand_boxes_matches_jax():
    from mqdet_tpu.core.boxes import expand_boxes as jexpand

    boxes = np.array([[5, 5, 20, 30], [0, 0, 63, 47], [50, 40, 70, 60], [10, 10, 10, 10]], np.float32)
    for ratio, h, w in ((1.5, 48.0, 64.0), (1.0, 60.0, 80.0), (2.5, 48.0, 64.0)):
        got = expand_boxes(torch.from_numpy(boxes), ratio, h, w).numpy()
        np.testing.assert_array_equal(got, np.asarray(jexpand(jnp.asarray(boxes), ratio, h, w)))


# ---- ROIAlign --------------------------------------------------------------


def roi_case(seed=0):
    """5 levels of a 160x224 image (strides 8..128, the smallest 2x2) and
    boxes inside, on the border, past the map and of sizes that map to every
    level (sqrt(area) 10 to 900). No sample lies exactly on the edge of the
    zero region (y = -1 or H, x = -1 or W): there XLA's fused multiply-add
    and PyTorch's two roundings may fall on either side."""
    rng = np.random.default_rng(seed)
    shapes = [(20, 28), (10, 14), (5, 7), (3, 4), (2, 2)]
    maps = [rng.standard_normal(s + (6,)).astype(np.float32) for s in shapes]
    rois = [[10, 12, 30, 40], [0, 0, 223, 159], [200, 140, 260, 190], [-30, -20, 5, 8],
            [100, 60, 100.5, 60.5], [0, 0, 900, 900], [40, 30, 140, 130], [60, 21, 460, 423],
            [3.3, 7.7, 13.1, 17.9], [215, 0, 224, 160], [10, 10, 560, 610], [-7, -3, 1993, 1903]]
    return maps, np.asarray(rois, np.float32)


def test_roi_align_matches_jax():
    maps, rois = roi_case()
    for level, (f, sc) in enumerate(zip(maps, SCALES)):
        for p, s in ((7, 2), (3, 1)):
            want = jroi.roi_align(jnp.asarray(f), jnp.asarray(rois), sc, output_size=p, sampling_ratio=s)
            got = troi.roi_align(torch.from_numpy(f), torch.from_numpy(rois), sc, output_size=p, sampling_ratio=s)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0, err_msg=f"level {level}")


def test_multi_and_all_level_roi_align_match_jax():
    maps, rois = roi_case(1)
    area = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    target = np.clip(np.floor(4 + np.log2(np.sqrt(np.maximum(area, 1e-6)) / 224 + 1e-6)), 3, 7) - 3
    assert set(target.astype(int)) == {0, 1, 2, 3, 4}, "the boxes must cross every level"
    tmaps, trois = [torch.from_numpy(f) for f in maps], torch.from_numpy(rois)
    want = jroi.multi_level_roi_align([jnp.asarray(f) for f in maps], jnp.asarray(rois), SCALES)
    np.testing.assert_allclose(troi.multi_level_roi_align(tmaps, trois, SCALES).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    want = jroi.all_level_roi_align([jnp.asarray(f) for f in maps], jnp.asarray(rois), SCALES)
    got = troi.all_level_roi_align(tmaps, trois, SCALES)
    assert tuple(got.shape) == (5, len(rois), 7, 7, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # GDINO: 4 levels take the first 4 scales
    want = jroi.multi_level_roi_align([jnp.asarray(f) for f in maps[:4]], jnp.asarray(rois), SCALES)
    np.testing.assert_allclose(troi.multi_level_roi_align(tmaps[:4], trois, SCALES).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


# ---- extraction --------------------------------------------------------------


def gdino_pair(mods=None):
    """(jax model, jax params, torch model, jax cfg, torch cfg) of tiny
    MQ-GroundingDINO with the same weights; `mods(cfg)` edits both configs."""
    jcfg, tcfg = jb.tiny_gdino_config(), tb.tiny_gdino_config()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES = SCALES[:4]
        if mods is not None:
            mods(cfg)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jb.build_model(jcfg)
    b = tb.synthetic_caption_batch(tcfg, 2, (96, 96), num_labels=3, k_shot=2, seed=0)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    params = perturb(jb.init_params_fast(jmodel, *(jnp.asarray(b[k]) for k in keys), seed=0))
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return jmodel, params, tmodel, jcfg, tcfg


@pytest.fixture(scope="module")
def glip():
    return tiny_pair()


@pytest.fixture(scope="module")
def gdino():
    return gdino_pair()


EXTRACT_BOXES = np.array([[4, 6, 30, 40], [0, 0, 95, 95], [60, 50, 94, 70], [40, 40, 41, 42],
                          [10, 70, 90, 95], [-5, -5, 20, 20]], np.float32)


@pytest.mark.parametrize("family,select_level", [("glip", True), ("glip", False), ("gdino", True)])
def test_make_extract_fn_matches_jax(request, family, select_level):
    jmodel, params, tmodel, jcfg, tcfg = request.getfixturevalue(family)
    for cfg in (jcfg, tcfg):
        cfg.VISION_QUERY.SELECT_FPN_LEVEL = select_level
    try:
        image = np.random.default_rng(7).standard_normal((1, 96, 96, 3)).astype(np.float32)
        want = jext.make_extract_fn(jmodel, (96, 96), jcfg)(
            params, jnp.asarray(image), jnp.asarray(EXTRACT_BOXES), 90.0, 96.0)
        got = text.make_extract_fn(tmodel, tcfg)(
            torch.from_numpy(image).permute(0, 3, 1, 2), EXTRACT_BOXES, 90.0, 96.0)
    finally:
        for cfg in (jcfg, tcfg):
            cfg.VISION_QUERY.SELECT_FPN_LEVEL = True
    levels = 4 if family == "gdino" else 5
    assert tuple(got.shape) == (len(EXTRACT_BOXES), 1 if select_level else levels, 16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_extract_queries_into_bank_matches_jax(request, tmp_path, family):
    """Over a 4-image synthetic COCO (one portrait image, 3 boxes each), the
    transformed image and its boxes as the JAX training CLI's extraction
    iterator builds them: the same labels and counts, features within the
    tolerance. MAX_QUERY_NUMBER 2 makes the cap bind."""
    jmodel, params, tmodel, jcfg, tcfg = request.getfixturevalue(family)
    bucket = (96, 96) if family == "gdino" else (64, 96)
    for cfg in (jcfg, tcfg):
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = (72, 96) if family == "gdino" else (48, 80)
        cfg.TPU.IMAGE_BUCKETS = (bucket,)
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(LVIS_NAMES[:6])]
    ann_file, img_dir = write_coco(tmp_path, [(60, 80)] * 3 + [(80, 60)], categories=cats, seed=4)
    jds, tds = jcoco.CocoDetectionDataset(ann_file, img_dir), tcoco.CocoDetectionDataset(ann_file, img_dir)

    jfn, transform = jext.make_extract_fn(jmodel, bucket, jcfg), jtf.EvalTransform(jcfg)

    def jax_iter():
        for img_id in jds.ids:
            padded, (oh, ow), (sy, sx) = transform(jds.load_image(img_id))
            boxes, labels = jds.annotations(img_id)
            yield {"image": jnp.asarray(padded[None]), "boxes": boxes / np.array([sx, sy, sx, sy], np.float32),
                   "labels": labels, "image_size": (float(oh), float(ow))}

    want = jext.extract_queries_into_bank(jfn, params, jax_iter(), jbank.QueryBank(channels=16),
                                          max_query_number=2)
    got = text.extract_queries_into_bank(
        text.make_extract_fn(tmodel, tcfg), text.dataset_extraction_iter(tds, ttf.EvalTransform(tcfg), "cpu"),
        tbank.QueryBank(channels=16), max_query_number=2)
    assert got.labels == want.labels and len(got.labels) >= 3
    assert max(got.count(l) for l in got.labels) == 2
    for lab in got.labels:
        assert got.count(lab) == want.count(lab)
        np.testing.assert_allclose(got.get(lab), want.get(lab), atol=1e-4, rtol=1e-4)
