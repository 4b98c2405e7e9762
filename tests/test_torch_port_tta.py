"""The port's test-time augmentation vs the JAX package: the copy of
`engine/box_aug.py` (NMS, Gaussian soft-NMS, box voting, the per-class merge
under every TEST.SPECIAL_NMS, `im_detect_bbox_aug` with ranges and flip),
`ops/nms.py::soft_nms` against the jitted JAX one, and `run_inference`
under TEST.USE_MULTISCALE for tiny MQ-GLIP and tiny MQ-GroundingDINO.

The numpy copies must give equal results. soft_nms: atol 1e-6 on the
decayed scores, the same indices. run_inference: three scales over two
buckets, flip on, SPECIAL_NMS `nms` and `soft-vote`; the detections compared
as `test_torch_port_eval.py` compares them (the same labels and counts,
boxes and scores within atol 1e-4 and rtol 1e-4), the AP fields within 1e-6.
"""
import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.data import coco as jcoco
from mqdet_tpu.data import tokenizer as jtok
from mqdet_tpu.engine import box_aug as jaug
from mqdet_tpu.engine import evaluator as jev
from mqdet_tpu.engine import inference as jinf
from mqdet_tpu.engine import predict as jpredict
from mqdet_tpu.ops import nms as jnms
from mqdet_torch.data import coco as tcoco
from mqdet_torch.data import tokenizer as ttok
from mqdet_torch.engine import box_aug as taug
from mqdet_torch.engine import evaluator as tev
from mqdet_torch.engine import inference as tinf
from mqdet_torch.ops import nms as tnms
from test_torch_port_eval import (  # noqa: F401  (module fixtures)
    assert_same_ap, data, gdino, glip, recording, seeded_banks, selectors,
)

torch.set_num_threads(2)

NMS_TYPES = ("none", "nms", "soft-nms", "vote", "soft-vote")
# family -> (buckets, scales, TEST.MAX_SIZE): the 60x80 images (and the 80x60
# one) resize into both buckets, rotated for the portrait image
TTA = {"glip": (((48, 64), (64, 96)), (40, 48, 56), 96), "gdino": (((64, 96), (96, 96)), (60, 64, 72), 96)}


def seeded_boxes(rng, n, classes=4):
    xy = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (n, 2))], 1).astype(np.float32)
    # clusters: copies of a few boxes nudged, so NMS and voting have work
    boxes[n // 2:] = boxes[: n - n // 2] + rng.normal(0, 2, (n - n // 2, 4)).astype(np.float32)
    return boxes, rng.random(n).astype(np.float32), rng.integers(1, classes + 1, n).astype(np.int64)


def same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- the numpy copy ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_soft_nms_and_voting_copies_match(seed):
    rng = np.random.default_rng(seed)
    boxes, scores, _ = seeded_boxes(rng, 40)
    for thresh in (0.3, 0.6):
        same(taug.nms_numpy(boxes, scores, thresh), jaug.nms_numpy(boxes, scores, thresh))
        same(taug.soft_nms_numpy(boxes, scores, thresh), jaug.soft_nms_numpy(boxes, scores, thresh))
        for soft in (False, True):
            same(taug.bbox_vote(boxes, scores, thresh, soft), jaug.bbox_vote(boxes, scores, thresh, soft))
    same(taug._iou_matrix(boxes, boxes[:7]), jaug._iou_matrix(boxes, boxes[:7]))


@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_merge_multi_scale_copy_matches(nms_type):
    rng = np.random.default_rng(3)
    boxes, scores, labels = seeded_boxes(rng, 60)
    for kw in ({}, {"max_detections": 10}, {"select_classes": [2, 3, 9]}, {"thresh": 0.3}):
        same(taug.merge_multi_scale(boxes, scores, labels, nms_type, **kw),
             jaug.merge_multi_scale(boxes, scores, labels, nms_type, **kw))
    empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32), np.zeros((0,), np.int64))
    same(taug.merge_multi_scale(*empty, nms_type), jaug.merge_multi_scale(*empty, nms_type))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ranges", [None, [(0, 30), (10, 1e9), None]])
def test_im_detect_bbox_aug_copy_matches(flip, ranges):
    """A seeded fake detector per (scale, flip): the calls made and the merge."""
    calls = {"jax": [], "torch": []}

    def predictor(side):
        def predict(image, min_size, max_size, hflip):
            calls[side].append((min_size, max_size, hflip))
            rng = np.random.default_rng(min_size * 2 + hflip)
            b, s, l = seeded_boxes(rng, 12)
            return {"boxes": b, "scores": s, "labels": l}
        return predict

    image = np.zeros((60, 80, 3), np.uint8)
    for nms_type in ("nms", "soft-vote"):
        kw = dict(scales=(40, 56, 72), max_size=96, flip=flip, ranges=ranges, nms_type=nms_type, thresh=0.5,
                  max_detections=20)
        same(taug.im_detect_bbox_aug(predictor("torch"), image, **kw),
             jaug.im_detect_bbox_aug(predictor("jax"), image, **kw))
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 2 * 3 * (1 + flip)


# ---- soft_nms ------------------------------------------------------------------


@pytest.mark.parametrize("max_outputs", [10, 50])
def test_soft_nms_matches_jax(max_outputs):
    """A batch of 3 rows against the jitted JAX function row by row: the
    same indices and validity, the decayed scores within 1e-6."""
    rng = np.random.default_rng(4)
    rows = [seeded_boxes(rng, 40) for _ in range(3)]
    boxes = np.stack([r[0] for r in rows])
    scores = np.stack([r[1] for r in rows])
    valid = rng.random((3, 40)) < 0.8
    got = tnms.soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
                        max_outputs=max_outputs)
    assert [t.dtype for t in got] == [torch.int64, torch.float32, torch.bool]
    for i in range(3):
        want = jnms.soft_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]),
                             max_outputs=max_outputs)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
    assert got[2].any() and (max_outputs < 30 or not got[2].all())  # 50 steps outrun the valid boxes


# ---- run_inference under TEST.USE_MULTISCALE -----------------------------------


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX package's make_split_predict_fns built once per (model,
    bucket) for the module (each build is a new jit, compiled anew)."""
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


def tta_settings(cfg, family, nms_type):
    buckets, scales, max_size = TTA[family]
    cfg.TPU.IMAGE_BUCKETS = buckets
    cfg.TEST.USE_MULTISCALE, cfg.TEST.FLIP = True, True
    cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = scales, max_size
    cfg.TEST.SPECIAL_NMS, cfg.TEST.TH = nms_type, 0.6


@pytest.mark.parametrize("nms_type", ["nms", "soft-vote"])
@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_run_inference_multiscale_matches_jax(request, jax_fns, data, family, nms_type):
    jmodel, params, tmodel, jcfg, tcfg = request.getfixturevalue(family)
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    for cfg in (jcfg, tcfg):
        tta_settings(cfg, family, nms_type)
    ann_file, img_dir, freq = data
    sels = selectors(tcfg, seeded_banks())
    evs = [recording(m.DetectionEvaluator)(style="lvis_fixed", max_dets=300, category_frequency=freq)
           for m in (jev, tev)]
    random.seed(0)
    want = jinf.run_inference(jcfg, jmodel, params, jcoco.CocoDetectionDataset(ann_file, img_dir),
                              jtok.WordPieceTokenizer(), sels[0], evaluator=evs[0], verbose=False)
    random.seed(0)
    built = []
    make = tinf.make_split_predict_fns
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinf, "make_split_predict_fns", lambda m, b, c: built.append(tuple(b)) or make(m, b, c))
        got = tinf.run_inference(tcfg, tmodel, tcoco.CocoDetectionDataset(ann_file, img_dir),
                                 ttok.WordPieceTokenizer(), sels[1], evaluator=evs[1], verbose=False)
    # every bucket's predict functions built once for the run: both buckets and the portrait image's rotated ones
    assert len(built) == len(set(built)) and len(built) >= 3
    assert evs[0].seen.keys() == evs[1].seen.keys()
    for img_id, (jb_, js, jl) in evs[0].seen.items():
        tb_, ts, tl = evs[1].seen[img_id]
        assert len(tl) >= 4, "too few detections to compare"
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tb_, jb_, atol=1e-4, rtol=1e-4)
    assert_same_ap(want, got)


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_multiscale_scale_that_fits_no_bucket_raises(request, jax_fns, data, family):
    jmodel, params, tmodel, jcfg, tcfg = request.getfixturevalue(family)
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    for cfg in (jcfg, tcfg):
        tta_settings(cfg, family, "nms")
        cfg.TEST.SCALES, cfg.TEST.MAX_SIZE = (48, 200), 300  # 200x266 fits no bucket
    ann_file, img_dir, _ = data
    with pytest.raises(ValueError, match="fits no TPU.IMAGE_BUCKETS entry"):
        jinf.run_inference(jcfg, jmodel, params, jcoco.CocoDetectionDataset(ann_file, img_dir),
                           jtok.WordPieceTokenizer(), None, verbose=False)
    with pytest.raises(ValueError, match="fits no TPU.IMAGE_BUCKETS entry"):
        tinf.run_inference(tcfg, tmodel, tcoco.CocoDetectionDataset(ann_file, img_dir), ttok.WordPieceTokenizer(),
                           None, verbose=False)


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_online_update_under_multiscale_matches_jax(request, jax_fns, data, family):
    """JAX's `online_update` reads no TEST.USE_MULTISCALE: one turn updates at
    the single scale, and so does the port's (it refused the option before).
    One turn over the 2 landscape images from an empty bank: the same labels
    and counts, the features within atol and rtol 1e-4."""
    from mqdet_tpu.mq import bank as jbank
    from mqdet_tpu.mq import extract as jext
    from mqdet_torch.mq import bank as tbank
    from mqdet_torch.mq import extract as text
    jmodel, params, tmodel, jcfg, tcfg = request.getfixturevalue(family)
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    # JAX's update builds its functions for the first bucket: make it the one the single scale picks
    first = {"glip": (48, 64), "gdino": (96, 96)}[family]
    for cfg in (jcfg, tcfg):
        tta_settings(cfg, family, "soft-vote")
        cfg.TPU.IMAGE_BUCKETS = (first,) + tuple(b for b in TTA[family][0] if b != first)
        cfg.VISION_QUERY.MAX_TEST_QUERY_NUMBER = 4
    ann_file, img_dir, _ = data
    banks = jbank.QueryBank(channels=16), tbank.QueryBank(channels=16)
    sels = selectors(tcfg, banks)
    jinf.online_update(jcfg, jmodel, params, jcoco.CocoDetectionDataset(ann_file, img_dir), jtok.WordPieceTokenizer(),
                       sels[0], jext.make_extract_fn(jmodel, first, jcfg), max_images=2)
    tinf.online_update(tcfg, tmodel, tcoco.CocoDetectionDataset(ann_file, img_dir), ttok.WordPieceTokenizer(),
                       sels[1], text.make_extract_fn(tmodel, tcfg), max_images=2)
    want, got = banks
    assert got.labels == want.labels and len(got.labels) >= 3
    for lab in got.labels:
        assert got.count(lab) == want.count(lab), lab
        np.testing.assert_allclose(got.get(lab), want.get(lab), atol=1e-4, rtol=1e-4)
