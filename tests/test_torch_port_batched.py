"""The port's image-batched LVIS protocol, its one-call predict and the
remaining public helpers against the JAX package, at the tiny configs in fp32.

`make_batched_protocol_fn` runs B images x G chunk groups: the image tower
once at batch B, each group's head at batch B * CP (features repeated
image-major, prompts tiled). It is held against JAX's on the same weights
(MQ-GLIP-T tiny at 64x64, MQ-GroundingDINO-T tiny at 96x96, whose pyramid
has no 1x1 level) with B 2, CP 2, G 2, images of two different true sizes
and a distinct prompt for every (group, chunk); and entry by entry against
the port's own per-image `make_protocol_fn`. `make_predict_fn` (encode +
head in one call) is held against JAX's at batch 2. Tolerances, those of
tests/test_torch_port_slice.py: scores atol 1e-5, valid boxes 1e-4, labels
and validity equal. One JAX compile of each family's batched protocol.

The helpers (`core/detections.py`'s concatenate / top_k / resize /
to_numpy_dict, `ops/nms.py::nms`, `core/boxes.py`'s box_iou_aligned /
xyxy_to_cxcywh, `utils/profiling.py`'s annotate / device_fence /
StepTimer, `io/checkpoints.py::save_params_npz`, `pad_image_to_bucket`) are
one parametrised test against their JAX counterparts.
"""
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.engine import predict as jpredict
from mqdet_tpu.utils import builders as jb
from mqdet_torch.engine import predict as tpredict
from mqdet_torch.io.from_jax import params_from_jax
from mqdet_torch.utils import builders as tb
from test_torch_port_modules import flat_params, nchw, perturb, tiny_pair

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, CP, G = 2, 2, 2
ORDER = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")


@functools.lru_cache(maxsize=1)
def _glip_pair():
    """The tiny MQ-GLIP-T pair, built once for the module's tests."""
    def mods(cfg):
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
        cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 20

    jmodel, params, tmodel, jcfg, tcfg = tiny_pair(mods)
    return jmodel, params, tmodel, jcfg, tcfg, (64, 64), lambda cfg, seed: jb.synthetic_batch(cfg, 1, (64, 64), 3, 2,
                                                                                             seed=seed)


def _gdino_pair():
    hw = (96, 96)
    jcfg, tcfg = jb.tiny_gdino_config(), tb.tiny_gdino_config()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    for cfg in (jcfg, tcfg):
        cfg.GROUNDINGDINO.box_threshold = 0.9  # about half of the slots pass
    jmodel = jb.build_model(jcfg)

    def captions(cfg, seed, batch=1):
        return tb.synthetic_caption_batch(cfg, batch, hw, num_labels=3, k_shot=2, seed=seed)

    b = captions(tcfg, 0, batch=2)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    params = perturb(jb.init_params_fast(jmodel, *(jnp.asarray(b[k]) for k in keys), seed=0))
    tmodel = tb.build_model(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(flat_params(params), tmodel))
    return jmodel, params, tmodel, jcfg, tcfg, hw, captions


@pytest.fixture(scope="module", params=["glip", "gdino"])
def family(request):
    """(name, jax model, params, port model, jax cfg, port cfg, hw, images
    NHWC, image sizes (B, 2), prompts {key: (G, CP, ...)})."""
    jmodel, params, tmodel, jcfg, tcfg, hw, prompt = _glip_pair() if request.param == "glip" else _gdino_pair()
    rng = np.random.default_rng(5)
    images = rng.standard_normal((B,) + hw + (3,)).astype(np.float32)
    sizes = np.array([hw, (hw[0] - 6, hw[1] - 10)], np.float32)
    images[1, int(sizes[1, 0]):] = 0.0  # the second image is smaller than the bucket: zero padding
    images[1, :, int(sizes[1, 1]):] = 0.0
    chunks = [[prompt(tcfg, 17 * g + c + 1) for c in range(CP)] for g in range(G)]
    text = {k: np.stack([np.stack([ch[k][0] for ch in grp]) for grp in chunks]) for k in ORDER}
    text["attention_mask"][1, 0, 12:] = 0  # one chunk with a padded tail
    return request.param, jmodel, params, tmodel, jcfg, tcfg, hw, images, sizes, text


def _assert_same(got, want, what=""):
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), v, err_msg=what)
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(want.labels), err_msg=what)
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), atol=1e-5, err_msg=what)
    np.testing.assert_allclose(np.asarray(got.boxes)[v], np.asarray(want.boxes)[v], atol=1e-4, err_msg=what)


def _port_batched(family):
    _, _, _, tmodel, _, tcfg, hw, images, sizes, text = family
    fn = tpredict.make_batched_protocol_fn(tmodel, hw, tcfg, image_batch=B)
    return fn(nchw(images), torch.from_numpy(sizes), *(torch.from_numpy(text[k]) for k in ORDER))


def test_batched_protocol_matches_jax(family):
    name, jmodel, params, _, jcfg, _, hw, images, sizes, text = family
    t0 = time.perf_counter()
    want = jpredict.make_batched_protocol_fn(jmodel, hw, jcfg, image_batch=B)(
        params, jnp.asarray(images), jnp.asarray(sizes), *(jnp.asarray(text[k]) for k in ORDER))
    jax_s = time.perf_counter() - t0
    got = _port_batched(family)
    n = want.valid.shape[-1]
    assert got.boxes.shape == (G, B * CP, n, 4) and got.valid.shape == (G, B * CP, n)
    v = np.asarray(want.valid)
    assert v.any(axis=-1).all(), f"{name}: an entry without a valid detection compares too little"
    _assert_same(got, want, f"{name} (JAX's compile and call {jax_s:.1f} s)")


def test_batched_protocol_matches_per_image_protocol(family):
    """Entry i * CP + c of each group is image i against chunk c of the
    port's per-image protocol."""
    name, _, _, tmodel, _, tcfg, hw, images, sizes, text = family
    got = _port_batched(family)
    single = tpredict.make_protocol_fn(tmodel, hw, tcfg)
    for i in range(B):
        sz = torch.from_numpy(np.broadcast_to(sizes[i], (G, CP, 2)).copy())
        want = single(nchw(images[i:i + 1]), *(torch.from_numpy(text[k]) for k in ORDER), sz)
        for c in range(CP):
            entry = type(got)(**{f: getattr(got, f)[:, i * CP + c] for f in ("boxes", "scores", "labels", "valid")})
            part = type(want)(**{f: getattr(want, f)[:, c] for f in ("boxes", "scores", "labels", "valid")})
            _assert_same(entry, part, f"{name} image {i} chunk {c}")


def test_predict_fn_matches_jax():
    """make_predict_fn at batch 2 (MQ-GLIP-T tiny): image b against prompt b,
    the second image smaller than the bucket."""
    jmodel, params, tmodel, jcfg, tcfg, hw, _ = _glip_pair()
    b = jb.synthetic_batch(jcfg, 2, hw, num_labels=3, k_shot=2, seed=9)
    sizes = np.array([hw, (hw[0] - 4, hw[1] - 8)], np.float32)
    keys = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
    want = jpredict.make_predict_fn(jmodel.apply, hw, jcfg)(
        params, jnp.asarray(b["images"]), *(jnp.asarray(b[k]) for k in keys), jnp.asarray(sizes))
    got = tpredict.make_predict_fn(tmodel, hw, tcfg)(
        nchw(b["images"]), *(torch.from_numpy(b[k]) for k in keys), torch.from_numpy(sizes))
    v = np.asarray(want.valid)
    assert got.boxes.shape == (2, 20, 4) and v.sum() >= 10
    _assert_same(got, want)


# ---- the remaining public helpers -----------------------------------------


def _dets(rng, shape, n):
    boxes = rng.uniform(0, 50, shape + (n, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + rng.uniform(2, 30, shape + (n, 2)).astype(np.float32)], -1)
    scores = np.round(rng.uniform(0, 1, shape + (n,)), 1).astype(np.float32)  # ties
    labels = rng.integers(1, 4, shape + (n,)).astype(np.int32)
    valid = rng.uniform(size=shape + (n,)) < 0.7
    return boxes, scores, labels, valid


def _pair_dets(arrays):
    from mqdet_tpu.core.detections import Detections as JD
    from mqdet_torch.core.detections import Detections as TD

    names = ("boxes", "scores", "labels", "valid")
    return (JD(**{k: jnp.asarray(a) for k, a in zip(names, arrays)}),
            TD(**{k: torch.from_numpy(np.asarray(a)) for k, a in zip(names, arrays)}))


def _same_fields(t, j):
    for f in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def _helper_detections(rng, tmp_path, monkeypatch):
    from mqdet_tpu.core import detections as jd
    from mqdet_torch.core import detections as td

    j1, t1 = _pair_dets(_dets(rng, (), 12))
    j2, t2 = _pair_dets(_dets(rng, (), 5))
    _same_fields(td.concatenate([t1, t2]), jd.concatenate([j1, j2]))
    for k in (1, 5, 12):
        _same_fields(td.top_k(t1, k), jd.top_k(j1, k))
    _same_fields(td.resize(t1, 0.5, 2.0), jd.resize(j1, jnp.float32(0.5), jnp.float32(2.0)))
    got, want = td.to_numpy_dict(t1), jd.to_numpy_dict(j1)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # batched: top_k over a leading dim is each row's
    jb_, tb_ = _pair_dets(_dets(rng, (3,), 12))
    rows = td.top_k(tb_, 4)
    for r in range(3):
        jr = jd.Detections(**{f: getattr(jb_, f)[r] for f in ("boxes", "scores", "labels", "valid")})
        tr = td.Detections(**{f: getattr(rows, f)[r] for f in ("boxes", "scores", "labels", "valid")})
        _same_fields(tr, jd.top_k(jr, 4))


def _helper_nms(rng, tmp_path, monkeypatch):
    from mqdet_tpu.ops import nms as jn
    from mqdet_torch.ops import nms as tn

    boxes, scores, _, valid = _dets(rng, (), 40)
    boxes[5] = boxes[3] + 0.5  # overlapping pairs that suppress
    boxes[9] = boxes[3] + 1.0
    want_idx, want_valid = jn.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5, 16)
    got_idx, got_valid = tn.nms(*(torch.from_numpy(a)[None] for a in (boxes, scores, valid)), 0.5, 16)
    wv = np.asarray(want_valid)
    np.testing.assert_array_equal(got_valid[0].numpy(), wv)
    np.testing.assert_array_equal(got_idx[0].numpy()[wv], np.asarray(want_idx)[wv])
    assert 0 < wv.sum() < valid.sum()


def _helper_boxes(rng, tmp_path, monkeypatch):
    from mqdet_tpu.core import boxes as jbx
    from mqdet_torch.core import boxes as tbx

    a, _, _, _ = _dets(rng, (2,), 7)
    b, _, _, _ = _dets(rng, (2,), 7)
    b[0, :3] = a[0, :3]  # equal boxes: IoU 1
    np.testing.assert_allclose(tbx.box_iou_aligned(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jbx.box_iou_aligned(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_array_equal(tbx.xyxy_to_cxcywh(torch.from_numpy(a)).numpy(),
                                  np.asarray(jbx.xyxy_to_cxcywh(jnp.asarray(a))))


def _helper_profiling(rng, tmp_path, monkeypatch):
    from mqdet_tpu.utils import profiling as jp
    from mqdet_torch.utils import profiling as tp

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tp.annotate("batched-region") as off:  # the tracer off: not named
            torch.ones(4).sum()
        with tp.tracer(cuda=False), tp.annotate("batched-region"):
            torch.ones(4).sum()
    assert off is None and sum(e.name == "batched-region" for e in prof.events()) == 1
    with jp.annotate("batched-region"):
        pass
    det = _pair_dets(_dets(rng, (), 4))[1]
    assert tp.device_fence({"d": det, "x": [torch.ones(2)]}) is None
    assert jp.device_fence({"x": jnp.ones(2)}) is None
    summaries = []
    for mod in (jp, tp):  # the same clock readings through both timers
        ticks = iter([0.0, 0.5, 1.25, 1.5, 3.0, 3.125])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(warmup=2)
        empty = timer.summary()
        dts = [timer.tick() for _ in range(6)]
        monkeypatch.undo()
        summaries.append((empty, dts, timer.summary()))
    assert summaries[0] == summaries[1]
    assert summaries[1][2]["steps"] == 3


def _helper_npz(rng, tmp_path, monkeypatch):
    from mqdet_tpu.io import checkpoints as jc
    from mqdet_torch.io import checkpoints as tc

    _, params, tmodel, _, tcfg, _, _ = _glip_pair()
    path = str(tmp_path / "weights.npz")
    tc.save_params_npz(path, tmodel)
    back = jc.load_params_npz(path, params)
    want, got = flat_params(params), flat_params(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fresh = tc.load_params_npz(path, tb.build_model(tcfg).eval())
    state = tmodel.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k


def _helper_pad(rng, tmp_path, monkeypatch):
    image = rng.integers(0, 255, (30, 41, 3)).astype(np.uint8)
    got = tpredict.pad_image_to_bucket(image, (48, 64))
    np.testing.assert_array_equal(got, jpredict.pad_image_to_bucket(image, (48, 64)))
    assert got.dtype == np.uint8 and got.shape == (48, 64, 3)


HELPERS = {"detections": _helper_detections, "nms": _helper_nms, "boxes": _helper_boxes,
           "profiling": _helper_profiling, "save_params_npz": _helper_npz, "pad_image_to_bucket": _helper_pad}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_matches_jax(name, tmp_path, monkeypatch):
    HELPERS[name](np.random.default_rng(3), tmp_path, monkeypatch)
