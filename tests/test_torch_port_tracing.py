"""The port's spans and counters (`mqdet_torch/utils/profiling.py`:
`annotate`, `count`, `tracer`) on the image-batched LVIS protocol, and the
span reductions of `mqdet_torch/tools/perf_trace.py`, on the CPU at the tiny
configs (no JAX: the tracer's records are the port's own).

- The span tree of a call: one `protocol` root a call, `encode` and one
  `head_group` a group under it, the head's spans under each group, the
  post-processing's under `postprocess`; ids, parents and call ids.
- With the tracer off nothing is kept: no span object, no CUDA event, no
  `record_function`.
- Detections are bitwise the same with the tracer on and off.
- `nms_rounds` and `host_syncs` equal the rounds of a plain re-run of the
  fixed-point loop on the same candidates.
- The clock: a span and a `record_function` region opened together agree,
  once converted with the profiler's `trace_start_ns`, to within 50 us (CPU
  activity); on a card (marker `cuda`), a span that ends in
  `torch.cuda.synchronize()` ends no earlier than its last kernel and no
  more than 200 us after it.
- `idle_by_span`: idle time split across nested spans by their self time,
  the rest `outside`, the parts summing to the window's idle time.
"""
import functools
import time

import pytest
import torch

from mqdet_torch.core.boxes import box_iou
from mqdet_torch.engine.predict import make_batched_protocol_fn
from mqdet_torch.tools import perf_trace
from mqdet_torch.utils import builders as tb
from mqdet_torch.utils import profiling

torch.set_num_threads(2)

B, CP, G = 2, 2, 2
ORDER = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")
HEAD_SPANS = {"glip": ["language_tower", "glip_head", "postprocess", "atss_candidates", "nms"],
              "gdino": ["language_tower", "gdino_encoder", "gdino_decoder", "postprocess"]}


@functools.lru_cache(maxsize=2)
def _protocol(family):
    """(protocol_fn, args) of the tiny model of `family` at B 2 x G 2 x CP 2
    (GLIP at 64x64 with a low threshold, so NMS runs several rounds; GDINO
    at 96x96)."""
    if family == "glip":
        cfg, hw, make = tb.tiny_test_config(), (64, 64), tb.synthetic_batch
        cfg.MODEL.ATSS.INFERENCE_TH = 0.01
        cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 20
    else:
        cfg, hw, make = tb.tiny_gdino_config(), (96, 96), tb.synthetic_caption_batch
        cfg.GROUNDINGDINO.box_threshold = 0.1
    model = tb.init_params(tb.build_model(cfg).eval(), seed=0)
    groups = [make(cfg, batch=CP, image_hw=hw, num_labels=3, k_shot=2, seed=g) for g in range(G)]
    text = [torch.stack([torch.from_numpy(grp[k]) for grp in groups]) for k in ORDER]
    images = torch.randn(B, 3, *hw, generator=torch.Generator().manual_seed(1))
    sizes = torch.tensor([hw, (hw[0] - 8, hw[1])], dtype=torch.float32)
    return make_batched_protocol_fn(model, hw, cfg, B), (images, sizes, *text)


def _run(family):
    fn, args = _protocol(family)
    return fn(*args)


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_span_tree_of_the_batched_protocol(family):
    with profiling.tracer(cuda=False) as tr:
        _run(family)
        _run(family)
    got = tr.export()
    assert got["calls"] == 2 and got["clock"] == "time_ns"
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}
    assert [s["id"] for s in spans] == list(range(len(spans)))
    per_call = [["protocol", "encode"] + ["head_group", *HEAD_SPANS[family]] * G] * 2
    assert [[s["name"] for s in spans if s["call"] == c] for c in range(2)] == per_call
    want_parent = {"protocol": None, "encode": "protocol", "head_group": "protocol", "language_tower": "head_group",
                   "glip_head": "head_group", "gdino_encoder": "head_group", "gdino_decoder": "head_group",
                   "postprocess": "head_group", "atss_candidates": "postprocess", "nms": "postprocess"}
    for s in spans:
        parent = by_id.get(s["parent"])
        assert (parent and parent["name"]) == want_parent[s["name"]], s
        assert s["t0_ns"] <= s["t1_ns"] and s["device_ms"] is None
        if parent is not None:
            assert parent["call"] == s["call"]
            assert parent["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= parent["t1_ns"]
    assert [s["attrs"] for s in spans if s["name"] == "head_group"] == [{"g": g} for g in range(G)] * 2
    assert all(s["attrs"] == {} for s in spans if s["name"] != "head_group")
    roots = [s for s in spans if s["parent"] is None]
    assert [r["call"] for r in roots] == [0, 1] and roots[0]["t1_ns"] <= roots[1]["t0_ns"]


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_tracer_off_keeps_nothing(family, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made with the tracer off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling.Tracer, "add", refuse)
    assert profiling._TRACER is None
    dets = _run(family)
    assert dets.scores.shape[:2] == (G, B * CP)
    with profiling.annotate("off", g=1) as span:
        profiling.count("host_syncs")
    assert span is None and profiling._TRACER is None


def test_a_counter_needs_an_open_span():
    with profiling.tracer(cuda=False) as tr:
        with pytest.raises(RuntimeError, match="no span open"):
            profiling.count("host_syncs")
        with profiling.annotate("nms"):
            profiling.count("nms_rounds", 3)
            profiling.count("nms_rounds")
    assert tr.export()["spans"][0]["counters"] == {"nms_rounds": 4}


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_detections_bitwise_equal_with_the_tracer_on(family):
    off = _run(family)
    with profiling.tracer(cuda=False) as tr:
        on = _run(family)
    assert tr.export()["calls"] == 1
    for f in ("boxes", "scores", "labels", "valid"):
        a, b = getattr(off, f), getattr(on, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert bool(off.valid.any())


def _plain_rounds(boxes, scores, labels, valid, thr):
    """The rounds of keep <- valid & ~any(outranked & same label & IoU >
    thr & keep) from keep = valid to its fixpoint, on the score order;
    the round that finds the fixpoint counts."""
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -1e30)), dim=-1, descending=True,
                       stable=True).indices
    b_s, l_s, v_s = boxes.gather(1, order[..., None].expand(*order.shape, 4)), labels.gather(1, order), \
        valid.gather(1, order)
    n = scores.shape[1]
    earlier = torch.arange(n)[None, :] < torch.arange(n)[:, None]
    m = (box_iou(b_s, b_s) > thr) & (l_s[:, :, None] == l_s[:, None, :]) & earlier[None]
    keep, rounds = v_s, 0
    while True:
        rounds += 1
        new = v_s & ~(m & keep[:, None, :]).any(-1)
        if bool((new == keep).all()):
            return rounds
        keep = new


def test_nms_counters_equal_a_plain_rerun_of_the_fixed_point(monkeypatch):
    from mqdet_torch.models import postprocess

    seen = []
    real = postprocess.class_aware_nms

    def spy(boxes, scores, labels, valid, thr, k):
        seen.append((boxes, scores, labels, valid, thr))
        return real(boxes, scores, labels, valid, thr, k)

    monkeypatch.setattr(postprocess, "class_aware_nms", spy)
    with profiling.tracer(cuda=False) as tr:
        _run("glip")
    got = tr.export()
    nms = [s for s in got["spans"] if s["name"] == "nms"]
    rounds = [_plain_rounds(*args) for args in seen]
    assert len(seen) == G and max(rounds) > 2
    assert [s["counters"] for s in nms] == [{"nms_rounds": r, "host_syncs": r} for r in rounds]
    assert got["counters"] == [{"nms_rounds": sum(rounds), "host_syncs": sum(rounds)}]
    assert all(s["counters"] == {} for s in got["spans"] if s["name"] != "nms")


def test_gdino_counts_no_host_sync():
    with profiling.tracer(cuda=False) as tr:
        _run("gdino")
    assert tr.export()["counters"] == [{}]


def _busy(ms):
    end = time.perf_counter() + ms / 1000
    x = torch.ones(64)
    while time.perf_counter() < end:
        x = x + 1
    return x


def test_span_clock_agrees_with_the_profiler_on_the_cpu():
    """The span against its own `record_function` range, opened with it:
    the median over 10 regions (after one that warms the profiler's
    session) within 50 us (a wrong clock is off in every region, the host's
    scheduling in a few); and inside a region opened just before it."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracer(cuda=False) as tr:
            for k in range(11):
                with torch.profiler.record_function(f"region{k}"), profiling.annotate(f"span{k}"):
                    _busy(1)
    start = prof.profiler.kineto_results.trace_start_ns()
    spans = {s["name"]: s for s in tr.export()["spans"]}
    events = {e.name: e.time_range for e in prof.events()}
    gaps = []
    for k in range(1, 11):
        s = spans[f"span{k}"]
        t0, t1 = (s["t0_ns"] - start) / 1000, (s["t1_ns"] - start) / 1000
        own, outer = events[f"span{k}"], events[f"region{k}"]
        gaps.append(max(abs(t0 - own.start), abs(t1 - own.end)))
        assert outer.start <= t0 and t1 <= outer.end, (k, outer.start, t0, t1, outer.end)
    assert statistics.median(gaps) < 50, gaps


@pytest.mark.cuda
def test_span_ending_in_a_synchronise_ends_after_its_last_kernel():
    """Each of 7 spans ends no earlier than its last kernel; the median ends
    within 200 us of it (the host's wake-up from the synchronise varies
    from call to call: 0.2-0.6 ms were seen on single calls)."""
    import statistics

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(2048, 2048, device="cuda")

    def body():
        y = x
        for _ in range(4):
            y = y @ x
        torch.cuda.synchronize()

    perf_trace.span_trace(lambda: _spanned(body), 1)  # warm the profiler and the tracer
    lags = []
    for _ in range(7):
        exported, kernels = perf_trace.span_trace(lambda: _spanned(body), 1)
        span = next(s for s in exported["spans"] if s["name"] == "synced")
        assert span["t0_ns"] <= min(s for _, s, _ in kernels) and span["device_ms"] > 0
        lags.append(span["t1_ns"] - max(e for _, _, e in kernels))
    assert min(lags) >= 0 and statistics.median(lags) <= 200_000, lags


def _spanned(body):
    with profiling.annotate("synced"):
        body()


def _span(name, sid, parent, t0, t1):
    return {"name": name, "id": sid, "parent": parent, "call": 0, "attrs": {}, "counters": {}, "t0_ns": t0,
            "t1_ns": t1, "device_ms": None}


def test_idle_is_split_across_nested_spans_by_self_time():
    spans = [_span("protocol", 0, None, 0, 100), _span("head_group", 1, 0, 10, 90),
             _span("postprocess", 2, 1, 50, 80), _span("nms", 3, 2, 60, 70)]
    assert perf_trace.self_segments(spans) == [(0, 10, "protocol"), (10, 50, "head_group"), (50, 60, "postprocess"),
                                               (60, 70, "nms"), (70, 80, "postprocess"), (80, 90, "head_group"),
                                               (90, 100, "protocol")]
    # kernels 5-20, 30-40 and 35-55, 65-66, 110-120: idle 20-30, 55-65, 66-110
    kernels = [("k", 5, 20), ("k", 30, 40), ("k", 35, 55), ("k", 65, 66), ("k", 110, 120)]
    got = perf_trace.idle_by_span(spans, kernels)
    assert got["window_ns"] == 115 and got["idle_ns"] == 10 + 10 + 44
    assert got["by_span"] == {"head_group": 10 + 10, "postprocess": 5 + 10, "nms": 5 + 4, "protocol": 10}
    assert got["outside_ns"] == 10  # 100-110: no span open
    assert got["postprocess_ns"] == 24 and got["forward_ns"] == 20
    assert sum(got["by_span"].values()) + got["outside_ns"] == got["idle_ns"]


def test_idle_outside_every_span_and_with_no_kernel():
    spans = [_span("protocol", 0, None, 0, 10), _span("protocol", 1, None, 50, 60)]
    got = perf_trace.idle_by_span(spans, [("k", 0, 5), ("k", 55, 60)])
    assert got["by_span"] == {"protocol": 5 + 5} and got["outside_ns"] == 40 and got["idle_ns"] == 50
    empty = perf_trace.idle_by_span(spans, [])
    assert empty["idle_ns"] == 0 and empty["by_span"] == {} and empty["outside_ns"] == 0


def test_perf_trace_spans_runs_tiny_on_the_cpu(capsys):
    import json

    assert perf_trace.main(["--device", "cpu", "--tiny", "--spans", "0.2", "--iters", "1", "--batch", "2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    calls = [r for r in lines if "call" in r]
    assert calls and all(r["counters"]["host_syncs"] == r["counters"]["nms_rounds"] > 0 for r in calls)
    assert all(r["call_ms"] >= r["host_ms"]["protocol"] > 0 for r in calls)
    idle = next(r for r in lines if "by_span" in r)
    assert idle["idle_ns"] == sum(idle["by_span"].values()) + idle["outside_ns"]
    assert lines[-1] == {"cp": 4, "batch": 2, "device": "cpu"}
