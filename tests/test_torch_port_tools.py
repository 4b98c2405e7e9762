"""The port's measurement tools (`mqdet_torch/tools/perf_{trace,bisect,
bisect2,head_once,postproc,fusion,protocol_sweep,bucket_churn,train_step}.py`)
on the CPU at the tiny config: each runs through its command line
(`--device cpu --tiny`) and prints its JSON keys with finite values; the
bucket-churn arithmetic against a hand computation and its tables pinned to
the JAX tool's; the trace aggregation's families summing to its total; the
post-processing's two timed stages composing into `atss_postprocess`; the
training tool's first loss equal to `make_train_step`'s; the training batch
equal to the JAX package's `synthetic_batch(..., max_gt=30)`.
"""
import ast
import json
import math
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tool -> (command line after --device cpu --tiny, keys each point must print)
TOOLS = {
    "perf_trace": (["--cp", "16", "--iters", "1"],
                   [("op", "total_ms", "per_call_ms", "count", "hint"), ("instance", "per_call_ms", "count"),
                    ("device_total_ms", "per_protocol_ms", "iters", "busy_ms", "window_ms", "idle_share")]),
    "perf_bisect": (["--iters", "1"],
                    [("encode_b1_ms", "head_postproc_cp4_ms", "head_raw_cp4_ms", "lang_cp4_ms", "postproc_cp4_ms",
                      "head_raw_nodeform_cp4_ms", "dcn_l0_pallas_ms", "dcn_l0_window_ms", "conv3x3_l0_plain_ms")]),
    "perf_bisect2": ([], [("dispatch_overhead_ms",), ("conv3x3_l0_amortized_ms",), ("dcn_l0_pallas_amortized_ms",),
                          ("dcn_l0_window_amortized_ms",), ("head_postproc_window_cp4_ms",), ("encode_flops",),
                          ("head_flops_cp4",)]),
    "perf_head_once": ([], [("head_ms_per_group", "runs")]),
    "perf_postproc": ([], [("postproc_full_ms",), ("candidates_only_ms",), ("nms_only_ms",)]),
    "perf_fusion": ([], [("fusion_impl", "per_stage_ms")]),
    "perf_protocol_sweep": (["--cps", "4,8", "--runs", "1"], [("cp", "groups", "protocol_p50_ms", "img_per_sec")]),
    "perf_bucket_churn": (["--runs", "1", "--n-images", "100"],
                          [("geometry", "first_call_s", "protocol_p50_ms"),
                           ("bucket_set", "geometries_compiled", "first_call_total_s", "avg_s_per_image",
                            "avg_padding_waste_pct", "total_eval_s_at_N", "n_images"), ("recommendation",)]),
    "perf_train_step": (["2"], [("batch", "remat", "step_p50_ms", "train_img_per_sec_chip", "loss")]),
}


def numbers(x):
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return
    if isinstance(x, (int, float)):
        yield float(x)
    elif isinstance(x, dict):
        for v in x.values():
            yield from numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from numbers(v)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_tiny_on_the_cpu(tool, capsys):
    import importlib

    argv, shapes = TOOLS[tool]
    mod = importlib.import_module(f"mqdet_torch.tools.{tool}")
    assert mod.main(["--device", "cpu", "--tiny", *argv]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines[-1]["device"] == "cpu"
    for keys in shapes:
        hits = [r for r in lines if set(keys) <= set(r)]
        assert hits, (tool, keys)
        for r in hits:
            assert all(math.isfinite(v) for v in numbers({k: r[k] for k in keys})), r
    times = [t for r in lines for k, v in r.items() if "_ms" in k or k.endswith("_s") for t in numbers(v)]
    assert times and all(t > 0 for t in times)


def test_tools_refuse_a_machine_without_a_card(monkeypatch):
    from mqdet_torch.tools import perf_head_once

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        perf_head_once.main([])
    assert e.value.code == 2


def test_bucket_churn_arithmetic_matches_a_hand_computation():
    from mqdet_torch.tools.perf_bucket_churn import bucket_sets_report

    sizes = ((80, 100, 0.75), (100, 80, 0.25))
    sets = {"one": ((80, 120),), "square": ((120, 120),)}
    p50 = {(80, 120): 100.0, (120, 80): 100.0, (120, 120): 150.0}
    first = {(80, 120): 2.0, (120, 80): 3.0, (120, 120): 4.0}
    got = bucket_sets_report(p50, first, 1000, sizes, sets)
    # "one": both orientations, 0.1 s an image; waste (9600 - 8000) / 8000 = 20% for each size
    assert got[0] == {"bucket_set": "one", "geometries_compiled": [[80, 120], [120, 80]],
                      "first_call_total_s": 5.0, "avg_s_per_image": pytest.approx(0.1),
                      "avg_padding_waste_pct": pytest.approx(20.0), "total_eval_s_at_N": pytest.approx(105.0),
                      "n_images": 1000}
    # "square": 0.15 s an image, waste (14400 - 8000) / 8000 = 80%; 4 + 150 s
    assert got[1]["bucket_set"] == "square"
    assert got[1]["avg_padding_waste_pct"] == pytest.approx(80.0)
    assert got[1]["total_eval_s_at_N"] == pytest.approx(154.0)
    assert got[2] == {"recommendation": "one"}


def test_bucket_churn_tables_are_the_jax_tools():
    """Read with `ast`: importing the JAX tool would run its
    `enable_compile_cache()`."""
    from mqdet_torch.tools import perf_bucket_churn as port

    tree = ast.parse(open(os.path.join(REPO, "tools", "perf_bucket_churn.py")).read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name) and t.id in ("SIZE_DISTRIBUTION", "BUCKET_SETS",
                                                                             "CHUNKS_PER_IMAGE")}
    assert consts["SIZE_DISTRIBUTION"] == port.SIZE_DISTRIBUTION
    assert consts["BUCKET_SETS"] == port.BUCKET_SETS
    assert consts["CHUNKS_PER_IMAGE"] == port.CHUNKS_PER_IMAGE
    assert math.isclose(sum(f for _, _, f in port.SIZE_DISTRIBUTION), 1.0)
    sizes, sets = port.scaled(16)
    assert port.geometries(sizes, sets) == [(50, 68), (68, 50), (50, 76), (76, 50), (50, 84), (84, 50), (84, 84)]


def test_trace_families_sum_to_the_total():
    from mqdet_torch.tools.perf_trace import family, report, trace

    assert family("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)") == \
        "at::native::vectorized_elementwise_kernel"
    assert family("void dcn_band_kernel<2>(DcnBandArgs)") == "dcn_band_kernel"
    assert family("void (anonymous namespace)::softmax_warp_forward<float, 8>(float*, int)") == \
        "softmax_warp_forward"
    assert family("fusion_12") == "fusion" and family("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    x = torch.randn(64, 64)
    rep = report(trace(lambda: (x @ x).relu().sum(), iters=2, cuda=False), 2)
    assert rep["kernels"] > 0 and rep["device_total_ms"] > 0
    assert math.isclose(sum(ms for _, ms, _, _ in rep["families"]), rep["device_total_ms"], rel_tol=1e-9)
    assert math.isclose(sum(rep["classes"].values()), rep["device_total_ms"], rel_tol=1e-9)
    assert rep["per_protocol_ms"] == pytest.approx(rep["device_total_ms"] / 2)
    assert sum(n for _, _, n in rep["instances"]) == rep["kernels"]


def test_postproc_stages_compose_into_the_postprocess():
    from mqdet_torch.models.postprocess import atss_candidates, atss_postprocess, atss_select
    from mqdet_torch.tools.perf_postproc import postproc_inputs

    head_out, anchors, agg, sizes, p = postproc_inputs(torch.device("cpu"), (64, 64), tokens=16, classes=7)
    want = atss_postprocess(head_out, anchors, agg, sizes, p)
    got = atss_select(*atss_candidates(head_out, anchors, agg, sizes, p), p)
    assert int(want.valid.sum()) > 0
    for f in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_sweep_inputs_tile_the_cp4_chunks():
    from mqdet_torch.tools.perf_protocol_sweep import sweep_inputs
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch, tiny_test_config

    cfg = tiny_test_config()
    image4, text4 = protocol_inputs(cfg, synthetic_batch, 8, 4, (64, 64))
    image, text = sweep_inputs(cfg, 16, (64, 64))
    assert torch.equal(image, image4)
    for t, t4 in zip(text, text4):
        assert t.shape[:2] == (2, 16)
        for c in range(16):
            assert torch.equal(t[1, c], t4[0, c % 4])


def test_train_step_first_loss_is_make_train_steps():
    from mqdet_torch.core.config import frozen_patterns, trainable_patterns
    from mqdet_torch.engine.train import init_train_state, make_train_step
    from mqdet_torch.tools.perf_train_step import GEN_SEED, train_batch, train_point
    from mqdet_torch.utils import builders

    cfg = builders.pretrain_settings(builders.tiny_test_config())

    def model():
        return builders.init_params(builders.build_model(cfg), seed=0)

    rec = train_point(model(), cfg, 2, (64, 64), warm=1, timed=1)
    m = model()
    state, tx = init_train_state(m, cfg, trainable_patterns(cfg), frozen_patterns(cfg))
    _, metrics = make_train_step(m, tx, cfg)(state, train_batch(cfg, 2, (64, 64), torch.device("cpu")),
                                             torch.Generator().manual_seed(GEN_SEED))
    assert rec["first_loss"] == float(metrics["loss_total"])
    assert math.isfinite(rec["loss"]) and rec["loss"] != rec["first_loss"]


def test_training_batch_is_the_jax_packages():
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.utils import builders as tb

    cfg = tb.tiny_test_config()
    want = jb.synthetic_batch(jb.tiny_test_config(), 2, (64, 64), num_labels=7, k_shot=2, max_gt=5, seed=3)
    got = tb.synthetic_batch(cfg, 2, (64, 64), num_labels=7, k_shot=2, seed=3, max_gt=5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
