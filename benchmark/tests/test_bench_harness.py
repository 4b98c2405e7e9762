"""CPU tests of the benchmark: the data files and BENCHMARK.json against the
rules on names, units and lines, the work formulas against hand-computed
bounds, the trace arithmetic, the plain reference against the program at
the tiny configurations, the import guard, the refusal without a card, and
that a new configuration, mix and metric are picked up from files alone.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import harness, tracing, work  # noqa: E402
from benchmark.tests.tiny import tiny_cell  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_every_data_file_parses():
    for path in list((BENCH / "configs").glob("*.json")) + list((BENCH / "traffic").glob("*.json")):
        harness.load_json(path)
    s = spec()
    for w in s["workloads"]:
        c = harness.cell(w["name"], s)
        assert c["config"]["name"] == w["config"]
        assert set(c["config"]["limits"]) and all(v >= 0 for v in c["config"]["limits"].values())


def test_names_units_and_lines_follow_the_format():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    names = []
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        names.append(c["name"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["per_layer"]:
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").exists()
    for text in [c["why"] for c in s["configs"]] + [w["why"] for w in s["workloads"]] + \
            [m["layer"] for m in s["per_layer"]] + [c["source"] for c in s["configs"]] + s["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_kernel_bounds_match_the_hand_computed_values():
    # PERF.md's kernel table: K1 level 0 at head batch 4, K3 at GLIP's shape, K5's encoder call
    assert work.dcn_bound(4, 100, 168, 256, 256, 1) * 1e3 == pytest.approx(0.0802, abs=5e-5)
    assert work.bi_attention_bound(4, 22400, 256, 2048) * 1e3 == pytest.approx(0.3324, abs=5e-5)
    assert work.msda_bound(4, 22323, 22323, 8, 32, 4, 4) * 1e3 == pytest.approx(0.0682, abs=5e-5)
    assert work.glip_levels((800, 1344)) == [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    assert len(work.glip_dcn_calls(work.glip_levels((800, 1344)), 256, 16)) == 13


def test_union_and_idle_arithmetic():
    events = [("void a_kernel<1>(int)", 0.0, 10.0), ("b_kernel_12", 5.0, 20.0), ("a_kernel", 30.0, 40.0)]
    r = tracing.reduce(events)
    assert r["busy_s"] == pytest.approx(30e-6) and r["window_s"] == pytest.approx(40e-6)
    assert r["families"] == pytest.approx({"a_kernel": 20e-6, "b_kernel": 15e-6})
    assert tracing.kernel_seconds(r, ("a_kernel",)) == pytest.approx(20e-6)
    b = tracing.breakdown(events)
    assert b["idle_gaps"] == [["before a_kernel", pytest.approx(10e-6)]]
    assert b["device_ops"][0][0] == "a_kernel"
    record = {"trace": r}
    assert harness.read_per_layer({"per_layer": [{"name": "device_idle_share.eval", "unit": "%"}]}, "x",
                                   record)["device_idle_share.eval"]["value"] == pytest.approx(25.0)


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_reference_matches_the_program_at_the_tiny_configs(family, monkeypatch):
    import torch

    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")  # the program's clipped MSDA on the CPU
    torch.set_num_threads(2)
    r = harness.run("tiny", 4123456789, 0.2, False, device="cpu", dtype_name="float32", check_devices=False,
                    cell_data=tiny_cell(family))
    assert r["correct"]
    assert all(value <= 1e-4 for value, _ in r["checks"].values()), r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    import types

    for name in ("jaxtyping", "mqdet_tpu_extras.sub"):  # a forbidden name as a prefix is not the name
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"jaxtyping", "mqdet_tpu_extras"} & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.harness, benchmark.judge, "
            "benchmark.calibrate, benchmark.count_flops, benchmark.reference.glip, benchmark.reference.gdino; "
            "import mqdet_torch.engine.predict, mqdet_torch.utils.builders; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'mqdet_tpu'}))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "mqdet_torch" not in text and "mqdet_tpu" not in text and "jax" not in text, path


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", spec()["workloads"][0]["name"],
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


TOY_ENTRY = """
RATE = {"name": "toy_calls_per_s", "unit": "1/s"}


def build(config, mix, seed, dev, dtype, table, mark, protocol_wrap=None):
    return {"inputs": {"seed": seed}, "call": lambda k: k * mix["step"], "units": 1}


def spans(config, state):
    return {}


def after_window(config, mix, state, n_calls, seed):
    return {}


def numbers(config, mix, inputs, outputs, captured, seed, device, table, dtype, control=False):
    return {"off_by": float(max(abs(o - k * mix["step"]) for k, o in enumerate(outputs)))}
"""


def test_new_cell_config_and_metric_come_from_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    s = json.loads((copy / "BENCHMARK.json").read_text())
    config = json.loads((copy / "benchmark/configs/mq_glip_t.json").read_text())
    config["name"] = "mq_glip_t_copy"
    (copy / "benchmark/configs/mq_glip_t_copy.json").write_text(json.dumps(config))
    mix = json.loads((copy / "benchmark/traffic/lvis_b4_cp4.json").read_text())
    mix["image_batch"] = 8
    (copy / "benchmark/traffic/lvis_b8_cp4.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/calls_seen.py").write_text("def read(record):\n    return float(record['calls'])\n")
    # a new entry point: its own file, mix, configuration and end-to-end rate
    (copy / "benchmark/entries/toy.py").write_text(TOY_ENTRY)
    (copy / "benchmark/traffic/toy_mix.json").write_text(json.dumps({"entry": "toy", "step": 3, "warmup_calls": 1}))
    (copy / "benchmark/configs/toy.json").write_text(json.dumps({"name": "toy", "family": "toy",
                                                                 "limits": {"off_by": 0}}))
    s["configs"] += [{"name": "mq_glip_t_copy", "source": "x", "file": "benchmark/configs/mq_glip_t_copy.json",
                      "reduced": [], "why": "x"},
                     {"name": "toy", "source": "x", "file": "benchmark/configs/toy.json", "reduced": [], "why": "x"}]
    s["workloads"] += [{"name": "mq_glip_t_copy.lvis_b8_cp4", "config": "mq_glip_t_copy", "traffic": "lvis_b8_cp4",
                        "chips": 1, "why": "x"},
                       {"name": "toy.toy_mix", "config": "toy", "traffic": "toy_mix", "chips": 1, "why": "x"}]
    s["end_to_end"].append({"name": "toy_calls_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["toy.toy_mix"]})
    s["per_layer"].append({"name": "calls_seen", "unit": "1", "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "eval_img_per_s", "workloads": ["mq_glip_t_copy.lvis_b8_cp4"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(s))
    code = ("import sys, json; sys.path.insert(0, %r); from benchmark import harness; "
            "c = harness.cell('mq_glip_t_copy.lvis_b8_cp4'); "
            "toy = harness.run('toy.toy_mix', 7, 0.05, False, device='cpu', check_devices=False); "
            "print(json.dumps([c['config']['name'], c['mix']['image_batch'], "
            "harness.read_per_layer(c['spec'], 'mq_glip_t_copy.lvis_b8_cp4', {'calls': 3}), "
            "toy['correct'], sorted(toy['metrics']), toy['checks']]))") % str(copy)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=copy)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "mq_glip_t_copy", 8, {"calls_seen": {"value": 3.0, "unit": "1"}},
        True, ["peak_mem_gib", "setup_s", "toy_calls_per_s"], {"off_by": [0.0, 0]}]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_an_unknown_entry_is_refused():
    with pytest.raises(SystemExit, match="unknown entry"):
        harness.entry_module({"entry": "no_such_entry"})
    with pytest.raises(SystemExit, match="unknown entry"):
        harness.entry_module({})


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_weight_table_and_the_weight_laws(family):
    import math

    import torch

    config = tiny_cell(family)["config"]
    table = harness.weight_table(config, "cpu")
    built = harness.reference_model(config, "meta")
    assert [(n, s) for n, s, _ in table] == sorted((n, tuple(p.shape)) for n, p in built.named_parameters())
    w = harness.seeded_weights(table, 3000000007, "cpu", torch.float32, config)
    again = harness.seeded_weights(table, 3000000007, "cpu", torch.float32, config)
    assert all(torch.equal(w[k], again[k]) for k in w)
    name, shape = max(((n, s) for n, s, r in table if r == "normal" and len(s) >= 2), key=lambda t: math.prod(t[1]))
    want = 1.0 / math.sqrt(math.prod(shape[1:])) if config["weights"]["law"] == "fan_in" else 0.02
    assert float(w[name].std()) == pytest.approx(want, rel=0.05)


def test_slots_match_near_identical_proposals_one_to_one():
    import torch

    from benchmark import judge

    boxes = torch.tensor([[0.5, 0.5, 0.1, 0.1], [0.5001, 0.5, 0.1, 0.1], [0.2, 0.2, 0.1, 0.1]])
    scores = torch.tensor([56.0, 68.0, 60.0])
    init = torch.tensor([[0.50005, 0.5, 0.1, 0.1], [0.50005, 0.5, 0.1, 0.1], [0.2, 0.2001, 0.1, 0.1]])
    d = torch.cdist(init, boxes, p=float("inf"))
    # the first slot takes the better scored of the two near-equal boxes, the second the other
    assert judge.match_slots(d, scores).tolist() == [1, 0, 2]
