"""The comparison that decides `correct` has to refuse what is wrong.

Faults: a run of the harness at the tiny configurations (the look for a
card skipped, everything else as in a benchmark run; the tiny cells' own
limits, `tiny.TINY_LIMITS`) with the program's protocol call broken
underneath:
a call that returns its state unchanged (the previous call's detections),
half of a call's images left out (the first half computed twice), an
answer altered where it is produced (every detection's class moved to the
next one), and the returned set cut (no detection returned; only each
entry's best one returned). Each must come out not correct; on the card
(`-m cuda`) the same at the cells' own size and limits.

The control: the reference computed in fp8 in the program's place. On the
CPU at the tiny size its numbers must stand far above the program's (which
computes in fp32 there); on the card (`-m cuda`, at the cells' own size) it
must fail a limit on each of three seeds.

    python -m pytest benchmark/tests -q            # the CPU tests
    python -m pytest benchmark/tests -q -m cuda    # the control on the card
"""
from __future__ import annotations

import sys
from dataclasses import replace
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import calibrate, harness  # noqa: E402
from benchmark.tests.tiny import tiny_cell  # noqa: E402


def stale(fn):
    prev = {}

    def call(images, sizes, *text):
        out = fn(images, sizes, *text)
        last = prev.get("out", out)
        prev["out"] = out
        return last

    return call


def half(fn):
    def call(images, sizes, *text):
        b = images.shape[0]
        return fn(images[: b // 2].repeat(2, 1, 1, 1), sizes, *text)

    return call


def relabel(fn):
    def call(images, sizes, *text):
        out = fn(images, sizes, *text)
        k = text[-1].shape[-2]  # classes a chunk
        return replace(out, labels=out.labels % k + 1)

    return call


def empty(fn):
    def call(images, sizes, *text):
        out = fn(images, sizes, *text)
        return replace(out, valid=out.valid & False)

    return call


def top1(fn):
    def call(images, sizes, *text):
        out = fn(images, sizes, *text)
        score = out.scores.float().masked_fill(~out.valid, float("-inf"))
        best = score == score.amax(-1, keepdim=True)
        return replace(out, valid=out.valid & best)

    return call


FAULTS = [stale, half, relabel, empty, top1]
FAULT_IDS = ["unchanged", "half_batch", "altered", "empty", "top1"]


@pytest.fixture
def cpu_run(monkeypatch):
    import torch

    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    torch.set_num_threads(2)

    def go(family, wrap=None, seed=5123456789):
        return harness.run("tiny", seed, 0.2, False, device="cpu", dtype_name="float32", check_devices=False,
                           cell_data=tiny_cell(family), protocol_wrap=wrap)

    return go


@pytest.mark.parametrize("family", ["glip", "gdino"])
@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_a_broken_protocol_is_not_correct(cpu_run, family, fault):
    r = cpu_run(family, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_the_control_reads_far_above_the_program_on_the_cpu(cpu_run, family, monkeypatch):
    program = cpu_run(family)["checks"]
    control = calibrate.control_numbers(tiny_cell(family), 6123456789, device="cpu", dtype_name="float32")
    assert max(control[k] for k in program) > 100 * max(1e-6, max(v for v, _ in program.values()))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cells' own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]])
def test_the_control_fails_a_limit_at_full_size(card, workload):
    c = harness.cell(workload)
    for seed in (3100000001, 3100000002, 3100000003):
        got = calibrate.control_numbers(c, seed)
        assert any(got[k] > lim for k, lim in c["config"]["limits"].items()), (seed, got)


FULL_SIZE_FAULTS = [(w["name"], f) for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"] for f in FAULTS]
SOUND = {}


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", FULL_SIZE_FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FULL_SIZE_FAULTS])
def test_a_broken_protocol_is_not_correct_at_full_size(card, workload, fault):
    if workload not in SOUND:  # the same run, unbroken, once a cell
        SOUND[workload] = harness.run(workload, 3100000011, 3.0, False)
    assert SOUND[workload]["correct"], SOUND[workload]["checks"]
    r = harness.run(workload, 3100000011, 3.0, False, protocol_wrap=fault)
    print(workload, fault.__name__, r["_extra"]["numbers"])
    assert not r["correct"], r["checks"]
