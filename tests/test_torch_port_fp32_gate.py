"""`chip_smoke.py`'s second gradient gate (ROADMAP Queue C 4): a training
step in fp32 on the card's plain versions held against the CPU's fp32 step
within FP32_BOUND (1e-1) relative L2 (`fp32_verdict`), on every tensor
whose bf16 bound is 1 or more (such a bound passes a zero gradient) and
every 0-d or 1-element tensor. Here both steps are the tiny MQ-GLIP's fp32
step on the CPU: the gate passes two runs of it, and fails when one gate's
gradient, or a covered tensor's, is zeroed or moved by twice the bound.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from mqdet_torch.core.config import trainable_patterns
from mqdet_torch.engine.train import batch_to_device, init_train_state, make_train_step
from mqdet_torch.utils import builders as tb

torch.set_num_threads(2)

GATE = "language_backbone.body.model.encoder.qv_layer.0.ff_gate"


@pytest.fixture(scope="module")
def steps():
    """Two runs of the tiny MQ-GLIP's vision-query step (fp32, CPU, the same
    generator): (loss, {trainable name: gradient}) each."""
    cfg = tb.tiny_test_config()
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = "vision_query"
    model = tb.init_params(tb.build_model(cfg), seed=0)
    b = tb.synthetic_batch(cfg, 2, (64, 64), num_labels=3, k_shot=2, seed=3)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, (2, 4))
    xy = rng.uniform(0, 32, (2, 4, 2))
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=np.concatenate([xy, xy + rng.uniform(8, 30, (2, 4, 2))], -1).astype(np.float32),
                 gt_labels=(labels + 1).astype(np.int32), gt_valid=np.ones((2, 4), bool),
                 gt_token_map=np.take_along_axis(b["agg_map"], labels[..., None], 1).astype(np.float32),
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32))

    def step():
        m = copy.deepcopy(model)
        state, tx = init_train_state(m, cfg, trainable_patterns(cfg))
        _, metrics = make_train_step(m, tx, cfg)(state, batch_to_device(batch, "cpu"),
                                                 torch.Generator().manual_seed(0))
        params = dict(m.named_parameters())
        return float(metrics["loss_total"]), {n: params[n].grad.float().clone() for n in state.trainable}

    return step(), step()


def test_gate_passes_two_runs_of_the_step(steps):
    got, ref = steps
    assert float(got[1][GATE].abs()) > 0  # the gate's gradient is not 0
    assert chip_smoke.fp32_verdict(torch, "test", "two CPU runs", got, ref, {}) == sum(
        g.numel() <= 1 for g in ref[1].values())


@pytest.mark.parametrize("change", ["zero", "twice the bound"])
def test_gate_fails_on_a_wrong_gate_gradient(steps, change):
    """A zeroed ff_gate gradient reads 1, one moved by twice the bound reads
    twice the bound: both outside it, though the bf16 rule's bound for the
    gate could be 1 or more."""
    got, ref = copy.deepcopy(steps[0]), steps[1]
    got[1][GATE] = got[1][GATE] * (0.0 if change == "zero" else 1.0 + 2 * chip_smoke.FP32_BOUND)
    with pytest.raises(SystemExit):
        chip_smoke.fp32_verdict(torch, "test", "a gate's gradient changed", got, ref, {GATE: 0.5})


def test_gate_covers_the_bounds_at_one_or_more(steps):
    """A tensor of many elements is covered where its bf16 bound is 1 or
    more: zeroing it fails the gate; with a bound under 1 it is left to the
    bf16 rule."""
    got, ref = copy.deepcopy(steps[0]), steps[1]
    name = next(n for n, g in ref[1].items() if g.numel() > 1 and float(g.abs().max()) > 0)
    got[1][name] = torch.zeros_like(got[1][name])
    assert name not in chip_smoke.fp32_covered(ref[1], {name: 0.9})
    chip_smoke.fp32_verdict(torch, "test", "not covered", got, ref, {name: 0.9})
    assert name in chip_smoke.fp32_covered(ref[1], {name: 1.0})
    with pytest.raises(SystemExit):
        chip_smoke.fp32_verdict(torch, "test", "covered", got, ref, {name: 1.0})


def test_zero_gradients_are_held_at_the_model_scale(steps):
    """A gradient that is 0 in exact arithmetic is rounding noise on both
    sides: noise far below the step's gradient scale passes, a value at that
    scale does not."""
    got, ref = copy.deepcopy(steps[0]), copy.deepcopy(steps[1])
    flat = torch.cat([g.reshape(-1) for g in ref[1].values()])
    rms = float(flat.norm()) / flat.numel() ** 0.5
    ref[1][GATE] = torch.zeros_like(ref[1][GATE])
    got[1][GATE] = torch.full_like(got[1][GATE], 1e-9 * rms)
    chip_smoke.fp32_verdict(torch, "test", "zero in exact arithmetic", got, ref, {})
    got[1][GATE] = torch.full_like(got[1][GATE], rms)
    with pytest.raises(SystemExit):
        chip_smoke.fp32_verdict(torch, "test", "a real value where 0 belongs", got, ref, {})
