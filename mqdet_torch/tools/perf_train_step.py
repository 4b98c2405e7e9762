"""The modulated pre-training step of MQ-GLIP-T on one card, at batches 2
and 4 (the port of `tools/perf_train_step.py`).

    [MQDET_TRAIN_REMAT=0|1] python -m mqdet_torch.tools.perf_train_step [BATCH ...]   (default 2 4)
    python -m mqdet_torch.tools.perf_train_step --device cpu --tiny 2

The reference pre-trains MQ-GLIP-T at 16 images over 8 GPUs, 2 a GPU, at
800x1333 (configs/pretrain/mq-glip-t.yaml). For each batch this builds
MQ-GLIP-T under `builders.mq_glip_t_pretrain_config` from init_params(seed
0), bf16 on the card, TPU.REMAT from MQDET_TRAIN_REMAT (default 1, as the
JAX tool); the state of `engine/train.py::init_train_state` (the frozen base,
the GCP pieces trained, AdamW in fp32 masters) and the step of
`make_train_step` (ATSS, GLIP and gate losses, text dropout); the batch of
`builders.synthetic_batch(..., max_gt=30)` at 800x1344 (40 labels x 5
queries). Two warm-up and 8 timed steps feed the state back, each with the
generator seeded 7 (the JAX tool's key), host clock around work that ends in
the read of the loss (which waits for the card). One JSON line per batch:
`batch`, `remat`, `step_p50_ms`, `train_img_per_sec_chip`, `loss` (the last
step's), `first_loss`, the peak memory and the launches of one step. A
batch the card cannot hold prints {"batch", "error"} and the next batch
runs, as in the JAX tool. `--tiny`: the tiny test config at 64x64.
"""
from __future__ import annotations

import os
import statistics
import sys
import time
from typing import Dict

GEN_SEED = 7
TRAIN_KEYS = ("images", "input_ids", "attention_mask", "queries", "query_mask", "gt_boxes", "gt_labels",
              "gt_valid", "gt_token_map", "pos_category_map", "has_query")


def train_batch(cfg, batch: int, hw, device, seed: int = 0):
    """The training batch on `device` (`synthetic_batch` with 30 boxes an
    image, 40 labels x 5 queries)."""
    from mqdet_torch.engine.train import batch_to_device
    from mqdet_torch.utils.builders import synthetic_batch

    b = synthetic_batch(cfg, batch, hw, num_labels=40, k_shot=5, seed=seed, max_gt=30)
    return batch_to_device({k: b[k] for k in TRAIN_KEYS}, device)


def train_point(model, cfg, batch: int, hw, warm: int = 2, timed: int = 8, seed: int = 0) -> Dict:
    """One batch's record (module docstring) on `model` (MQ-GLIP, on its
    device; its trainable parameters are trained in place)."""
    import torch

    from mqdet_torch.core.config import frozen_patterns, trainable_patterns
    from mqdet_torch.engine.train import init_train_state, make_train_step
    from mqdet_torch.ops import launch_counts

    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    data = train_batch(cfg, batch, hw, dev, seed)
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg), frozen_patterns(cfg))
    step = make_train_step(model, tx, cfg)

    def one():
        gen = torch.Generator(device=dev).manual_seed(GEN_SEED)
        _, metrics = step(state, data, gen)
        return float(metrics["loss_total"])

    first = one()
    for _ in range(warm - 1):
        one()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    times, loss = [], first
    for i in range(timed):
        if i == timed - 1:
            launch_counts(reset=True)
        t0 = time.perf_counter()
        loss = one()
        times.append((time.perf_counter() - t0) * 1000.0)
    p50 = statistics.median(times)
    return {"batch": batch, "remat": bool(cfg.TPU.REMAT), "step_p50_ms": p50,
            "train_img_per_sec_chip": batch * 1000.0 / p50, "loss": loss, "first_loss": first,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "launches_per_step": {k: v for k, v in launch_counts().items() if v}}


def train_points(model, cfg, batches, hw, warm: int = 2, timed: int = 8, emit=None):
    """`train_point` for each batch on one model; a batch that does not fit
    on the card gives {"batch", "error"}."""
    import torch

    out = []
    for bs in batches:
        try:
            rec = train_point(model, cfg, bs, hw, warm, timed)
        except torch.cuda.OutOfMemoryError as e:
            rec = {"batch": bs, "error": f"{type(e).__name__}: {e}"[:200]}
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        out.append(rec)
        if emit is not None:
            emit(rec)
    return out


def main(argv=None) -> int:
    import torch

    from mqdet_torch.tools import device_name, emit, tool_args
    from mqdet_torch.utils import builders

    def extra(ap):
        ap.add_argument("batches", nargs="*", type=int)

    args, dev = tool_args(__doc__.split("\n")[0], argv, extra)
    cfg = builders.pretrain_settings(builders.tiny_test_config()) if args.tiny else \
        builders.mq_glip_t_pretrain_config()
    cfg.TPU.REMAT = os.environ.get("MQDET_TRAIN_REMAT", "1") != "0"
    hw = tuple(cfg.TPU.IMAGE_BUCKETS[0])
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE) if dev.type == "cuda" else torch.float32
    for bs in args.batches or [2, 4]:
        model = builders.init_params(builders.build_model(cfg), seed=0).to(dev, dtype)
        train_points(model.to(memory_format=torch.channels_last), cfg, [bs], hw, emit=emit)
        del model
    emit({"device": device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
