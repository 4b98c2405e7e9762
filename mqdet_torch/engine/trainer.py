"""The training loop (counterpart of `mqdet_tpu/engine/trainer.py`; reference
engine/trainer.py do_train): epochs to iterations, the negative-batch skip
(MAX_NEG_PER_BATCH), loss logging every 20 iterations, evaluation during
training with the autostep LR decay and auto-terminate patience, periodic
checkpoints.

The step's generator is `step_generator(SOLVER.SEED, iteration)`, a pure
function of the absolute iteration, and the loader reshuffles per epoch from
(seed, epoch): a resumed run skips the consumed batches of its epoch and
replays the uninterrupted run's stream.

Across processes (`parallel/comm.py`) every rank runs the loop on its shard
and the ranks enter each collective together: one small all-reduce an
iteration carries whether the rank has a batch, its images without a
positive and its images, so when any rank's loader runs out (it yields one
batch per bucket as it fills, so the count depends on the shard's
orientations) every rank starts the next epoch, and the negative-batch skip
is decided on the global batch. Only rank 0 logs; the checkpointer writes on
rank 0 (`io/checkpoints.py`). `eval_fn` runs on every rank (a sharded
`run_inference` needs them all) and rank 0's result, broadcast, drives the
autostep and the auto-termination on every rank.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from mqdet_torch.engine.train import batch_to_device, step_generator
from mqdet_torch.io.checkpoints import Checkpointer
from mqdet_torch.parallel import comm
from mqdet_torch.utils.metric_logger import JsonlLogger, MetricLogger


def _agree(batch, device) -> tuple:
    """(every rank has a batch, the global batch's count of images without
    a positive, its images): one all-reduce across ranks; this rank's own
    counts in one process."""
    num_pos = None if batch is None else batch.get("num_positive")
    neg = 0 if num_pos is None else int((np.asarray(num_pos) == 0).sum())
    n = 0 if num_pos is None else int(np.asarray(num_pos).size)
    world = comm.get_world_size()
    if world == 1:
        return batch is not None, neg, n
    v = comm.all_reduce_sum(torch.tensor([batch is not None, neg, n], dtype=torch.float64, device=device))
    return int(v[0]) == world, int(v[1]), int(v[2])


def do_train(cfg, train_step: Callable, state, data_loader, device, eval_fn: Optional[Callable] = None,
             checkpointer: Optional[Checkpointer] = None, start_iter: int = 0, log: Callable = print):
    """Run the loop on `device`; returns (state, best eval result)."""
    max_iter = cfg.SOLVER.MAX_ITER
    if max_iter <= 0:
        max_iter = cfg.SOLVER.MAX_EPOCH * data_loader.steps_per_epoch()
    ckpt_period = cfg.SOLVER.CHECKPOINT_PERIOD
    if cfg.SOLVER.CHECKPOINT_PER_EPOCH > 0:
        ckpt_period = max(1, int(data_loader.steps_per_epoch() / cfg.SOLVER.CHECKPOINT_PER_EPOCH))
    eval_period = data_loader.steps_per_epoch() if cfg.SOLVER.TEST_WITH_INFERENCE else 0
    max_neg_frac = cfg.SOLVER.MAX_NEG_PER_BATCH
    patience = cfg.SOLVER.AUTOTERMINATE_PATIENCE
    main = comm.is_main_process()

    logger = MetricLogger()
    jsonl = JsonlLogger(cfg.OUTPUT_DIR) if main else None
    steps_pe = data_loader.steps_per_epoch()
    if start_iter and hasattr(data_loader, "epoch"):
        data_loader.epoch = start_iter // steps_pe
    skip_batches = start_iter % steps_pe if start_iter else 0

    best_result = -1.0
    patience_left = patience
    iteration = start_iter
    t_end = time.time()
    while iteration < max_iter:
        batches = iter(data_loader)
        while iteration < max_iter:
            batch = next(batches, None)
            every_rank, neg, n = _agree(batch, device)
            if not every_rank:  # a rank's epoch ended: every rank starts the next
                break
            if skip_batches > 0:
                skip_batches -= 1
                continue
            data_time = time.time() - t_end
            # negative-batch skip (trainer.py:93-98), on the global batch
            if batch.pop("num_positive", None) is not None and max_neg_frac < 1.0 and neg / n > max_neg_frac:
                t_end = time.time()
                continue
            gen = step_generator(cfg.SOLVER.SEED, iteration, device)
            state, metrics = train_step(state, batch_to_device(batch, device), gen)
            iteration += 1

            values = {k: float(v) for k, v in metrics.items()}
            batch_time = time.time() - t_end
            t_end = time.time()
            logger.update(time=batch_time, data=data_time, **values)
            if main and (iteration % 20 == 0 or iteration == max_iter):
                log(f"iter {iteration}/{max_iter}  {logger}")
                jsonl.log(iteration, **values)

            if checkpointer is not None and iteration % ckpt_period == 0:
                checkpointer.save(iteration, state, {"iteration": iteration})

            if eval_period and iteration % eval_period == 0 and eval_fn is not None:
                result = float(comm.broadcast_object(float(eval_fn(state))))
                if main:
                    jsonl.log(iteration, eval_result=result)
                if result > best_result:
                    best_result = result
                    patience_left = patience
                    if checkpointer is not None:
                        checkpointer.save(iteration, state, {"best": result})
                else:
                    patience_left -= 1
                    if cfg.SOLVER.USE_AUTOSTEP:
                        state = scale_learning_rate(state, cfg.SOLVER.GAMMA)
                if patience >= 0 and patience_left < 0:
                    if main:
                        log(f"auto-terminate at iter {iteration}: best {best_result}")
                    return state, best_result

    if checkpointer is not None:
        checkpointer.save(iteration, state, {"iteration": iteration, "final": True})
    return state, best_result


def scale_learning_rate(state, gamma: float):
    """The autostep plateau decay (WarmupReduceLROnPlateau): every later
    update is multiplied by `gamma` through the state's `lr_scale`."""
    state.lr_scale = state.lr_scale * gamma
    return state
