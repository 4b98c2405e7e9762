"""The training loop (counterpart of `mqdet_tpu/engine/trainer.py`; reference
engine/trainer.py do_train): epochs to iterations, the negative-batch skip
(MAX_NEG_PER_BATCH), loss logging every 20 iterations, evaluation during
training with the autostep LR decay and auto-terminate patience, periodic
checkpoints. One card: DDP over NCCL is ROADMAP Queue A 4.1.

The step's generator is `step_generator(SOLVER.SEED, iteration)`, a pure
function of the absolute iteration, and the loader reshuffles per epoch from
(seed, epoch): a resumed run skips the consumed batches of its epoch and
replays the uninterrupted run's stream.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from mqdet_torch.engine.train import batch_to_device, step_generator
from mqdet_torch.io.checkpoints import Checkpointer
from mqdet_torch.utils.metric_logger import JsonlLogger, MetricLogger


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

    logger = MetricLogger()
    jsonl = JsonlLogger(cfg.OUTPUT_DIR)
    steps_pe = data_loader.steps_per_epoch()
    if start_iter and hasattr(data_loader, "epoch"):
        data_loader.epoch = start_iter // steps_pe
    skip_batches = start_iter % steps_pe if start_iter else 0

    best_result = -1.0
    patience_left = patience
    iteration = start_iter
    t_end = time.time()
    while iteration < max_iter:
        for batch in data_loader:
            if iteration >= max_iter:
                break
            if skip_batches > 0:
                skip_batches -= 1
                continue
            data_time = time.time() - t_end
            # negative-batch skip (trainer.py:93-98)
            num_pos = batch.pop("num_positive", None)
            if num_pos is not None and max_neg_frac < 1.0:
                if float((np.asarray(num_pos) == 0).mean()) > max_neg_frac:
                    t_end = time.time()
                    continue
            gen = step_generator(cfg.SOLVER.SEED, iteration, device)
            state, metrics = train_step(state, batch_to_device(batch, device), gen)
            iteration += 1

            values = {k: float(v) for k, v in metrics.items()}
            batch_time = time.time() - t_end
            t_end = time.time()
            logger.update(time=batch_time, data=data_time, **values)
            if iteration % 20 == 0 or iteration == max_iter:
                log(f"iter {iteration}/{max_iter}  {logger}")
                jsonl.log(iteration, **values)

            if checkpointer is not None and iteration % ckpt_period == 0:
                checkpointer.save(iteration, state, {"iteration": iteration})

            if eval_period and iteration % eval_period == 0 and eval_fn is not None:
                result = float(eval_fn(state))
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
