"""Modulated pre-training of MQ-GLIP and MQ-GroundingDINO: the body of the
JAX package's `tools/train.py` (:140-296) as a function, on one device.

    from mqdet_torch.tools.train import train
    state, best = train(cfg, dataset, bank, output_dir, resume=False)

It builds the model from `SOLVER.SEED` (or takes `model`, e.g. weights loaded
through the bridge), the query selector over `bank` (a `QueryBank` or None),
the grounding train loader over `dataset` (a `CocoDetectionDataset`), the
train state and step (`engine/train.py`: GLIP's with the anchors of the
first bucket, or, where `GROUNDINGDINO.enabled`, GroundingDINO's, which
needs none, as the JAX dispatch at `tools/train.py:259-265`), the
checkpointer in `output_dir`, and runs `do_train`. The model's frozen
parameters and activations are in `TPU.COMPUTE_DTYPE` on the card (fp32 on
the CPU); the trainable set keeps fp32 masters. Loading the config from yaml
waits for ROADMAP Queue A's yaml-free reader (Queue A 3).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from mqdet_torch.core.config import frozen_patterns, trainable_patterns
from mqdet_torch.data.loader import GroundingTrainLoader
from mqdet_torch.data.tokenizer import get_tokenizer
from mqdet_torch.engine.train import glip_anchors, init_train_state, make_gdino_train_step, make_train_step
from mqdet_torch.engine.trainer import do_train
from mqdet_torch.io.checkpoints import Checkpointer
from mqdet_torch.mq.selector import QuerySelector
from mqdet_torch.utils.builders import build_model, init_params


def build_training(cfg, dataset, bank, output_dir: str, device="cuda", model: Optional[torch.nn.Module] = None,
                   tokenizer=None):
    """(model, loader, state, train_step, checkpointer), as `train` builds
    them; `cfg.SOLVER.MAX_ITER` is set from MAX_EPOCH where it is 0."""
    device = torch.device(device)
    cfg.OUTPUT_DIR = output_dir
    os.makedirs(output_dir, exist_ok=True)
    if model is None:
        model = init_params(build_model(cfg), seed=cfg.SOLVER.SEED)
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE) if device.type == "cuda" else torch.float32
    model = model.to(device, dtype).to(memory_format=torch.channels_last)
    vq = cfg.VISION_QUERY
    selector = QuerySelector(bank, num_query_per_class=vq.NUM_QUERY_PER_CLASS, pure_text_rate=vq.PURE_TEXT_RATE,
                             random_kshot=vq.RANDOM_KSHOT, max_labels=vq.MAX_CLASSES_PER_PROMPT)
    loader = GroundingTrainLoader(dataset, cfg, tokenizer or get_tokenizer(cfg.MODEL.LANGUAGE_BACKBONE.TOKENIZER_TYPE),
                                  selector)
    if cfg.SOLVER.MAX_ITER <= 0:
        cfg.SOLVER.MAX_ITER = cfg.SOLVER.MAX_EPOCH * loader.steps_per_epoch()
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg), frozen_patterns(cfg))
    if cfg.GROUNDINGDINO.enabled:
        step = make_gdino_train_step(model, tx, cfg)
    else:
        anchors, level_sizes = glip_anchors(cfg, cfg.TPU.IMAGE_BUCKETS[0], device)
        step = make_train_step(model, tx, anchors, level_sizes, cfg)
    return model, loader, state, step, Checkpointer(output_dir, cfg.SOLVER.MAX_TO_KEEP)


def train(cfg, dataset, bank, output_dir: str, resume: bool = False, device="cuda",
          model: Optional[torch.nn.Module] = None, tokenizer=None, log: Callable = print):
    """Train; returns (state, best eval result). With `resume`, continues
    from the checkpointer's last step."""
    model, loader, state, step, ckpt = build_training(cfg, dataset, bank, output_dir, device, model, tokenizer)
    start_iter = 0
    if resume and ckpt.has_checkpoint():
        state, start_iter = ckpt.restore(state)
        log(f"resumed from iteration {start_iter}")
    return do_train(cfg, step, state, loader, torch.device(device), checkpointer=ckpt, start_iter=start_iter,
                    log=log)
