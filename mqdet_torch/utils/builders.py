"""Model and input builders (counterpart of `mqdet_tpu/utils/builders.py`).

The configs set the same values as the JAX package's on the same defaults
(`mqdet_torch/core/config.py`). `init_params` fills a model's parameters by
the rule of the JAX package's `init_params_fast` with numpy normals from a
seed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mqdet_torch.core.config import CfgNode, default_config


def mq_glip_t_config() -> CfgNode:
    """MQ-GLIP-T (configs/pretrain/mq-glip-t.yaml semantics)."""
    cfg = default_config()
    cfg.VISION_QUERY.ENABLED = True
    cfg.MODEL.DYHEAD.NUM_CLASSES = 81
    return cfg


def tiny_test_config() -> CfgNode:
    """Miniature config for CPU tests (the JAX package's values for the keys
    this package reads)."""
    cfg = mq_glip_t_config()
    cfg.MODEL.SWINT.EMBED_DIM = 16
    cfg.MODEL.SWINT.DEPTHS = (1, 1, 1, 1)
    cfg.MODEL.SWINT.NUM_HEADS = (1, 2, 4, 8)
    cfg.MODEL.SWINT.WINDOW_SIZE = 4
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    cfg.MODEL.DYHEAD.NUM_CONVS = 1
    cfg.MODEL.DYHEAD.CHANNELS = 16
    cfg.MODEL.LANGUAGE_BACKBONE.HIDDEN_LAYERS = 2
    cfg.MODEL.LANGUAGE_BACKBONE.LANG_DIM = 32
    cfg.MODEL.LANGUAGE_BACKBONE.HIDDEN_SIZE = 32
    cfg.MODEL.LANGUAGE_BACKBONE.NUM_HEADS = 2
    cfg.MODEL.LANGUAGE_BACKBONE.INTERMEDIATE_SIZE = 64
    cfg.MODEL.LANGUAGE_BACKBONE.VOCAB_SIZE = 30522
    cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 16
    cfg.VISION_QUERY.START_QV_LAYER = 1
    return cfg


def build_model(cfg):
    """MQ-GLIP from a config, in fp32 on the CPU. Move it with
    `.to(device, dtype)`: the compute dtype is the parameters' dtype."""
    from mqdet_torch.models.mq_glip import MQGLIP

    return MQGLIP(cfg)


def synthetic_batch(
    cfg,
    batch: int,
    image_hw: Tuple[int, int],
    num_labels: int = 40,
    k_shot: int = 5,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Random but valid inputs, identical to the JAX package's
    `synthetic_batch` for the same arguments (images stay NHWC here; the
    model takes NCHW)."""
    rng = np.random.default_rng(seed)
    t = cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
    v = num_labels * k_shot
    c = cfg.MODEL.BACKBONE.OUT_CHANNELS
    h, w = image_hw
    input_ids = rng.integers(1, cfg.MODEL.LANGUAGE_BACKBONE.VOCAB_SIZE, (batch, t)).astype(np.int32)
    attention_mask = np.ones((batch, t), np.int32)
    # each label occupies 2 tokens; queries of label j attend to its span
    query_mask = np.zeros((batch, v, t), np.float32)
    agg_map = np.zeros((batch, num_labels, t), np.float32)
    for j in range(num_labels):
        span = [min(2 * j + 1, t - 2), min(2 * j + 2, t - 2)]
        query_mask[:, j * k_shot : (j + 1) * k_shot, span] = 1
        agg_map[:, j, span] = 0.5
    return {
        "images": rng.standard_normal((batch, h, w, 3)).astype(np.float32),
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "queries": rng.standard_normal((batch, v, c)).astype(np.float32),
        "query_mask": query_mask,
        "agg_map": agg_map,
        "image_sizes": np.tile(np.asarray([[h, w]], np.float32), (batch, 1)),
    }


@torch.no_grad()
def init_params(model: torch.nn.Module, seed: int = 0, scale: float = 0.02) -> torch.nn.Module:
    """Fill every parameter by the rule of the JAX package's
    `init_params_fast`: ones for norm scales, the fusion layer-scale gammas
    and the `Scale` / `log_scale` scalars (flax leaves named *scale,
    *gamma_v, *gamma_l), zeros for biases, else numpy normals * `scale` from
    `seed`, drawn in state_dict order."""
    ones = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            ones.add(f"{name}.weight")
    rng = np.random.default_rng(seed)
    for key, t in model.state_dict().items():
        if key in ones or key.endswith(("gamma_v", "gamma_l", "scale")):
            t.fill_(1.0)
        elif key.endswith(".bias"):
            t.zero_()
        else:
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * scale))
    return model
