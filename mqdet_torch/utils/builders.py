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


def mq_glip_l_config() -> CfgNode:
    """MQ-GLIP-L (configs/pretrain/mq-glip-l.yaml SWINT block): Swin-L 192 /
    (2, 2, 18, 2) / heads (6, 12, 24, 48) / window 12 / drop path 0.4 and 8
    head stages."""
    cfg = mq_glip_t_config()
    cfg.MODEL.SWINT.EMBED_DIM = 192
    cfg.MODEL.SWINT.DEPTHS = (2, 2, 18, 2)
    cfg.MODEL.SWINT.NUM_HEADS = (6, 12, 24, 48)
    cfg.MODEL.SWINT.WINDOW_SIZE = 12
    cfg.MODEL.SWINT.OUT_CHANNELS = (192, 384, 768, 1536)
    cfg.MODEL.SWINT.DROP_PATH_RATE = 0.4
    cfg.MODEL.DYHEAD.NUM_CONVS = 8
    return cfg


def pretrain_settings(cfg: CfgNode) -> CfgNode:
    """`cfg` with the training settings of configs/pretrain/mq-glip-t.yaml:
    recipe vision_query (the GCP pieces train), AdamW at BASE 1e-4 / GATE
    5e-3 / QUERY 1e-5 / LANG 1e-5, weight decay 1e-4, MODEL_EMA 0.999, text
    dropout 0.4, 5 queries a class, RANDOM_SAMPLE_NEG 85; batch 2 (the
    yaml's 16 over 8 GPUs). The warmup (2000 iterations from 1e-3) is cut to
    0: from its first steps the LR would move no 1.0-valued norm weight in
    fp32, and a step's time does not depend on the LR."""
    s, vq = cfg.SOLVER, cfg.VISION_QUERY
    s.TUNING_HIGHLEVEL_OVERRIDE = "vision_query"
    s.BASE_LR, s.GATE_LR, s.QUERY_LR, s.LANG_LR, s.WEIGHT_DECAY = 1e-4, 5e-3, 1e-5, 1e-5, 1e-4
    s.STEPS, s.MODEL_EMA, s.IMS_PER_BATCH, s.WARMUP_ITERS, s.MAX_TO_KEEP = (0.95,), 0.999, 2, 0, 4
    s.MAX_ITER = 1000
    vq.TEXT_DROPOUT, vq.NUM_QUERY_PER_CLASS, vq.PURE_TEXT_RATE = 0.4, 5, 0.0
    cfg.DATASETS.RANDOM_SAMPLE_NEG = 85
    return cfg


def mq_glip_t_pretrain_config() -> CfgNode:
    """MQ-GLIP-T under `pretrain_settings`, with the yaml's multi-scale
    resize (480-800, max 1333) into the 800x1344 bucket."""
    cfg = pretrain_settings(mq_glip_t_config())
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = 800, 1333
    cfg.AUGMENT.MULT_MIN_SIZE_TRAIN = (480, 560, 640, 720, 800)
    return cfg


def tiny_l_config() -> CfgNode:
    """`tiny_test_config` in MQ-GLIP-L's shape, for CPU tests: window 12 (a
    small image pads at every Swin stage), a third stage of 3 blocks (the
    block indexing of depth 18), shifted blocks in every stage, drop path
    0.4, 8 head stages."""
    cfg = tiny_test_config()
    cfg.MODEL.SWINT.DEPTHS = (2, 2, 3, 2)
    cfg.MODEL.SWINT.WINDOW_SIZE = 12
    cfg.MODEL.SWINT.OUT_CHANNELS = (16, 32, 64, 128)
    cfg.MODEL.SWINT.DROP_PATH_RATE = 0.4
    cfg.MODEL.DYHEAD.NUM_CONVS = 8
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
    cfg.MODEL.GROUP_NORM.NUM_GROUPS = 4
    cfg.TPU.IMAGE_BUCKETS = ((64, 64),)
    return cfg


def mq_groundingdino_t_config() -> CfgNode:
    """MQ-GroundingDINO-T (configs/pretrain/mq-groundingdino-t.yaml): Swin-T,
    hidden 256, 8 heads, FFN 2048, 6 + 6 layers, 900 queries, 4 levels x 4
    points, BERT-base with GCP from layer 6, max_text_len 256. Its image bucket
    is the yaml's 800x1344, where the JAX package's builder sets the TPU-only
    832x1408 (chosen for its Pallas MSDA kernel's exact level ratios)."""
    cfg = default_config()
    cfg.MODEL.META_ARCHITECTURE = "MQGroundingDINO"
    cfg.GROUNDINGDINO.enabled = True
    cfg.VISION_QUERY.ENABLED = True
    return cfg


def tiny_gdino_config() -> CfgNode:
    """Miniature MQ-GroundingDINO config for CPU tests (the JAX package's
    values for the keys this package reads)."""
    cfg = tiny_test_config()
    cfg.MODEL.META_ARCHITECTURE = "MQGroundingDINO"
    cfg.GROUNDINGDINO.enabled = True
    cfg.GROUNDINGDINO.hidden_dim = 16  # == MODEL.BACKBONE.OUT_CHANNELS
    cfg.GROUNDINGDINO.nheads = 2
    cfg.GROUNDINGDINO.dim_feedforward = 32
    cfg.GROUNDINGDINO.enc_layers = 1
    cfg.GROUNDINGDINO.dec_layers = 2
    cfg.GROUNDINGDINO.num_queries = 12
    cfg.GROUNDINGDINO.max_text_len = cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
    return cfg


def build_model(cfg, bank_shape=None):
    """MQ-GLIP, or MQ-GroundingDINO when `GROUNDINGDINO.enabled`, from a
    config, in fp32 on the CPU. Move it with `.to(device, dtype)`: the
    compute dtype is the parameters' dtype. `bank_shape`: (rows, slots, C)
    from `QuerySelector.bank_table_shape()`, required under
    VISION_QUERY.LEARNABLE_BANK."""
    if cfg.GROUNDINGDINO.enabled:
        from mqdet_torch.models.gdino import MQGroundingDINO

        return MQGroundingDINO(cfg)
    from mqdet_torch.models.mq_glip import MQGLIP

    return MQGLIP(cfg, bank_shape=bank_shape)


@torch.no_grad()
def install_learnable_bank(model: torch.nn.Module, selector) -> torch.nn.Module:
    """Write the bank's values (`selector.bank_table()`, the selector built
    with `emit_indices=True`) into the model's learnable bank, in place (the
    reference loads them at construction, query_selector.py:17-20)."""
    bank = getattr(model, "qv_layer_learnable_bank", None)
    if bank is None:
        raise ValueError("the model was built without VISION_QUERY.LEARNABLE_BANK")
    bank.copy_(torch.from_numpy(selector.bank_table()))
    return model


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


def synthetic_caption_batch(
    cfg,
    batch: int,
    image_hw: Tuple[int, int],
    num_labels: int = 40,
    k_shot: int = 5,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """`synthetic_batch` with captions in GroundingDINO's shape: [CLS] (101),
    then per label two name tokens and '.' (1012), then [SEP] (102), then
    padding masked out. The queries and the agg_map row of label j sit on
    its two name tokens, so the sub-sentence masks hold one block per label."""
    out = synthetic_batch(cfg, batch, image_hw, num_labels, k_shot, seed)
    t = cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
    used = 3 * num_labels + 2
    if used > t:
        raise ValueError(f"{num_labels} labels need {used} tokens, T = {t}")
    rng = np.random.default_rng(seed + 1)
    ids = np.zeros((batch, t), np.int32)
    ids[:, 0] = 101
    ids[:, 1 : used - 1] = np.concatenate(
        [rng.integers(2000, 29000, (batch, num_labels, 2)), np.full((batch, num_labels, 1), 1012)], -1
    ).reshape(batch, -1)
    ids[:, used - 1] = 102
    mask = np.zeros((batch, t), np.int32)
    mask[:, :used] = 1
    query_mask = np.zeros((batch, num_labels * k_shot, t), np.float32)
    agg_map = np.zeros((batch, num_labels, t), np.float32)
    for j in range(num_labels):
        span = [3 * j + 1, 3 * j + 2]
        query_mask[:, j * k_shot : (j + 1) * k_shot, span] = 1
        agg_map[:, j, span] = 0.5
    out.update(input_ids=ids, attention_mask=mask, query_mask=query_mask, agg_map=agg_map)
    return out


def protocol_inputs(cfg, make_batch, groups: int, cp: int, image_hw: Tuple[int, int], seed: int = 0):
    """The LVIS protocol's inputs as bench.py builds them: one image
    (1, 3, H, W) and [input_ids, attention_mask, queries, query_mask,
    agg_map, image_sizes], each (G, CP, ...), every group given the same CP
    chunks of 40 labels x 5 queries from `make_batch` (`synthetic_batch` or
    `synthetic_caption_batch`)."""
    batch = make_batch(cfg, batch=cp, image_hw=image_hw, num_labels=40, k_shot=5, seed=seed)
    image = torch.from_numpy(batch["images"][:1]).permute(0, 3, 1, 2).contiguous()

    def grp(key):
        x = torch.from_numpy(batch[key])
        return x[None].expand(groups, *x.shape).contiguous()

    keys = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map", "image_sizes")
    return image, [grp(k) for k in keys]


@torch.no_grad()
def init_params(model: torch.nn.Module, seed: int = 0, scale: float = 0.02, keys=None) -> torch.nn.Module:
    """Fill every parameter by the rule of the JAX package's
    `init_params_fast`: ones for norm scales, the fusion layer-scale gammas
    and the `Scale` / `log_scale` scalars (flax leaves named *scale,
    *gamma_v, *gamma_l) and BatchNorm running variances, zeros for biases
    (an attention's `in_proj_bias` holds three flax biases) and running
    means, else numpy normals * `scale` from `seed`, drawn in state_dict
    order. `keys`: fill only these state_dict entries (drawn in the same
    order), leave the others as they are."""
    from mqdet_torch.models.fusion import BatchNorm

    ones = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm, BatchNorm)):
            ones.add(f"{name}.weight")
    rng = np.random.default_rng(seed)
    for key, t in model.state_dict().items():
        if keys is not None and key not in keys:
            continue
        if key in ones or key.endswith(("gamma_v", "gamma_l", "scale", "running_var")):
            t.fill_(1.0)
        elif key.endswith((".bias", "in_proj_bias", "running_mean")):
            t.zero_()
        else:
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * scale))
    return model


LVIS_FREQUENCIES = {"r": 337, "c": 461, "f": 405}  # LVIS v1's 1203 categories by frequency


def synthetic_lvis(root: str, seed: int):
    """An LVIS-shaped dataset written from `seed` into `root`: 1203
    categories with seeded pseudo-word names (some with LVIS's '_' and
    '(...)') and r/c/f frequencies in LVIS v1's proportions; 8 images, 6
    landscape 480x640 and 2 portrait 640x480; 2-6 boxes each over a pool of
    40 categories; neg and not-exhaustive category ids per image. The json is
    read by the port's `CocoDetectionDataset`; `load_image` is overridden
    with seeded pixels (smooth noise, uint8), so nothing needs PIL to read
    an image file. Returns (dataset, {contiguous label: frequency})."""
    import json
    import os

    from mqdet_torch.data.coco import CocoDetectionDataset

    rng = np.random.default_rng(seed + 7)
    syllables = ["ka", "lo", "mi", "ne", "ru", "ta", "vo", "zi", "pe", "sa", "do", "gu", "bri", "sto", "fen"]
    freq = rng.permutation(np.repeat(list(LVIS_FREQUENCIES), list(LVIS_FREQUENCIES.values())))
    names, cats = set(), []
    for i in range(len(freq)):
        name = "".join(rng.choice(syllables, rng.integers(2, 4)))
        if i % 5 == 1:
            name += "_" + "".join(rng.choice(syllables, 2))
        elif i % 7 == 2:
            name += "_(" + "".join(rng.choice(syllables, 2)) + ")"
        while name in names:
            name += "s"
        names.add(name)
        cats.append({"id": i + 1, "name": name, "frequency": str(freq[i])})
    pool = np.concatenate([rng.choice(np.flatnonzero(freq == f), 14 if f == "r" else 13, replace=False)
                           for f in LVIS_FREQUENCIES]) + 1
    images, anns = [], []
    for i in range(8):
        h, w = (480, 640) if i < 6 else (640, 480)
        n = int(rng.integers(2, 7))
        labels = rng.choice(pool, n)
        others = [int(c) for c in pool if c not in labels]
        images.append({"id": i + 1, "file_name": f"{i + 1}.jpg", "height": h, "width": w,
                       "neg_category_ids": [int(c) for c in rng.choice(others, 3, replace=False)],
                       "not_exhaustive_category_ids": [int(c) for c in rng.choice(pool, 2, replace=False)]})
        for lab in labels:
            bw, bh = rng.uniform(20, w * 0.6), rng.uniform(20, h * 0.6)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": int(lab),
                         "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0})
    ann_file = os.path.join(root, "lvis_synthetic.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)

    class SeededImages(CocoDetectionDataset):
        def load_image(self, img_id):
            im = self.images[img_id]
            g = torch.Generator().manual_seed(seed * 1000 + img_id)
            low = torch.rand(1, 3, im["height"] // 32, im["width"] // 32, generator=g) * 255.0
            img = torch.nn.functional.interpolate(low, size=(im["height"], im["width"]), mode="bilinear")
            return img[0].permute(1, 2, 0).round().to(torch.uint8).numpy()

    ds = SeededImages(ann_file, img_dir=root)
    return ds, {ds.cat_id_to_contiguous[c["id"]]: c["frequency"] for c in ds.categories}


def landscape(dataset, portrait: bool = False):
    """A shallow copy of `dataset` holding its landscape images (or its
    portrait ones): the loader fills one batch per bucket, so a dataset of
    one orientation yields a batch for every IMS_PER_BATCH images."""
    import copy

    ds = copy.copy(dataset)
    ds.ids = [i for i in dataset.ids if (dataset.image_size(i)[0] < dataset.image_size(i)[1]) != portrait]
    return ds
