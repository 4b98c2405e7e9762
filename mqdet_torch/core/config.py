"""The configuration keys this package reads, with the JAX package's
defaults (`mqdet_tpu/core/config.py::default_config`, which mirrors the
reference's yacs defaults). The port keeps its own copy so that it, and
`chip_smoke.py`, import nothing of the JAX package;
`tests/test_torch_port_modules.py` pins every value here to the JAX
package's. A JAX package config works wherever this one does: the key names
are the same.
"""
from __future__ import annotations

import copy
from typing import Any


class CfgNode(dict):
    """A dict with attribute access."""

    def __init__(self, init=None):
        super().__init__()
        for k, v in (init or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if name not in self:
            raise KeyError(f"unknown config key {name}")
        self[name] = CfgNode(value) if isinstance(value, dict) else value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)


def default_config() -> CfgNode:
    return CfgNode({
        "MODEL": {
            "SWINT": {
                "EMBED_DIM": 96, "DEPTHS": (2, 2, 6, 2), "NUM_HEADS": (3, 6, 12, 24),
                "WINDOW_SIZE": 7, "MLP_RATIO": 4.0, "VERSION": "v1",
            },
            "BACKBONE": {"OUT_CHANNELS": 256},
            "LANGUAGE_BACKBONE": {
                "MODEL_TYPE": "bert-base-uncased", "LANG_DIM": 768, "HIDDEN_SIZE": 768,
                "NUM_HEADS": 12, "INTERMEDIATE_SIZE": 3072, "HIDDEN_LAYERS": 12,
                "VOCAB_SIZE": 30522, "N_LAYERS": 1, "MAX_QUERY_LEN": 256,
                "TOKENIZER_TYPE": "bert-base-uncased",
            },
            "DYHEAD": {
                "NUM_CLASSES": 81, "CHANNELS": 256, "NUM_CONVS": 6, "PRIOR_PROB": 0.01,
                "LOG_SCALE": 0.0, "USE_DFCONV": True, "USE_DYFUSE": True, "USE_DYRELU": True,
                "SCORE_AGG": "MEAN",
                "FUSE_CONFIG": {
                    "TYPE": "MHA-B", "EARLY_FUSE_ON": True, "USE_FUSED_FEATURES_DOT_PRODUCT": True,
                    "USE_LAYER_SCALE": True, "MLM_LOSS": False, "ADD_LINEAR_LAYER": False,
                },
            },
            "RPN": {
                "ANCHOR_SIZES": (64, 128, 256, 512, 1024), "ANCHOR_STRIDE": (8, 16, 32, 64, 128),
                "ASPECT_RATIOS": (1.0,),
            },
            "ATSS": {"INFERENCE_TH": 0.05, "NMS_TH": 0.6, "PRE_NMS_TOP_N": 1000, "DETECTIONS_PER_IMG": 100},
            # the vision-query pooler of `mq/extract.py` (GDINO's 4 levels take the first 4 scales)
            "ROI_BOX_HEAD": {"POOLER_RESOLUTION": 7,
                             "POOLER_SCALES": (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)},
        },
        "INPUT": {
            "MIN_SIZE_TEST": 800, "MAX_SIZE_TEST": 1333, "PIXEL_MEAN": (103.530, 116.280, 123.675),
            "PIXEL_STD": (57.375, 57.120, 58.395), "TO_BGR255": True,
        },
        "DATASETS": {"SEPARATION_TOKENS": ". ", "CAPTION_PROMPT": ""},
        # CHUNK_PARALLELISM: prompt chunks batched per head call; USE_MULTISCALE is refused
        "TEST": {"CHUNKED_EVALUATION": -1, "CHUNK_PARALLELISM": 4, "SELECT_CLASSES": (), "USE_MULTISCALE": False},
        "SOLVER": {"SEED": 0},
        # a knowledge file is refused (`engine/inference.py`)
        "GLIPKNOW": {"KNOWLEDGE_FILE": ""},
        "VISION_QUERY": {
            "ENABLED": False, "START_QV_LAYER": 6, "NUM_PRE_SELECT_LAYERS": 2, "VISION_SCALE": 1.0,
            # the MQ-Det settings the port builds; other values raise
            "CONDITION_GATE": True, "NONLINEAR_GATE": True, "NO_CAT": True, "FIX_ATTN_GATE": -1.0,
            "ADD_ADAPT_LAYER": False, "SHARE_KV": False, "AUGMENT_IMAGE_WITH_QUERY": False,
            "NEW_MASK_TOKEN": False, "LEARNABLE_BANK": False, "ADD_VISION_LAYER": False,
            "QUERY_FUSION": False,
            # the query bank, its extraction, evaluation and the online update
            "NUM_QUERY_PER_CLASS": 5, "MAX_QUERY_NUMBER": 5000, "MAX_TEST_QUERY_NUMBER": 100,
            "SCORE_THRESHOLD": 0.6, "NUM_TURNS": 1, "TEXT_DROPOUT": 0.0, "PURE_TEXT_RATE": 0.0,
            "EXPAND_RATIO": 1.5, "SELECT_FPN_LEVEL": True, "MASK_DURING_INFERENCE": False,
            "RETURN_ATTN_GATE_VALUE": False, "DEBUG": False, "MAX_CLASSES_PER_PROMPT": 40, "NUM_SCALES": 1,
        },
        # DCNv2: the clipped routes clip offsets to +-DEFORM_RADIUS
        # (`utils/calibrate.py` measures and sets it); offsets applied to the
        # conv over the next level are read "strided" (the reference CUDA
        # kernel's flat-buffer reinterpretation) or "resample"d
        # IMAGE_BUCKETS: the (H, W) sizes an evaluated image is padded to (either orientation)
        "TPU": {"DEFORM_RADIUS": 2, "DEFORM_OFFSET_COMPAT": "strided", "IMAGE_BUCKETS": ((800, 1344),)},
        # the evaluation keys of the JAX package's GroundingDINO block
        "GROUNDINGDINO": {
            "enabled": False, "hidden_dim": 256, "num_queries": 900, "nheads": 8,
            "dim_feedforward": 2048, "enc_layers": 6, "dec_layers": 6, "num_feature_levels": 4,
            "enc_n_points": 4, "dec_n_points": 4, "two_stage_type": "standard",
            "max_text_len": 256, "box_threshold": 0.05, "dn_number": 0, "query_dim": 4,
        },
    })
