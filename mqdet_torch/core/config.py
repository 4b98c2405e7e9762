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
from typing import Any, Dict, List


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
                "WINDOW_SIZE": 7, "MLP_RATIO": 4.0, "VERSION": "v1", "DROP_PATH_RATE": 0.2,
            },
            # FREEZE / FREEZE_CONV_BODY_AT: `frozen_patterns` below
            "BACKBONE": {"OUT_CHANNELS": 256, "FREEZE": False, "FREEZE_CONV_BODY_AT": -1},
            "LANGUAGE_BACKBONE": {
                "MODEL_TYPE": "bert-base-uncased", "LANG_DIM": 768, "HIDDEN_SIZE": 768,
                "NUM_HEADS": 12, "INTERMEDIATE_SIZE": 3072, "HIDDEN_LAYERS": 12,
                "VOCAB_SIZE": 30522, "N_LAYERS": 1, "MAX_QUERY_LEN": 256,
                "TOKENIZER_TYPE": "bert-base-uncased", "FREEZE": False,
            },
            "DYHEAD": {
                "NUM_CLASSES": 81, "CHANNELS": 256, "NUM_CONVS": 6, "PRIOR_PROB": 0.01,
                "LOG_SCALE": 0.0, "USE_DFCONV": True, "USE_DYFUSE": True, "USE_DYRELU": True,
                "SCORE_AGG": "MEAN",
                "FUSE_CONFIG": {
                    "TYPE": "MHA-B", "EARLY_FUSE_ON": True, "USE_FUSED_FEATURES_DOT_PRODUCT": True,
                    "USE_LAYER_SCALE": True, "MLM_LOSS": False, "ADD_LINEAR_LAYER": False,
                    "MLM_LOSS_COEF": 1.0, "MLM_LOSS_FOR_ONLY_POSITIVES": True,
                },
            },
            "RPN": {
                "ANCHOR_SIZES": (64, 128, 256, 512, 1024), "ANCHOR_STRIDE": (8, 16, 32, 64, 128),
                "ASPECT_RATIOS": (1.0,),
            },
            "ATSS": {"INFERENCE_TH": 0.05, "NMS_TH": 0.6, "PRE_NMS_TOP_N": 1000, "DETECTIONS_PER_IMG": 100,
                     "TOPK": 9, "REG_LOSS_WEIGHT": 2.0},
            # the vision-query pooler of `mq/extract.py` (GDINO's 4 levels take the first 4 scales)
            "ROI_BOX_HEAD": {"POOLER_RESOLUTION": 7,
                             "POOLER_SCALES": (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)},
        },
        "INPUT": {
            "MIN_SIZE_TEST": 800, "MAX_SIZE_TEST": 1333, "PIXEL_MEAN": (103.530, 116.280, 123.675),
            "PIXEL_STD": (57.375, 57.120, 58.395), "TO_BGR255": True,
            "MIN_SIZE_TRAIN": 800, "MAX_SIZE_TRAIN": 1333,
        },
        # the training transform (`data/transforms.py::TrainTransform`)
        "AUGMENT": {"MULT_MIN_SIZE_TRAIN": (), "FLIP_PROB_TRAIN": 0.5, "BRIGHTNESS": 0.0, "CONTRAST": 0.0,
                    "SATURATION": 0.0, "HUE": 0.0},
        # the rest: the training loader's caption synthesis (`data/loader.py`)
        "DATASETS": {"SEPARATION_TOKENS": ". ", "CAPTION_PROMPT": "", "RANDOM_SAMPLE_NEG": -1,
                     "CONTROL_PROB": (), "DISABLE_SHUFFLE": False, "ADD_DET_PROMPT": False,
                     "GENERAL_COPY": -1},
        # CHUNK_PARALLELISM: prompt chunks batched per head call; USE_MULTISCALE is refused
        "TEST": {"CHUNKED_EVALUATION": -1, "CHUNK_PARALLELISM": 4, "SELECT_CLASSES": (), "USE_MULTISCALE": False},
        # the optimizer, its schedules, EMA, checkpoints and the loop (`engine/`)
        "SOLVER": {
            "OPTIMIZER": "ADAMW", "BASE_LR": 1e-4, "LANG_LR": 1e-5, "GATE_LR": 5e-3, "QUERY_LR": 1e-5,
            "BIAS_LR_FACTOR": 2.0, "WEIGHT_DECAY": 1e-4, "WEIGHT_DECAY_NORM_FACTOR": 1.0,
            "WEIGHT_DECAY_SCHEDULE": False, "WEIGHT_DECAY_SCHEDULE_RATIO": 0.667, "STEPS": (0.95,),
            "MAX_ITER": 0, "MAX_EPOCH": 1, "IMS_PER_BATCH": 16, "WARMUP_ITERS": 2000, "WARMUP_FACTOR": 1e-3,
            "GAMMA": 0.1, "USE_AMP": True, "MODEL_EMA": 0.0, "CHECKPOINT_PERIOD": 99999999,
            "CHECKPOINT_PER_EPOCH": -1.0, "MAX_TO_KEEP": 4, "TEST_WITH_INFERENCE": False,
            "USE_AUTOSTEP": False, "AUTOTERMINATE_PATIENCE": -1, "MAX_NEG_PER_BATCH": 0.1, "SEED": 0,
            "TUNING_HIGHLEVEL_OVERRIDE": "",
            "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "full_model", "CLIP_VALUE": 1.0, "NORM_TYPE": 2.0},
        },
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
            # training: the gate loss and the selector's k draw
            "GATE_REGULARIZATION": False, "GATE_REGULARIZATION_SCALE": 1.0, "RANDOM_KSHOT": False,
        },
        # DCNv2: the clipped routes clip offsets to +-DEFORM_RADIUS
        # (`utils/calibrate.py` measures and sets it); offsets applied to the
        # conv over the next level are read "strided" (the reference CUDA
        # kernel's flat-buffer reinterpretation) or "resample"d
        # IMAGE_BUCKETS: the (H, W) sizes an evaluated image is padded to (either orientation)
        # REMAT (activation checkpointing) is refused by the train step; COMPUTE_DTYPE is the card's
        "TPU": {"DEFORM_RADIUS": 2, "DEFORM_OFFSET_COMPAT": "strided", "IMAGE_BUCKETS": ((800, 1344),),
                "REMAT": False, "COMPUTE_DTYPE": "bfloat16"},
        # the JAX package's GroundingDINO block: the model, evaluation, and the set
        # criterion's weights and Hungarian matcher costs (`engine/gdino_losses.py`)
        "GROUNDINGDINO": {
            "enabled": False, "hidden_dim": 256, "num_queries": 900, "nheads": 8,
            "dim_feedforward": 2048, "enc_layers": 6, "dec_layers": 6, "num_feature_levels": 4,
            "enc_n_points": 4, "dec_n_points": 4, "two_stage_type": "standard",
            "max_text_len": 256, "box_threshold": 0.05, "dn_number": 0, "query_dim": 4,
            "loss_ce_coef": 2.0, "loss_bbox_coef": 5.0, "loss_giou_coef": 2.0,
            "matcher": {"set_cost_class": 1.0, "set_cost_bbox": 5.0, "set_cost_giou": 2.0, "focal_alpha": 0.25},
        },
        "OUTPUT_DIR": "OUTPUT",
    })


# --- named high-level tuning recipes (the JAX package's TUNING_RECIPES) ---
# A parameter is trainable iff any pattern is a substring of its flax path
# (`engine/optim.py` maps each port parameter to that path through the bridge).
_HEAD_PROBE = ["cls_logits", "bbox_pred", "centerness", "dot_product_projection"]
_GCP = ["qv_layer", "pre_select", "attn_gate", "ff_gate"]
TUNING_RECIPES: Dict[str, List[str]] = {
    "full": [""],
    # modulated pre-training: the GCP pieces only
    "vision_query": _GCP,
    "full_with_vs": ["rpn", "language_backbone"],
    "full_frozen_image": ["rpn", "language_backbone"],
    "full_vs": [""],
    "vision_query_v2": _GCP,
    "vision_query_v3": _GCP + ["tunable_linear"],
    "vision_query_v4": _GCP + ["tunable_linear"],
    "vision_query_v5": _GCP + ["tunable_linear", "query_bank"],
    "query_prompt": ["query_bank"],
    "query_prompt_v2": ["vision_layer"],
    "linear_prob": _HEAD_PROBE,
    "adapter": ["adapter"],
    "vision_language_prompt": ["query_bank", "tunable_linear"],
    "language_prompt_v1": ["language_backbone"],
    "language_prompt_v2": ["tunable_linear"],
    "language_prompt_v3": _HEAD_PROBE + ["language_backbone"],
    "language_prompt_v4": _HEAD_PROBE + ["tunable_linear"],
    "language_prompt_v5": ["tunable_linear", "language_backbone"],
}


def trainable_patterns(cfg: CfgNode) -> List[str]:
    name = cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE
    if not name:
        return [""]
    if name not in TUNING_RECIPES:
        raise KeyError(f"Unknown tuning recipe {name!r}; known: {list(TUNING_RECIPES)}")
    return TUNING_RECIPES[name]


def frozen_patterns(cfg: CfgNode) -> List[str]:
    """Explicit freeze flags on top of the recipe: MODEL.BACKBONE.FREEZE /
    FREEZE_CONV_BODY_AT and MODEL.LANGUAGE_BACKBONE.FREEZE."""
    out: List[str] = []
    if cfg.MODEL.BACKBONE.FREEZE or cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT == 0:
        out.append("backbone/")
    elif cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT > 0:
        out.append("backbone/patch_embed")
        for i in range(cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT - 1):
            out.append(f"backbone/layers_{i}")
    if cfg.MODEL.LANGUAGE_BACKBONE.FREEZE:
        out.append("language_backbone/")
    return out
