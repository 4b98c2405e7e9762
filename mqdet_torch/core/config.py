"""The configuration tree: the JAX package's whole key surface and defaults
(`mqdet_tpu/core/config.py::default_config`, which mirrors the reference's
yacs defaults), so that every yaml under `configs/` merges into it, and the
merging: `merge_from_file` (through `core/yaml_lite.py`: the machine with
the card has no PyYAML), `merge_from_list` (dotted KEY VALUE pairs),
`merge_from_other`, and `dump_yaml`, which `yaml_lite` (and PyYAML) read
back equal. The port keeps its own copy so that it, and `chip_smoke.py`,
import nothing of the JAX package; `tests/test_torch_port_modules.py` pins
the tree to the JAX package's both ways, and `tests/test_torch_port_cli.py`
every shipped yaml merged into it.

Some keys are inert here as in the JAX package, kept so that the reference's
yamls load: DATALOADER.* (the host pipeline has no workers; TPU.IMAGE_BUCKETS
replaces SIZE_DIVISIBILITY), SOLVER.USE_AMP and the FUSE_CONFIG clamps (bf16
has no fp16 range problem), TEST.DURING_TRAINING (SOLVER.TEST_WITH_INFERENCE
is the knob read), MODEL.DYHEAD.USE_GN, the experiment-only FUSE_CONFIG and
VISION_QUERY flags, MODEL.SWINT.APE, the mesh keys of TPU, and the
ResNet / EfficientNet backbones and the legacy heads, which the port does
not build yet (ROADMAP Queue A 5.3).
"""
from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List

from mqdet_torch.core import yaml_lite


class CfgNode(dict):
    """A dict with attribute access. Setting an attribute that is not a key
    raises (a misspelt key fails loudly); merges follow the JAX package's."""

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

    # subtrees that take new keys (the dataset registry)
    _OPEN_SUBTREES = ("DATASETS.REGISTER",)

    def merge_from_other(self, other: Dict[str, Any], _path: str = "") -> None:
        """Merge a nested dict; a key outside the tree raises KeyError."""
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            open_subtree = any(full == o or full.startswith(o + ".") for o in self._OPEN_SUBTREES)
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode) and not open_subtree:
                self[k].merge_from_other(v, full)
            else:
                if k not in self and not open_subtree:
                    raise KeyError(f"Unknown config key: {full}")
                self[k] = _coerce(v, self.get(k), full)

    def merge_from_file(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            data = yaml_lite.safe_load(f.read()) or {}
        self.merge_from_other(data)

    def merge_from_list(self, opts: List[Any]) -> None:
        """Dotted KEY VALUE pairs, e.g. ['SOLVER.BASE_LR', '1e-4']."""
        if len(opts) % 2:
            raise ValueError(f"override list must be even: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)

    def dump_yaml(self) -> str:
        """The tree as yaml that `yaml_lite.safe_load` reads back equal
        (tuples as lists; `merge_from_file` turns them back into tuples)."""
        return yaml_lite.dump(self)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce a yaml or string value to the type of the default it replaces
    (the JAX package's rule)."""
    if isinstance(value, str) and not isinstance(old, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        return bool(value)
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, dict) and isinstance(value, dict):
        return CfgNode(value)
    if type(old) is not type(value) and not isinstance(old, (list, tuple)):
        try:
            return type(old)(value)
        except (TypeError, ValueError):
            pass
    return value


def default_config() -> CfgNode:
    """The JAX package's default tree, key for key and value for value."""
    return CfgNode({
        "MODEL": {
            "META_ARCHITECTURE": "MQGLIP", "WEIGHT": "", "RPN_ONLY": True, "RPN_ARCHITECTURE": "VLDYHEAD",
            "BACKBONE": {
                "CONV_BODY": "SWINT-FPN-RETINANET", "OUT_CHANNELS": 256, "FREEZE": False,
                "FREEZE_CONV_BODY_AT": -1, "EFFICIENT_DET_START_FROM": 3, "EFFICIENT_DET_COMPOUND": 0,
            },
            "BIFPN": {"NUM_REPEATS": 1, "USE_ATTENTION": True},
            "SWINT": {
                "EMBED_DIM": 96, "OUT_CHANNELS": (96, 192, 384, 768), "DEPTHS": (2, 2, 6, 2),
                "NUM_HEADS": (3, 6, 12, 24), "WINDOW_SIZE": 7, "MLP_RATIO": 4.0, "DROP_PATH_RATE": 0.2,
                "APE": False, "VERSION": "v1", "OUT_NORM": True,
            },
            "FPN": {"USE_GN": False, "USE_RELU": False},
            "GROUP_NORM": {"NUM_GROUPS": 16},
            "LANGUAGE_BACKBONE": {
                "FREEZE": False, "TOKENIZER_TYPE": "bert-base-uncased", "MODEL_TYPE": "bert-base-uncased",
                "LANG_DIM": 768, "MAX_QUERY_LEN": 256, "N_LAYERS": 1, "PAD_MAX": True, "MASK_SPECIAL": False,
                "USE_CHECKPOINT": False, "HIDDEN_LAYERS": 12, "HIDDEN_SIZE": 768, "NUM_HEADS": 12,
                "INTERMEDIATE_SIZE": 3072, "VOCAB_SIZE": 30522,
            },
            "RPN": {
                "USE_FPN": True, "ANCHOR_SIZES": (64, 128, 256, 512, 1024),
                "ANCHOR_STRIDE": (8, 16, 32, 64, 128), "ASPECT_RATIOS": (1.0,), "SCALES_PER_OCTAVE": 1,
                "STRADDLE_THRESH": 0,
            },
            "ATSS": {
                "NUM_CLASSES": 81, "PRIOR_PROB": 0.01, "INFERENCE_TH": 0.05, "INFERENCE_TH_TRAIN": 0.0,
                "NMS_TH": 0.6, "PRE_NMS_TOP_N": 1000, "PRE_NMS_TOP_N_TRAIN": 3000,
                "POST_NMS_TOP_N_TRAIN": 1000, "TOPK": 9, "DETECTIONS_PER_IMG": 100, "REG_LOSS_WEIGHT": 2.0,
            },
            "DYHEAD": {
                "NUM_CLASSES": 81, "CHANNELS": 256, "NUM_CONVS": 6, "USE_GN": True, "USE_DYRELU": True,
                "USE_DFCONV": True, "USE_DYFUSE": True, "TOPK": 9, "SCORE_AGG": "MEAN", "LOG_SCALE": 0.0,
                "PRIOR_PROB": 0.01, "USE_CHECKPOINT": False,
                "FUSE_CONFIG": {
                    "EARLY_FUSE_ON": True, "TYPE": "MHA-B", "JOINT_EMB_SIZE": 256, "JOINT_EMB_DROPOUT": 0.1,
                    "ADD_LINEAR_LAYER": False, "USE_DOT_PRODUCT_TOKEN_LOSS": True, "USE_TOKEN_LOSS": False,
                    "USE_CLASSIFICATION_LOSS": False, "USE_CONTRASTIVE_ALIGN_LOSS": False,
                    "CONTRASTIVE_HIDDEN_DIM": 64, "USE_FUSED_FEATURES_DOT_PRODUCT": True,
                    "USE_LAYER_SCALE": True, "SEPARATE_BIDIRECTIONAL": False, "STABLE_SOFTMAX_2D": False,
                    "DO_LANG_PROJ_OUTSIDE_CHECKPOINT": False, "MLM_LOSS": False, "MLM_LOSS_COEF": 1.0,
                    "MLM_LOSS_FOR_ONLY_POSITIVES": True, "CLAMP_MIN_FOR_UNDERFLOW": True,
                    "CLAMP_MAX_FOR_OVERFLOW": True, "CLAMP_BERTATTN_MIN_FOR_UNDERFLOW": True,
                    "CLAMP_BERTATTN_MAX_FOR_OVERFLOW": True, "CLAMP_DOT_PRODUCT": True,
                },
            },
            "ROI_BOX_HEAD": {
                "POOLER_RESOLUTION": 7, "POOLER_SCALES": (0.125, 0.0625, 0.03125, 0.015625, 0.0078125),
                "POOLER_SAMPLING_RATIO": 0,
            },
        },
        "INPUT": {
            "MIN_SIZE_TRAIN": 800, "MAX_SIZE_TRAIN": 1333, "MIN_SIZE_TEST": 800, "MAX_SIZE_TEST": 1333,
            "PIXEL_MEAN": (103.53, 116.28, 123.675), "PIXEL_STD": (57.375, 57.12, 58.395), "TO_BGR255": True,
            "FORMAT": "", "FIX_RES": False,
        },
        "AUGMENT": {
            "MULT_MIN_SIZE_TRAIN": (), "FLIP_PROB_TRAIN": 0.5, "BRIGHTNESS": 0.0, "CONTRAST": 0.0,
            "SATURATION": 0.0, "HUE": 0.0,
        },
        "DATASETS": {
            "TRAIN": (), "TEST": (), "REGISTER": {}, "DATA_ROOT": "DATASET", "FEW_SHOT": 0, "SHUFFLE_SEED": 0,
            "DISABLE_SHUFFLE": False, "RANDOM_SAMPLE_NEG": -1, "CONTROL_PROB": (), "ADD_DET_PROMPT": False,
            "USE_OVERRIDE_CATEGORY": False, "SEPARATION_TOKENS": ". ", "EXCLUDE_CROWD": True, "MAX_BOX": -1,
            "ONE_HOT": False, "GENERAL_COPY": -1, "OVERRIDE_CATEGORY": "", "CAPTION_PROMPT": "",
            "PREDEFINED_TEXT": "", "SPECIAL_SAFEGUARD_FOR_COCO_GROUNDING": False,
        },
        "DATALOADER": {"SIZE_DIVISIBILITY": 32, "NUM_WORKERS": 0, "ASPECT_RATIO_GROUPING": False},
        "SOLVER": {
            "OPTIMIZER": "ADAMW", "BASE_LR": 0.0001, "LANG_LR": 1e-05, "GATE_LR": 0.005, "QUERY_LR": 1e-05,
            "BIAS_LR_FACTOR": 2.0, "WEIGHT_DECAY": 0.0001, "WEIGHT_DECAY_NORM_FACTOR": 1.0,
            "WEIGHT_DECAY_SCHEDULE": False, "WEIGHT_DECAY_SCHEDULE_RATIO": 0.667, "STEPS": (0.95,),
            "MAX_ITER": 0, "MAX_EPOCH": 1, "IMS_PER_BATCH": 16, "WARMUP_ITERS": 2000, "WARMUP_FACTOR": 0.001,
            "GAMMA": 0.1, "USE_AMP": True, "MODEL_EMA": 0.0, "CHECKPOINT_PERIOD": 99999999,
            "CHECKPOINT_PER_EPOCH": -1.0, "MAX_TO_KEEP": 4, "TEST_WITH_INFERENCE": False,
            "USE_AUTOSTEP": False, "AUTOTERMINATE_PATIENCE": -1, "MAX_NEG_PER_BATCH": 0.1, "SEED": 0,
            "TUNING_HIGHLEVEL_OVERRIDE": "",
            "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "full_model", "CLIP_VALUE": 1.0, "NORM_TYPE": 2.0},
        },
        "TEST": {
            "EVAL_TASK": "detection", "IMS_PER_BATCH": 1, "DURING_TRAINING": False, "CHUNKED_EVALUATION": -1,
            "CHUNK_PARALLELISM": 4, "MDETR_STYLE_AGGREGATE_CLASS_NUM": -1, "EXPECTED_RESULTS": (),
            "EXPECTED_RESULTS_SIGMA_TOL": 4, "USE_MULTISCALE": False,
            "SCALES": (400, 500, 600, 700, 900, 1000, 1100, 1200), "RANGES": (), "MAX_SIZE": 2000,
            "FLIP": True, "SPECIAL_NMS": "none", "TH": 0.6, "PRE_NMS_TOP_N": 1000, "SELECT_CLASSES": (),
            "VOC_USE_07_METRIC": False,
        },
        "VISION_QUERY": {
            "ENABLED": False, "QUERY_BANK_PATH": "", "DATASET_NAME": "", "NUM_QUERY_PER_CLASS": 5,
            "MAX_QUERY_NUMBER": 5000, "MAX_TEST_QUERY_NUMBER": 100, "SCORE_THRESHOLD": 0.6, "NUM_TURNS": 1,
            "TEXT_DROPOUT": 0.0, "PURE_TEXT_RATE": 0.0, "VISION_SCALE": 1.0, "RANDOM_KSHOT": False,
            "LEARNABLE_BANK": False, "ADD_ADAPT_LAYER": False, "ADD_VISION_LAYER": False,
            "CONDITION_GATE": True, "NONLINEAR_GATE": True, "NO_CAT": True, "SHARE_KV": False,
            "FIX_ATTN_GATE": -1.0, "START_QV_LAYER": 6, "NUM_PRE_SELECT_LAYERS": 2, "EXPAND_RATIO": 1.5,
            "SELECT_FPN_LEVEL": True, "QUERY_FUSION": False, "GATE_REGULARIZATION": False,
            "GATE_REGULARIZATION_SCALE": 1.0, "RETURN_ATTN_GATE_VALUE": False, "MASK_DURING_INFERENCE": False,
            "NEW_MASK_TOKEN": False, "AUGMENT_IMAGE_WITH_QUERY": False, "DEBUG": False,
            "QUERY_BANK_SAVE_PATH": "", "QUERY_ADDITION_NUM": 5, "ONLINE_UPDATE": False,
            "MAX_CLASSES_PER_PROMPT": 40, "NUM_SCALES": 1,
        },
        "GROUNDINGDINO": {
            "enabled": False, "hidden_dim": 256, "num_queries": 900, "nheads": 8, "dim_feedforward": 2048,
            "enc_layers": 6, "dec_layers": 6, "num_feature_levels": 4, "enc_n_points": 4, "dec_n_points": 4,
            "two_stage_type": "standard", "max_text_len": 256, "box_threshold": 0.05, "dn_number": 0,
            "query_dim": 4, "fusion_droppath": 0.1, "loss_ce_coef": 2.0, "loss_bbox_coef": 5.0,
            "loss_giou_coef": 2.0,
            "matcher": {
                "matcher_type": "HungarianMatcher", "set_cost_class": 1.0, "set_cost_bbox": 5.0,
                "set_cost_giou": 2.0, "focal_alpha": 0.25,
            },
        },
        "TPU": {
            "MESH_SHAPE": (-1,), "MESH_AXIS_NAMES": ("data",), "COMPUTE_DTYPE": "bfloat16",
            "PARAM_DTYPE": "float32", "IMAGE_BUCKETS": ((800, 1344),), "MAX_DETECTIONS_PRE_NMS": 1000,
            "REMAT": False, "DEFORM_RADIUS": 2, "DEFORM_OFFSET_COMPAT": "strided",
        },
        "GLIPKNOW": {
            "KNOWLEDGE_FILE": "", "KNOWLEDGE_TYPE": "", "MAX_NUM_CLASSES_PER_BATCH_TRAIN": -1,
            "PARALLEL_LANGUAGE_INPUT": False, "LAN_FEATURE_AGG_TYPE": "first", "GPT3_NUM": 5,
            "WIKI_AND_GPT3": False,
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
