"""The port's evaluation CLI on the shipped MQ-GLIP-L yamls against the JAX
package's: `python -m mqdet_torch.tools.eval --config-file
configs/pretrain/mq-glip-l.yaml --task-config
configs/vision_query_5shot/lvis_minival_L.yaml --additional-model-config W.yaml`
and the JAX `tools/eval.py` on the same argv, in process on the CPU in fp32.
W.yaml takes the yamls to `tiny_l_config`'s widths (Swin window 12, depths
(2, 2, 3, 2), 8 head stages from the yaml; `test_torch_port_eval.py`'s
evaluation settings) and names the data root, the bank and the weights (a
reference-layout `.pth` of the 1204-class model the yamls describe, seeded).
The JAX CLI's functions compile at O0 (`jit_at_o0`). Tolerance: results
and bbox.csv within 1e-6, as `test_torch_port_cli.py`.
"""
import argparse
import os

import numpy as np
import torch

from mqdet_torch.core import yaml_lite
from mqdet_torch.io import torch_import as TI
from mqdet_torch.utils import builders as tb
from test_torch_port_cli import CATEGORIES, jax_cli, read_csv, same_results
from test_torch_port_eval import eval_settings
from test_torch_port_glip_l import L_YAML, REPO, jit_at_o0, save_reference_pth
from test_torch_port_querybank import write_coco

torch.set_num_threads(2)

LVIS_L_YAML = os.path.join(REPO, "configs", "vision_query_5shot", "lvis_minival_L.yaml")


def width_yaml(path, data_root, bank, weight):
    """The additional model config that takes MQ-GLIP-L's yamls to the tiny L
    widths (Swin, BERT, head channels, buckets) with the evaluation settings
    of `test_torch_port_eval.py`, plus the user's paths; fp32."""
    cfg = tb.tiny_l_config()
    eval_settings(cfg, "glip")
    lb, sw = cfg.MODEL.LANGUAGE_BACKBONE, cfg.MODEL.SWINT
    tree = {
        "MODEL": {
            "SWINT": {"EMBED_DIM": sw.EMBED_DIM, "DEPTHS": list(sw.DEPTHS), "NUM_HEADS": list(sw.NUM_HEADS),
                      "OUT_CHANNELS": list(sw.OUT_CHANNELS)},
            "BACKBONE": {"OUT_CHANNELS": cfg.MODEL.BACKBONE.OUT_CHANNELS},
            "DYHEAD": {"CHANNELS": cfg.MODEL.DYHEAD.CHANNELS},
            "LANGUAGE_BACKBONE": {k: lb[k] for k in ("HIDDEN_LAYERS", "LANG_DIM", "HIDDEN_SIZE", "NUM_HEADS",
                                                    "INTERMEDIATE_SIZE", "MAX_QUERY_LEN")},
            "GROUP_NORM": {"NUM_GROUPS": cfg.MODEL.GROUP_NORM.NUM_GROUPS},
            "ATSS": {"INFERENCE_TH": 0.0, "DETECTIONS_PER_IMG": cfg.MODEL.ATSS.DETECTIONS_PER_IMG},
            "WEIGHT": weight,
        },
        "INPUT": {"MIN_SIZE_TEST": cfg.INPUT.MIN_SIZE_TEST, "MAX_SIZE_TEST": cfg.INPUT.MAX_SIZE_TEST},
        "TEST": {"CHUNKED_EVALUATION": cfg.TEST.CHUNKED_EVALUATION, "CHUNK_PARALLELISM": cfg.TEST.CHUNK_PARALLELISM},
        "VISION_QUERY": {"START_QV_LAYER": cfg.VISION_QUERY.START_QV_LAYER, "QUERY_BANK_PATH": bank,
                         "MAX_CLASSES_PER_PROMPT": cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT,
                         "NUM_QUERY_PER_CLASS": cfg.VISION_QUERY.NUM_QUERY_PER_CLASS, "SCORE_THRESHOLD": 0.0},
        "TPU": {"IMAGE_BUCKETS": [list(b) for b in cfg.TPU.IMAGE_BUCKETS], "COMPUTE_DTYPE": "float32"},
        "DATASETS": {"DATA_ROOT": data_root},
    }
    path.write_text(yaml_lite.dump(tree))
    return str(path)


def test_eval_cli_on_the_mq_glip_l_yamls_matches_jax(tmp_path):
    """`python -m mqdet_torch.tools.eval --config-file
    configs/pretrain/mq-glip-l.yaml --task-config
    configs/vision_query_5shot/lvis_minival_L.yaml --additional-model-config
    W.yaml --device cpu` (W: the tiny L widths, the data root, the bank and
    the weights: a reference `.pth` of the 1204-class model the yamls
    describe) builds and evaluates MQ-GLIP-L's layout with LVIS fixed AP,
    and gives the JAX CLI's results and bbox.csv on the same argv, within
    1e-6; the import of those weights counts 0 missing and 0 unused."""
    from mqdet_tpu.mq import bank as jbank
    from mqdet_torch.tools import eval as teval
    from mqdet_torch.tools.train import load_config

    root = tmp_path / "data"
    ann = root / "coco" / "annotations"
    ann.mkdir(parents=True)
    ann_file, _ = write_coco(root / "coco", [(60, 80)] * 2 + [(80, 60)], boxes_per_image=3, categories=CATEGORIES,
                             seed=5)
    os.replace(ann_file, ann / "lvis_v1_minival_inserted_image_name.json")
    for name in os.listdir(root / "coco" / "images"):
        os.replace(root / "coco" / "images" / name, root / "coco" / name)  # the yaml's img_dir: "coco"
    bank = jbank.QueryBank(channels=16)
    rng = np.random.default_rng(0)
    for lab in (1, 2, 4, 5, 7):
        bank.add(lab, rng.standard_normal((3, 1, 16)).astype(np.float32))
    bank.save(str(tmp_path / "bank.npz"))
    weight = str(tmp_path / "glip_l.pth")
    extra = width_yaml(tmp_path / "tiny_l.yaml", str(root), str(tmp_path / "bank.npz"), weight)
    argv = ["--config-file", L_YAML, "--task-config", LVIS_L_YAML, "--additional-model-config", extra]
    cfg = load_config(argparse.Namespace(config_file=L_YAML, task_config=LVIS_L_YAML, additional_model_config=extra,
                                         opts=[]))
    assert cfg.MODEL.DYHEAD.NUM_CLASSES == 1204 and cfg.MODEL.SWINT.WINDOW_SIZE == 12
    assert tuple(cfg.MODEL.SWINT.DEPTHS) == (2, 2, 3, 2) and cfg.MODEL.DYHEAD.NUM_CONVS == 8
    save_reference_pth(weight, tb.init_params(tb.build_model(cfg), seed=3))

    with jit_at_o0():
        want = jax_cli([*argv, "OUTPUT_DIR", str(tmp_path / "jax")])
    got = teval.main([*argv, "--device", "cpu", "OUTPUT_DIR", str(tmp_path / "port")], device="cuda")
    timing = ("images_per_second", "seconds")
    same_results({k: v for k, v in got.items() if k not in timing}, {k: v for k, v in want.items() if k not in timing})
    assert np.isfinite(got["AP"]) and "AP75" in got
    keys, values = read_csv(tmp_path / "port" / "bbox.csv")
    jkeys, jvalues = read_csv(tmp_path / "jax" / "bbox.csv")
    assert keys == jkeys
    np.testing.assert_allclose(values, jvalues, atol=1e-6, rtol=0)
    report = TI.import_glip_checkpoint(tb.build_model(cfg), TI.load_torch_state_dict(weight))
    assert not report["missing"] and not report["unused"] and len(report["matched"]) > 600
