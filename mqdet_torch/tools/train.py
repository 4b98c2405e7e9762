"""Modulated pre-training of MQ-GLIP and MQ-GroundingDINO, and query-bank
extraction: the port's counterpart of the JAX package's `tools/train.py`.

    python -m mqdet_torch.tools.train --config-file configs/pretrain/mq-glip-t.yaml \\
        [--task-config X.yaml] [--additional-model-config Y.yaml] [--extract-query] \\
        [--resume] [--profile-dir DIR] [--device cpu] [KEY VALUE ...]
    torchrun --nproc_per_node=8 -m mqdet_torch.tools.train --config-file ... [KEY VALUE ...]

Under torchrun (WORLD_SIZE > 1) every process joins the group
(`parallel/comm.py::init_distributed`: NCCL on `cuda:LOCAL_RANK`, gloo with
--device cpu) and trains data-parallel on SOLVER.IMS_PER_BATCH / world
images (`engine/train.py`); rank 0 writes the config, the logs and the
checkpoints. Extraction shards the images by rank, merges the ranks' banks
(`QueryBank.allgather_merge`) and rank 0 saves the one bank. Without torchrun
it runs on one device.

`main` layers the config (`load_config`: the base yaml, then --task-config,
then --additional-model-config, then the dotted KEY VALUE opts; the yaml is
read by `core/yaml_lite.py`, since the card's machine has no PyYAML), writes
it to OUTPUT_DIR/config.yml, builds the training dataset from
DATASETS.REGISTER (`build_dataset`), the model from SOLVER.SEED with
MODEL.WEIGHT imported over it (`load_weights`: the import report printed),
and the bank from QUERY_BANK_PATH; then either extracts a query bank over
the dataset (--extract-query) into QUERY_BANK_SAVE_PATH, or trains
(`train`). The library surface:

    from mqdet_torch.tools.train import train
    state, best = train(cfg, dataset, bank, output_dir, resume=False)

`train` builds the model from `SOLVER.SEED` (or takes `model`), the query
selector over `bank` (a `QueryBank` or None), the grounding train loader over
`dataset` (one bucket a batch), the train state and step (`engine/train.py`:
GLIP's, with the anchors of each batch's bucket, or, where
`GROUNDINGDINO.enabled`, GroundingDINO's, which needs none, as the JAX
dispatch at `tools/train.py:259-265`), the checkpointer in `output_dir`, and
runs `do_train`. The model's frozen parameters and activations are in
`TPU.COMPUTE_DTYPE` on the card (fp32 on the CPU); the trainable set keeps
fp32 masters.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Callable, Dict, List, Optional

import torch

from mqdet_torch.core.config import CfgNode, default_config, frozen_patterns, trainable_patterns
from mqdet_torch.data.loader import GroundingTrainLoader
from mqdet_torch.data.tokenizer import get_tokenizer
from mqdet_torch.engine.train import init_train_state, make_gdino_train_step, make_train_step
from mqdet_torch.engine.trainer import do_train
from mqdet_torch.io.checkpoints import Checkpointer
from mqdet_torch.mq.selector import QuerySelector
from mqdet_torch.parallel import comm
from mqdet_torch.utils.builders import build_model, init_params


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MQ-Det training (PyTorch), data-parallel under torchrun")
    p.add_argument("--config-file", required=True)
    p.add_argument("--task-config", default=None)
    p.add_argument("--additional-model-config", default=None)
    p.add_argument("--extract-query", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of the run into this dir")
    p.add_argument("--device", default=None, help="the device to run on (default cuda; cpu where asked)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def load_config(args) -> CfgNode:
    """The reference's override layering (tools/train_net.py:422-432): the
    base yaml, then --task-config, then --additional-model-config, then the
    positional KEY VALUE opts."""
    cfg = default_config()
    cfg.merge_from_file(args.config_file)
    if getattr(args, "task_config", None):
        cfg.merge_from_file(args.task_config)
    if getattr(args, "additional_model_config", None):
        cfg.merge_from_file(args.additional_model_config)
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)
    return cfg


def build_dataset(cfg, name: str, train: bool):
    """The dataset factory dispatch of the JAX CLI (reference: the
    paths_catalog factory field + data/datasets/__init__.py registry). The
    REGISTER entry may carry a `factory` key; the default is the COCO-format
    reader every MQ-Det config uses."""
    from mqdet_torch.data import datasets_extra as DE
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tsv import ODTSVDataset

    reg = cfg.DATASETS.REGISTER.get(name)
    if reg is None:
        raise KeyError(f"dataset {name!r} not in DATASETS.REGISTER: register it with img_dir/ann_file in the config")
    root = cfg.DATASETS.DATA_ROOT
    factory = reg.get("factory", "CocoDetectionDataset")

    if factory in ("TSVDataset", "ODTSVDataset"):
        return ODTSVDataset(os.path.join(root, reg["ann_file"]))
    if factory in ("CaptionTSV", "CaptionTSVDataset"):
        return DE.CaptionTSVDataset(os.path.join(root, reg["ann_file"]))
    if factory in ("CocoDetectionTSV", "CocoDetectionTSVDataset"):
        return DE.CocoDetectionTSVDataset(os.path.join(root, reg["ann_file"]), categories=reg.get("categories"))
    if factory in ("PseudoData", "PseudoDataDataset"):
        return DE.PseudoDataDataset(os.path.join(root, reg["ann_file"]),
                                    caption_format_version=reg.get("caption_format_version", "v1"))
    if factory in ("ImageNet", "ImageNetDataset"):
        return DE.ImageNetDataset(reg["ann_file"], os.path.join(root, reg.get("img_dir", "")))
    if factory == "Background":
        return DE.BackgroundDataset(os.path.join(root, reg["ann_file"]), os.path.join(root, reg["img_dir"]))
    if factory == "PascalVOCDataset":
        return DE.PascalVOCDataset(os.path.join(root, reg["data_dir"]), reg.get("split", "train"))
    if factory == "MixedDataset":
        return DE.MixedDataset(os.path.join(root, reg["ann_file"]), os.path.join(root, reg["img_dir_coco"]),
                               os.path.join(root, reg["img_dir_vg"]))
    grounding = {
        "ModulatedDataset": DE.GroundingCaptionDataset,
        "FlickrDataset": DE.FlickrDataset,
        "RefExpDataset": DE.RefExpDataset,
        "GQADataset": DE.GQADataset,
        "PhrasecutDetection": DE.PhrasecutDetection,
    }
    if factory in grounding:
        return grounding[factory](os.path.join(root, reg["ann_file"]), os.path.join(root, reg["img_dir"]))

    override = None
    if cfg.DATASETS.USE_OVERRIDE_CATEGORY and cfg.DATASETS.OVERRIDE_CATEGORY:
        # the ODinW configs carry the corrected category list as a JSON string
        # (reference DATASETS.OVERRIDE_CATEGORY, tools/finetune.py:567-575)
        override = json.loads(cfg.DATASETS.OVERRIDE_CATEGORY)
    return CocoDetectionDataset(
        os.path.join(root, reg["ann_file"]),
        os.path.join(root, reg["img_dir"]),
        exclude_crowd=cfg.DATASETS.EXCLUDE_CROWD,
        few_shot=cfg.DATASETS.FEW_SHOT if train else 0,
        shuffle_seed=cfg.DATASETS.SHUFFLE_SEED,
        override_category=override,
    )


def build_cli_model(cfg) -> torch.nn.Module:
    """The model of `cfg` from init_params(SOLVER.SEED), fp32 on the CPU, at
    any Swin width and version (MQ-GLIP-T, MQ-GLIP-L; v1, v2, vl, v2_vl)
    with any of the three language towers; the models raise for the options
    the port does not build."""
    return init_params(build_model(cfg), seed=cfg.SOLVER.SEED)


def load_weights(cfg, model, path: str, log: Callable = print) -> Optional[Dict[str, list]]:
    """`path` into `model`: a JAX package `.npz` (`load_params_npz`), else a
    reference-layout `.pth` through the family's rule table, whose report
    ({matched, missing, unused}) is printed and returned."""
    from mqdet_torch.io.checkpoints import load_params_npz
    from mqdet_torch.io.torch_import import import_gdino_checkpoint, import_glip_checkpoint, load_torch_state_dict

    if path.endswith(".npz"):
        load_params_npz(path, model)
        log(f"loaded {path} (a JAX package parameter file)")
        return None
    imp = import_gdino_checkpoint if cfg.GROUNDINGDINO.enabled else import_glip_checkpoint
    report = imp(model, load_torch_state_dict(path))
    log(f"imported {len(report['matched'])} params; {len(report['missing'])} missing; "
        f"{len(report['unused'])} unused")
    return report


def load_bank(cfg):
    """VISION_QUERY.QUERY_BANK_PATH as a QueryBank (a reference `.pth` or
    this package's `.npz`), or None."""
    from mqdet_torch.mq.bank import QueryBank

    path = cfg.VISION_QUERY.QUERY_BANK_PATH
    if not (cfg.VISION_QUERY.ENABLED and path):
        return None
    return QueryBank.from_torch_pth(path) if path.endswith(".pth") else QueryBank.load(path)


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
        step = make_train_step(model, tx, cfg)
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


def extract_bank(cfg, model, dataset, device="cuda", log: Callable = print):
    """The --extract-query branch (reference tools/train_net.py:287-336):
    every GT box of `dataset` pooled into a new bank, saved to
    QUERY_BANK_SAVE_PATH (else OUTPUT_DIR/query_bank.npz). Across processes
    each rank pools its strided shard of the images, the banks are merged
    in rank order (`allgather_merge`, under MAX_QUERY_NUMBER) and rank 0
    saves the merged bank while the others wait (JAX tools/train.py:216,
    238-246). Returns (bank, path)."""
    from mqdet_torch.data.transforms import EvalTransform
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.mq.extract import dataset_extraction_iter, extract_queries_into_bank, make_extract_fn

    device = torch.device(device)
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE) if device.type == "cuda" else torch.float32
    model = model.to(device, dtype).to(memory_format=torch.channels_last).eval()
    bank = QueryBank(channels=cfg.MODEL.BACKBONE.OUT_CHANNELS, num_scales=cfg.VISION_QUERY.NUM_SCALES)
    cap = cfg.VISION_QUERY.MAX_QUERY_NUMBER
    ids = list(dataset.ids)[comm.get_rank()::comm.get_world_size()]
    extract_queries_into_bank(make_extract_fn(model, cfg),
                              dataset_extraction_iter(dataset, EvalTransform(cfg), device, ids), bank,
                              max_query_number=cap)
    bank.allgather_merge(capacity=cap)
    path = cfg.VISION_QUERY.QUERY_BANK_SAVE_PATH or os.path.join(cfg.OUTPUT_DIR, "query_bank.npz")
    if comm.is_main_process():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        bank.save(path)
        log(f"saved query bank ({len(bank)} classes) to {path}")
    comm.synchronize()
    return bank, path


def main(argv: Optional[List[str]] = None, device="cuda"):
    """The CLI. Returns the saved bank's path (--extract-query) or
    (state, best eval result)."""
    from mqdet_torch.utils.profiling import trace

    args = parse_args(argv)
    device = args.device or device
    if comm.launched_by_torchrun():
        device = comm.init_distributed(device)
    cfg = load_config(args)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    if comm.is_main_process():
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yml"), "w") as f:
            f.write(cfg.dump_yaml())

    tokenizer = get_tokenizer(cfg.MODEL.LANGUAGE_BACKBONE.TOKENIZER_TYPE)
    dataset = build_dataset(cfg, cfg.DATASETS.TRAIN[0], train=True)
    model = build_cli_model(cfg)
    if cfg.MODEL.WEIGHT:
        load_weights(cfg, model, cfg.MODEL.WEIGHT)
    if args.extract_query:
        return extract_bank(cfg, model, dataset, device)[1]
    if not hasattr(dataset, "ind_to_class"):
        raise NotImplementedError(
            f"training on {type(dataset).__name__} is not supported: the grounding train loader reads a "
            "detection dataset's ind_to_class, and the JAX package's loader does too, so neither package trains "
            "on caption or TSV datasets (ROADMAP Queue A 4.4)"
        )
    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with prof:
        state, best = train(cfg, dataset, load_bank(cfg), cfg.OUTPUT_DIR, resume=args.resume, device=device,
                            model=model, tokenizer=tokenizer)
    if comm.is_main_process():
        print(f"training done; best eval result: {best}")
    return state, best


if __name__ == "__main__":
    main()
