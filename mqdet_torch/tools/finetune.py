"""Few-shot finetuning over ODinW-style task configs: the port's counterpart
of the JAX package's `tools/finetune.py` (reference tools/finetune.py), on
one device.

    python -m mqdet_torch.tools.finetune --config-file configs/pretrain/mq-glip-t.yaml \\
        --ft-tasks configs/odinw_13/pothole.yaml[,TASK2.yaml ...] \\
        [--custom_shot_and_epoch_and_general_copy 3_200_4] [--weight W.pth] [--seeds 0,1,2] \\
        [--device cpu] [KEY VALUE ...]

Per task yaml and shuffle seed, as the JAX tool:
- the config: the base yaml, the task yaml, then the opts; DATASETS.FEW_SHOT,
  SHUFFLE_SEED and GENERAL_COPY and SOLVER.MAX_EPOCH (where the epoch is not
  0) from the shot_epoch_copy string; the recipe `vision_query_v3` where
  SOLVER.TUNING_HIGHLEVEL_OVERRIDE is empty; --weight as MODEL.WEIGHT;
- the model from init_params(SOLVER.SEED) with MODEL.WEIGHT imported over it
  (`tools/train.py::load_weights`, its report printed), on the device in
  TPU.COMPUTE_DTYPE (fp32 on the CPU);
- the few-shot train split and the test split (`build_dataset`);
- the bank: where VISION_QUERY.QUERY_BANK_PATH is empty, a temporary one
  extracted from the few-shot train split, NUM_QUERY_PER_CLASS queries a
  class; else the file;
- the loader, with SOLVER.MAX_ITER = MAX_EPOCH * its steps per epoch;
- `do_train` with an `eval_fn` that runs `run_inference` on the test split
  on the current fp32 masters cast into the model (what JAX's
  `merge(trainable, frozen)` holds: not the EMA, not the model's copy from
  before the last update), then one more evaluation;
- one line `[finetune] TASK seed=S: AP=...` (the better of the best
  evaluation during training and the final one), and after all runs the
  average AP over them.

JAX's tool is MQ-GLIP's only (its weight import and anchors), and so is
this one: a GroundingDINO config is refused. `main` returns {(task, seed):
AP}; `model_fn(cfg)` replaces the model's build (`build_cli_model`) and
`dataset_fn(cfg, name, train)` the dataset's (`build_dataset`), for a caller
that holds an initialised model or serves the images itself.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mqdet_torch.core.config import default_config, frozen_patterns, trainable_patterns
from mqdet_torch.data.loader import GroundingTrainLoader
from mqdet_torch.data.tokenizer import get_tokenizer
from mqdet_torch.data.transforms import EvalTransform
from mqdet_torch.engine.inference import run_inference
from mqdet_torch.engine.train import init_train_state, load_trainable, make_train_step
from mqdet_torch.engine.trainer import do_train
from mqdet_torch.mq.bank import QueryBank
from mqdet_torch.mq.extract import dataset_extraction_iter, extract_queries_into_bank, make_extract_fn
from mqdet_torch.mq.selector import QuerySelector
from mqdet_torch.tools.train import build_cli_model, build_dataset, load_bank, load_weights


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MQ-Det few-shot finetuning (PyTorch)")
    p.add_argument("--config-file", required=True, help="base model config")
    p.add_argument("--ft-tasks", required=True, help="comma-separated task yamls")
    p.add_argument("--custom_shot_and_epoch_and_general_copy", default="3_200_4", help="shot_epoch_generalcopy")
    p.add_argument("--weight", default=None)
    p.add_argument("--seeds", default="0", help="comma-separated shuffle seeds")
    p.add_argument("--device", default=None, help="the device to run on (default cuda; cpu where asked)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def task_config(config_file: str, task: str, opts: List[str], shot: int, epoch: int, copies: int, seed: int,
                weight: Optional[str] = None):
    """One run's config, layered as the JAX tool layers it."""
    cfg = default_config()
    cfg.merge_from_file(config_file)
    cfg.merge_from_file(task)
    if opts:
        cfg.merge_from_list(opts)
    cfg.DATASETS.FEW_SHOT = shot
    cfg.DATASETS.SHUFFLE_SEED = seed
    cfg.DATASETS.GENERAL_COPY = copies
    cfg.SOLVER.MAX_EPOCH = epoch if epoch else cfg.SOLVER.MAX_EPOCH
    if not cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE:
        cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = "vision_query_v3"
    if weight:
        cfg.MODEL.WEIGHT = weight
    return cfg


def finetune_one(cfg, device, tokenizer, model_fn: Callable = build_cli_model, dataset_fn: Callable = build_dataset,
                 log: Callable = print) -> float:
    """One task and seed on a layered config: the AP the JAX tool reports,
    max(best evaluation during training, final evaluation)."""
    if cfg.GROUNDINGDINO.enabled:
        raise NotImplementedError("finetune trains MQ-GLIP only, as the JAX package's tools/finetune.py")
    device = torch.device(device)
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE) if device.type == "cuda" else torch.float32
    train_ds = dataset_fn(cfg, cfg.DATASETS.TRAIN[0], True)
    test_ds = dataset_fn(cfg, cfg.DATASETS.TEST[0], False)
    model = model_fn(cfg)
    if cfg.MODEL.WEIGHT:
        load_weights(cfg, model, cfg.MODEL.WEIGHT, log)
    model = model.to(device, dtype).to(memory_format=torch.channels_last)

    vq = cfg.VISION_QUERY
    if vq.ENABLED and not vq.QUERY_BANK_PATH:
        # a temporary bank from the few-shot train split (tools/finetune.py:101-127)
        bank = QueryBank(channels=cfg.MODEL.BACKBONE.OUT_CHANNELS, num_scales=vq.NUM_SCALES)
        extract_queries_into_bank(make_extract_fn(model, cfg),
                                  dataset_extraction_iter(train_ds, EvalTransform(cfg), device), bank,
                                  max_query_number=vq.NUM_QUERY_PER_CLASS)
    else:
        bank = load_bank(cfg)
    selector = QuerySelector(bank, num_query_per_class=vq.NUM_QUERY_PER_CLASS, pure_text_rate=vq.PURE_TEXT_RATE,
                             max_labels=vq.MAX_CLASSES_PER_PROMPT)

    loader = GroundingTrainLoader(train_ds, cfg, tokenizer, selector, seed=cfg.DATASETS.SHUFFLE_SEED)
    cfg.SOLVER.MAX_ITER = cfg.SOLVER.MAX_EPOCH * loader.steps_per_epoch()
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg), frozen_patterns(cfg))
    train_step = make_train_step(model, tx, cfg)

    def eval_fn(st):
        load_trainable(model, st.trainable)  # the current masters, in the model's dtype
        return run_inference(cfg, model, test_ds, tokenizer, selector, verbose=False)["AP"]

    state, best = do_train(cfg, train_step, state, loader, device, eval_fn=eval_fn, log=log)
    return max(best, eval_fn(state))


def main(argv: Optional[List[str]] = None, device="cuda", model_fn: Callable = build_cli_model,
         dataset_fn: Callable = build_dataset, log: Callable = print) -> Dict[Tuple[str, int], float]:
    args = parse_args(argv)
    shot, epoch, copies = (int(x) for x in args.custom_shot_and_epoch_and_general_copy.split("_"))
    results: Dict[Tuple[str, int], float] = {}
    for task in args.ft_tasks.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            cfg = task_config(args.config_file, task, args.opts, shot, epoch, copies, seed, args.weight)
            tokenizer = get_tokenizer(cfg.MODEL.LANGUAGE_BACKBONE.TOKENIZER_TYPE)
            results[(task, seed)] = finetune_one(cfg, args.device or device, tokenizer, model_fn, dataset_fn, log)
            print(f"[finetune] {task} seed={seed}: AP={results[(task, seed)]:.4f}")
    if results:
        avg = sum(results.values()) / len(results)
        print(f"[finetune] average AP over {len(results)} runs: {avg:.4f}")
    return results


if __name__ == "__main__":
    main()
