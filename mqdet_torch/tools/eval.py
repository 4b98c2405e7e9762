"""Finetuning-free evaluation: the port's counterpart of the JAX package's
`tools/eval.py` (reference tools/test_grounding_net.py).

    python -m mqdet_torch.tools.eval --config-file configs/vision_query_5shot/lvis_minival.yaml \\
        --weight MODEL/mq-glip-t.pth [--task-config X.yaml] [--additional-model-config Y.yaml] \\
        [--max-images N] [--lvis] [--calibrate-deform] [--profile-dir DIR] [--device cpu] [KEY VALUE ...]
    torchrun --nproc_per_node=8 -m mqdet_torch.tools.eval --config-file ... --weight W.pth [KEY VALUE ...]

The config is layered as in training (`tools/train.py::load_config`; the
yaml is read by `core/yaml_lite.py`, since the card's machine has no
PyYAML). `evaluate` then builds the model, loads MODEL.WEIGHT (a JAX
package `.npz`, or a reference-layout `.pth` through the family's rule table
with the import report printed), optionally measures the DCN offsets and
moves TPU.DEFORM_RADIUS or the DCN route (--calibrate-deform, rebuilding the
model where the radius is taken at construction), reads the query bank
(QUERY_BANK_PATH: a reference `.pth` or this package's `.npz`), runs the
test-time online update (VISION_QUERY.ONLINE_UPDATE), evaluates
TEST[0] in the style its dataset's type picks (`engine/eval_dispatch.py`:
COCO, LVIS fixed AP, VOC, phrase grounding), writes OUTPUT_DIR/bbox.csv
(the JAX CLI's columns and format) and checks TEST.EXPECTED_RESULTS.
Everything runs on the card unless the caller asks for the CPU. Under
torchrun (WORLD_SIZE > 1) every process joins the group on `cuda:LOCAL_RANK`
(`parallel/comm.py::init_distributed`), `run_inference` scores each rank's
strided shard of the images and merges the evaluators' records, the online
update runs whole on every rank (as in JAX), and rank 0 writes bbox.csv.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from mqdet_torch.parallel import comm
from mqdet_torch.tools.train import build_cli_model, build_dataset, load_bank, load_config, load_weights

BBOX_CSV_COLUMNS = ("AP", "AP50", "AP75", "APr", "APc", "APf", "mAP", "recall@1", "recall@5", "recall@10")


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MQ-Det evaluation (PyTorch)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--weight", default=None)
    p.add_argument("--task-config", default=None)
    p.add_argument("--additional-model-config", default=None)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--lvis", action="store_true", help="use the LVIS fixed-AP protocol")
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of the evaluation into this dir")
    p.add_argument("--calibrate-deform", action="store_true",
                   help="measure the checkpoint's DCN offset range on one batch and raise TPU.DEFORM_RADIUS, "
                        "or take the exact gather route, where the clipped route would differ")
    p.add_argument("--device", default=None, help="the device to run on (default cuda; cpu where asked)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def write_bbox_csv(results: Dict[str, float], output_dir: str) -> str:
    """OUTPUT_DIR/bbox.csv: the headline metrics present, 4 decimals."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "bbox.csv")
    keys = [k for k in BBOX_CSV_COLUMNS if k in results]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(keys)
        w.writerow([f"{results[k]:.4f}" for k in keys])
    return path


def _calibrate(cfg, model, device, dtype, log):
    """--calibrate-deform: offsets measured on one synthetic batch at the
    first bucket (the JAX CLI's init batch); returns the model, rebuilt with
    its weights where the radius changed."""
    from mqdet_torch.utils.builders import build_model, synthetic_batch
    from mqdet_torch.utils.calibrate import apply_calibration, calibrate_deform_radius

    b = synthetic_batch(cfg, 1, tuple(cfg.TPU.IMAGE_BUCKETS[0]), num_labels=2,
                        k_shot=cfg.VISION_QUERY.NUM_QUERY_PER_CLASS)
    args = (torch.from_numpy(b["images"]).permute(0, 3, 1, 2).to(device, dtype),
            *(torch.from_numpy(b[k]).to(device) for k in ("input_ids", "attention_mask", "queries", "query_mask")))
    calib = calibrate_deform_radius(cfg, model, args)
    log(f"deform calibration: max|offset|={calib.max_offset:.2f}px -> radius={calib.radius} impl={calib.impl}")
    if apply_calibration(cfg, calib):
        # the radius is taken at construction: rebuild and load the weights again
        rebuilt = build_model(cfg)
        rebuilt.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        model = rebuilt.to(device, dtype).to(memory_format=torch.channels_last).eval()
    return model


def evaluate(cfg, dataset=None, device="cuda", tokenizer=None, max_images: Optional[int] = None,
             force_lvis: bool = False, calibrate_deform: bool = False, profile_dir: Optional[str] = None,
             log: Callable = print, record: Optional[dict] = None,
             model: Optional[torch.nn.Module] = None) -> Dict[str, float]:
    """The CLI's body on a merged config: the results of `run_evaluation`.
    `dataset` replaces the registry's DATASETS.TEST[0] (a reader whose
    `load_image` needs no PIL, say); `tokenizer` replaces
    `get_tokenizer(TOKENIZER_TYPE)`; `model`, a built model of `cfg` (fp32
    on the CPU), replaces `build_cli_model(cfg)`, whose random init the
    import overwrites. `record`, a dict, receives the import
    report ("import_report", None for an `.npz`) and the host seconds of
    each stage ("seconds": model, import, bank, update, evaluation, each
    ending synchronised on the card)."""
    from mqdet_torch.data.tokenizer import get_tokenizer
    from mqdet_torch.engine.eval_dispatch import run_evaluation
    from mqdet_torch.engine.evaluator import check_expected_results
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.utils.profiling import trace

    device = torch.device(device)
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE) if device.type == "cuda" else torch.float32
    record = {} if record is None else record
    seconds = record.setdefault("seconds", {})
    clock = [time.perf_counter()]

    def lap(stage):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[stage] = seconds.get(stage, 0.0) + now - clock[0]
        clock[0] = now

    model = build_cli_model(cfg) if model is None else model
    lap("model")
    record["import_report"] = load_weights(cfg, model, cfg.MODEL.WEIGHT, log) if cfg.MODEL.WEIGHT else None
    model = model.to(device, dtype).to(memory_format=torch.channels_last).eval()
    if calibrate_deform and cfg.MODEL.DYHEAD.USE_DFCONV:
        model = _calibrate(cfg, model, device, dtype, log)
    lap("import")
    if dataset is None:
        dataset = build_dataset(cfg, cfg.DATASETS.TEST[0], train=False)
    tokenizer = tokenizer or get_tokenizer(cfg.MODEL.LANGUAGE_BACKBONE.TOKENIZER_TYPE)
    selector = None
    bank = load_bank(cfg)
    if bank is not None:
        selector = QuerySelector(bank, num_query_per_class=cfg.VISION_QUERY.NUM_QUERY_PER_CLASS,
                                 max_labels=cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT)
    lap("bank")
    if cfg.VISION_QUERY.ONLINE_UPDATE and selector is not None:
        from mqdet_torch.engine.inference import online_update
        from mqdet_torch.mq.extract import make_extract_fn

        selector = online_update(cfg, model, dataset, tokenizer, selector, make_extract_fn(model, cfg),
                                 max_images=max_images)
        lap("update")

    prof = trace(profile_dir) if profile_dir else contextlib.nullcontext()
    with prof:
        results = run_evaluation(cfg, model, dataset, tokenizer, selector, max_images=max_images,
                                 dataset_name=cfg.DATASETS.TEST[0], force_lvis=force_lvis)
    lap("evaluation")
    if comm.is_main_process():
        log({k: v for k, v in results.items() if not isinstance(v, dict)})
        write_bbox_csv(results, cfg.OUTPUT_DIR)
    if cfg.TEST.EXPECTED_RESULTS:
        check_expected_results(results, cfg.TEST.EXPECTED_RESULTS, cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL)
        log("expected-results check passed")
    return results


def main(argv: Optional[List[str]] = None, device="cuda") -> Dict[str, float]:
    args = parse_args(argv)
    device = args.device or device
    if comm.launched_by_torchrun():
        device = comm.init_distributed(device)
    cfg = load_config(args)
    if args.weight:
        cfg.MODEL.WEIGHT = args.weight
    return evaluate(cfg, device=device, max_images=args.max_images, force_lvis=args.lvis,
                    calibrate_deform=args.calibrate_deform, profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
