"""Vision-query bank extraction with per-dataset presets: the port's
counterpart of the JAX package's `tools/extract_queries.py` (reference
tools/extract_vision_query.py). It runs `python -m mqdet_torch.tools.train
--extract-query` with the preset's FEW_SHOT, MAX_QUERY_NUMBER and save
path.

    python -m mqdet_torch.tools.extract_queries --config-file configs/pretrain/mq-glip-t.yaml \\
        --dataset lvis --num_vision_queries 5 [--add_name tiny] [--save_path P] [KEY VALUE ...]
    torchrun --nproc_per_node=8 -m mqdet_torch.tools.extract_queries --config-file ... --dataset lvis

Under torchrun each rank's extraction process inherits the group's
environment and joins it: the images are sharded by rank, the banks merged,
and rank 0 saves the one bank (`tools/train.py::extract_bank`).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional

PRESETS = {
    # dataset -> extra overrides
    "objects365": ["DATASETS.FEW_SHOT", "0"],
    "lvis": ["DATASETS.FEW_SHOT", "{k}"],
    "coco": ["DATASETS.FEW_SHOT", "{k}"],
    "odinw": ["DATASETS.FEW_SHOT", "{k}"],
}


def command(argv: Optional[List[str]] = None) -> List[str]:
    """The extraction command line for the preset."""
    p = argparse.ArgumentParser(description="query-bank extraction with per-dataset presets")
    p.add_argument("--config-file", required=True)
    p.add_argument("--dataset", default="lvis", choices=sorted(PRESETS))
    p.add_argument("--num_vision_queries", type=int, default=5)
    p.add_argument("--add_name", default="")
    p.add_argument("--save_path", default="")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    k = args.num_vision_queries
    save = args.save_path or f"MODEL/{args.dataset}_query_{k}_pool7_sel{args.add_name}.npz"
    extra = [s.format(k=k) for s in PRESETS[args.dataset]]
    return [
        sys.executable, "-m", "mqdet_torch.tools.train",
        "--config-file", args.config_file,
        "--extract-query",
        "VISION_QUERY.QUERY_BANK_SAVE_PATH", save,
        "VISION_QUERY.MAX_QUERY_NUMBER", str(k if args.dataset != "objects365" else 5000),
        *extra,
        *args.opts,
    ]


def main(argv: Optional[List[str]] = None) -> int:
    cmd = command(argv)
    print(" ".join(cmd))
    return subprocess.call(cmd)


if __name__ == "__main__":
    raise SystemExit(main())
