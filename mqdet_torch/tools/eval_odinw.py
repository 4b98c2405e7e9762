"""The ODinW sweep: the port's counterpart of the JAX package's
`tools/eval_odinw.py` (reference tools/eval_odinw.py), one process per task.

    python -m mqdet_torch.tools.eval_odinw --config-file configs/pretrain/mq-glip-t.yaml \\
        [--tasks configs/odinw_13] [--setting zero-shot|1-shot|3-shot|5-shot|10-shot] [--weight W.pth] \\
        [--device cpu] [KEY VALUE ...]

For every task yaml under --tasks, in sorted order: zero-shot runs `python -m
mqdet_torch.tools.eval --config-file C --task-config TASK`; a k-shot setting
runs `python -m mqdet_torch.tools.finetune --config-file C --ft-tasks TASK
--custom_shot_and_epoch_and_general_copy k_200_4`; each with --weight and
--device where given, then the opts. Each command is printed before it runs;
at the end, how many tasks returned 0, and the exit code is 1 if any did not.
Each task's AP is printed by its own process (eval's results, finetune's AP
line); this tool adds no average over the tasks and no per-shot recipe, as
the JAX tool has neither.
"""
from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MQ-Det ODinW sweep (PyTorch)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--tasks", default="configs/odinw_13", help="task config dir")
    p.add_argument("--setting", default="zero-shot", help="zero-shot | 1-shot | 3-shot | 5-shot | 10-shot")
    p.add_argument("--weight", default=None)
    p.add_argument("--device", default=None, help="passed on to each task's process (default there: cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def task_commands(args) -> List[List[str]]:
    """The command of every task, in the JAX tool's order and arguments."""
    task_files = sorted(glob.glob(os.path.join(args.tasks, "*.yaml")))
    if not task_files:
        raise FileNotFoundError(f"no task configs under {args.tasks}")
    cmds = []
    for task in task_files:
        if args.setting == "zero-shot":
            cmd = [sys.executable, "-m", "mqdet_torch.tools.eval", "--config-file", args.config_file,
                   "--task-config", task]
        else:
            shot = args.setting.split("-")[0]
            cmd = [sys.executable, "-m", "mqdet_torch.tools.finetune", "--config-file", args.config_file,
                   "--ft-tasks", task, "--custom_shot_and_epoch_and_general_copy", f"{shot}_200_4"]
        if args.weight:
            cmd += ["--weight", args.weight]
        if args.device:
            cmd += ["--device", args.device]
        cmds.append(cmd + list(args.opts))
    return cmds


def main(argv: Optional[List[str]] = None) -> None:
    rcs = []
    for cmd in task_commands(parse_args(argv)):
        print("[eval_odinw]", " ".join(cmd), flush=True)
        rcs.append(subprocess.call(cmd))
    failures = sum(1 for r in rcs if r)
    print(f"[eval_odinw] done: {len(rcs) - failures}/{len(rcs)} tasks succeeded")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
