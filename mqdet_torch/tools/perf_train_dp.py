"""Data-parallel training speed of MQ-GLIP-T through the train entry: one
process per card under torchrun, over NCCL (gloo with --device cpu).

    torchrun --nproc_per_node N -m mqdet_torch.tools.perf_train_dp
    torchrun --nproc_per_node 2 -m mqdet_torch.tools.perf_train_dp --tiny --device cpu

Every rank builds MQ-GLIP-T from seed 0 (bf16 on the card) under
`builders.mq_glip_t_pretrain_config` (configs/pretrain/mq-glip-t.yaml's
training settings, the warmup cut to 0) at IMAGES_PER_RANK images a rank, and
the seeded LVIS-shaped dataset of `builders.synthetic_lvis` cut to its 6
landscape images (the 800x1344 bucket; a rank's shard is padded as the
distributed sampler pads it). `tools.train.extract_bank` pools the bank over
the dataset (sharded by rank, merged, rank 0 saving). Then
`tools.train.build_training` and `engine.trainer.do_train` run WARM warm-up
iterations, STEPS timed ones and one split by a synchronise at its
forward / backward / all-reduce / update boundaries. An iteration is timed
on the host clock from one step's start to the next's, so it holds all a
user's iteration pays: the step, the read of its metrics (which waits for
the card), the loader's host work and `do_train`'s agreement all-reduce.

After the run every rank all-gathers the sha1 of its fp32 masters: the ranks
took one all-reduced gradient, so they must agree bitwise, else every rank
exits 1. Rank 0 prints one JSON line: the world, the backend, ms per
iteration (each rank's median, min, max), train img/s (the global batch over
the slowest rank's median), rank 0's split, each rank's all-reduce ms, the
peak memory (largest over the ranks), the last step's loss, whether the masters
agree, the card's name and power limit. --tiny takes the tiny test config at
64x64 (a rehearsal on the CPU). Without a card and without --device cpu it
exits non-zero.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import tempfile
import time

SEED = 0
IMAGES_PER_RANK = 2  # the pretrain yamls' 16 over 8 GPUs
WARM, STEPS = 2, 8


def masters_digest(state) -> str:
    """sha1 of the fp32 masters' bytes in name order."""
    h = hashlib.sha1()
    for n in sorted(state.trainable):
        h.update(n.encode())
        h.update(state.trainable[n].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true", help="the tiny test config at 64x64 (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.trainer import do_train
    from mqdet_torch.parallel import comm
    from mqdet_torch.tools.train import build_training, extract_bank
    from mqdet_torch.utils import builders

    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: run on a GPU, or with --device cpu", file=sys.stderr)
        return 2
    dev = comm.init_distributed(args.device) if comm.launched_by_torchrun() else torch.device(args.device)
    world, rank = comm.get_world_size(), comm.get_rank()
    cuda = dev.type == "cuda"
    if args.tiny:
        cfg = builders.pretrain_settings(builders.tiny_test_config())
        cfg.MODEL.BACKBONE.OUT_CHANNELS = cfg.MODEL.DYHEAD.CHANNELS = 32  # 2 values a GroupNorm group at 1x1
        cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 64
        cfg.AUGMENT.MULT_MIN_SIZE_TRAIN = (40, 48)
    else:
        cfg = builders.mq_glip_t_pretrain_config()
    cfg.SOLVER.IMS_PER_BATCH = world * IMAGES_PER_RANK
    cfg.SOLVER.MAX_ITER = WARM + STEPS + 1
    root = tempfile.TemporaryDirectory(prefix=f"mqdet_perf_dp_rank{rank}_")
    dataset = builders.landscape(builders.synthetic_lvis(root.name, SEED)[0])
    tokenizer = WordPieceTokenizer()
    model = builders.init_params(builders.build_model(cfg), seed=SEED)
    cfg.OUTPUT_DIR = root.name
    cfg.VISION_QUERY.QUERY_BANK_SAVE_PATH = f"{root.name}/bank.npz"
    bank, _ = extract_bank(cfg, model, dataset, dev, log=lambda m: None)
    model.train()
    model, loader, state, step, _ = build_training(cfg, dataset, bank, root.name, dev, model, tokenizer)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    starts, split, last = [], {}, {}

    def timed_step(state, batch, gen):
        if len(starts) == WARM and cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        starts.append(time.perf_counter())
        state, last["metrics"] = step(state, batch, gen, split if len(starts) == cfg.SOLVER.MAX_ITER else None)
        return state, last["metrics"]

    state, _ = do_train(cfg, timed_step, state, loader, dev, log=lambda m: None)
    its = [(b - a) * 1000.0 for a, b in zip(starts[WARM:-1], starts[WARM + 1:])]
    mine = {"ms": statistics.median(its), "min": min(its), "max": max(its), "digest": masters_digest(state),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "split_ms": {k: v * 1000.0 for k, v in split.items()}}
    every = comm.all_gather(mine)
    agree = len({r["digest"] for r in every}) == 1
    if comm.is_main_process():
        from mqdet_torch.tools import card as read_card

        slowest = max(r["ms"] for r in every)
        print(json.dumps({
            "world": world, "backend": torch.distributed.get_backend() if world > 1 else None,
            "images_per_rank": IMAGES_PER_RANK, "global_batch": cfg.SOLVER.IMS_PER_BATCH, "steps": STEPS,
            "ms_per_step": [r["ms"] for r in every], "min_ms": min(r["min"] for r in every),
            "max_ms": max(r["max"] for r in every), "train_img_s": cfg.SOLVER.IMS_PER_BATCH * 1000.0 / slowest,
            "split_ms_rank0": every[0]["split_ms"], "allreduce_ms": [r["split_ms"].get("allreduce") for r in every],
            "peak_gib": max(r["peak_gib"] for r in every) if cuda else None,
            "loss": float(last["metrics"]["loss_total"]),
            "masters_equal_across_ranks": agree, "tiny": args.tiny, "device": dev.type,
            "card": read_card() if cuda else None,
        }), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()
    root.cleanup()
    if not agree:
        print(f"rank {rank}: the ranks' masters differ after the run: {[r['digest'] for r in every]}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
