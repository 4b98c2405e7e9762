"""Data-parallel training and evaluation of the port across processes, on the
CPU over gloo, against the JAX package on the global batch and against the
port in one process.

The rank workers live in this file: run as a script
(`python test_torch_port_distributed.py SPEC.json`, with torchrun's RANK /
WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT in the environment) a
worker imports only torch, numpy and the port, joins the gloo group through
`mqdet_torch.parallel.comm.init_distributed`, runs every case of the spec in
order and saves its results. The module fixture `ranks` starts two workers
once (each with a timeout) while the tests compute the JAX side.

Tolerances, those of tests/test_torch_port_train.py and
test_torch_port_gdino_train.py: losses within rtol 1e-4, masters (and EMA)
within 1e-5 of their largest value, against JAX's step on the global batch
of 2 sharded over a 2-device mesh and against the port's own one-process
step on it; the masters of the two ranks bitwise equal; run_inference's AP
within 1e-6 of JAX's and its detections within JAX's run_inference
tolerances (scores 1e-5, boxes 1e-4), and equal to the one-process port's.
Dropout and drop path are at 0 (`no_dropout`); where the step draws text
dropout, JAX's loss takes the same (B, L) uniforms.
"""
from __future__ import annotations

import copy
import json
import os
import random
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 2
TEXT_DROPOUT = 0.5
RANK_TIMEOUT_S = 300   # each worker process
GLOO_TIMEOUT_S = 120   # a collective that waits longer raises


def no_dropout(model):
    """The port model with its training dropout rates at 0 (the fusion's
    attention dropout, Swin's stochastic depth)."""
    from mqdet_torch.models.fusion import BiMultiHeadAttention
    from mqdet_torch.models.swin import SwinBlock

    for m in model.modules():
        if isinstance(m, BiMultiHeadAttention):
            m.dropout = 0.0
        if isinstance(m, SwinBlock):
            m.drop_path = 0.0
    return model


def load_cfg(path):
    from mqdet_torch.core.config import default_config

    cfg = default_config()
    cfg.merge_from_file(path)
    return cfg


def load_model(cfg_path, weights_path):
    from mqdet_torch.utils import builders as tb

    cfg = load_cfg(cfg_path)
    model = tb.build_model(cfg).eval()
    model.load_state_dict(torch.load(weights_path, weights_only=True))
    return cfg, no_dropout(model)


def rows(batch, rank, b=1):
    """The rank's rows of a numpy global batch."""
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def masters(state):
    return {n: t.clone() for n, t in state.trainable.items()}


# ---------------------------------------------------------------- the worker


def _case_glip(spec, rank):
    """(a) 2 steps of the GLIP step on the rank's image of the global batch."""
    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine import train as tt

    cfg, model = load_model(spec["glip_cfg"], spec["glip_model"])
    batch = rows(dict(np.load(spec["glip_batch"])), rank)
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    step = tt.make_train_step(model, tx, cfg)
    out = {"masters": [], "ema": [], "metrics": [], "grads": []}
    for it in range(2):
        grads = {}
        state, metrics = step(state, tt.batch_to_device(batch, "cpu"), tt.step_generator(cfg.SOLVER.SEED, it, "cpu"),
                              grads_out=grads)
        out["grads"].append(grads)
        out["masters"].append(masters(state))
        out["ema"].append({n: t.clone() for n, t in state.ema.items()})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    return out


def _case_gate(spec, rank):
    """(c) a step whose loss is the gate loss alone (regularised, so it has
    a gradient)."""
    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine import train as tt

    cfg, model = load_model(spec["glip_cfg"], spec["glip_model"])
    cfg.VISION_QUERY.GATE_REGULARIZATION = True
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    gate = tt._gate_loss(model, tx, cfg, torch.device("cpu"))
    step = tt._finish_train_step(model, tx, lambda batch, g, times, t0: ({"loss_gate": gate()}, t0), 0.0,
                                 torch.device("cpu"))
    state, metrics = step(state, {}, torch.Generator())
    return {"masters": masters(state), "metrics": {k: float(v) for k, v in metrics.items()}}


def _case_nan(spec, rank):
    """(d) one step with a NaN in rank 1's queries alone, weight decay 0."""
    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine import train as tt

    cfg, model = load_model(spec["glip_cfg"], spec["glip_model"])
    cfg.SOLVER.WEIGHT_DECAY = 0.0
    batch = rows(dict(np.load(spec["glip_batch"])), rank)
    if rank == 1:
        batch["queries"] = batch["queries"].copy()
        batch["queries"][0, 0, 0] = np.nan
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    before = masters(state)
    state, metrics = tt.make_train_step(model, tx, cfg)(state, tt.batch_to_device(batch, "cpu"),
                                                         tt.step_generator(cfg.SOLVER.SEED, 0, "cpu"))
    return {"before": before, "masters": masters(state), "loss_total": float(metrics["loss_total"]),
            "mu_max": max(float(m.abs().max()) for m in state.opt_state["mu"].values())}


def _case_batch(spec, rank):
    """(e) SOLVER.IMS_PER_BATCH 3 over 2 ranks."""
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.loader import GroundingTrainLoader
    from mqdet_torch.data.tokenizer import WordPieceTokenizer

    cfg = load_cfg(spec["train_cfg"])
    cfg.SOLVER.IMS_PER_BATCH = 3
    try:
        GroundingTrainLoader(CocoDetectionDataset(*spec["coco"]), cfg, WordPieceTokenizer())
    except ValueError as exc:
        return {"error": str(exc)}
    return {"error": None}


def _train(spec, cfg_path, data, out_dir, max_iter, resume):
    """`tools.train.train` on the CPU: the final state, rank 0's checkpoint
    writes, and how many fetches found this rank's loader exhausted."""
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.io.checkpoints import Checkpointer
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.tools.train import train

    cfg = load_cfg(cfg_path)
    cfg.SOLVER.MAX_ITER = max_iter
    writes = []
    real = Checkpointer._write
    Checkpointer._write = lambda self, step, *a: (writes.append(step), real(self, step, *a))
    epochs = []
    try:
        from mqdet_torch.engine import trainer

        real_agree = trainer._agree
        trainer._agree = lambda batch, device: (epochs.append(batch is None), real_agree(batch, device))[1]
        state, _ = train(cfg, CocoDetectionDataset(*data), QueryBank.load(spec["train_bank"]), out_dir,
                         resume=resume, device="cpu", tokenizer=WordPieceTokenizer(), log=lambda m: None)
    finally:
        Checkpointer._write = real
        trainer._agree = real_agree
    return {"step": state.step, "masters": masters(state), "ema": dict(state.ema), "nu": dict(state.opt_state["nu"]),
            "writes": writes, "exhausted": sum(epochs)}


def _case_uneven(spec, rank):
    """(f) `train` on a dataset whose shards fill different numbers of
    batches an epoch: rank 0's four landscape images two, rank 1's portrait
    and three landscape ones one."""
    return _train(spec, spec["mixed_cfg"], spec["mixed"], os.path.join(spec["dir"], "uneven"), 4, False)


def _case_resume(spec, rank):
    """(i) 4 iterations straight, and 1 then resumed to 4."""
    root = spec["dir"]
    full = _train(spec, spec["train_cfg"], spec["coco"], os.path.join(root, "full"), 4, False)
    first = _train(spec, spec["train_cfg"], spec["coco"], os.path.join(root, "part"), 1, False)
    resumed = _train(spec, spec["train_cfg"], spec["coco"], os.path.join(root, "part"), 4, True)
    return {"full": full, "first": first, "resumed": resumed}


def _case_gdino(spec, rank):
    """(b) one GDINO step on the rank's image, the one-process assignment's rows."""
    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine import train as tt

    cfg, model = load_model(spec["gdino_cfg"], spec["gdino_model"])
    batch = rows(dict(np.load(spec["gdino_batch"])), rank)
    assignment = np.load(spec["gdino_assignment"])[:, rank:rank + 1]
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    step = tt.make_gdino_train_step(model, tx, cfg)
    state, metrics = step(state, tt.batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0),
                          assignment=assignment)
    return {"masters": masters(state), "ema": dict(state.ema), "metrics": {k: float(v) for k, v in metrics.items()}}


def _case_inference(spec, rank):
    """(g) run_inference over the rank's shard, the evaluators merged."""
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.evaluator import DetectionEvaluator
    from mqdet_torch.engine.inference import run_inference
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.mq.selector import QuerySelector

    cfg, model = load_model(spec["eval_cfg"], spec["eval_model"])
    vq = cfg.VISION_QUERY
    sel = QuerySelector(QueryBank.load(spec["eval_bank"]), num_query_per_class=vq.NUM_QUERY_PER_CLASS,
                        max_labels=vq.MAX_CLASSES_PER_PROMPT)
    freq = {int(k): v for k, v in json.loads(spec["eval_freq"]).items()}
    ev = DetectionEvaluator(style="lvis_fixed", max_dets=300, category_frequency=freq)
    random.seed(0)  # the plan's query draws, as the one-process run's
    results = run_inference(cfg, model, CocoDetectionDataset(*spec["eval_data"]), WordPieceTokenizer(), sel,
                            evaluator=ev, verbose=False)
    return {"results": {k: v for k, v in results.items() if k != "seconds"}, "state": ev.state_dict()}


def _case_bank(spec, rank):
    """(h) allgather_merge of seeded per-rank stores under a binding
    capacity; then `extract_bank` over the tiny model, sharded by rank."""
    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.tools.train import extract_bank

    bank = QueryBank(channels=8, num_scales=2)
    for label, n in spec["bank_stores"][rank]:
        bank.add(label, np.random.default_rng([rank, label]).standard_normal((n, 2, 8)).astype(np.float32))
    store = dict(bank._store)
    bank.allgather_merge(capacity=spec["bank_capacity"])
    merged = dict(bank._store)

    cfg, model = load_model(spec["eval_cfg"], spec["eval_model"])
    cfg.VISION_QUERY.QUERY_BANK_SAVE_PATH = os.path.join(spec["dir"], "extracted.npz")
    cfg.VISION_QUERY.MAX_QUERY_NUMBER = spec["extract_capacity"]
    saves, own = [], {}
    real_save, real_merge = QueryBank.save, QueryBank.allgather_merge
    QueryBank.save = lambda self, path: (saves.append(path), real_save(self, path))[1]
    QueryBank.allgather_merge = lambda self, capacity=None: (own.update(self._store), real_merge(self, capacity))[1]
    try:
        extracted, path = extract_bank(cfg, model, CocoDetectionDataset(*spec["eval_data"]), "cpu",
                                       log=lambda m: None)
    finally:
        QueryBank.save, QueryBank.allgather_merge = real_save, real_merge
    return {"store": store, "merged": merged, "extract_store": own, "extracted": dict(extracted._store),
            "saves": saves, "path": path}


def _case_four(spec, rank):
    """(j) one GLIP step under MLM_LOSS, text dropout 0.5, on the rank's
    image of a global batch of 4 (the 4-rank spawn): its gradients."""
    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine import train as tt

    cfg, model = load_model(spec["four_cfg"], spec["four_model"])
    batch = rows(dict(np.load(spec["four_batch"])), rank)
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    grads = {}
    _, metrics = tt.make_train_step(model, tx, cfg)(state, tt.batch_to_device(batch, "cpu"),
                                                    tt.step_generator(cfg.SOLVER.SEED, 0, "cpu"), grads_out=grads)
    return {"grads": grads, "metrics": {k: float(v) for k, v in metrics.items()}}


CASES = {"glip": _case_glip, "gate": _case_gate, "nan": _case_nan, "batch": _case_batch, "gdino": _case_gdino,
         "inference": _case_inference, "bank": _case_bank, "uneven": _case_uneven, "resume": _case_resume,
         "four": _case_four}
FOUR = 4  # the ranks of the "four" spawn


def worker(spec_path: str) -> int:
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    from mqdet_torch.parallel import comm

    comm.init_distributed("cpu", "gloo", timeout_s=GLOO_TIMEOUT_S)
    rank = comm.get_rank()
    out = {"world": comm.get_world_size(), "rank": rank, "seconds": {}}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        out[case] = CASES[case](spec, rank)
        out["seconds"][case] = time.perf_counter() - t0
        comm.synchronize()
    torch.save(out, os.path.join(spec["dir"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1]))


# ------------------------------------------------------------ the tests (parent)

import re  # noqa: E402

import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mqdet_tpu.core.config import trainable_patterns as jax_trainable_patterns  # noqa: E402
from mqdet_tpu.engine import losses as jl  # noqa: E402
from mqdet_tpu.engine import train as jtrain  # noqa: E402
from mqdet_tpu.parallel.mesh import make_mesh  # noqa: E402
from mqdet_torch.core.config import trainable_patterns  # noqa: E402
from mqdet_torch.engine import train as tt  # noqa: E402
from mqdet_torch.parallel import comm  # noqa: E402
from mqdet_torch.utils import builders as tb  # noqa: E402
from test_torch_port_eval import (  # noqa: E402
    CATEGORIES, assert_same_ap, assert_same_detections, eval_settings, recording, seeded_banks, selectors,
)
from test_torch_port_gdino_train import _jax_gdino_loss_fn  # noqa: E402
from test_torch_port_gdino_train import gpair  # noqa: E402,F401  (a module fixture)
from test_torch_port_modules import tiny_pair  # noqa: E402
from test_torch_port_querybank import write_coco  # noqa: E402
from test_torch_port_train import _anchors, _banks, _gt, _train_cfg, jax_leaf, to_flax  # noqa: E402
from test_torch_port_train import _train_mods as _glip_mods  # noqa: E402

torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _glip_mods_dropout(cfg):
    """The training mods, text dropout 0.5 and 32 channels in the head: a
    rank's batch of one image then has two values a DyConv GroupNorm group
    at the 1x1 levels (torch refuses one)."""
    _glip_mods(cfg)
    cfg.VISION_QUERY.TEXT_DROPOUT = TEXT_DROPOUT
    cfg.MODEL.BACKBONE.OUT_CHANNELS = cfg.MODEL.DYHEAD.CHANNELS = 32


@pytest.fixture(scope="module")
def glip_pair():
    """JAX and port tiny GLIP with the same weights (the `vision_query`
    recipe, EMA, warmup 3, text dropout 0.5) and a global batch of 2 with 3
    boxes an image."""
    from test_torch_port_modules import jax_init_args

    jmodel, params, tmodel, jcfg, tcfg = tiny_pair(_glip_mods_dropout)
    b, _ = jax_init_args(jcfg, batch=2, num_labels=3, k_shot=2, seed=3)
    gt = _gt(8, g=4, n_valid=(3, 3))
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=gt[0], gt_labels=gt[1], gt_valid=gt[2], gt_token_map=gt[3],
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 3), np.int32))
    return dict(jmodel=jmodel, params=params, tmodel=no_dropout(tmodel), jcfg=jcfg, tcfg=tcfg, batch=batch)


@pytest.fixture(scope="module")
def eval_pair():
    def mods(cfg):
        eval_settings(cfg, "glip")

    return tiny_pair(mods)


@pytest.fixture(scope="module")
def gdino_one(gpair):
    """The port's one-process GDINO step on the global batch: (model, state,
    metrics, assignment)."""
    model = copy.deepcopy(gpair["tmodel"])
    state, tx = tt.init_train_state(model, gpair["tcfg"], trainable_patterns(gpair["tcfg"]))
    step = tt.make_gdino_train_step(model, tx, gpair["tcfg"])
    state, metrics = step(state, tt.batch_to_device(gpair["batch"], "cpu"), torch.Generator().manual_seed(0))
    return model, state, metrics, step.assignment


BANK_STORES = [[(3, 4), (5, 2), (9, 1)], [(3, 3), (7, 2), (9, 4)]]  # (label, rows) per rank
BANK_CAPACITY = 5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, glip_pair, gdino_one, gpair, eval_pair):
    """Start the two workers over every case; returns `wait`: wait() ->
    [rank 0's results, rank 1's], raising with a rank's output where one
    failed; wait.spec the workers' spec."""
    root = tmp_path_factory.mktemp("ranks")
    spec = {"dir": str(root), "cases": [c for c in CASES if c != "four"], "bank_stores": BANK_STORES,
            "bank_capacity": BANK_CAPACITY, "extract_capacity": 2}

    def save_cfg(name, cfg):
        path = root / f"{name}.yml"
        path.write_text(cfg.dump_yaml())
        spec[f"{name}_cfg"] = str(path)

    def save_model(name, model):
        torch.save(model.state_dict(), root / f"{name}.pt")
        spec[f"{name}_model"] = str(root / f"{name}.pt")

    save_cfg("glip", glip_pair["tcfg"])
    save_model("glip", glip_pair["tmodel"])
    np.savez(root / "glip_batch.npz", **glip_pair["batch"])
    spec["glip_batch"] = str(root / "glip_batch.npz")

    save_cfg("gdino", gpair["tcfg"])
    save_model("gdino", gpair["tmodel"])
    np.savez(root / "gdino_batch.npz", **gpair["batch"])
    np.save(root / "gdino_assignment.npy", gdino_one[3])
    spec["gdino_batch"], spec["gdino_assignment"] = str(root / "gdino_batch.npz"), str(root / "gdino_assignment.npy")

    *_, tmodel, _, tcfg = eval_pair
    save_cfg("eval", tcfg)
    save_model("eval", tmodel)
    ann, img_dir = write_coco(root, [(60, 80)] * 3 + [(80, 60)], boxes_per_image=3, categories=CATEGORIES, seed=5)
    spec["eval_data"] = [str(ann), str(img_dir)]
    seeded_banks()[1].save(str(root / "eval_bank.npz"))
    spec["eval_bank"] = str(root / "eval_bank.npz")
    from mqdet_torch.data.coco import CocoDetectionDataset

    ds = CocoDetectionDataset(*spec["eval_data"])
    spec["eval_freq"] = json.dumps({ds.cat_id_to_contiguous[c["id"]]: c["frequency"] for c in ds.categories})

    coco_root = root / "coco"
    coco_root.mkdir()
    spec["coco"] = [str(p) for p in write_coco(coco_root, [(30, 40), (40, 30), (32, 32), (36, 44), (44, 36)],
                                               boxes_per_image=3)]
    train_cfg = _train_cfg(None)  # 2 images a rank (one would meet torch's GroupNorm refusal), 2 batches an epoch
    train_cfg.SOLVER.IMS_PER_BATCH, train_cfg.DATASETS.GENERAL_COPY = 4, 2
    save_cfg("train", train_cfg)
    _banks(CocoDetectionDataset(*spec["coco"]).ind_to_class, 16)[1].save(str(root / "train_bank.npz"))
    spec["train_bank"] = str(root / "train_bank.npz")
    mixed_root = root / "mixed"
    mixed_root.mkdir()
    # shards ids[rank::2] (no shuffle): rank 0 four landscape images, rank 1 a portrait one and three landscape
    spec["mixed"] = [str(p) for p in write_coco(mixed_root, [(30, 40), (40, 30)] + [(30, 40)] * 6,
                                                boxes_per_image=2, seed=4)]
    mixed = _train_cfg(None)
    mixed.TPU.IMAGE_BUCKETS = ((48, 64),)
    mixed.SOLVER.IMS_PER_BATCH = 4
    mixed.DATASETS.DISABLE_SHUFFLE = True
    save_cfg("mixed", mixed)

    wait = _spawn(root, spec, WORLD)
    yield wait
    wait.kill()


def _spawn(root, spec, world):
    """Start `world` workers of this file on `spec`; returns wait() -> each
    rank's results, raising with a rank's output where one failed (each
    within RANK_TIMEOUT_S); wait.spec the spec, wait.kill() ends them."""
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               LOCAL_RANK="0", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(spec_path)], env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    started = time.monotonic()
    done = {}

    def wait():
        if "out" not in done:
            try:
                while any(p.poll() is None for p in procs):
                    if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() - started > RANK_TIMEOUT_S:
                        break
                    time.sleep(0.2)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            logs = [p.communicate()[0] for p in procs]
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    raise AssertionError(f"rank {r} exited {p.returncode}:\n{logs[r][-6000:]}")
            done["out"] = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]
        return done["out"]

    def kill():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    wait.spec, wait.kill = spec, kill
    return wait


def _four_mods(cfg):
    """The 4-rank case: phase 13's recipe shape at the tiny config (the
    `vision_query` GCP set, 32 head channels so one image a rank meets no
    GroupNorm refusal, text dropout 0.5) with MLM_LOSS on, so the MLM
    normaliser is summed over the ranks too."""
    _glip_mods_dropout(cfg)
    cfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS = True


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The tiny GLIP from `init_params(seed 0)` (every gate non-zero), a
    global batch of 4 with 3 boxes an image, and 4 workers started on it:
    (cfg, model, batch, wait)."""
    root = tmp_path_factory.mktemp("four")
    cfg = tb.tiny_test_config()
    _four_mods(cfg)
    model = no_dropout(tb.init_params(tb.build_model(cfg), seed=0).eval())
    b = tb.synthetic_batch(cfg, FOUR, (64, 64), num_labels=3, k_shot=2, seed=4)
    gt = _gt(9, b=FOUR, g=4, n_valid=(3, 2))
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=gt[0], gt_labels=gt[1], gt_valid=gt[2], gt_token_map=gt[3],
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((FOUR, 3), np.int32))
    (root / "four.yml").write_text(cfg.dump_yaml())
    torch.save(model.state_dict(), root / "four.pt")
    np.savez(root / "four_batch.npz", **batch)
    spec = {"dir": str(root), "cases": ["four"], "four_cfg": str(root / "four.yml"),
            "four_model": str(root / "four.pt"), "four_batch": str(root / "four_batch.npz")}
    wait = _spawn(root, spec, FOUR)
    yield cfg, model, batch, wait
    wait.kill()


def _uniforms(cfg, it, b=2, labels=3):
    """The (B, L) text-dropout uniforms the step of iteration `it` draws
    first from its generator, for the global batch."""
    return torch.rand((b, labels), generator=tt.step_generator(cfg.SOLVER.SEED, it, "cpu")).numpy()


def _assert_masters(got, want_of, err_msg=""):
    """Each master within 1e-5 of its largest value of `want_of(name)`."""
    for n, t in got.items():
        want = want_of(n)
        np.testing.assert_allclose(t.numpy() if hasattr(t, "numpy") else t, want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"{err_msg} {n}")


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def test_glip_step_on_four_ranks_matches_one_process_at_batch_four(four_ranks):
    """(j) ROADMAP Queue C 3's question on the CPU, noise or fault: 4 gloo
    ranks of 1 image against one process at batch 4, in fp32, one GLIP step
    under MLM_LOSS and text dropout (the draws the global batch's): every
    gradient the optimizer takes (summed over the ranks) within 1e-5
    relative L2 of the one process's, the summed losses within rtol 1e-5,
    the ranks' gradients bitwise equal. Prints the GCP attention gates'
    norm biases (`qv_layer.*.attn_gate.norm.bias`), the tensor the card's
    `--cards 4` run flagged."""
    cfg, model, batch, wait = four_ranks
    model = copy.deepcopy(model)
    state, tx = tt.init_train_state(model, cfg, trainable_patterns(cfg))
    want = {}
    _, metrics = tt.make_train_step(model, tx, cfg)(state, tt.batch_to_device(batch, "cpu"),
                                                    tt.step_generator(cfg.SOLVER.SEED, 0, "cpu"), grads_out=want)
    out = [o["four"] for o in wait()]
    assert "loss_mlm" in out[0]["metrics"] and all(o["metrics"] == out[0]["metrics"] for o in out)
    for k, v in metrics.items():
        assert abs(out[0]["metrics"][k] - float(v)) <= 1e-5 * max(abs(float(v)), 1e-30), k
    dist = {n: float(torch.linalg.vector_norm(out[0]["grads"][n] - g) / torch.linalg.vector_norm(g).clamp(min=1e-30))
            for n, g in want.items()}
    for n, d in sorted(dist.items()):
        if re.fullmatch(r".*qv_layer\.\d+\.attn_gate\.norm\.bias", n):
            print(f"{n}: relative L2 {d!r} (one process's norm {float(torch.linalg.vector_norm(want[n]))!r})")
    assert len(dist) > 10 and any(".attn_gate.norm.bias" in n for n in dist)
    bad = {n: d for n, d in dist.items() if not d <= 1e-5}
    assert not bad, bad
    for o in out[1:]:
        assert all(torch.equal(o["grads"][n], out[0]["grads"][n]) for n in want)


def test_glip_step_on_two_ranks_matches_jax_on_a_two_device_mesh(ranks, glip_pair):
    """(a) 2 GLIP steps, 1 image a rank, against JAX's `_finish_train_step`
    on the global batch of 2 sharded over a 2-device `data` mesh (its loss
    deterministic, with the port's text-dropout uniforms) and against the
    port's one-process step on the global batch: the summed losses within
    rtol 1e-4, the masters and EMA within 1e-5 of their largest value after
    each step, the gradients the optimizer took (summed over the ranks)
    each within 2e-4 of the one-process gradient's largest value, the two
    ranks' masters bitwise equal."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    gp = glip_pair
    jcfg, tcfg = gp["jcfg"], gp["tcfg"]
    anchors, level_sizes = _anchors()
    state, tx, merge = jtrain.init_train_state(gp["params"], jcfg, jax_trainable_patterns(jcfg))

    def loss_fn(trainable, frozen, batch, rng):
        p = merge(trainable, jax.lax.stop_gradient(frozen))
        drop = (batch["u"] < TEXT_DROPOUT) & (batch["has_query"] > 0)  # apply_text_dropout's draw, given
        masked = jnp.einsum("bl,blt->bt", drop.astype(jnp.float32), batch["pos_category_map"])
        ids = jnp.where(masked > 0, jtrain.MASK_TOKEN_ID, batch["input_ids"])
        out = gp["jmodel"].apply(p, batch["images"], ids, batch["attention_mask"], batch["queries"],
                                 batch["query_mask"], deterministic=True)
        losses = jl.glip_losses(out, jnp.asarray(anchors), level_sizes, batch["gt_boxes"], batch["gt_labels"],
                                batch["gt_valid"], batch["gt_token_map"], batch["attention_mask"])
        losses["loss_gate"] = jl.gate_loss_from_params(trainable)
        total = sum(losses.values())
        return jnp.where(jnp.isfinite(total), total, 0.0), losses

    mesh = make_mesh((WORLD,), ("data",), jax.devices()[:WORLD])
    data_s, rep_s = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    keys = list(gp["batch"]) + ["u"]
    jstep = jax.jit(jtrain._finish_train_step(loss_fn, tx, jcfg.SOLVER.MODEL_EMA),
                    in_shardings=(rep_s, {k: data_s for k in keys}, rep_s), out_shardings=(rep_s, rep_s))
    jstate = jax.device_put(state, rep_s)
    model = copy.deepcopy(gp["tmodel"])
    one, ttx = tt.init_train_state(model, tcfg, trainable_patterns(tcfg))
    one_step = tt.make_train_step(model, ttx, tcfg)
    out = ranks()
    for it in range(2):
        jbatch = {k: jax.device_put(jnp.asarray(v), data_s) for k, v in
                  dict(gp["batch"], u=_uniforms(tcfg, it)).items()}
        jstate, jmetrics = jstep(jstate, jbatch, jax.device_put(jax.random.PRNGKey(0), rep_s))
        one_grads = {}
        one, metrics = one_step(one, tt.batch_to_device(gp["batch"], "cpu"),
                                tt.step_generator(tcfg.SOLVER.SEED, it, "cpu"), grads_out=one_grads)
        got = [o["glip"] for o in out]
        assert got[0]["metrics"][it] == got[1]["metrics"][it]
        for k, v in jmetrics.items():
            assert rel_err(v, got[0]["metrics"][it][k]) < 1e-4, (it, k)
            assert rel_err(metrics[k], got[0]["metrics"][it][k]) < 1e-4, (it, k)
        for n, t in got[0]["masters"][it].items():
            assert torch.equal(t, got[1]["masters"][it][n]), (it, n)
        flax = {n: to_flax(n, t) for n, t in got[0]["masters"][it].items()}
        _assert_masters(flax, lambda n: jax_leaf(jstate.trainable, n), f"step {it} vs JAX")
        _assert_masters({n: to_flax(n, t) for n, t in got[0]["ema"][it].items()},
                        lambda n: jax_leaf(jstate.ema, n), f"step {it} EMA vs JAX")
        _assert_masters(got[0]["masters"][it], lambda n: one.trainable[n].numpy(), f"step {it} vs one process")
        for n, g in one_grads.items():
            assert rel_err(g, got[0]["grads"][it][n]) < 2e-4 and torch.equal(got[1]["grads"][it][n],
                                                                             got[0]["grads"][it][n]), (it, n)
    # the text dropout bit: the uniforms mask some, not all, of the 6 (image, label) slots
    u = np.concatenate([_uniforms(tcfg, it) for it in range(2)])
    assert 0 < (u < TEXT_DROPOUT).sum() < u.size


def test_gdino_step_on_two_ranks_matches_jax_on_a_two_device_mesh(ranks, gpair, gdino_one):
    """(b) one GDINO step, 1 image a rank on the one-process assignment's
    rows, num_boxes the global count: against JAX's `make_gdino_train_step`
    on the global batch over a 2-device mesh and the port's one-process
    step; losses within rtol 1e-4, masters and EMA within 1e-5 of their
    largest value, the two ranks bitwise equal."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from test_torch_port_gdino_train import _flax_paths, rule_table

    gp = gpair
    mp = pytest.MonkeyPatch()
    try:
        _, jstep = _jax_gdino_loss_fn(gp["jmodel"], gp["merge"], gp["tx"], gp["jcfg"], mp)
    finally:
        mp.undo()
    mesh = make_mesh((WORLD,), ("data",), jax.devices()[:WORLD])
    data_s, rep_s = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    jstep = jax.jit(jstep, in_shardings=(rep_s, {k: data_s for k in gp["batch"]}, rep_s),
                    out_shardings=(rep_s, rep_s))
    jstate, jmetrics = jstep(jax.device_put(gp["state"], rep_s),
                             {k: jax.device_put(v, data_s) for k, v in gp["jbatch"].items()},
                             jax.device_put(jax.random.PRNGKey(0), rep_s))
    model, one, metrics, _ = gdino_one
    got = [o["gdino"] for o in ranks()]
    assert got[0]["metrics"] == got[1]["metrics"]
    assert rel_err(jmetrics["loss_total"], got[0]["metrics"]["loss_total"]) < 1e-4
    for k, v in metrics.items():
        assert rel_err(v, got[0]["metrics"][k]) < 1e-4, k
    paths = _flax_paths(model)
    for n, t in got[0]["masters"].items():
        assert torch.equal(t, got[1]["masters"][n]), n
        (path,) = paths[n]
        tf = rule_table(model)[path[len("params/"):]][1]
        want = np.asarray(jstate.trainable[path])
        np.testing.assert_allclose(tf(t.numpy()), want, atol=1e-5 * np.abs(want).max(), err_msg=n)
        np.testing.assert_allclose(tf(got[0]["ema"][n].numpy()), np.asarray(jstate.ema[path]),
                                   atol=1e-5 * np.abs(want).max(), err_msg=n)
        np.testing.assert_allclose(t.numpy(), one.trainable[n].numpy(),
                                   atol=1e-5 * np.abs(one.trainable[n].numpy()).max(), err_msg=n)


def test_gate_loss_counts_once_over_two_ranks(ranks, glip_pair):
    """(c) a step whose loss is the regularised gate loss alone: the two
    ranks' summed step equals the one-process step bitwise (each rank takes
    half of the same gate loss), loss_gate the one-process value."""
    tcfg = copy.deepcopy(glip_pair["tcfg"])
    tcfg.VISION_QUERY.GATE_REGULARIZATION = True
    model = copy.deepcopy(glip_pair["tmodel"])
    state, tx = tt.init_train_state(model, tcfg, trainable_patterns(tcfg))
    gate = tt._gate_loss(model, tx, tcfg, torch.device("cpu"))
    step = tt._finish_train_step(model, tx, lambda batch, g, times, t0: ({"loss_gate": gate()}, t0), 0.0,
                                 torch.device("cpu"))
    state, metrics = step(state, {}, torch.Generator())
    got = [o["gate"] for o in ranks()]
    assert got[0]["metrics"]["loss_gate"] == got[1]["metrics"]["loss_gate"] == float(metrics["loss_gate"]) > 0
    moved = 0
    for n, t in state.trainable.items():
        assert torch.equal(got[0]["masters"][n], t) and torch.equal(got[1]["masters"][n], t), n
        moved += not torch.equal(t, dict(glip_pair["tmodel"].named_parameters())[n].detach())
    assert moved > 0  # the gates moved


def test_nonfinite_loss_on_one_rank_zeroes_the_step_on_both(ranks):
    """(d) a NaN query on rank 1 alone: on both ranks the logged loss is 0,
    Adam's moments stay 0 and (weight decay 0) the masters are unchanged."""
    for o in ranks():
        got = o["nan"]
        assert got["loss_total"] == 0.0 and got["mu_max"] == 0.0
        for n, t in got["masters"].items():
            assert torch.equal(t, got["before"][n]), n


def test_a_batch_that_does_not_divide_over_the_ranks_raises(ranks):
    """(e) SOLVER.IMS_PER_BATCH 3 on 2 ranks: the loader refuses it."""
    for o in ranks():
        assert o["batch"]["error"] and "does not divide over 2" in o["batch"]["error"]


def test_uneven_loaders_finish_together(ranks):
    """(f) rank 0's shard fills two batches an epoch, rank 1's one (a
    portrait image apart): both ranks reach iteration 4 without a hang, start
    each epoch together (every exhausted fetch seen on both) and hold the
    same masters bitwise; only rank 0 writes checkpoints."""
    got = [o["uneven"] for o in ranks()]
    assert got[0]["step"] == got[1]["step"] == 4
    assert got[0]["exhausted"] == 0 < got[1]["exhausted"]  # only rank 1's loader ran out
    for n, t in got[0]["masters"].items():
        assert torch.equal(t, got[1]["masters"][n]), n
    assert got[0]["writes"] and not got[1]["writes"]


def test_run_inference_on_two_ranks_matches_one_process_and_jax(ranks, eval_pair):
    """(g) run_inference over 4 images, 2 a rank, the evaluators merged:
    every rank's AP dict equal to the one-process port's and within 1e-6 of
    JAX's `run_inference`; the merged detections the one-process port's,
    bitwise, and within JAX's tolerances of JAX's."""
    from mqdet_tpu.data import coco as jcoco
    from mqdet_tpu.data import tokenizer as jtok
    from mqdet_tpu.engine import evaluator as jev
    from mqdet_tpu.engine import inference as jinf
    from mqdet_torch.data import coco as tcoco
    from mqdet_torch.data import tokenizer as ttok
    from mqdet_torch.engine import evaluator as tev
    from mqdet_torch.engine import inference as tinf

    jmodel, params, tmodel, jcfg, tcfg = eval_pair
    ann, img_dir = ranks.spec["eval_data"]
    freq = {int(k): v for k, v in json.loads(ranks.spec["eval_freq"]).items()}
    sels = selectors(tcfg, seeded_banks())
    evs = [recording(m.DetectionEvaluator)(style="lvis_fixed", max_dets=300, category_frequency=freq)
           for m in (jev, tev)]
    random.seed(0)
    want = jinf.run_inference(jcfg, jmodel, params, jcoco.CocoDetectionDataset(ann, img_dir),
                              jtok.WordPieceTokenizer(), sels[0], evaluator=evs[0], verbose=False)
    random.seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the workers' count: the CPU kernels then sum in the workers' order
    try:
        one = tinf.run_inference(tcfg, tmodel, tcoco.CocoDetectionDataset(ann, img_dir), ttok.WordPieceTokenizer(),
                                 sels[1], evaluator=evs[1], verbose=False)
    finally:
        torch.set_num_threads(threads)
    assert_same_detections(evs[0], evs[1], 1)
    assert_same_ap(want, one)
    for o in ranks():
        got = o["inference"]
        assert {k: v for k, v in got["results"].items() if k != "images_per_second"} == \
            {k: v for k, v in one.items() if k not in ("images_per_second", "seconds")}
        assert_same_ap(want, dict(got["results"], seconds=one["seconds"]))
        state, ref = got["state"], evs[1].state_dict()
        assert state["images"] == ref["images"] and len(state["images"]) == 4
        assert state["categories"] == ref["categories"]
        for key in ("gts", "gt_ignore", "cat_pos_images", "cat_neg_images", "cat_nel_images"):
            assert {k: np.asarray(v).tolist() if key in ("gts",) else v for k, v in state[key].items()} == \
                {k: np.asarray(v).tolist() if key in ("gts",) else v for k, v in ref[key].items()}, key
        assert state["dets"].keys() == ref["dets"].keys()
        for cat, recs in ref["dets"].items():
            def key(r):
                return (r[1], -r[0], tuple(np.asarray(r[2]).tolist()))
            assert sorted(map(key, state["dets"][cat])) == sorted(map(key, recs)), cat


def _jax_allgather_merge(stores, rank, capacity, channels, num_scales):
    """JAX's `QueryBank.allgather_merge` on `rank` of len(stores) processes
    whose stores are `stores`: its own code, with the process count, index
    and all-gather given."""
    from mqdet_tpu.mq.bank import QueryBank as JBank
    from mqdet_tpu.parallel import comm as jcomm

    bank = JBank(channels=channels, num_scales=num_scales)
    bank._store = {k: v.copy() for k, v in stores[rank].items()}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax, "process_count", lambda: len(stores))
        mp.setattr(jax, "process_index", lambda: rank)
        mp.setattr(jcomm, "all_gather", lambda data: [dict(s) for s in stores])
        bank.allgather_merge(capacity=capacity)
    finally:
        mp.undo()
    return bank._store


def _same_store(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_allgather_merge_matches_jax_and_rank_0_saves_the_extracted_bank(ranks):
    """(h) each rank's seeded store merged over the ranks under a binding
    capacity (5: label 3 holds 4 + 3 rows, label 9 1 + 4) equals JAX's
    `allgather_merge` on the same stores, on each rank; then `extract_bank`
    over the 4 images, 2 a rank, at MAX_QUERY_NUMBER 2: the file rank 0
    saved (and no other rank) holds JAX's merge of the ranks' stores."""
    from mqdet_torch.mq.bank import QueryBank

    out = ranks()
    got = [o["bank"] for o in out]
    stores = [g["store"] for g in got]
    assert {k: len(v) for k, v in stores[0].items()} == {3: 4, 5: 2, 9: 1}
    for r, g in enumerate(got):
        _same_store(g["merged"], _jax_allgather_merge(stores, r, BANK_CAPACITY, 8, 2))
        assert len(g["merged"][3]) == BANK_CAPACITY
    assert got[0]["saves"] == [got[0]["path"]] and got[1]["saves"] == []
    own = [g["extract_store"] for g in got]
    assert all(own)
    saved = QueryBank.load(got[0]["path"])
    want = _jax_allgather_merge(own, 0, ranks.spec["extract_capacity"], saved.channels, saved.num_scales)
    _same_store(saved._store, want)
    _same_store(got[0]["extracted"], want)


def test_two_rank_run_resumed_at_step_1_replays_the_uninterrupted_one(ranks):
    """(i) `train` on 2 ranks: 4 iterations straight against 1, then resumed
    to 4 from rank 0's checkpoint: the masters, the EMA and Adam's second
    moments bitwise equal on both ranks; rank 0 wrote every checkpoint, rank
    1 none."""
    for o in ranks():
        got = o["resume"]
        full, resumed = got["full"], got["resumed"]
        assert full["step"] == resumed["step"] == 4 and got["first"]["step"] == 1
        for n, t in full["masters"].items():
            assert torch.equal(t, resumed["masters"][n]), n
            assert torch.equal(full["ema"][n], resumed["ema"][n]), n
            assert torch.equal(full["nu"][n], resumed["nu"][n]), n
        writes = [got[k]["writes"] for k in ("full", "first", "resumed")]
        assert all(writes) if o["rank"] == 0 else not any(writes)


def test_comm_in_one_process_is_the_identity():
    """(j) without a process group every function of `comm` is the identity
    and calls no collective."""
    assert not torch.distributed.is_initialized()
    assert comm.get_world_size() == 1 and comm.get_rank() == 0 and comm.is_main_process()
    comm.synchronize()
    data = {"a": np.arange(3)}
    assert comm.all_gather(data)[0] is data and len(comm.all_gather(data)) == 1
    assert comm.broadcast_object(data) is data
    t = torch.arange(4.0)
    assert comm.all_reduce_sum(t) is t and torch.equal(t, torch.arange(4.0))
    d = {"loss": torch.tensor(1.5)}
    assert comm.reduce_dict(d) is d
    assert not comm.launched_by_torchrun() or os.environ.get("WORLD_SIZE")


@pytest.mark.parametrize("style", ["coco", "lvis_fixed"])
def test_evaluator_state_merge_matches_jax(style):
    """The copy of `state_dict` / `merge_state`: 12 seeded images scored in
    three strided shards (one image in two shards, as a padded shard holds
    it), each shard's state merged into the first in both packages: the
    merged states equal, the summaries within 1e-9 of each other and of the
    unsharded evaluation."""
    from mqdet_tpu.engine import evaluator as jev
    from mqdet_torch.engine import evaluator as tev

    rng = np.random.default_rng(11)
    images = []
    for img in range(12):
        ng, nd = int(rng.integers(1, 4)), int(rng.integers(0, 8))
        xy = rng.uniform(0, 80, (ng, 2))
        gt = np.concatenate([xy, xy + rng.uniform(8, 30, (ng, 2))], 1).astype(np.float32)
        dxy = rng.uniform(0, 80, (nd, 2))
        det = np.concatenate([dxy, dxy + rng.uniform(8, 30, (nd, 2))], 1).astype(np.float32)
        if nd:
            det[0] = gt[0] + 1.0
        images.append((img, gt, rng.integers(1, 5, ng), det, rng.uniform(0.1, 1, nd).astype(np.float32),
                       rng.integers(1, 5, nd), [int(rng.integers(1, 5))]))
    shards = [images[0::3], images[1::3] + [images[0]], images[2::3]]

    def run(mod, parts):
        evs = [mod.DetectionEvaluator(style=style, category_frequency={c: "rcf"[c % 3] for c in range(1, 5)})
               for _ in parts]
        for ev, part in zip(evs, parts):
            ev.register_categories(range(1, 5))
            for img, gt, gl, det, ds, dl, neg in part:
                ev.add_image(img, gt, gl, det, ds, dl, neg_category_ids=neg)
        for ev in evs[1:]:
            evs[0].merge_state(ev.state_dict())
        return evs[0]

    jmerged, tmerged, whole = run(jev, shards), run(tev, shards), run(tev, [images])
    js, ts = jmerged.state_dict(), tmerged.state_dict()
    assert js.keys() == ts.keys() and js["images"] == ts["images"] == set(range(12))
    for key in ("gt_ignore", "cat_pos_images", "cat_neg_images", "cat_nel_images"):
        assert js[key] == ts[key], key
    assert all(len(ts["dets"][c]) == len(js["dets"][c]) for c in js["dets"])
    want, got, ref = jmerged.summarize(), tmerged.summarize(), whole.summarize()
    for key in ("AP", "AP50", "AP75"):
        assert abs(got[key] - want[key]) <= 1e-9 and abs(got[key] - ref[key]) <= 1e-9, key


def test_perf_train_dp_runs_over_two_gloo_ranks(tmp_path):
    """`mqdet_torch.tools.perf_train_dp` as torchrun starts it, 2 ranks over
    gloo on the CPU at the tiny config, through the extraction and
    `do_train`: rank 0 prints one JSON line of the world, its backend, both
    ranks' iteration ms, the all-reduce in the split and the masters bitwise
    equal across the ranks."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               LOCAL_RANK="0", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "mqdet_torch.tools.perf_train_dp", "--tiny", "--device", "cpu"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    (line,) = [x for x in outs[0].splitlines() if x.startswith("{")]
    rec = json.loads(line)
    assert rec["world"] == 2 and rec["backend"] == "gloo" and rec["global_batch"] == 4
    assert rec["steps"] == 8 and len(rec["ms_per_step"]) == 2 and all(a is not None and a > 0 for a in rec["allreduce_ms"])
    assert np.isfinite(rec["loss"]) and rec["masters_equal_across_ranks"] is True
    assert not [x for x in outs[1].splitlines() if x.startswith("{")]
