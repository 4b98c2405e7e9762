"""The few-shot finetuning CLIs of the port against the JAX package's, on
the CPU in fp32 at `tiny_l_config`: `mqdet_torch.tools.finetune` against
`tools/finetune.py` and `mqdet_torch.tools.eval_odinw` against
`tools/eval_odinw.py`.

The data: an ODinW-shaped task, 2 categories renamed through
OVERRIDE_CATEGORY, a train split of 5 landscape images (a batch of 2 fills
one bucket) and a 2-image val split (COCO
json, PNG images read with PIL on both sides); a base yaml (the dump of the
tiny L config with `test_torch_port_eval.py`'s evaluation settings and a
training resize into its bucket); a task yaml with an `odinw_13` task's
keys (REGISTER train / val, OVERRIDE_CATEGORY, NUM_CLASSES,
TEST_WITH_INFERENCE, USE_AUTOSTEP, AUTOTERMINATE_PATIENCE, GENERAL_COPY) and
`configs/vision_query_5shot/odinw.yaml`'s QUERY_BANK_PATH "" (the bank is
extracted); one reference-layout `.pth` that both CLIs import.

Against JAX, both CLIs run in process with their training loop and their
evaluation replaced by recorders (the training draws of the two packages
cannot be made equal: JAX's come from its keys, the port's from a torch
generator; the evaluation returns a fixed AP on both sides): the few-shot
train ids, the temporary bank (its classes exactly, its queries within
1e-4: fp32 rounding of the image tower), the trainable set, MAX_ITER, the
loader's steps per epoch and the printed AP lines, equal. The port alone
then runs the CLI for real: trained, evaluated, AP finite, and each
evaluation seeing the current fp32 masters. `eval_odinw`: the commands and
the count of return codes against JAX's, with the processes replaced by a
recorder.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from mqdet_torch.core import yaml_lite
from mqdet_torch.utils import builders as tb
from test_torch_port_eval import eval_settings
from test_torch_port_glip_l import jit_at_o0

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = [{"id": 1, "name": "raw_a"}, {"id": 2, "name": "raw_b"}]
OVERRIDE = [{"id": 1, "name": "fish", "supercategory": "creatures"},
            {"id": 2, "name": "shark", "supercategory": "creatures"}]


def base_config():
    """The tiny L config with the evaluation settings and a training resize
    into its bucket, fp32: the base yaml's tree."""
    cfg = tb.tiny_l_config()
    eval_settings(cfg, "glip")
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = 48, 64
    cfg.AUGMENT.MULT_MIN_SIZE_TRAIN = (40, 48)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def write_split(root, sizes, labels, seed):
    """A COCO json of PNG images of `sizes` with seeded pixels, image i
    holding one box of each category id in labels[i]. Returns (ann_file,
    img_dir)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir()
    images, anns = [], []
    for i, ((h, w), labs) in enumerate(zip(sizes, labels)):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"{i}.png", "height": h, "width": w})
        for lab in labs:
            x0, y0 = rng.uniform(0, w * 0.5), rng.uniform(0, h * 0.5)
            bw, bh = rng.uniform(8, w - x0), rng.uniform(8, h - y0)
            anns.append({"id": len(anns) + 1, "image_id": 10 + i, "category_id": lab, "bbox": [x0, y0, bw, bh],
                         "area": bw * bh, "iscrowd": 0})
    ann = root / "annotations_without_background.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns, "categories": RAW}))
    return str(ann), str(root)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """(base yaml, task yaml, .pth, {split: image ids}) on disk."""
    root = tmp_path_factory.mktemp("odinw")
    splits = {}
    for split, sizes, labels, seed in (
        ("train", [(60, 80), (56, 84), (60, 84), (60, 80), (64, 72)], [[1], [2], [1, 2], [2], [1]], 1),
        ("valid", [(60, 80), (80, 60)], [[1, 2], [2]], 2),
    ):
        ann, img_dir = write_split(root / split, sizes, labels, seed)
        splits[split] = {"ann_file": os.path.relpath(ann, root), "img_dir": os.path.relpath(img_dir, root)}
    base = base_config()
    base_yml = root / "base.yaml"
    base_yml.write_text(base.dump_yaml())
    tree = {
        "DATASETS": {
            "GENERAL_COPY": 16, "OVERRIDE_CATEGORY": json.dumps(OVERRIDE), "USE_OVERRIDE_CATEGORY": True,
            "REGISTER": {"train": splits["train"], "val": splits["valid"]},
            "TRAIN": ["train"], "TEST": ["val"], "DATA_ROOT": str(root),
        },
        "MODEL": {"ATSS": {"NUM_CLASSES": 3}, "DYHEAD": {"NUM_CLASSES": 3}},
        "SOLVER": {"AUTOTERMINATE_PATIENCE": 8, "MAX_EPOCH": 12, "TEST_WITH_INFERENCE": True, "USE_AUTOSTEP": True},
        "VISION_QUERY": {"ENABLED": True, "NUM_QUERY_PER_CLASS": 2, "QUERY_BANK_PATH": "", "TEXT_DROPOUT": 0.0},
    }
    task_yml = root / "Fishes.yaml"
    task_yml.write_text(yaml_lite.dump(tree))
    from mqdet_torch.tools.finetune import task_config

    cfg = task_config(str(base_yml), str(task_yml), [], 1, 1, 1, 0)
    model = tb.init_params(tb.build_model(cfg), seed=4)
    g = torch.Generator().manual_seed(4)
    state = {f"module.{k}": v + 0.02 * torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}
    pth = root / "mq_glip_l_tiny.pth"
    torch.save({"model": state}, pth)
    return str(base_yml), str(task_yml), str(pth), root


def argv(task, shot_epoch_copy="1_1_1", seeds="3", flags=()):
    base_yml, task_yml, pth, root = task
    return ["--config-file", base_yml, "--ft-tasks", task_yml, "--custom_shot_and_epoch_and_general_copy",
            shot_epoch_copy, "--weight", pth, "--seeds", seeds, *flags, "OUTPUT_DIR", str(root / "out")]


def recorders(mp, seen, trainer_mod, inference_mod, extract_mod, extract_name="extract_queries_into_bank"):
    """Replace a package's do_train and run_inference (AP 0.125 from the
    loop, 0.25 from the final evaluation) and record the loop's inputs and
    each extracted bank."""
    real_extract = getattr(extract_mod, extract_name)

    def extract(*a, **kw):
        bank = real_extract(*a, **kw)
        seen.setdefault("banks", []).append(bank)
        return bank

    def do_train(cfg, step, state, loader, *a, **kw):
        seen.setdefault("runs", []).append(dict(max_iter=cfg.SOLVER.MAX_ITER, steps=loader.steps_per_epoch(),
                                                ids=list(loader.dataset.ids), trainable=state.trainable,
                                                eval_fn=kw.get("eval_fn")))
        return state, 0.125

    mp.setattr(trainer_mod, "do_train", do_train)
    mp.setattr(inference_mod, "run_inference", lambda *a, **kw: {"AP": 0.25})
    mp.setattr(extract_mod, extract_name, extract)


def run_jax_finetune(args, capsys):
    from mqdet_tpu.data import tokenizer as jtok
    from mqdet_tpu.engine import inference as jinf
    from mqdet_tpu.engine import trainer as jtrainer
    from mqdet_tpu.mq import extract as jext

    jft = importlib.import_module("tools.finetune")
    seen = {}
    with pytest.MonkeyPatch.context() as mp, jit_at_o0():
        recorders(mp, seen, jtrainer, jinf, jext)
        mp.setattr(jtok, "get_tokenizer", lambda *a, **kw: jtok.WordPieceTokenizer())
        mp.setattr(sys, "argv", ["tools/finetune.py", *args])
        capsys.readouterr()
        jft.main()
        seen["out"] = capsys.readouterr().out
    return seen


def run_port_finetune(args, capsys, stub=True):
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.tools import finetune as tft

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        if stub:
            recorders(mp, seen, tft, tft, tft)
        mp.setattr(tft, "get_tokenizer", lambda *a, **kw: WordPieceTokenizer())
        capsys.readouterr()
        seen["results"] = tft.main(args, device="cuda")
        seen["out"] = capsys.readouterr().out
    return seen


def test_finetune_cli_matches_the_jax_cli(task, capsys):
    from mqdet_torch.io.from_jax import reference_rules

    want = run_jax_finetune(argv(task), capsys)
    got = run_port_finetune(argv(task, flags=("--device", "cpu")), capsys)
    assert len(got["runs"]) == len(want["runs"]) == 1
    rules = reference_rules()
    for g, w in zip(got["runs"], want["runs"]):
        assert g["ids"] == w["ids"] and len(g["ids"]) == 2  # one shot of each class
        assert g["max_iter"] == w["max_iter"] == g["steps"] == w["steps"] == 1
        names = sorted(rules[n][0] for n in g["trainable"])
        jnames = sorted("/".join(str(getattr(k, "key", k)) for k in p).replace("params/", "", 1)
                        for p, _ in __import__("jax").tree_util.tree_leaves_with_path(w["trainable"]))
        assert names == jnames and any("tunable_linear" in n or "qv_layer" in n for n in names)
    assert len(got["banks"]) == len(want["banks"]) == 1
    for g, w in zip(got["banks"], want["banks"]):
        assert sorted(g.labels) == sorted(w.labels) == [1, 2]
        for lab in g.labels:
            np.testing.assert_allclose(g.get(lab), np.asarray(w.get(lab)), atol=1e-4)
    lines = lambda out: [l for l in out.splitlines() if l.startswith("[finetune]")]  # noqa: E731
    assert lines(got["out"]) == lines(want["out"]) and len(lines(got["out"])) == 2
    assert lines(got["out"])[-1] == "[finetune] average AP over 1 runs: 0.2500"


def test_finetune_cli_trains_and_evaluates_the_current_masters(task, capsys):
    """The port's CLI for real (shot 1, 1 epoch, copies 2): two steps, the
    evaluation during training and the final one both on the current fp32
    masters (moved from the imported weights), AP finite."""
    from mqdet_torch.tools import finetune as tft

    seen = {"evals": []}
    real_do_train, real_inference = tft.do_train, tft.run_inference

    def do_train(cfg, step, state, loader, device, **kw):
        seen["start"] = {n: t.clone() for n, t in state.trainable.items()}
        state, best = real_do_train(cfg, step, state, loader, device, **kw)
        seen["state"] = state
        return state, best

    def run_inference(cfg, model, *a, **kw):
        params = dict(model.named_parameters())
        seen["evals"].append({n: params[n].detach().clone() for n in seen["start"]})
        return real_inference(cfg, model, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tft, "do_train", do_train)
        mp.setattr(tft, "run_inference", run_inference)
        got = run_port_finetune(argv(task, "1_1_2", flags=("--device", "cpu")), capsys, stub=False)
    (key, ap), = got["results"].items()
    assert np.isfinite(ap) and f"AP={ap:.4f}" in got["out"]
    assert len(seen["evals"]) == 2  # the epoch's evaluation and the final one
    masters = seen["state"].trainable
    assert seen["state"].step == 2  # 2 few-shot images x 2 copies, batch 2, one epoch
    for snap in seen["evals"]:
        for n, t in masters.items():
            assert torch.equal(snap[n], t), n
    assert any(not torch.equal(masters[n], seen["start"][n]) for n in masters)


def test_finetune_refuses_groundingdino(task, tmp_path):
    from mqdet_torch.tools import finetune as tft

    base_yml, task_yml, _, _ = task
    cfg = tft.task_config(base_yml, task_yml, ["MODEL.META_ARCHITECTURE", "MQGroundingDINO",
                                               "GROUNDINGDINO.enabled", "True"], 1, 1, 1, 0)
    with pytest.raises(NotImplementedError, match="MQ-GLIP only"):
        tft.finetune_one(cfg, "cpu", None)


@pytest.mark.parametrize("setting", ["zero-shot", "3-shot"])
@pytest.mark.parametrize("rcs", [(0, 0, 0), (0, 2, 0)])
def test_eval_odinw_commands_and_count_match_jax(setting, rcs, tmp_path, capsys):
    """Three task yamls: the same per-task commands (the JAX tool's script
    path against the port's `-m` module, the rest equal), the same printed
    count and exit code for the given return codes."""
    from mqdet_torch.tools import eval_odinw as todinw

    tasks = tmp_path / "tasks"
    tasks.mkdir()
    for name in ("b.yaml", "a.yaml", "c.yaml"):
        (tasks / name).write_text("DATASETS:\n  FEW_SHOT: 1\n")
    args = ["--config-file", "base.yaml", "--tasks", str(tasks), "--setting", setting, "--weight", "w.pth",
            "TEST.IMS_PER_BATCH", "1"]

    def run(main, argv_setter):
        calls = []

        def call(cmd):
            calls.append(cmd)
            return rcs[len(calls) - 1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("subprocess.call", call)
            argv_setter(mp)
            capsys.readouterr()
            with pytest.raises(SystemExit) as exit_:
                main()
        return calls, exit_.value.code, capsys.readouterr().out.splitlines()[-1]

    jodinw = importlib.import_module("tools.eval_odinw")
    jcalls, jcode, jlast = run(jodinw.main, lambda mp: mp.setattr(sys, "argv", ["tools/eval_odinw.py", *args]))
    tcalls, tcode, tlast = run(lambda: todinw.main(args), lambda mp: None)
    assert (tcode, tlast) == (jcode, jlast) and tcode == (1 if any(rcs) else 0)
    tool = "finetune" if setting != "zero-shot" else "eval"
    assert len(tcalls) == len(jcalls) == 3
    for t, j in zip(tcalls, jcalls):
        assert j[1] == os.path.join(REPO, "tools", f"{tool}.py")
        assert t[1:3] == ["-m", f"mqdet_torch.tools.{tool}"]
        assert t[0] == j[0] and t[3:] == j[2:]
    assert [c[c.index("--task-config" if tool == "eval" else "--ft-tasks") + 1] for c in tcalls] == \
        [str(tasks / n) for n in ("a.yaml", "b.yaml", "c.yaml")]
    # the port's --device (JAX's tool has none) goes to every task's process, before the opts
    cmds = todinw.task_commands(todinw.parse_args(args[:-2] + ["--device", "cpu"] + args[-2:]))
    assert all(c[-4:] == ["--device", "cpu", "TEST.IMS_PER_BATCH", "1"] for c in cmds)
