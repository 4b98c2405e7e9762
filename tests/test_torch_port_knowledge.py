"""The port's GLIPKNOW knowledge prompts vs the JAX package: the copy of
`data/knowledge.py` under each GLIPKNOW.KNOWLEDGE_TYPE, GPT3_NUM and
WIKI_AND_GPT3, the port's yaml reader against PyYAML on knowledge files in
PyYAML's own dump styles (long sentences wrapped over several lines), and
the evaluation plan with GLIPKNOW.KNOWLEDGE_FILE against JAX's plan: the
same captions, token ids and positive maps. Everything here is host-side
and exact: the results must be equal.
"""
import random

import numpy as np
import pytest
import yaml

from mqdet_tpu.data import knowledge as jknow
from mqdet_tpu.data import tokenizer as jtok
from mqdet_tpu.engine import inference as jinf
from mqdet_tpu.utils import builders as jb
from mqdet_torch.core import yaml_lite
from mqdet_torch.data import knowledge as tknow
from mqdet_torch.data import tokenizer as ttok
from mqdet_torch.engine import inference as tinf
from mqdet_torch.utils import builders as tb

KNOW = {
    "cat": {"clean_name": "cat", "def_wiki": "a small domesticated carnivorous mammal with soft fur, a short "
            "snout, and retractable claws: it is widely kept as a pet.",
            "def_wn": "feline mammal usually having thick soft fur and no ability to roar",
            "gpt3": ["cats have whiskers and they are very good at climbing trees, walls and fences.",
                     "cats purr.", "it's a cat's life", "a cat sleeps for most of the day"]},
    "dog": {"clean_name": "dog", "def_wiki": "a domesticated canid.", "gpt3": []},
    "hot_dog": {"clean_name": "hot dog", "def_wn": "a frankfurter served hot on a bun", "gpt3": "not a list"},
    "crème_brûlée": {"clean_name": "crème brûlée",
                     "def_wiki": "a dessert of custard with a caramelised top " * 3},
    "bicycle": {"clean_name": "bicycle", "def_wiki": None, "gpt3": ["- two wheels", "#1 vehicle", "12", "yes"]},
    "ski pole": {},
}
NAMES = ["cat", "dog", "hot_dog", "crème_brûlée", "bicycle", "ski pole", "frisbee"]
SETTINGS = [  # (KNOWLEDGE_TYPE, GPT3_NUM, WIKI_AND_GPT3)
    ("def_wiki", 5, False), ("def_wn", 5, False), ("gpt3", 2, False), ("gpt3", 5, False), ("", 5, False),
    ("def_wiki", 1, True), ("def_wiki", 3, True),
]


def dumps():
    """The knowledge file in PyYAML's dump styles: block, unicode kept,
    narrow (more lines wrapped), insertion order."""
    return [yaml.safe_dump(KNOW), yaml.safe_dump(KNOW, allow_unicode=True, width=40),
            yaml.dump(KNOW, allow_unicode=True, sort_keys=False, width=30)]


@pytest.mark.parametrize("style", range(3))
def test_yaml_lite_reads_knowledge_files_as_pyyaml(style):
    text = dumps()[style]
    assert len(text.splitlines()) > 30  # long values wrapped over several lines
    assert yaml_lite.safe_load(text) == yaml.safe_load(text) == KNOW


def config(tmp_path, side, setting, style=0):
    path = tmp_path / f"know{style}.yaml"
    path.write_text(dumps()[style], encoding="utf-8")
    cfg = (jb if side == "jax" else tb).tiny_test_config()
    cfg.GLIPKNOW.KNOWLEDGE_FILE = str(path)
    cfg.GLIPKNOW.KNOWLEDGE_TYPE, cfg.GLIPKNOW.GPT3_NUM, cfg.GLIPKNOW.WIKI_AND_GPT3 = setting
    return cfg


@pytest.mark.parametrize("setting", SETTINGS)
def test_knowledge_copy_matches(tmp_path, setting):
    jcfg, tcfg = config(tmp_path, "jax", setting), config(tmp_path, "torch", setting)
    assert tknow.load_knowledge_file(tcfg.GLIPKNOW.KNOWLEDGE_FILE) == jknow.load_knowledge_file(
        jcfg.GLIPKNOW.KNOWLEDGE_FILE)
    assert tknow.knowledge_caption_prompts(tcfg, NAMES) == jknow.knowledge_caption_prompts(jcfg, NAMES)
    assert tknow.knowledge_captions_from_cfg(tcfg, NAMES) == jknow.knowledge_captions_from_cfg(jcfg, NAMES)
    kind, num, both = setting
    assert (tknow.construct_knowledge_captions(NAMES, KNOW, kind, num, both)
            == jknow.construct_knowledge_captions(NAMES, KNOW, kind, num, both))
    for info in KNOW.values():
        assert tknow._knowledge_sequence(info, kind, num, both) == jknow._knowledge_sequence(info, kind, num, both)
    assert tknow.construct_knowledge_captions(NAMES, None) == jknow.construct_knowledge_captions(NAMES, None)


def test_knowledge_off_is_the_plain_class_list():
    jcfg, tcfg = jb.tiny_test_config(), tb.tiny_test_config()
    assert tknow.knowledge_caption_prompts(tcfg, NAMES) is None is jknow.knowledge_caption_prompts(jcfg, NAMES)
    assert tknow.knowledge_captions_from_cfg(tcfg, NAMES) == jknow.knowledge_captions_from_cfg(jcfg, NAMES) == NAMES


class DS:
    ind_to_class = {i + 1: n for i, n in enumerate(NAMES)}


@pytest.mark.parametrize("setting,style", [(SETTINGS[0], 0), (SETTINGS[2], 1), (SETTINGS[6], 2)])
def test_plan_with_knowledge_file_matches_jax(tmp_path, setting, style):
    """ChunkedEvaluationPlan under GLIPKNOW.KNOWLEDGE_FILE: the captions carry
    the knowledge after each name, the spans stay on the names; the same
    token ids, masks, maps and slots as JAX's plan."""
    plans = []
    for side, inf, tok in (("jax", jinf, jtok), ("torch", tinf, ttok)):
        cfg = config(tmp_path, side, setting, style)
        cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 96
        cfg.TEST.CHUNKED_EVALUATION = 4
        cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT = 4
        random.seed(0)
        plans.append(inf.ChunkedEvaluationPlan(cfg, DS(), tok.WordPieceTokenizer(), None))
    want, got = plans
    assert len(got) == len(want) == 2 and got.chunks == want.chunks
    assert [b.caption for b in got.bundles] == [b.caption for b in want.bundles]
    for key in ("input_ids", "attention_mask", "all_map", "agg_map", "slot_to_label"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    if setting[0] == "def_wiki":
        assert "a domesticated canid." in got.bundles[0].caption
    # the spans cover the names only: "cat" is one word piece, its knowledge many
    assert 0 < (got.all_map[0, 0] > 0).sum() <= 2 < (got.attention_mask[0] > 0).sum()
