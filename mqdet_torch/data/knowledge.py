"""GLIPKNOW knowledge-augmented prompts (the port's copy of
`mqdet_tpu/data/knowledge.py`, which imports no framework but PyYAML; the
reference's generalized_vl_rcnn_new.py:521-666 and its GLIPKNOW config block,
config/defaults.py:887-894): class names are expanded with encyclopedic
descriptions (wiki definitions and/or GPT-3 generated sentences) loaded from
a yaml knowledge file `{class: {clean_name, def_wiki, def_wn, gpt3: [...]}}`,
one caption per class. The machine with the card has no PyYAML, so the file
is read by `core/yaml_lite.py`; `tests/test_torch_port_knowledge.py` holds
every function equal to the JAX package's and the reader to PyYAML.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from mqdet_torch.core import yaml_lite


def load_knowledge_file(path: str) -> Dict[str, dict]:
    """knowledge yaml: {class_name: {clean_name, def_wiki, def_wn, gpt3: [...]}}"""
    with open(path, encoding="utf-8") as f:
        return yaml_lite.safe_load(f.read())


def _knowledge_sequence(
    info: dict, knowledge_type: str, gpt3_num: int, wiki_and_gpt3: bool
) -> str:
    """The appended knowledge text for one class entry
    (generalized_vl_rcnn_new.py:_construct_captions_from_class_names)."""
    try:
        if wiki_and_gpt3:
            know_seq = info.get("def_wiki", "") or ""
            gpt3 = info.get("gpt3") or []
            if isinstance(gpt3, list):
                know_seq += " ".join(gpt3[:gpt3_num])
            return know_seq
        if knowledge_type and info.get(knowledge_type):
            val = info[knowledge_type]
            if knowledge_type == "gpt3" or isinstance(val, list):
                return " ".join(list(val)[:gpt3_num])
            return val
    except (TypeError, KeyError):
        pass
    return ""


def construct_knowledge_captions(
    class_names: Sequence[str],
    knowledge: Optional[Dict[str, dict]],
    knowledge_type: str = "",
    gpt3_num: int = 5,
    wiki_and_gpt3: bool = False,
) -> List[str]:
    """One caption per class: "<clean_name>: <knowledge sentences>"
    (generalized_vl_rcnn_new.py:_construct_captions_from_class_names).
    Falls back to the raw class name when no knowledge entry exists."""
    captions = []
    for name in class_names:
        info = (knowledge or {}).get(name)
        if not info:
            captions.append(name)
            continue
        cap = info.get("clean_name", name)
        know_seq = _knowledge_sequence(info, knowledge_type, gpt3_num, wiki_and_gpt3)
        if know_seq:
            cap += ": " + know_seq
        captions.append(cap)
    return captions


def knowledge_caption_prompts(cfg, class_names: Sequence[str]) -> Optional[List[dict]]:
    """Knowledge expansion as caption_prompt entries for build_caption
    (data/grounding.py:33-66): the positive-map span stays on the clean
    class name; the knowledge text rides in the suffix — the GLIPKNOW
    forward-path semantics (generalized_vl_rcnn_new.py:521-666) expressed
    through the prompt pipeline. Returns None when GLIPKNOW is off."""
    if not cfg.GLIPKNOW.KNOWLEDGE_FILE:
        return None
    know = load_knowledge_file(cfg.GLIPKNOW.KNOWLEDGE_FILE)
    prompts = []
    for name in class_names:
        info = (know or {}).get(name) or {}
        disp = info.get("clean_name", name) if info else name
        know_seq = _knowledge_sequence(
            info, cfg.GLIPKNOW.KNOWLEDGE_TYPE, cfg.GLIPKNOW.GPT3_NUM,
            cfg.GLIPKNOW.WIKI_AND_GPT3,
        )
        prompts.append(
            {"prefix": "", "name": disp,
             "suffix": (": " + know_seq) if know_seq else ""}
        )
    return prompts


def knowledge_captions_from_cfg(cfg, class_names: Sequence[str]) -> List[str]:
    """Config-driven entry: loads GLIPKNOW.KNOWLEDGE_FILE and expands
    class names per GLIPKNOW.{KNOWLEDGE_TYPE, GPT3_NUM, WIKI_AND_GPT3}."""
    if not cfg.GLIPKNOW.KNOWLEDGE_FILE:
        return list(class_names)
    know = load_knowledge_file(cfg.GLIPKNOW.KNOWLEDGE_FILE)
    return construct_knowledge_captions(
        class_names,
        know,
        knowledge_type=cfg.GLIPKNOW.KNOWLEDGE_TYPE,
        gpt3_num=cfg.GLIPKNOW.GPT3_NUM,
        wiki_and_gpt3=cfg.GLIPKNOW.WIKI_AND_GPT3,
    )
