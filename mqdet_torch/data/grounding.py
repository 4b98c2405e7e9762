"""Prompts: class captions, char-span -> token-span positive maps, LVIS
class chunking and, for the training loader, negative sampling, overflow
trimming and the control probabilities. The port's copy of
`mqdet_tpu/data/grounding.py` (framework-free; pinned to the original by
`tests/test_torch_port_querybank.py` and `tests/test_torch_port_train.py`).

Reference: od_to_grounding.py (captions), modulated_coco_new.py:682-709
(positive maps with the +-1/2/3 char_to_token fallbacks) and
engine/inference.py:165-283 (chunking, create_queries_and_maps).

Every array here is fixed-shape numpy, the head's input:
  all_map             (L, T)  caption label slot -> token span (normalized)
  positive_category_map (L, T) binary variant
  agg_map             (L, T)  MEAN score-aggregation matrix for postprocess
"""
from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def clean_name(name: str) -> str:
    """od_to_grounding.py:9-13."""
    name = re.sub(r"\(.*\)", "", name)
    name = re.sub(r"_", " ", name)
    name = re.sub(r"  ", " ", name)
    return name


def build_caption(
    label_list: Sequence[int],
    ind_to_class: Dict[int, str],
    separation_tokens: str = ". ",
    add_detection_prompt: bool = False,
    shuffle: bool = False,
    caption_prompt: Optional[List[dict]] = None,
    rng: Optional[random.Random] = None,
) -> Tuple[str, Dict[int, Tuple[int, int]]]:
    """generate_sentence_from_labels (od_to_grounding.py:33-68).

    Returns (caption, label -> (char_start, char_end)).
    """
    labels = list(label_list)
    if shuffle:
        assert caption_prompt is None
        (rng or random).shuffle(labels)

    caption = "object detection : " if add_detection_prompt else ""
    label_to_positions: Dict[int, Tuple[int, int]] = {}
    for index, label in enumerate(labels):
        if caption_prompt is not None:
            caption += caption_prompt[index]["prefix"]
        start = len(caption)
        if caption_prompt is not None:
            caption += clean_name(caption_prompt[index]["name"])
        else:
            caption += clean_name(ind_to_class[label])
        label_to_positions[label] = (start, len(caption))
        if caption_prompt is not None:
            caption += caption_prompt[index]["suffix"]
        if index != len(labels) - 1:
            caption += separation_tokens
    return caption, label_to_positions


def char_span_to_token_span(tokenized, beg: int, end: int):
    """char_to_token with the reference's +-1/2/3 fallbacks
    (modulated_coco_new.py:688-703)."""
    c2t = tokenized.char_to_token
    beg_pos = c2t(beg)
    if beg_pos is None:
        try:
            beg_pos = c2t(beg + 1)
            if beg_pos is None:
                beg_pos = c2t(beg + 2)
        except Exception:
            beg_pos = None
    end_pos = c2t(end - 1)
    if end_pos is None:
        try:
            end_pos = c2t(end - 2)
            if end_pos is None:
                end_pos = c2t(end - 3)
        except Exception:
            end_pos = None
    return beg_pos, end_pos


def create_positive_map(
    tokenized,
    tokens_positive: List[List[Tuple[int, int]]],
    max_text_len: int = 256,
    normalize: bool = True,
) -> np.ndarray:
    """(G, T) map, positive_map[i, j] = 1 iff box i associated to token j,
    row-normalized (modulated_coco_new.py:682-709)."""
    out = np.zeros((len(tokens_positive), max_text_len), np.float32)
    for j, tok_list in enumerate(tokens_positive):
        for beg, end in tok_list:
            beg_pos, end_pos = char_span_to_token_span(tokenized, beg, end)
            if beg_pos is None or end_pos is None:
                continue
            out[j, beg_pos : end_pos + 1] = 1.0
    if normalize:
        out = out / (out.sum(-1, keepdims=True) + 1e-6)
    return out


def check_for_positive_overflow(
    positive_labels: List[int],
    ind_to_class: Dict[int, str],
    tokenizer,
    max_seq_length: int = 256,
    separation_tokens: str = ". ",
) -> List[int]:
    """Trim positive labels so their caption fits (od_to_grounding.py:104+).

    Returns the kept labels (order preserved after the reference's shuffle-free
    length accumulation: labels are added until the tokenized length would
    exceed max_seq_length)."""
    kept = []
    length = 0
    # the reference accounts for [CLS]/[SEP]
    for label in positive_labels:
        text = clean_name(ind_to_class[label]) + separation_tokens
        piece = len(tokenizer.tokenize(text))
        if length + piece > max_seq_length - 2:
            break
        length += piece
        kept.append(label)
    return kept


def generate_control_options_given_probabilities(
    control_probabilities: Sequence[float],
    full_positive: int,
    full_negative: int,
    rng: Optional[random.Random] = None,
):
    """DATASETS.CONTROL_PROB twin (od_to_grounding.py:340-379): decide how
    many negative/positive classes the synthesized caption gets.

    control_probabilities = (one_negative, one_positive, full, drop_positive):
      a. with prob one_negative: exactly 1 negative, 0 positives (mimics eval)
      b. with prob one_positive: 0 negatives, 1 positive
      c. with prob full: all positives + all negatives
      d. otherwise: uniform-random 1..full_negative negatives, all positives
    drop_positive must be 0 (asserted, like the reference).
    """
    r = rng or random
    p_one_neg, p_one_pos, p_full, p_drop_pos = control_probabilities
    assert p_drop_pos == 0
    outer = r.random()
    if outer < p_one_neg:
        return 1, 0
    if outer < p_one_neg + p_one_pos:
        return 0, 1
    if outer < p_one_neg + p_one_pos + p_full:
        return full_negative, full_positive
    return r.randint(1, max(1, full_negative)), full_positive


def sample_negatives(
    positive_labels: List[int],
    all_labels: Sequence[int],
    random_sample_neg: int,
    rng: Optional[random.Random] = None,
    control_probabilities: Optional[Sequence[float]] = None,
) -> List[int]:
    """Negative category sampling for grounding pretraining
    (convert_object_detection_to_grounding_optimized_for_od,
    od_to_grounding.py:149+): fill up to `random_sample_neg` total classes
    with random negatives; DATASETS.CONTROL_PROB optionally caps the count
    via generate_control_options_given_probabilities."""
    r = rng or random
    negatives = [l for l in all_labels if l not in set(positive_labels)]
    budget = max(0, random_sample_neg - len(positive_labels))
    if control_probabilities is not None and any(control_probabilities):
        n_neg, _ = generate_control_options_given_probabilities(
            control_probabilities, len(positive_labels), len(negatives), r
        )
        budget = min(budget, n_neg)
    if budget < len(negatives):
        negatives = r.sample(list(negatives), budget)
    return list(negatives)


def chunk_classes(class_ids: Sequence[int], chunk_size: int) -> List[List[int]]:
    """LVIS chunked evaluation (engine/inference.py:165-211): split the
    category list into chunks of <= chunk_size."""
    if chunk_size <= 0:
        return [list(class_ids)]
    out = []
    for i in range(0, len(class_ids), chunk_size):
        out.append(list(class_ids[i : i + chunk_size]))
    return out


class PromptBundle:
    """Tokenized prompt + every map the head needs, for one chunk."""

    def __init__(
        self,
        caption: str,
        input_ids: np.ndarray,         # (T,)
        attention_mask: np.ndarray,    # (T,)
        label_ids: List[int],          # global category ids, caption order
        all_map: np.ndarray,           # (L, T) normalized
        agg_map: np.ndarray,           # (L, T) MEAN aggregation (= all_map)
        positive_category_map: np.ndarray,  # (L, T) binary
    ):
        self.caption = caption
        self.input_ids = input_ids
        self.attention_mask = attention_mask
        self.label_ids = label_ids
        self.all_map = all_map
        self.agg_map = agg_map
        self.positive_category_map = positive_category_map

    @property
    def num_labels(self) -> int:
        return len(self.label_ids)


def build_prompt(
    label_ids: Sequence[int],
    ind_to_class: Dict[int, str],
    tokenizer,
    max_text_len: int = 256,
    separation_tokens: str = ". ",
    caption_prompt: Optional[List[dict]] = None,
) -> PromptBundle:
    """create_queries_and_maps (engine/inference.py:212-283) as a bundle."""
    caption, label_to_pos = build_caption(
        label_ids, ind_to_class, separation_tokens=separation_tokens,
        caption_prompt=caption_prompt,
    )
    tokenized = tokenizer(
        caption, max_length=max_text_len, padding="max_length",
        truncation=True, return_tensors="np",
    )
    spans = [[label_to_pos[l]] for l in label_ids]
    all_map = create_positive_map(tokenized, spans, max_text_len)
    binary = (all_map > 0).astype(np.float32)
    return PromptBundle(
        caption=caption,
        input_ids=tokenized["input_ids"][0].astype(np.int32),
        attention_mask=tokenized["attention_mask"][0].astype(np.int32),
        label_ids=list(label_ids),
        all_map=all_map,
        agg_map=all_map,
        positive_category_map=binary,
    )


def pad_prompt_maps(bundle: PromptBundle, max_labels: int):
    """Pad the (L, T) maps to a static L."""
    l, t = bundle.all_map.shape
    assert l <= max_labels, (l, max_labels)
    pad = ((0, max_labels - l), (0, 0))
    return (
        np.pad(bundle.all_map, pad),
        np.pad(bundle.agg_map, pad),
        np.pad(bundle.positive_category_map, pad),
    )
