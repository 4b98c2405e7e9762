"""Query selection: bank rows -> padded query arrays. The port's copy of
`mqdet_tpu/mq/selector.py` (framework-free; pinned to the original by
`tests/test_torch_port_querybank.py`). The learnable bank's index form
(`emit_indices`, VISION_QUERY.LEARNABLE_BANK) is refused, as the port's
models refuse LEARNABLE_BANK (ROADMAP Queue A 5).

Reference QuerySelector.forward
(maskrcnn_benchmark/modeling/query_selector/query_selector.py:40-116): per
image and per caption label, sample k queries (random at train, first-k
sorted at eval), build the (V, C) padded query array and the (V, T)
query->token attention mask from the label's token span, plus
has_vision_query flags. PURE_TEXT_RATE drops all queries of a label with the
given probability at train time; RANDOM_KSHOT samples k ~ U{1..K}. With no
`rng`, draws come from the module-level `random`, as in the JAX module.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np

from mqdet_torch.mq.bank import QueryBank


class QuerySelector:
    def __init__(
        self,
        bank: Optional[QueryBank],
        num_query_per_class: int = 5,
        pure_text_rate: float = 0.0,
        random_kshot: bool = False,
        max_labels: int = 40,
        emit_indices: bool = False,
    ):
        if emit_indices:
            raise NotImplementedError(
                "the learnable bank's index selection (VISION_QUERY.LEARNABLE_BANK) is not ported "
                "(ROADMAP Queue A 5)"
            )
        self.bank = bank
        self.k = num_query_per_class
        self.pure_text_rate = pure_text_rate
        self.random_kshot = random_kshot
        self.max_labels = max_labels

    @property
    def max_queries(self) -> int:
        s = self.bank.num_scales if self.bank is not None else 1
        return self.max_labels * self.k * s

    def select(
        self,
        labels_in_caption: Sequence[int],
        location_map: np.ndarray,   # (L, T) label slot -> token map (any scale)
        training: bool = False,
        rng: Optional[random.Random] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One image -> (queries (V, C), query_mask (V, T), has_query (Lmax,)).

        V = max_queries (padded); mask rows of padded slots are all-zero so
        the GCP attention ignores them exactly.
        """
        r = rng or random
        t_len = location_map.shape[1]
        c = self.bank.channels if self.bank is not None else 1
        s = self.bank.num_scales if self.bank is not None else 1
        v = self.max_queries

        queries = np.zeros((v, c), np.float32)
        query_mask = np.zeros((v, t_len), np.float32)
        has_query = np.zeros((self.max_labels,), np.int32)
        if self.bank is None:
            return queries, query_mask, has_query

        cursor = 0
        for j, label in enumerate(labels_in_caption[: self.max_labels]):
            candidates = self.bank.get(int(label))
            if candidates is None or not len(candidates):
                continue
            k = self.k
            if self.random_kshot and training:
                k = r.randint(1, self.k)
            n = min(len(candidates), k)
            if training and r.random() < self.pure_text_rate:
                n = 0  # pure-text augmentation
            if n == 0:
                continue
            idx = r.sample(range(len(candidates)), n)
            if not training:
                idx = sorted(idx)
            sel = candidates[idx]  # (n, S, C)
            flat = sel.reshape(n * s, c)
            queries[cursor : cursor + len(flat)] = flat
            # binary query->token mask from the label's token span
            # (query_selector.py:105-112 re-binarizes the normalized map)
            row = (location_map[j] != 0).astype(np.float32)
            query_mask[cursor : cursor + len(flat)] = row[None, :]
            cursor += len(flat)
            has_query[j] = 1
        return queries, query_mask, has_query
