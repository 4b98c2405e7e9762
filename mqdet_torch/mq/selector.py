"""Query selection: bank rows -> padded query arrays. The port's copy of
`mqdet_tpu/mq/selector.py` (framework-free; pinned to the original by
`tests/test_torch_port_querybank.py`), with the learnable bank's index form
(`emit_indices`, VISION_QUERY.LEARNABLE_BANK): int32 (row, slot) pairs in
place of the features, which the model gathers from its bank parameter;
`bank_table_shape` / `bank_table` size and fill that parameter.

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
        self.bank = bank
        self.k = num_query_per_class
        self.pure_text_rate = pure_text_rate
        self.random_kshot = random_kshot
        self.max_labels = max_labels
        # VISION_QUERY.LEARNABLE_BANK (query_selector.py:17-20,59): (bank_row,
        # slot) int32 indices instead of features; padded slots are (0, 0)
        # with an all-zero mask row
        self.emit_indices = emit_indices
        if emit_indices:
            if bank is None:
                raise ValueError("emit_indices needs a bank")
            self._label_to_row = {int(lab): i for i, lab in enumerate(sorted(bank.labels))}

    def bank_table_shape(self) -> Tuple[int, int, int]:
        """(rows, slots, channels) of the learnable bank parameter."""
        rows = len(self.bank.labels)
        slots = max((len(self.bank.get(int(lab))) for lab in self.bank.labels), default=1) * self.bank.num_scales
        return rows, slots, self.bank.channels

    def bank_table(self) -> np.ndarray:
        """Dense (rows, slots, C) values for the learnable bank."""
        rows, slots, c = self.bank_table_shape()
        table = np.zeros((rows, slots, c), np.float32)
        for lab, i in self._label_to_row.items():
            e = self.bank.get(lab).reshape(-1, c)
            table[i, : len(e)] = e
        return table

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

        queries = np.zeros((v, 2), np.int32) if self.emit_indices else np.zeros((v, c), np.float32)
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
            if self.emit_indices:
                row = self._label_to_row[int(label)]
                flat = np.asarray([(row, q * s + sc) for q in idx for sc in range(s)], np.int32)
            else:
                flat = candidates[idx].reshape(n * s, c)  # (n, S, C) -> (n S, C)
            queries[cursor : cursor + len(flat)] = flat
            # binary query->token mask from the label's token span
            # (query_selector.py:105-112 re-binarizes the normalized map)
            row = (location_map[j] != 0).astype(np.float32)
            query_mask[cursor : cursor + len(flat)] = row[None, :]
            cursor += len(flat)
            has_query[j] = 1
        return queries, query_mask, has_query
