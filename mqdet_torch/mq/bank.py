"""Vision-query bank: storage, import, accumulation. The port's copy of
`mqdet_tpu/mq/bank.py` (framework-free; pinned to the original by
`tests/test_torch_port_querybank.py`; `allgather_merge` by
`tests/test_torch_port_distributed.py`).

The reference's bank is a dict label -> (num_queries, num_scales, C) tensor
saved with torch.save (tools/train_net.py:324-336, loaded by QuerySelector,
modeling/query_selector/query_selector.py:8-38). This one is saved as one
.npz, the JAX package's format:
  features (num_labels, capacity, num_scales, C) float32
  counts   (num_labels,) int32
  labels   (num_labels,) int32  -- the category ids, row order
`from_torch_pth` reads a reference .pth bank.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch


class QueryBank:
    def __init__(
        self,
        channels: int,
        num_scales: int = 1,
        capacity: int = 5000,
    ):
        self.channels = channels
        self.num_scales = num_scales
        self.capacity = capacity
        self._store: Dict[int, np.ndarray] = {}  # label -> (n, S, C)

    # ---- accumulation (extraction path) ----------------------------------
    def add(
        self,
        label: int,
        feats: np.ndarray,
        exclude_similar: bool = False,
        similarity_threshold: float = 0.85,
        capacity: Optional[int] = None,
    ) -> int:
        """Append (n, S, C) features for `label`, capped at capacity.

        exclude_similar reproduces extract_query(exclude_similar=True)
        (generalized_vl_rcnn_new.py:232-288 / engine/inference.py online
        update): skip new queries whose cosine similarity with any stored
        query of the same label exceeds the threshold.
        """
        cap = capacity or self.capacity
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[:, None, :]
        assert feats.shape[-1] == self.channels
        cur = self._store.get(label)
        added = 0
        for row in feats:
            if cur is not None and len(cur) >= cap:
                break
            if exclude_similar and cur is not None and len(cur):
                a = row.reshape(-1)
                b = cur.reshape(len(cur), -1)
                sim = (b @ a) / (
                    np.linalg.norm(b, axis=1) * np.linalg.norm(a) + 1e-8
                )
                if (sim > similarity_threshold).any():
                    continue
            cur = row[None] if cur is None else np.concatenate([cur, row[None]])
            added += 1
        if cur is not None:
            self._store[label] = cur
        return added

    def count(self, label: int) -> int:
        arr = self._store.get(label)
        return 0 if arr is None else len(arr)

    @property
    def labels(self):
        return sorted(self._store.keys())

    def get(self, label: int) -> Optional[np.ndarray]:
        return self._store.get(label)

    def __len__(self):
        return len(self._store)

    # ---- packing for the device -------------------------------------------
    def pack(self, label_ids: Iterable[int], k: int):
        """Dense (L, k, S, C) block + (L,) counts for the given labels."""
        label_ids = list(label_ids)
        l = len(label_ids)
        out = np.zeros((l, k, self.num_scales, self.channels), np.float32)
        counts = np.zeros((l,), np.int32)
        for i, lab in enumerate(label_ids):
            arr = self._store.get(lab)
            if arr is None or not len(arr):
                continue
            n = min(k, len(arr))
            out[i, :n] = arr[:n]
            counts[i] = n
        return out, counts

    # ---- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        labels = self.labels
        cap = max((len(self._store[l]) for l in labels), default=0)
        feats = np.zeros((len(labels), cap, self.num_scales, self.channels), np.float32)
        counts = np.zeros((len(labels),), np.int32)
        for i, lab in enumerate(labels):
            arr = self._store[lab]
            feats[i, : len(arr)] = arr
            counts[i] = len(arr)
        np.savez_compressed(
            path, features=feats, counts=counts, labels=np.asarray(labels, np.int32),
            num_scales=self.num_scales, channels=self.channels,
        )

    @classmethod
    def load(cls, path: str) -> "QueryBank":
        data = np.load(path)
        bank = cls(
            channels=int(data["channels"]),
            num_scales=int(data["num_scales"]),
        )
        for i, lab in enumerate(data["labels"]):
            n = int(data["counts"][i])
            if n:
                bank._store[int(lab)] = data["features"][i, :n].astype(np.float32)
        return bank

    @classmethod
    def from_torch_pth(cls, path: str) -> "QueryBank":
        """Import a reference bank (torch.save'd dict label -> tensor)."""
        raw = torch.load(path, map_location="cpu", weights_only=False)
        first = next(iter(raw.values()))
        arr0 = first.detach().numpy() if hasattr(first, "detach") else np.asarray(first)
        if arr0.ndim == 2:
            arr0 = arr0[:, None, :]
        bank = cls(channels=arr0.shape[-1], num_scales=arr0.shape[-2])
        for label, tensor in raw.items():
            arr = tensor.detach().numpy() if hasattr(tensor, "detach") else np.asarray(tensor)
            if arr.ndim == 2:
                arr = arr[:, None, :]
            if len(arr):
                bank._store[int(label)] = arr.astype(np.float32)
        return bank

    def merge(self, other: "QueryBank", capacity: Optional[int] = None) -> None:
        """Add every entry of `other` (the reference leaves per-rank files
        unmerged, tools/train_net.py:305-336)."""
        for lab in other.labels:
            self.add(lab, other.get(lab), capacity=capacity)

    def allgather_merge(self, capacity: Optional[int] = None) -> None:
        """Merge every other process's entries into this bank, in rank order
        after its own, under `capacity` (the JAX module's; the reference
        leaves one unmerged file per rank). No-op in one process."""
        from mqdet_torch.parallel import comm

        if comm.get_world_size() == 1:
            return
        for r, store in enumerate(comm.all_gather(dict(self._store))):
            if r == comm.get_rank():
                continue
            for lab in sorted(store):
                self.add(int(lab), store[lab], capacity=capacity)
