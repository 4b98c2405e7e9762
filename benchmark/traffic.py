"""The one traffic generator: a mix's parameters (a file under `traffic/`)
and a seed give the inputs, made on the device in a few large calls.

LVIS-protocol mixes (`"entry": "batched_protocol"`):
- an image pool of `image_pool` seeded images filling the bucket
  `image_hw` (smooth noise at 1/16 of the resolution plus fine noise, in
  the program's input scale); call k takes images (k * image_batch + j) mod
  pool, so no call repeats the one before it;
- `classes` seeded class names, `name_tokens` word pieces each (ids drawn
  from `name_ids`), split into chunks of `chunk_size`; the chunks go into
  groups of `chunk_parallelism`, the last group padded with the last chunk;
- a prompt per chunk in GroundingDINO's caption shape: [CLS], then per class
  its name tokens and '.', then [SEP], padded to `text_len` and masked;
- `queries_per_class` seeded vision queries a class (the query bank), whose
  rows attend to their class's name tokens; the class map averages over
  the name tokens.
Every seed gets the same sizes; only the values change.
"""
from __future__ import annotations

from typing import Dict

import torch

CLS, SEP, DOT = 101, 102, 1012


def chunk_groups(n_chunks: int, cp: int):
    """The chunk index of each (group, slot): ceil(n / cp) groups, the last
    padded with the last chunk."""
    groups = -(-n_chunks // cp)
    return [[min(g * cp + c, n_chunks - 1) for c in range(cp)] for g in range(groups)]


def lvis_protocol(mix: Dict, channels: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """{"images" (pool, 3, H, W), "input_ids" (G, CP, T) int64,
    "attention_mask" (G, CP, T) int64, "queries" (G, CP, V, C),
    "query_mask" (G, CP, V, T), "agg_map" (G, CP, K, T)} with K =
    chunk_size, V = K * queries_per_class."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    h, w = mix["image_hw"]
    pool = mix["image_pool"]
    low = torch.randn(pool, 3, -(-h // 16), -(-w // 16), generator=g, device=device)
    images = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    images += 0.25 * torch.randn(pool, 3, h, w, generator=g, device=device)

    n_cls, k, kq, t = mix["classes"], mix["chunk_size"], mix["queries_per_class"], mix["text_len"]
    n_tok = mix["name_tokens"]
    lo, hi = mix["name_ids"]
    names = torch.randint(lo, hi, (n_cls, n_tok), generator=g, device=device)
    bank = torch.randn(n_cls, kq, channels, generator=g, device=device)
    n_chunks = -(-n_cls // k)
    if (n_tok + 1) * k + 2 > t:
        raise ValueError(f"{k} classes of {n_tok} tokens do not fit {t} tokens")

    ids = torch.zeros(n_chunks, t, dtype=torch.long, device=device)
    mask = torch.zeros(n_chunks, t, dtype=torch.long, device=device)
    queries = torch.zeros(n_chunks, k * kq, channels, device=device)
    qmask = torch.zeros(n_chunks, k * kq, t, device=device)
    agg = torch.zeros(n_chunks, k, t, device=device)
    for c in range(n_chunks):
        members = range(c * k, min(n_cls, (c + 1) * k))
        pos = 1
        ids[c, 0] = CLS
        for j, cls in enumerate(members):
            span = slice(pos, pos + n_tok)
            ids[c, span] = names[cls]
            ids[c, pos + n_tok] = DOT
            queries[c, j * kq:(j + 1) * kq] = bank[cls]
            qmask[c, j * kq:(j + 1) * kq, span] = 1.0
            agg[c, j, span] = 1.0 / n_tok
            pos += n_tok + 1
        ids[c, pos] = SEP
        mask[c, :pos + 1] = 1
    order = torch.tensor(chunk_groups(n_chunks, mix["chunk_parallelism"]), device=device)
    return {
        "images": images,
        "input_ids": ids[order],
        "attention_mask": mask[order],
        "queries": queries[order],
        "query_mask": qmask[order],
        "agg_map": agg[order],
    }


def call_images(mix: Dict, call: int):
    """The pool indices of call `call`'s images."""
    b, pool = mix["image_batch"], mix["image_pool"]
    return [(call * b + j) % pool for j in range(b)]
