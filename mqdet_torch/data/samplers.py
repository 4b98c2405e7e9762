"""Sampling strategies for the training loader: the port's copy of
`mqdet_tpu/data/samplers.py` (framework-free; pinned to the original by
`tests/test_torch_port_train.py`). Reference maskrcnn_benchmark/data/samplers/:
  * distributed_shard — DistributedSampler (distributed.py:12-72): each host
    takes a strided shard of the (optionally shuffled) index list
  * grouped_by_aspect_ratio — GroupedBatchSampler (grouped_batch_sampler.py):
    batches drawn from same aspect-ratio bucket (here: same image bucket,
    which is what actually matters for static-shape batching)
  * iteration_based — IterationBasedBatchSampler (iteration_based_batch_sampler.py):
    repeat the sampler until a target iteration count
"""
from __future__ import annotations

import random
from typing import Iterable, Iterator, List, Sequence


def distributed_shard(
    ids: Sequence, num_hosts: int, host_id: int, shuffle: bool = True,
    seed: int = 0, epoch: int = 0,
) -> List:
    ids = list(ids)
    if shuffle:
        random.Random(seed + epoch).shuffle(ids)
    # pad to a multiple of num_hosts (DistributedSampler total_size semantics)
    total = -(-len(ids) // num_hosts) * num_hosts
    ids = (ids + ids)[:total]
    return ids[host_id::num_hosts]


def grouped_by_bucket(
    ids: Sequence, bucket_of, batch_size: int, drop_uneven: bool = False
) -> List[List]:
    groups = {}
    for i in ids:
        groups.setdefault(bucket_of(i), []).append(i)
    batches = []
    for _, members in sorted(groups.items(), key=lambda kv: str(kv[0])):
        for s in range(0, len(members), batch_size):
            batch = members[s : s + batch_size]
            if drop_uneven and len(batch) < batch_size:
                continue
            batches.append(batch)
    return batches


def iteration_based(batches: Iterable, num_iterations: int, start_iter: int = 0) -> Iterator:
    it = start_iter
    while it < num_iterations:
        for b in batches:
            if it >= num_iterations:
                return
            it += 1
            yield b


def distributed_shard_chunk_by_node(
    dataset_sizes: Sequence[int],
    chunk_or_not: Sequence[bool],
    *,
    rank: int,
    world_size: int,
    node_rank: int,
    node_number: int,
    rank_within_node: int,
    process_num_per_node: int,
    seed: int = 0,
    epoch: int = 0,
) -> List[int]:
    """DistributedSamplerChunkByNode capability twin
    (data/datasets/custom_distributed_sampler.py): indices of a ConcatDataset
    where "chunked" sub-datasets are pinned per node (disk-local multi-node
    shards) and non-chunked ones follow conventional sharding.

    dataset_sizes: length of each concatenated sub-dataset, in order
    chunk_or_not: whether each sub-dataset is node-pinned
    Returns this rank's global indices for the epoch.
    """
    import numpy as np

    assert process_num_per_node * node_number == world_size
    # global index ranges per sub-dataset, in concat order
    starts = np.cumsum([0] + list(dataset_sizes))[:-1]
    normal_idx: List[int] = []
    chunked_ranges: List[range] = []
    for size, start, chunk in zip(dataset_sizes, starts, chunk_or_not):
        if chunk:
            chunked_ranges.append(range(int(start), int(start + size)))
        else:
            normal_idx.extend(range(int(start), int(start + size)))

    rng = np.random.default_rng(seed + epoch)

    # node-pinned part: each node gets a contiguous block of chunked datasets
    assert len(chunked_ranges) >= node_number or not chunked_ranges
    node_part: List[int] = []
    if chunked_ranges:
        per_node = len(chunked_ranges) // node_number
        lo = node_rank * per_node
        hi = (node_rank + 1) * per_node if node_rank < node_number - 1 else len(
            chunked_ranges
        )
        for r in chunked_ranges[lo:hi]:
            node_part.extend(r)
        node_part = list(rng.permutation(node_part))
        # split among this node's local ranks
        per_rank = -(-len(node_part) // process_num_per_node)
        node_part = (node_part * 2)[
            rank_within_node * per_rank : (rank_within_node + 1) * per_rank
        ]

    # conventional part: shard across ALL ranks
    normal = list(rng.permutation(normal_idx))
    per_rank_n = -(-len(normal) // world_size) if normal else 0
    normal = (normal * 2)[rank * per_rank_n : (rank + 1) * per_rank_n]

    out = normal + node_part
    return [int(i) for i in rng.permutation(out)]
