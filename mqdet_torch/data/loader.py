"""Training data loader: OD annotations -> fixed-shape grounding batches. The
port's copy of `mqdet_tpu/data/loader.py` (numpy; pinned to the original by
`tests/test_torch_port_train.py`), reading the port's dataset, tokenizer,
grounding helpers, `TrainTransform` and `QuerySelector`. Two differences,
both where the JAX module fails: the caption keeps its positives when the
label cap cuts it (`_one_example`), and each batch holds one bucket's
images (`__iter__`; ROADMAP Queue C 1), so a portrait image trains in the
rotated bucket with that bucket's anchors instead of failing to stack (a
mixed batch) or training against the landscape anchors (a portrait batch).
The host sharding (`num_hosts`, `host_id`) defaults to the process group's
world and rank (`parallel/comm.py`), as the JAX module's defaults to
`jax.process_count()`; each rank's batch is SOLVER.IMS_PER_BATCH // world (the
reference divides it by the number of GPUs, JAX's mesh over its devices),
and a value that does not divide raises.

Reference make_data_loader + CocoGrounding_New + BatchCollator
(maskrcnn_benchmark/data/build.py:244-506,
 data/datasets/modulated_coco_new.py:32-289,450-588,
 data/collate_batch.py:6-71): per image it synthesizes a grounding caption
(positives + sampled negatives), tokenizes, builds the positive maps, runs
the train transforms, selects vision queries, and pads everything to the
static device ABI. Epoch->iteration conversion and GENERAL_COPY duplication
(duplicate_dataset.py) are handled by the iterator.
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, Optional

import numpy as np

from mqdet_torch.data import grounding as G
from mqdet_torch.data.samplers import distributed_shard
from mqdet_torch.data.transforms import TrainTransform
from mqdet_torch.mq.selector import QuerySelector
from mqdet_torch.parallel import comm


class GroundingTrainLoader:
    def __init__(
        self,
        dataset,
        cfg,
        tokenizer,
        selector: Optional[QuerySelector] = None,
        max_gt: int = 64,
        seed: int = 0,
        num_hosts: Optional[int] = None,
        host_id: Optional[int] = None,
    ):
        self.dataset = dataset
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.selector = selector
        self.max_gt = max_gt
        self.seed = seed
        self.rng = random.Random(seed)
        self.transform = TrainTransform(cfg)
        self.t_len = cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
        self.max_labels = cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT
        if num_hosts is None:
            num_hosts, host_id = comm.get_world_size(), comm.get_rank()
        num_hosts = max(1, num_hosts)
        if cfg.SOLVER.IMS_PER_BATCH % num_hosts:
            raise ValueError(f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} does not divide over {num_hosts} "
                             "processes: the global batch is split evenly")
        self.batch_size = max(1, cfg.SOLVER.IMS_PER_BATCH // num_hosts)
        copies = max(1, cfg.DATASETS.GENERAL_COPY)
        self.epoch_ids = list(dataset.ids) * copies
        # data sharding (reference DistributedSampler semantics,
        # data/samplers/distributed.py:12-72): every process shuffles the SAME
        # permutation (seed+epoch), then takes a strided shard.
        self.num_hosts = num_hosts
        self.host_id = host_id or 0
        self.epoch = 0

    def steps_per_epoch(self) -> int:
        shard = -(-len(self.epoch_ids) // self.num_hosts)
        return max(1, shard // self.batch_size)

    def _one_example(self, img_id) -> Dict[str, np.ndarray]:
        ds = self.dataset
        cfg = self.cfg
        img = ds.load_image(img_id)
        boxes, labels = ds.annotations(img_id)
        img, boxes, (oh, ow) = self.transform(img, boxes, rng=self.rng)

        positive_labels = sorted(set(int(l) for l in labels))
        if cfg.DATASETS.RANDOM_SAMPLE_NEG > 0:
            negatives = G.sample_negatives(
                positive_labels, sorted(ds.ind_to_class.keys()),
                cfg.DATASETS.RANDOM_SAMPLE_NEG, rng=self.rng,
                control_probabilities=tuple(cfg.DATASETS.CONTROL_PROB),
            )
        else:
            negatives = [
                l for l in sorted(ds.ind_to_class.keys())
                if l not in set(positive_labels)
            ]
        positive_labels = G.check_for_positive_overflow(
            positive_labels, ds.ind_to_class, self.tokenizer, self.t_len,
            cfg.DATASETS.SEPARATION_TOKENS,
        )
        caption_labels = negatives + positive_labels
        if len(caption_labels) > self.max_labels:
            # the cap of MAX_CLASSES_PER_PROMPT cuts: keep the positives. The
            # JAX module cuts (negatives + positives), which drops every
            # positive once RANDOM_SAMPLE_NEG reaches the cap (85 against 40
            # in mq-glip-t.yaml); the reference's caption holds them all
            caption_labels = positive_labels + negatives
        caption_labels = caption_labels[: self.max_labels]
        if not cfg.DATASETS.DISABLE_SHUFFLE:
            self.rng.shuffle(caption_labels)

        caption, label_to_pos = G.build_caption(
            caption_labels, ds.ind_to_class,
            separation_tokens=cfg.DATASETS.SEPARATION_TOKENS,
            add_detection_prompt=cfg.DATASETS.ADD_DET_PROMPT,
        )
        tokenized = self.tokenizer(
            caption, max_length=self.t_len, padding="max_length",
            truncation=True, return_tensors="np",
        )
        input_ids = np.asarray(tokenized["input_ids"][0], np.int32)
        attention_mask = np.asarray(tokenized["attention_mask"][0], np.int32)

        # caption label slot maps
        spans = [[label_to_pos[l]] for l in caption_labels]
        all_map = G.create_positive_map(tokenized, spans, self.t_len)
        pos_cat_map = (all_map > 0).astype(np.float32)
        all_map_p = np.zeros((self.max_labels, self.t_len), np.float32)
        pos_cat_p = np.zeros_like(all_map_p)
        all_map_p[: len(caption_labels)] = all_map
        pos_cat_p[: len(caption_labels)] = pos_cat_map

        # per-box token maps; drop boxes whose label fell out of the caption
        keep = [i for i, l in enumerate(labels) if int(l) in label_to_pos]
        boxes = boxes[keep][: self.max_gt]
        labels = labels[keep][: self.max_gt]
        g = len(boxes)
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_valid = np.zeros((self.max_gt,), bool)
        gt_token_map = np.zeros((self.max_gt, self.t_len), np.float32)
        gt_boxes[:g] = boxes
        gt_labels[:g] = labels
        gt_valid[:g] = True
        slot_of_label = {l: i for i, l in enumerate(caption_labels)}
        for i in range(g):
            gt_token_map[i] = all_map[slot_of_label[int(labels[i])]]

        out = {
            "images": img.astype(np.float32),
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
            "gt_token_map": gt_token_map,
            "pos_category_map": pos_cat_p,
            "num_positive": np.int32(g),
            # true (h, w) of the resized image inside the padded bucket;
            # the GDINO criterion normalizes gt boxes by it (the reference's
            # normed_cxcy_boxes convention)
            "image_sizes": np.asarray([oh, ow], np.float32),
        }
        if self.selector is not None and self.selector.bank is not None:
            q, qm, hq = self.selector.select(
                caption_labels, all_map_p, training=True, rng=self.rng
            )
            out["queries"] = q
            out["query_mask"] = qm
            out["has_query"] = hq
        else:
            v = self.max_labels * (self.selector.k if self.selector else 5)
            out["queries"] = np.zeros((v, self.cfg.MODEL.BACKBONE.OUT_CHANNELS), np.float32)
            out["query_mask"] = np.zeros((v, self.t_len), np.float32)
            out["has_query"] = np.zeros((self.max_labels,), np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        ids = distributed_shard(
            self.epoch_ids, self.num_hosts, self.host_id,
            shuffle=not self.cfg.DATASETS.DISABLE_SHUFFLE,
            seed=self.seed, epoch=self.epoch,
        )
        self.epoch += 1
        # one batch per bucket as it fills (the reference's aspect-ratio
        # GroupedBatchSampler). The bucket is known only after the
        # transform's multi-scale draw, so examples are grouped as they are
        # made; with one bucket this is the JAX module's order. A bucket's
        # partial batch at the end of the epoch is dropped, as before.
        pending: Dict[tuple, list] = {}
        yielded = False
        for img_id in ids:
            ex = self._one_example(img_id)
            batch = pending.setdefault(ex["images"].shape[:2], [])
            batch.append(ex)
            if len(batch) == self.batch_size:
                yielded = True
                yield {k: np.stack([b[k] for b in batch]) for k in batch[0]}
                batch.clear()
        if ids and not yielded:
            raise ValueError(f"no image bucket filled a batch of {self.batch_size} in this epoch: {sorted(pending)}")
