"""TSV dataset format (GLIP pre-training data: cc/sbu/goldg shards).

Capability twin of maskrcnn_benchmark/data/datasets/tsv.py: line-indexed
random access into large .tsv shards whose rows are
`key \t json_labels \t base64_image`, plus composite sharding
(CompositeTSVFile over a file list + sequence map) and an OD dataset view
producing (image, annotations) pairs.

Pure host-side IO — feeds the same grounding/caption synthesis path as the
COCO reader.

The port's copy of `mqdet_tpu/data/tsv.py` (framework-free; PIL is
imported only where an image is decoded), pinned to the original by
`tests/test_torch_port_cli.py`.
"""
from __future__ import annotations

import base64
import io
import json
import os
from typing import List, Optional, Sequence, Tuple


def create_lineidx(tsv_path: str, idx_path: str) -> None:
    """Byte offset of every line (tsv.py:create_lineidx)."""
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(idx_path, "w") as f:
        for o in offsets:
            f.write(f"{o}\n")


class TSVFile:
    """Random-access TSV via a .lineidx sidecar (built on demand)."""

    def __init__(self, tsv_file: str, generate_lineidx: bool = True):
        self.tsv_file = tsv_file
        self.lineidx_file = os.path.splitext(tsv_file)[0] + ".lineidx"
        if not os.path.isfile(self.lineidx_file) and generate_lineidx:
            create_lineidx(tsv_file, self.lineidx_file)
        self._fp = None
        self._lineidx: Optional[List[int]] = None

    def _ensure(self):
        if self._lineidx is None:
            with open(self.lineidx_file) as f:
                self._lineidx = [int(l) for l in f if l.strip()]
        if self._fp is None:
            self._fp = open(self.tsv_file, "r")

    def num_rows(self) -> int:
        self._ensure()
        return len(self._lineidx)

    def seek(self, idx: int) -> List[str]:
        self._ensure()
        self._fp.seek(self._lineidx[idx])
        return self._fp.readline().rstrip("\n").split("\t")

    def get_key(self, idx: int) -> str:
        return self.seek(idx)[0]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def __len__(self) -> int:
        return self.num_rows()


class CompositeTSVFile:
    """A list of shards + (shard, row) sequence map (tsv.py:146-171)."""

    def __init__(self, file_list: Sequence[str], seq: Sequence[Tuple[int, int]],
                 root: str = "."):
        self.shards = [TSVFile(os.path.join(root, f)) for f in file_list]
        self.seq = list(seq)

    def __getitem__(self, index: int) -> List[str]:
        shard, row = self.seq[index]
        return self.shards[shard].seek(row)

    def get_key(self, index: int) -> str:
        return self[index][0]

    def __len__(self) -> int:
        return len(self.seq)


def img_from_base64(s: str):
    """Decode a base64 jpeg/png column into an RGB numpy array."""
    import numpy as np
    from PIL import Image

    raw = base64.b64decode(s)
    with Image.open(io.BytesIO(raw)) as im:
        return np.asarray(im.convert("RGB"))


class ODTSVDataset:
    """OD view over a TSV shard: rows `key \t labels_json \t b64_image`.

    labels_json is either a list of {rect, class} dicts or a dict with
    "objects"; returns (image, boxes xyxy, class names) like the reference's
    TSVDataset consumed by grounding synthesis.
    """

    def __init__(self, tsv_file: str):
        self.tsv = TSVFile(tsv_file)

    def __len__(self):
        return len(self.tsv)

    def get_annotations(self, idx: int):
        row = self.tsv.seek(idx)
        labels = json.loads(row[1])
        if isinstance(labels, dict):
            labels = labels.get("objects", [])
        boxes, names = [], []
        for obj in labels:
            rect = obj.get("rect") or obj.get("bbox")
            if rect is None:
                continue
            boxes.append([float(v) for v in rect])
            names.append(obj.get("class") or obj.get("category") or "")
        return boxes, names

    def __getitem__(self, idx: int):
        row = self.tsv.seek(idx)
        img = img_from_base64(row[2])
        boxes, names = self.get_annotations(idx)
        return img, boxes, names
