"""Self-contained BERT-style tokenizer with char->token offset tracking: the
port's copy of `mqdet_tpu/data/tokenizer.py` (framework-free; the port
imports nothing of the JAX package). `tests/test_torch_port_querybank.py`
pins it to the original on the same captions.

The reference uses HF AutoTokenizer("bert-base-uncased"); positive maps
depend on char_to_token (modulated_coco_new.py:682-709).

  * `get_tokenizer(name)` -- the WordPiece tokenizer of a local vocab.txt,
    else the HF tokenizer when `transformers` resolves it from local files,
    else this module's WordPiece with its hash vocab: it never downloads.
  * `WordPieceTokenizer` -- BERT basic tokenization (lowercase, accent strip,
    punctuation split) + greedy-longest-match WordPiece with '##'
    continuations, tracking character offsets so `char_to_token` matches HF
    semantics. Given the real vocab.txt it reproduces bert-base-uncased ids;
    without it, a deterministic hash vocab keeps the pipeline functional
    (ids are stable but NOT checkpoint-compatible).
"""
from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class Encoding:
    """Minimal BatchEncoding twin: input_ids/attention_mask + char_to_token."""

    def __init__(self, ids, mask, offsets, max_length):
        # ids: list (batch) of list (tokens); offsets: (start, end) per token
        self._ids = ids
        self._mask = mask
        self._offsets = offsets
        self.max_length = max_length

    def __getitem__(self, key):
        if key == "input_ids":
            return np.asarray(self._ids, np.int32)
        if key == "attention_mask":
            return np.asarray(self._mask, np.int32)
        raise KeyError(key)

    @property
    def input_ids(self):
        return self["input_ids"]

    @property
    def attention_mask(self):
        return self["attention_mask"]

    def char_to_token(self, a, b=None):
        """char_to_token(char) or char_to_token(batch_index, char)."""
        if b is None:
            batch, char = 0, a
        else:
            batch, char = a, b
        for t, (s, e) in enumerate(self._offsets[batch]):
            if s <= char < e:
                return t
        return None


class WordPieceTokenizer:
    mask_token_id = MASK_ID
    pad_token_id = PAD_ID
    cls_token_id = CLS_ID
    sep_token_id = SEP_ID
    unk_token_id = UNK_ID

    def __init__(self, vocab: Optional[Dict[str, int]] = None, vocab_size: int = 30522):
        self.vocab = vocab
        self.vocab_size = vocab_size

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, vocab_size=len(vocab))

    def convert_tokens_to_ids(self, tokens):
        """HF-tokenizer-compatible lookup (str or list of str)."""
        if isinstance(tokens, str):
            if self.vocab is not None:
                return self.vocab.get(tokens, self.unk_token_id)
            return {
                "[PAD]": self.pad_token_id, "[CLS]": self.cls_token_id,
                "[SEP]": self.sep_token_id, "[MASK]": self.mask_token_id,
            }.get(tokens, self.unk_token_id)
        return [self.convert_tokens_to_ids(t) for t in tokens]

    # ---- basic tokenization with offsets -----------------------------------
    def _basic_tokenize(self, text: str):
        """Lowercase + accent-strip + punctuation-split, tracking offsets."""
        tokens = []  # (token_text, start, end)
        i = 0
        n = len(text)
        while i < n:
            ch = text[i]
            if ch.isspace():
                i += 1
                continue
            if _is_punctuation(ch):
                tokens.append((ch.lower(), i, i + 1))
                i += 1
                continue
            j = i
            while j < n and not text[j].isspace() and not _is_punctuation(text[j]):
                j += 1
            word = text[i:j].lower()
            word = "".join(
                c for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
            tokens.append((word, i, j))
            i = j
        return tokens

    def _wordpiece(self, word: str):
        """Greedy longest-match WordPiece. Returns list of (piece, rel_s, rel_e)."""
        if self.vocab is None:
            return [(word, 0, len(word))]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = (sub, start, end)
                    break
                end -= 1
            if cur is None:
                return [("[UNK]", 0, len(word))]
            pieces.append(cur)
            start = cur[2]
        return pieces

    def _piece_id(self, piece: str) -> int:
        if self.vocab is not None:
            return self.vocab.get(piece, UNK_ID)
        if piece == "[UNK]":
            return UNK_ID
        h = int(hashlib.md5(piece.encode()).hexdigest(), 16)
        return 1000 + h % (self.vocab_size - 1100)

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word, _, _ in self._basic_tokenize(text):
            out.extend(p for p, _, _ in self._wordpiece(word))
        return out

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        max_length: int = 256,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str = "np",
        return_special_tokens_mask: bool = False,
        **kw,
    ) -> Encoding:
        texts = [text] if isinstance(text, str) else list(text)
        all_ids, all_mask, all_offsets = [], [], []
        for t in texts:
            ids = [CLS_ID]
            offsets = [(-1, -1)]
            for word, s, e in self._basic_tokenize(t):
                for piece, rs, re_ in self._wordpiece(word):
                    ids.append(self._piece_id(piece))
                    offsets.append((s + rs, s + re_))
            ids.append(SEP_ID)
            offsets.append((-1, -1))
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [SEP_ID]
                offsets = offsets[: max_length - 1] + [(-1, -1)]
            mask = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [PAD_ID] * pad
                mask = mask + [0] * pad
                offsets = offsets + [(-1, -1)] * pad
            all_ids.append(ids)
            all_mask.append(mask)
            all_offsets.append(offsets)
        if padding != "max_length":
            longest = max(len(i) for i in all_ids)
            all_ids = [i + [PAD_ID] * (longest - len(i)) for i in all_ids]
            all_mask = [m + [0] * (longest - len(m)) for m in all_mask]
            all_offsets = [o + [(-1, -1)] * (longest - len(o)) for o in all_offsets]
        return Encoding(all_ids, all_mask, all_offsets, max_length)

    def batch_encode_plus(self, texts, **kw):
        return self(texts, **kw)


def get_tokenizer(name: str = "bert-base-uncased", vocab_path: Optional[str] = None):
    """HF tokenizer if its assets resolve locally, else the built-in one."""
    if vocab_path and os.path.exists(vocab_path):
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    for candidate in (
        name,
        os.path.join("MODEL/THIRD_PARTIES", name),
    ):
        vp = os.path.join(candidate, "vocab.txt") if os.path.isdir(candidate) else None
        if vp and os.path.exists(vp):
            return WordPieceTokenizer.from_vocab_file(vp)
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name, local_files_only=True)
    except Exception:
        return WordPieceTokenizer()
