"""CLIP-style byte-pair-encoding tokenizer (the port's copy of
`mqdet_tpu/data/bpe_tokenizer.py`, which imports no framework; reference
maskrcnn_benchmark/modeling/language_backbone/simple_tokenizer.py): byte ->
unicode mapping, greedy lowest-rank BPE merges over word chunks, with
<|startoftext|>/<|endoftext|> specials. The merge table (the public
`bpe_simple_vocab_16e6.txt.gz`) is data supplied at run time, not bundled.
As in the JAX package, no model path calls it. `tests/test_torch_port_
text_towers.py` holds it equal to the JAX package's on hand-built merges.
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte→printable-unicode map (GPT-2/CLIP convention):
    printable ASCII + latin-1 ranges map to themselves; the rest shift into
    the U+0100.. plane so every byte has a visible single-char stand-in."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+""",
    re.IGNORECASE,
)


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class BPETokenizer:
    def __init__(self, merges: List[Tuple[str, str]]):
        """merges: ordered list of merge pairs (highest priority first)."""
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = [v for v in self.byte_encoder.values()]
        vocab += [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @classmethod
    def from_vocab_file(cls, path: str) -> "BPETokenizer":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # standard file: first line is a version header; merges follow
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        return cls([m for m in merges if len(m) == 2])

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _WORD_RE.findall(text):
            if token in ("<|startoftext|>", "<|endoftext|>"):
                out.append(self.encoder[token])
                continue
            btoken = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.encoder[t] for t in self.bpe(btoken).split(" "))
        return out

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self, texts, context_length: int = 77, sot: bool = True, eot: bool = True
    ):
        """CLIP front-end: <sot> tokens <eot>, padded to context_length."""
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]
        sot_id = self.encoder["<|startoftext|>"]
        eot_id = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        masks = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            ids = ([sot_id] if sot else []) + ids + ([eot_id] if eot else [])
            ids = ids[:context_length]
            out[i, : len(ids)] = ids
            masks[i, : len(ids)] = 1
        return out, masks
