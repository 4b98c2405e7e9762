"""The other language towers: the CLIP text transformer and the RNN encoder
(counterpart of `mqdet_tpu/models/text_towers.py`; the non-BERT entries of
the reference's language-backbone registry, modeling/language_backbone/
backbone.py:15-54, clip_model.py:69-199 and rnn_model.py).

  * `CLIPTextTransformer`: token and learned positional embeddings, pre-LN
    residual blocks (multi-head attention with a key-padding mask and no
    causal mask, as the reference passes attn_mask=None; a QuickGELU MLP),
    a final LayerNorm. It returns the language dict the head takes, with
    aggregate = embedded = hidden.
  * `RNNEncoder`: embedding -> dropout -> Dense + ReLU -> a forward and a
    reversed LSTM or GRU; the output concatenates both directions, and
    `aggregate` is the output at each row's last valid step.

The parameters are one tensor for each flax leaf (`io/from_jax.py::
tower_rules`): the attention's query / key / value / out projections in
flax's DenseGeneral layout (`DenseGeneral`), each RNN gate's input and
hidden Dense as a Linear named as flax names it (`ii`, `if`, ... for the
LSTM; `ir`, `iz`, `in`, `hr`, `hz`, `hn` for the GRU). The recurrence runs in
fp32 through `torch.lstm` / `torch.gru` (cuDNN on the card), the gates'
weights concatenated in torch's (i, f, g, o) / (r, z, n) order; flax's LSTM
has no input-side bias and its GRU no hidden-side bias but `hn`'s, which
torch's equations take as zeros. As in flax without `keep_order`, the
reversed direction's outputs stay in the order it ran them: position t holds
its state after reading tokens T-1 .. T-1-t, padding included.

As in the JAX package, these towers take no vision queries (the GCP blocks
live in the BERT tower only): `MQGLIP` refuses queries with them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import LayerNorm, dropout

LSTM_GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class DenseGeneral(nn.Module):
    """flax's DenseGeneral of an attention projection: into heads, `kernel`
    (C, H, D) and `bias` (H, D); out of heads (`heads_in`), `kernel`
    (H, D, C) and `bias` (C,); applied as one (C, H*D) product."""

    def __init__(self, width: int, heads: int, heads_in: bool = False):
        super().__init__()
        d = width // heads
        self.heads_in = heads_in
        self.kernel = nn.Parameter(torch.zeros((heads, d, width) if heads_in else (width, heads, d)))
        self.bias = nn.Parameter(torch.zeros(width if heads_in else (heads, d)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, H*D), or (B, T, H*D) -> (B, T, C) for heads_in."""
        k = self.kernel.reshape(-1, self.kernel.shape[-1]) if self.heads_in else self.kernel.flatten(1)
        return x @ k.to(x.dtype) + self.bias.reshape(-1).to(x.dtype)


class CLIPAttention(nn.Module):
    """flax's MultiHeadDotProductAttention: q scaled by 1/sqrt(d), masked
    logits set to fp32's lowest value, softmax in fp32."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = DenseGeneral(width, heads)
        self.key = DenseGeneral(width, heads)
        self.value = DenseGeneral(width, heads)
        self.out = DenseGeneral(width, heads, heads_in=True)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """x (B, T, C); keep (B, T) bool, the keys a query may attend to."""
        b, t, c = x.shape
        h = self.heads
        d = c // h
        q = (self.query(x) / d**0.5).reshape(b, t, h, d).transpose(1, 2)
        k = self.key(x).reshape(b, t, h, d).transpose(1, 2)
        v = self.value(x).reshape(b, t, h, d).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)).float()
        logits = logits.masked_fill(~keep[:, None, None, :], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.out(torch.matmul(probs, v).transpose(1, 2).reshape(b, t, c))


class CLIPResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), keep)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class CLIPTextTransformer(nn.Module):
    def __init__(self, context_length: int = 256, width: int = 512, layers: int = 12, heads: int = 8,
                 vocab_size: int = 49408):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.resblocks = nn.ModuleList(CLIPResidualBlock(width, heads) for _ in range(layers))
        self.ln_final = LayerNorm(width, eps=1e-5)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.token_embedding(input_ids)
        x = x + self.positional_embedding[: input_ids.shape[1]].to(x.dtype)[None]
        keep = attention_mask.bool()
        for block in self.resblocks:
            x = block(x, keep)
        x = self.ln_final(x)
        return {"aggregate": x, "embedded": x, "masks": attention_mask, "hidden": x}


class RecurrentCell(nn.Module):
    """One direction's LSTM or GRU gates, one Linear per flax Dense."""

    def __init__(self, rnn_type: str, cin: int, hidden: int):
        super().__init__()
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(f"rnn_type {rnn_type!r}: lstm or gru")
        self.rnn_type = rnn_type
        gates = LSTM_GATES if rnn_type == "lstm" else GRU_GATES
        for g in gates:  # flax: the input Dense has a bias in the GRU only, the hidden one in the LSTM only (and hn)
            self.add_module(f"i{g}", nn.Linear(cin, hidden, bias=rnn_type == "gru"))
            self.add_module(f"h{g}", nn.Linear(hidden, hidden, bias=rnn_type == "lstm" or g == "n"))
        self.gates = gates
        self.hidden = hidden

    def flat_weights(self):
        """[w_ih, w_hh, b_ih, b_hh] in torch's gate order, fp32."""
        lin = [getattr(self, f"i{g}") for g in self.gates], [getattr(self, f"h{g}") for g in self.gates]
        w = [torch.cat([m.weight for m in side]).float() for side in lin]
        b = [torch.cat([m.bias if m.bias is not None else m.weight.new_zeros(self.hidden) for m in side]).float()
             for side in lin]
        return w + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, C) -> the states (B, T, hidden) in fp32, from zeros."""
        h0 = x.new_zeros(1, x.shape[0], self.hidden, dtype=torch.float32)
        args = (self.flat_weights(), True, 1, 0.0, False, False, True)
        if self.rnn_type == "lstm":
            return torch.lstm(x.float(), (h0, h0), *args)[0]
        return torch.gru(x.float(), h0, *args)[0]


class RNNEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, word_embedding_size: int = 512, word_vec_size: int = 512,
                 hidden_size: int = 512, bidirectional: bool = True, rnn_type: str = "lstm",
                 input_dropout_p: float = 0.5):
        super().__init__()
        self.input_dropout_p = input_dropout_p
        self.embedding = nn.Embedding(vocab_size, word_embedding_size)
        self.mlp = nn.Linear(word_embedding_size, word_vec_size)
        self.cell_fwd = RecurrentCell(rnn_type, word_vec_size, hidden_size)
        self.cell_bwd = RecurrentCell(rnn_type, word_vec_size, hidden_size) if bidirectional else None

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """`generator` draws the input dropout (None: none, the JAX
        package's `deterministic=True`)."""
        emb = dropout(self.embedding(input_ids), self.input_dropout_p, generator)
        emb = F.relu(self.mlp(emb))
        out = self.cell_fwd(emb)
        if self.cell_bwd is not None:
            out = torch.cat([out, self.cell_bwd(emb.flip(1))], dim=-1)
        out = out.to(emb.dtype)
        t = input_ids.shape[1]
        if attention_mask is not None:
            lengths = attention_mask.sum(dim=1).long()
        else:
            lengths = torch.full((input_ids.shape[0],), t, dtype=torch.long, device=input_ids.device)
        last = (lengths - 1).clamp(0, t - 1)
        final = out.gather(1, last[:, None, None].expand(-1, 1, out.shape[-1]))[:, 0]
        return {"hidden": out, "output": out, "embedded": emb, "final_output": final, "aggregate": final,
                "masks": attention_mask}
