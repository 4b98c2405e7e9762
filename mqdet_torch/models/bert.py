"""BERT language backbone with interleaved GCP gated cross-attention
(counterpart of `mqdet_tpu/models/bert.py`; reference
modeling/language_backbone/modeling_bert_new.py and bert_model_new.py).

Attribute names follow the reference torch tree, so that the state_dict keys
are those of the JAX package's rule table (`language_backbone.body.model.*`).
The query->token cross-attention is the JAX package's dense masked form:
additive -1e4 on masked logits, then masked probabilities zeroed, so a token
with no query receives exactly zero and its gated residual is the identity.
Eval only: dropout is the identity.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import GCPFeedForward, LayerNorm

MASK_FILL = -1e4


class MaskedCrossAttention(nn.Module):
    """Text tokens (B, T, D) attend to vision tokens (B, V, Dv); mask (B, V, T)
    is 1 where vision token v may be attended by text token t."""

    def __init__(self, input_dim, vision_dim, output_dim=None, dim_head=64, heads=8):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(input_dim, eps=1e-5)
        self.norm_kv = LayerNorm(vision_dim, eps=1e-5)
        self.to_q = nn.Linear(input_dim, inner, bias=False)
        self.to_kv = nn.Linear(vision_dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, output_dim or input_dim, bias=False)

    def forward(self, x, vision, attention_mask=None):
        h, d = self.heads, self.dim_head
        x = self.norm(x)
        vision = self.norm_kv(vision)
        b, t, _ = x.shape
        vlen = vision.shape[1]
        q = self.to_q(x).reshape(b, t, h, d).transpose(1, 2) * d**-0.5
        k, v = self.to_kv(vision).chunk(2, dim=-1)
        k = k.reshape(b, vlen, h, d).transpose(1, 2)
        v = v.reshape(b, vlen, h, d).transpose(1, 2)
        sim = torch.matmul(q, k.transpose(-1, -2))  # (B, h, T, V), compute dtype
        if attention_mask is not None:
            keep = attention_mask.transpose(1, 2)[:, None] != 0  # (B, 1, T, V)
            sim = sim + torch.where(keep, 0.0, MASK_FILL).to(sim.dtype)
        m = sim.amax(dim=-1, keepdim=True)
        e = torch.exp((sim - m).float())
        attn = e / e.sum(dim=-1, keepdim=True)
        if attention_mask is not None:
            attn = attn * keep
        out = torch.matmul(attn.to(v.dtype), v).transpose(1, 2).reshape(b, t, h * d)
        return self.to_out(out)


class GatedCrossAttentionBlock(nn.Module):
    """GCP block with the MQ-Det defaults (conditional nonlinear gate on the
    attention output alone, learned ff gate):
        x <- attn(x, queries) * tanh(gate(attn_out)) + x
        x <- ff(x) * tanh(ff_gate) + x"""

    def __init__(self, dim: int, vision_dim: int):
        super().__init__()
        self.attn = MaskedCrossAttention(dim, vision_dim)
        self.attn_gate = GCPFeedForward(dim, mult=0.5, out_dim=1)
        self.ff = GCPFeedForward(dim, mult=4.0)
        self.ff_gate = nn.Parameter(torch.zeros(1))

    def forward(self, x, vision, attention_mask=None):
        supported = self.attn(x, vision, attention_mask)
        x = supported * torch.tanh(self.attn_gate(supported)) + x
        return self.ff(x) * torch.tanh(self.ff_gate).to(x.dtype) + x


class PreSelectBlock(nn.Module):
    """Queries cross-attend to image tokens (modeling_bert_new.py:377-412)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.image_condition = MaskedCrossAttention(dim, dim, out_dim, dim_head=32, heads=8)
        self.res_mapping = nn.Linear(dim, out_dim, bias=False) if dim != out_dim else None
        self.ff = GCPFeedForward(out_dim, mult=4.0)

    def forward(self, vision, image):
        attended = self.image_condition(vision, image)
        res = self.res_mapping(vision) if self.res_mapping is not None else vision
        vision = attended + res
        return self.ff(vision) + vision


class PreSelectModule(nn.Module):
    def __init__(self, dim: int, out_dim: int, num_layers: int = 2, vision_scale: float = 1.0):
        super().__init__()
        self.vision_scale = vision_scale
        self.layers = nn.ModuleList(
            PreSelectBlock(dim, out_dim if i == num_layers - 1 else dim) for i in range(num_layers)
        )

    def forward(self, vision, image):
        vision = vision * self.vision_scale
        image = image * self.vision_scale
        for layer in self.layers:
            vision = layer(vision, image)
        return vision


class BertSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)

    def forward(self, x, attn_bias):
        b, t, c = x.shape
        h = self.heads
        d = c // h
        q = self.query(x).reshape(b, t, h, d).transpose(1, 2)
        k = self.key(x).reshape(b, t, h, d).transpose(1, 2)
        v = self.value(x).reshape(b, t, h, d).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / d**0.5 + attn_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, t, c)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int, ln: bool):
        super().__init__()
        self.dense = nn.Linear(cin, cout)
        if ln:
            self.LayerNorm = LayerNorm(cout, eps=1e-12)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.self = BertSelfAttention(hidden, heads)
        self.output = _Dense(hidden, hidden, ln=True)


class BertLayer(nn.Module):
    def __init__(self, hidden: int = 768, heads: int = 12, intermediate: int = 3072):
        super().__init__()
        self.attention = _Attention(hidden, heads)
        self.intermediate = _Dense(hidden, intermediate, ln=False)
        self.output = _Dense(intermediate, hidden, ln=True)

    def forward(self, x, attn_bias):
        a = self.attention.output.dense(self.attention.self(x, attn_bias))
        x = self.attention.output.LayerNorm(x + a)
        inter = F.gelu(self.intermediate.dense(x), approximate="none")
        return self.output.LayerNorm(x + self.output.dense(inter))


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, hidden: int, max_position: int = 512, type_vocab: int = 2):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, hidden)
        self.position_embeddings = nn.Embedding(max_position, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden)
        self.LayerNorm = LayerNorm(hidden, eps=1e-12)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        return self.LayerNorm(x)


class _Encoder(nn.Module):
    def __init__(self, cfg_lb, num_qv: int, vision_hidden: int):
        super().__init__()
        hid = cfg_lb.HIDDEN_SIZE
        self.layer = nn.ModuleList(
            BertLayer(hid, cfg_lb.NUM_HEADS, cfg_lb.INTERMEDIATE_SIZE)
            for _ in range(cfg_lb.HIDDEN_LAYERS)
        )
        self.qv_layer = nn.ModuleList(
            GatedCrossAttentionBlock(hid, vision_hidden) for _ in range(num_qv)
        )


class QVBertModel(nn.Module):
    """BERT with a GCP block before every layer >= start_qv_layer; the vision
    queries are first conditioned on the image by the PreSelect module.
    `vision_dim` is the width of the queries and image tokens
    (MODEL.BACKBONE.OUT_CHANNELS unless given)."""

    def __init__(self, cfg, vision_dim: Optional[int] = None):
        super().__init__()
        lb = cfg.MODEL.LANGUAGE_BACKBONE
        vq = cfg.VISION_QUERY
        self.start_qv_layer = vq.START_QV_LAYER
        self.embeddings = BertEmbeddings(lb.VOCAB_SIZE, lb.HIDDEN_SIZE)
        self.encoder = _Encoder(lb, lb.HIDDEN_LAYERS - vq.START_QV_LAYER, lb.HIDDEN_SIZE)
        self.pre_select = PreSelectModule(
            vision_dim or cfg.MODEL.BACKBONE.OUT_CHANNELS, lb.HIDDEN_SIZE,
            vq.NUM_PRE_SELECT_LAYERS, vq.VISION_SCALE,
        )

    def forward(self, input_ids, attention_mask, queries=None, query_mask=None,
                image_tokens=None, attention_matrix=None, position_ids=None) -> Dict[str, torch.Tensor]:
        """attention_matrix (B, T, T) bool, GroundingDINO's sub-sentence
        blocks, is then the attention mask ALONE (padding tokens are already
        self-only blocks); position_ids (B, T) restart in each block."""
        x = self.embeddings(input_ids, position_ids)
        if attention_matrix is not None:
            attn_bias = (1.0 - attention_matrix[:, None].float()) * -10000.0
        else:
            attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        vision = None
        if queries is not None:
            vision = (
                self.pre_select(queries, image_tokens) if image_tokens is not None else queries
            )
        hidden_states = []
        for i, layer in enumerate(self.encoder.layer):
            if vision is not None and i >= self.start_qv_layer:
                x = self.encoder.qv_layer[i - self.start_qv_layer](x, vision, query_mask)
            x = layer(x, attn_bias)
            hidden_states.append(x)
        return {"last_hidden": x, "hidden_states": hidden_states, "augmented_vision": vision}


class _Body(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.model = QVBertModel(cfg)


class LanguageBackbone(nn.Module):
    """The BertEncoder wrapper: aggregate / embedded / masks / hidden."""

    def __init__(self, cfg):
        super().__init__()
        self.n_agg = cfg.MODEL.LANGUAGE_BACKBONE.N_LAYERS
        self.body = _Body(cfg)

    def forward(self, input_ids, attention_mask, queries=None, query_mask=None, image_tokens=None):
        out = self.body.model(input_ids, attention_mask, queries, query_mask, image_tokens)
        n = self.n_agg
        features = torch.stack(out["hidden_states"][-n:], dim=1).mean(dim=1) / n
        embedded = features * attention_mask[..., None].to(features.dtype)
        aggregate = embedded.sum(1) / attention_mask.sum(-1, keepdim=True).to(features.dtype)
        return {
            "aggregate": aggregate,
            "embedded": embedded,
            "masks": attention_mask,
            "hidden": out["hidden_states"][-1],
            "augmented_vision": out["augmented_vision"],
        }
