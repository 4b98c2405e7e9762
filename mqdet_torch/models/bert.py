"""BERT language backbone with interleaved GCP gated cross-attention
(counterpart of `mqdet_tpu/models/bert.py`; reference
modeling/language_backbone/modeling_bert_new.py and bert_model_new.py).

Attribute names follow the reference torch tree, so that the state_dict keys
are those of the JAX package's rule table (`language_backbone.body.model.*`).
The query->token cross-attention is the JAX package's dense masked form:
additive -1e4 on masked logits, then masked probabilities zeroed, so a token
with no query receives exactly zero and its gated residual is the identity.
Eval only: dropout is the identity. With `remat` (`TPU.REMAT`, as the JAX
package's `bert.py`) each of the encoder's BertLayers is one checkpointed
segment (`layers.remat`) wherever autograd records the forward.

The Gated Class-scalable Perceiver's switches are the JAX module's
(`VISION_QUERY.*`, read by `gcp_options`): CONDITION_GATE, NONLINEAR_GATE,
NO_CAT, FIX_ATTN_GATE, ADD_ADAPT_LAYER, SHARE_KV in every GCP block,
AUGMENT_IMAGE_WITH_QUERY in the PreSelect module, NEW_MASK_TOKEN in the
embeddings. Gate telemetry (VISION_QUERY.RETURN_ATTN_GATE_VALUE, the JAX
blocks' `sow`): inside `with gate_telemetry() as values:` every GCP block
appends its mean |attn_gate| in fp32 to `values`; outside it nothing is
recorded and nothing is computed.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.models.layers import GCPFeedForward, LayerNorm, remat

MASK_FILL = -1e4
MASK_TOKEN_ID = 103  # bert-base-uncased [MASK]

_TELEMETRY: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def gate_telemetry():
    """Collect every GCP block's mean |attn_gate| (a 0-d fp32 tensor each,
    in call order) while the context is open."""
    global _TELEMETRY
    outer, _TELEMETRY = _TELEMETRY, []
    try:
        yield _TELEMETRY
    finally:
        _TELEMETRY = outer


def gcp_options(vq) -> Dict[str, object]:
    """The GCP block switches of a VISION_QUERY config node."""
    return dict(condition_gate=bool(vq.CONDITION_GATE), nonlinear_gate=bool(vq.NONLINEAR_GATE),
                no_cat=bool(vq.NO_CAT), fix_attn_gate=float(vq.FIX_ATTN_GATE),
                add_adapt_layer=bool(vq.ADD_ADAPT_LAYER), share_kv=bool(vq.SHARE_KV))


class MaskedCrossAttention(nn.Module):
    """Text tokens (B, T, D) attend to vision tokens (B, V, Dv); mask (B, V, T)
    is 1 where vision token v may be attended by text token t."""

    def __init__(self, input_dim, vision_dim, output_dim=None, dim_head=64, heads=8, share_kv=False):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.share_kv = heads, dim_head, share_kv
        self.norm = LayerNorm(input_dim, eps=1e-5)
        self.norm_kv = LayerNorm(vision_dim, eps=1e-5)
        self.to_q = nn.Linear(input_dim, inner, bias=False)
        # SHARE_KV: one projection of width `inner` gives both keys and values
        self.to_kv = nn.Linear(vision_dim, inner if share_kv else inner * 2, bias=False)
        self.to_out = nn.Linear(inner, output_dim or input_dim, bias=False)

    def forward(self, x, vision, attention_mask=None):
        h, d = self.heads, self.dim_head
        x = self.norm(x)
        vision = self.norm_kv(vision)
        b, t, _ = x.shape
        vlen = vision.shape[1]
        q = self.to_q(x).reshape(b, t, h, d).transpose(1, 2) * d**-0.5
        kv = self.to_kv(vision)
        k, v = (kv, kv) if self.share_kv else kv.chunk(2, dim=-1)
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
    """GCP block (modeling_bert_new.py:251-374):
        queries <- adaptor(queries) + queries          (ADD_ADAPT_LAYER)
        x <- attn(x, queries) * tanh(gate) + x
        x <- ff(x) * tanh(ff_gate) + x                 (enable_ffn)
    The gate is, by the switches: FIX_ATTN_GATE != -1, that constant for both
    gates and no gate parameter; CONDITION_GATE off, one 0-d learned
    `attn_gate` (the reference's 1-element tensor here); else conditioned on
    the attention output (with NO_CAT off, on [attn_out, x]) by a GCP
    FeedForward to 1 (NONLINEAR_GATE) or a bias-free Linear to 1."""

    def __init__(self, dim: int, vision_dim: int, condition_gate: bool = True, nonlinear_gate: bool = True,
                 no_cat: bool = True, fix_attn_gate: float = -1.0, add_adapt_layer: bool = False,
                 share_kv: bool = False, enable_ffn: bool = True):
        super().__init__()
        self.condition_gate, self.nonlinear_gate, self.no_cat = condition_gate, nonlinear_gate, no_cat
        self.fix_attn_gate = fix_attn_gate
        self.fixed = fix_attn_gate != -1.0
        self.adaptor = GCPFeedForward(vision_dim, mult=2.0) if add_adapt_layer else None
        self.attn = MaskedCrossAttention(dim, vision_dim, share_kv=share_kv)
        if self.fixed:
            self.attn_gate = None
        elif not condition_gate:
            self.attn_gate = nn.Parameter(torch.zeros(1))
        elif nonlinear_gate:
            self.attn_gate = GCPFeedForward(dim if no_cat else 2 * dim, mult=0.5, out_dim=1)
        else:
            self.attn_gate = nn.Linear(dim, 1, bias=False)
        self.enable_ffn = enable_ffn
        if enable_ffn:
            self.ff = GCPFeedForward(dim, mult=4.0)
            self.ff_gate = None if self.fixed else nn.Parameter(torch.zeros(1))

    def _gate(self, supported, x):
        if self.fixed:  # a fill on the device: a host tensor copied per call would synchronise the stream
            return x.new_full((), self.fix_attn_gate)
        if not self.condition_gate:
            return torch.tanh(self.attn_gate.reshape(())).to(x.dtype)
        gate_in = supported if (self.no_cat or not self.nonlinear_gate) else torch.cat([supported, x], -1)
        return torch.tanh(self.attn_gate(gate_in))

    def forward(self, x, vision, attention_mask=None):
        if self.adaptor is not None:
            vision = self.adaptor(vision) + vision
        supported = self.attn(x, vision, attention_mask)
        attn_gate = self._gate(supported, x)
        if _TELEMETRY is not None:
            _TELEMETRY.append(attn_gate.float().abs().mean())
        x = supported * attn_gate + x
        if not self.enable_ffn:
            return x
        y = self.ff(x)
        if self.fixed:
            return y * x.new_full((), self.fix_attn_gate) + x
        return y * torch.tanh(self.ff_gate).to(x.dtype) + x


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
    """Condition the bank's queries on this image (modeling_bert_new.py:414-448).
    With AUGMENT_IMAGE_WITH_QUERY the first block runs with the roles
    swapped (image tokens attend to the queries) and the later blocks
    condition the queries on the augmented image."""

    def __init__(self, dim: int, out_dim: int, num_layers: int = 2, vision_scale: float = 1.0,
                 augment_image_with_query: bool = False):
        super().__init__()
        if augment_image_with_query and num_layers < 2:
            raise ValueError("AUGMENT_IMAGE_WITH_QUERY needs NUM_PRE_SELECT_LAYERS > 1")
        self.vision_scale = vision_scale
        self.augment_image_with_query = augment_image_with_query
        self.layers = nn.ModuleList(
            PreSelectBlock(dim, out_dim if i == num_layers - 1 else dim) for i in range(num_layers)
        )

    def forward(self, vision, image):
        vision = vision * self.vision_scale
        image = image * self.vision_scale
        layers = list(self.layers)
        if self.augment_image_with_query:
            image = layers.pop(0)(image, vision)
        for layer in layers:
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
    def __init__(self, cfg_lb, num_qv: int, vision_hidden: int, gcp: Dict[str, object]):
        super().__init__()
        hid = cfg_lb.HIDDEN_SIZE
        self.layer = nn.ModuleList(
            BertLayer(hid, cfg_lb.NUM_HEADS, cfg_lb.INTERMEDIATE_SIZE)
            for _ in range(cfg_lb.HIDDEN_LAYERS)
        )
        self.qv_layer = nn.ModuleList(
            GatedCrossAttentionBlock(hid, vision_hidden, **gcp) for _ in range(num_qv)
        )


class QVBertModel(nn.Module):
    """BERT with a GCP block before every layer >= start_qv_layer; the vision
    queries are first conditioned on the image by the PreSelect module.
    `vision_dim` is the width of the queries and image tokens
    (MODEL.BACKBONE.OUT_CHANNELS unless given). With NEW_MASK_TOKEN a learned
    `mask_token` (normal(0.02) at construction) replaces the embeddings of
    the [MASK] id."""

    def __init__(self, cfg, vision_dim: Optional[int] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        lb = cfg.MODEL.LANGUAGE_BACKBONE
        vq = cfg.VISION_QUERY
        self.start_qv_layer = vq.START_QV_LAYER
        self.embeddings = BertEmbeddings(lb.VOCAB_SIZE, lb.HIDDEN_SIZE)
        self.encoder = _Encoder(lb, lb.HIDDEN_LAYERS - vq.START_QV_LAYER, lb.HIDDEN_SIZE, gcp_options(vq))
        self.pre_select = PreSelectModule(
            vision_dim or cfg.MODEL.BACKBONE.OUT_CHANNELS, lb.HIDDEN_SIZE,
            vq.NUM_PRE_SELECT_LAYERS, vq.VISION_SCALE, bool(vq.AUGMENT_IMAGE_WITH_QUERY),
        )
        self.mask_token = nn.Parameter(torch.randn(lb.HIDDEN_SIZE) * 0.02) if vq.NEW_MASK_TOKEN else None

    def forward(self, input_ids, attention_mask, queries=None, query_mask=None,
                image_tokens=None, attention_matrix=None, position_ids=None) -> Dict[str, torch.Tensor]:
        """attention_matrix (B, T, T) bool, GroundingDINO's sub-sentence
        blocks, is then the attention mask ALONE (padding tokens are already
        self-only blocks); position_ids (B, T) restart in each block."""
        x = self.embeddings(input_ids, position_ids)
        if self.mask_token is not None:
            x = torch.where((input_ids == MASK_TOKEN_ID)[..., None], self.mask_token.to(x.dtype), x)
        if attention_matrix is not None:
            attn_bias = (1.0 - attention_matrix[:, None].float()) * -10000.0
        else:
            attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
        vision = augmented = None
        if queries is not None and image_tokens is not None:
            vision = augmented = self.pre_select(queries, image_tokens)
        elif queries is not None:
            vision = queries
        hidden_states = []
        for i, layer in enumerate(self.encoder.layer):
            if vision is not None and i >= self.start_qv_layer:
                x = self.encoder.qv_layer[i - self.start_qv_layer](x, vision, query_mask)
            x = remat(layer, x, attn_bias, enabled=self.remat)
            hidden_states.append(x)
        return {"last_hidden": x, "hidden_states": hidden_states, "augmented_vision": augmented}


class MLMHead(nn.Module):
    """BertLMPredictionHead (utils/fuse_helper.py:27-44), used under
    MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS: dense, exact GELU, LayerNorm (eps
    1e-12), then the vocabulary decoder, whose bias is the reference's tied
    `mlm_head.bias`."""

    def __init__(self, hidden: int, vocab: int):
        super().__init__()
        self.transform = _Dense(hidden, hidden, ln=True)
        self.decoder = nn.Linear(hidden, vocab, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab))

    def forward(self, x):
        x = self.transform.LayerNorm(F.gelu(self.transform.dense(x), approximate="none"))
        return self.decoder(x) + self.bias.to(x.dtype)


class _Body(nn.Module):
    def __init__(self, cfg, remat: bool = False):
        super().__init__()
        self.model = QVBertModel(cfg, remat=remat)


class LanguageBackbone(nn.Module):
    """The BertEncoder wrapper: aggregate / embedded / masks / hidden."""

    def __init__(self, cfg, remat: bool = False):
        super().__init__()
        self.n_agg = cfg.MODEL.LANGUAGE_BACKBONE.N_LAYERS
        self.body = _Body(cfg, remat)

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
