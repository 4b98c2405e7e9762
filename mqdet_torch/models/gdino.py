"""MQ-GroundingDINO (counterpart of `mqdet_tpu/models/gdino.py`; reference
groundingdino_new/models/GroundingDINO/).

Swin -> input_proj -> GCP-BERT text tower with sub-sentence masks -> 6
encoder layers (bi-attention fusion, text enhancer, deformable
self-attention) -> two-stage top-k proposals -> 6 decoder layers
(self-attention, text cross-attention, deformable cross-attention) with
iterative box refinement. `encode_image` runs once per image,
`forward_head` once per group of prompt chunks.

Module names follow the reference torch tree (`backbone.0`, `bert`,
`feat_map`, `input_proj.{i}.{0,1}`, `transformer.{encoder,decoder}...`,
`bbox_embed.{i}.layers.{j}`), so the state_dict keys are those of the JAX
package's GroundingDINO rule table; the text and decoder attentions hold a
torch `in_proj_weight` (3C, C) and `in_proj_bias` as `nn.MultiheadAttention`
does. Their attention is plain matmul and softmax. MSDA goes through
`ops.ms_deform_attn` and the fusion through `ops.bi_attention`.

Images are NCHW. The compute dtype is the parameters' dtype; sampling
locations, attention weights, reference boxes and logits stay fp32, as in
the JAX package.

`deterministic` is the JAX package's switch, with `mq_glip.py`'s rule: False
runs the training forward, Swin's stochastic depth (the JAX model's default
rate, `SWIN_DROP_PATH`) and each encoder fusion's composite with attention
dropout, drawing from `generator` (required then); True (the default) runs
neither. The text enhancer, the deformable layers and the decoder have no
dropout, as in JAX. The decoder's box chain stops gradients where JAX does:
at the two-stage reference and at each layer's refined reference.

GROUNDINGDINO.num_feature_levels is 4 (the configs') or 3 (no stride-64
level: three `input_proj` pairs, a 3-row `level_embed`, MSDA over 3
levels), as JAX builds `min(levels, 4)` projections; other counts raise,
where JAX fails. GROUNDINGDINO.two_stage_type, dn_number and query_dim are
read by nothing in JAX, which builds the same model whatever they say; so
does this model.

`TPU.REMAT` (and the USE_CHECKPOINT keys) are ignored: JAX's
`models/gdino.py` checkpoints nothing, so neither does this model. So are
MODEL.LANGUAGE_BACKBONE.MODEL_TYPE and MODEL.SWINT.VERSION: JAX's
`from_config` and `setup` read neither and always build BERT and Swin v1,
and so does this model.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mqdet_torch.core.detections import Detections
from mqdet_torch.models.bert import QVBertModel
from mqdet_torch.models.fusion import BiAttentionBlock
from mqdet_torch.models.layers import GroupNorm, LayerNorm, avg_pool_2x, cl, training_draws
from mqdet_torch.models.swin import SwinTransformer
from mqdet_torch.ops.ms_deform_attn import ms_deform_attn

SPECIAL_IDS = (101, 102, 1012, 1029)  # [CLS] [SEP] . ?
SWIN_DROP_PATH = 0.2  # the JAX model builds its SwinTransformer with the class default (no config key)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _sin_cos(p: torch.Tensor) -> torch.Tensor:
    """(..., D) phases -> (..., D): sin of the even entries interleaved with
    cos of the odd ones."""
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2)


def _dim_t(n: int, temperature: float, device) -> torch.Tensor:
    d = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(d, 2, rounding_mode="floor") / n)


def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int = 128, temperature: float = 20,
                      device=None) -> torch.Tensor:
    """PositionEmbeddingSineHW, normalised over the whole map -> (H, W, 2F)."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, device)
    return torch.cat([_sin_cos(y[..., None] / dim_t), _sin_cos(x[..., None] / dim_t)], -1)


def sine_embed_1d(pos: torch.Tensor, num_pos_feats: int = 256, temperature: float = 10000) -> torch.Tensor:
    """get_sine_pos_embed of scalar positions: (...) -> (..., F)."""
    return _sin_cos(pos[..., None] * (2 * math.pi) / _dim_t(num_pos_feats, temperature, pos.device))


def gen_sineembed_for_position(pos: torch.Tensor) -> torch.Tensor:
    """(..., 2 or 4) boxes -> (..., 256 or 512): 128 features each of y, x
    (and w, h)."""
    dim_t = _dim_t(128, 10000, pos.device)

    def emb(v):
        return _sin_cos(v[..., None] * (2 * math.pi) / dim_t)

    parts = [emb(pos[..., 1]), emb(pos[..., 0])]
    if pos.shape[-1] == 4:
        parts += [emb(pos[..., 2]), emb(pos[..., 3])]
    return torch.cat(parts, -1)


def sub_sentence_masks(input_ids: torch.Tensor, special_ids: Sequence[int] = SPECIAL_IDS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) ids -> (attention (B, T, T) bool, position_ids (B, T)).

    Each interior special token (position 1 .. T-2) ends a block spanning
    (previous special, this special]; the block's tokens attend to each
    other and their position ids restart at 0. Specials at position 0 or
    T-1, position 0 itself and the tokens after the last interior special
    (padding) attend only to themselves, with position id 0."""
    b, t = input_ids.shape
    dev = input_ids.device
    special = torch.zeros_like(input_ids, dtype=torch.bool)
    for s in special_ids:
        special |= input_ids == s
    idx = torch.arange(t, device=dev)[None].expand(b, t)
    interior = special & (idx > 0) & (idx < t - 1)
    # the last special strictly before each position, -1 if none
    prev_incl = torch.cummax(torch.where(special, idx, torch.full_like(idx, -1)), dim=1).values
    prev_strict = torch.cat([torch.full((b, 1), -1, dtype=idx.dtype, device=dev), prev_incl[:, :-1]], 1)
    # the next interior special at or after each position (the block's end)
    big = t + 1
    nxt = torch.cummin(torch.where(interior, idx, torch.full_like(idx, big)).flip(1), dim=1).values.flip(1)
    member = (nxt < big) & ~(special & ~interior) & (idx > 0)
    block = torch.where(member, nxt, -idx - 1)  # a unique sentinel for each non-member
    attn = (block[:, :, None] == block[:, None, :]) | torch.eye(t, dtype=torch.bool, device=dev)[None]
    position_ids = torch.where(member, idx - prev_strict.clamp(min=0) - 1, torch.zeros_like(idx))
    return attn, position_ids


def contrastive_embed(queries: torch.Tensor, text: torch.Tensor, text_mask: torch.Tensor,
                      max_text_len: int = 256) -> torch.Tensor:
    """Query-token dot logits in fp32, -inf on masked tokens, padded with
    -inf to max_text_len: (B, Q, C), (B, T, C) -> (B, Q, max_text_len)."""
    res = torch.matmul(queries.float(), text.float().transpose(1, 2))
    res = res.masked_fill(~(text_mask[:, None, :] > 0), float("-inf"))
    t = res.shape[-1]
    if t < max_text_len:
        res = F.pad(res, (0, max_text_len - t), value=float("-inf"))
    return res


class MLP(nn.Module):
    """Linear layers with ReLU between them (reference `MLP`)."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(d, hidden if i < num_layers - 1 else out) for i, d in enumerate(dims)
        )

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MultiheadAttention(nn.Module):
    """Multi-head attention holding `nn.MultiheadAttention`'s parameters
    (`in_proj_weight` (3C, C), `in_proj_bias`, `out_proj`). Scores and
    softmax in fp32; `keep` (B, 1 or Tq, Tk) bool masks keys with -1e9."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(3 * dim, dim)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, keep: Optional[torch.Tensor] = None):
        b, tq, c = query.shape
        h = self.num_heads
        d = c // h
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)

        def split(x, w, bias):
            return F.linear(x, w, bias).reshape(b, -1, h, d).transpose(1, 2)

        q, k, v = split(query, w_q, b_q), split(key, w_k, b_k), split(value, w_v, b_v)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / d**0.5
        if keep is not None:
            scores = scores.masked_fill(~keep[:, None], -1e9)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, tq, c)
        return self.out_proj(out)


def level_wh(spatial_shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """(L, 2) level sizes (W, H) in fp32, filled on the device: a
    host-to-device copy of pageable memory would synchronise the stream."""
    return torch.cat([
        torch.full((1, 1), float(v), device=device) for h, w in spatial_shapes for v in (w, h)
    ]).reshape(-1, 2)


class MSDeformAttn(nn.Module):
    """Value projection, predicted sampling offsets and attention weights,
    the MSDA op, output projection."""

    def __init__(self, dim: int = 256, num_heads: int = 8, num_levels: int = 4, num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(dim, num_heads * num_levels * num_points)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query, value, reference_points, spatial_shapes: List[Tuple[int, int]],
                wh: Optional[torch.Tensor] = None):
        """query (B, Q, C); value (B, S, C); reference_points (B, Q, L, 2 or
        4) fp32 in [0, 1]; spatial_shapes [(H, W)] per level; wh their
        `level_wh`, made here if not given (2-d reference points only)."""
        b, q, c = query.shape
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).reshape(b, -1, nh, c // nh)
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, npt, 2).float()
        attn = self.attention_weights(query).reshape(b, q, nh, nl * npt).float()
        attn = torch.softmax(attn, dim=-1).reshape(b, q, nh, nl, npt)
        ref = reference_points[:, :, None, :, None, :]
        if reference_points.shape[-1] == 2:
            if wh is None:
                wh = level_wh(spatial_shapes, query.device)
            loc = ref + offsets / wh[None, None, None, :, None, :]
        else:
            loc = ref[..., :2] + offsets / npt * ref[..., 2:] * 0.5
        out = ms_deform_attn(v.contiguous(), spatial_shapes, loc.contiguous(), attn.contiguous())
        return self.output_proj(out.to(query.dtype))


class _FFNLayer(nn.Module):
    """norm1 and norm2 with linear1 -> ReLU -> linear2 between them."""

    def __init__(self, dim: int, ffn: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class TextEnhancerLayer(_FFNLayer):
    """Text self-attention within sub-sentence blocks, with sine position
    embeddings from the position ids, then an FFN (post-norm)."""

    def __init__(self, dim: int = 256, num_heads: int = 4, ffn: int = 1024):
        super().__init__(dim, ffn)
        self.self_attn = MultiheadAttention(dim, num_heads)

    def forward(self, text, attn_matrix, pos):
        qk = text + pos
        text = self.norm1(text + self.self_attn(qk, qk, text, attn_matrix))
        return self.norm2(text + self.ffn(text))


class FusionLayer(BiAttentionBlock):
    """Bi-attention between the image tokens and the text, layer scale 1e-4,
    residual on the normed inputs (the port's `BiAttentionBlock`)."""

    def __init__(self, dim: int = 256, embed_dim: int = 1024, num_heads: int = 4):
        super().__init__(dim, dim, embed_dim, num_heads, init_value=1e-4)


class DeformableEncoderLayer(_FFNLayer):
    def __init__(self, dim=256, ffn=2048, num_heads=8, num_levels=4, num_points=4):
        super().__init__(dim, ffn)
        self.self_attn = MSDeformAttn(dim, num_heads, num_levels, num_points)

    def forward(self, src, pos, reference_points, spatial_shapes, wh=None):
        src = self.norm1(src + self.self_attn(src + pos, src, reference_points, spatial_shapes, wh))
        return self.norm2(src + self.ffn(src))


class DecoderLayer(_FFNLayer):
    def __init__(self, dim=256, ffn=2048, num_heads=8, num_levels=4, num_points=4):
        super().__init__(dim, ffn)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.ca_text = MultiheadAttention(dim, num_heads)
        self.cross_attn = MSDeformAttn(dim, num_heads, num_levels, num_points)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.catext_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, memory, spatial_shapes, text, text_mask):
        qk = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(qk, qk, tgt))
        keep = (text_mask > 0)[:, None, :]
        tgt = self.catext_norm(tgt + self.ca_text(tgt + query_pos, text, text, keep))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, memory, reference_points, spatial_shapes))
        return self.norm3(tgt + self.ffn(tgt))


class _Encoder(nn.Module):
    def __init__(self, n_layers, dim, ffn, heads, levels, points):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(dim, ffn, heads, levels, points) for _ in range(n_layers)
        )
        # the text enhancer and the fusion halve the FFN width and the heads
        self.text_layers = nn.ModuleList(
            TextEnhancerLayer(dim, heads // 2, ffn // 2) for _ in range(n_layers)
        )
        self.fusion_layers = nn.ModuleList(
            FusionLayer(dim, ffn // 2, heads // 2) for _ in range(n_layers)
        )


class _Decoder(nn.Module):
    def __init__(self, n_layers, dim, ffn, heads, levels, points):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(dim, ffn, heads, levels, points) for _ in range(n_layers)
        )
        self.norm = LayerNorm(dim, eps=1e-5)
        self.ref_point_head = MLP(512, dim, dim, 2)  # on the 4 x 128 sine box embedding


class _Transformer(nn.Module):
    def __init__(self, g):
        super().__init__()
        c = g.hidden_dim
        args = (c, g.dim_feedforward, g.nheads, g.num_feature_levels)
        self.level_embed = nn.Parameter(torch.zeros(g.num_feature_levels, c))
        self.encoder = _Encoder(g.enc_layers, *args, g.enc_n_points)
        self.decoder = _Decoder(g.dec_layers, *args, g.dec_n_points)
        self.tgt_embed = nn.Embedding(g.num_queries, c)
        self.enc_output = nn.Linear(c, c)
        self.enc_output_norm = LayerNorm(c, eps=1e-5)
        self.enc_out_bbox_embed = MLP(c, c, 4, 3)


def _level_grid(h: int, w: int, device) -> torch.Tensor:
    """Cell centres of an (H, W) level, normalised, as (H*W, 2) (x, y)."""
    gy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    gx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    return torch.stack([gx[None, :].expand(h, w), gy[:, None].expand(h, w)], -1).reshape(-1, 2)


class MQGroundingDINO(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        g = cfg.GROUNDINGDINO
        sw = cfg.MODEL.SWINT
        if g.num_feature_levels not in (3, 4):
            raise ValueError(
                f"GROUNDINGDINO.num_feature_levels {g.num_feature_levels}: 3 or 4. The JAX package builds no "
                "other either: at 2 its encode_image indexes a third input_proj norm it did not make "
                "(IndexError), at 5 its deformable layers' offsets do not broadcast against the 4 maps it "
                "makes (TypeError)")
        c = g.hidden_dim
        self.num_queries = g.num_queries
        self.max_text_len = g.max_text_len
        self.special_ids = SPECIAL_IDS
        self.debug_outputs = False  # add encoder and two-stage intermediates to the outputs
        self.backbone = nn.ModuleList([
            SwinTransformer(sw.EMBED_DIM, tuple(sw.DEPTHS), tuple(sw.NUM_HEADS), sw.WINDOW_SIZE, sw.MLP_RATIO,
                            SWIN_DROP_PATH)
        ])
        e = sw.EMBED_DIM
        in_ch = [2 * e, 4 * e, 8 * e, 8 * e]
        self.input_proj = nn.ModuleList(
            nn.Sequential(
                nn.Conv2d(in_ch[i], c, 1) if i < 3 else nn.Conv2d(in_ch[i], c, 3, stride=2, padding=1),
                GroupNorm(min(32, c), c),  # flax's eps 1e-6, as the JAX package
            )
            for i in range(g.num_feature_levels)
        )
        self.bert = QVBertModel(cfg, vision_dim=c)
        self.feat_map = nn.Linear(cfg.MODEL.LANGUAGE_BACKBONE.HIDDEN_SIZE, c)
        self.transformer = _Transformer(g)
        self.bbox_embed = nn.ModuleList(MLP(c, c, 4, 3) for _ in range(g.dec_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.level_embed.dtype

    def encode_image(self, images: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """Swin stages 1..3 + input_proj on (B, 3, H, W) -> num_feature_levels
        levels (B, C, H_l, W_l) at strides 8, 16, 32 (and 64: a stride-2
        conv over the last stage)."""
        feats = self.backbone[0](cl(images.to(self.dtype)), training_draws(deterministic, generator))[1:4]
        return [proj(cl(f)) for proj, f in zip(self.input_proj, feats + feats[-1:])]

    def forward_head(
        self,
        srcs: List[torch.Tensor],
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        queries: Optional[torch.Tensor] = None,
        query_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Text tower, encoder, two-stage selection, decoder and per-layer
        heads. srcs may have batch 1 while the text has batch CP (chunk
        parallelism): the levels are broadcast to the text batch."""
        draws = training_draws(deterministic, generator)
        b = input_ids.shape[0]
        dt = self.dtype
        dev = input_ids.device
        tr = self.transformer
        c = tr.level_embed.shape[1]
        shapes = [(int(s.shape[2]), int(s.shape[3])) for s in srcs]
        flat = [s.permute(0, 2, 3, 1).reshape(s.shape[0], -1, c).expand(b, -1, -1) for s in srcs]

        image_tokens = None
        if queries is not None:
            pooled = [avg_pool_2x(s) for s in srcs]
            image_tokens = torch.cat(
                [p.permute(0, 2, 3, 1).reshape(p.shape[0], -1, c).expand(b, -1, -1) for p in pooled], 1
            )
            queries = queries.to(dt)
        attn_matrix, position_ids = sub_sentence_masks(input_ids, self.special_ids)
        lang = self.bert(input_ids, attention_mask, queries, query_mask, image_tokens,
                         attention_matrix=attn_matrix, position_ids=position_ids)
        text = self.feat_map(lang["last_hidden"])
        text_mask = attention_mask

        memory = torch.cat(flat, 1)
        pos_embed = torch.cat([
            (sine_pos_embed_2d(h, w, c // 2, device=dev).to(dt) + tr.level_embed[lvl].to(dt)).reshape(1, h * w, c)
            for lvl, (h, w) in enumerate(shapes)
        ], 1)
        grid = torch.cat([_level_grid(h, w, dev) for h, w in shapes], 0)  # (S, 2)
        enc_ref = grid[None, :, None, :].expand(b, -1, len(shapes), 2)
        enc_wh = level_wh(shapes, dev)
        pos_text = sine_embed_1d(position_ids.float(), c).to(dt)

        for fusion, text_layer, layer in zip(tr.encoder.fusion_layers, tr.encoder.text_layers, tr.encoder.layers):
            memory, text = fusion(memory, text, text_mask, draws)
            text = text_layer(text, attn_matrix, pos_text)
            memory = layer(memory, pos_embed, enc_ref, shapes, enc_wh)

        # two-stage proposals: one box per pyramid cell; cells with any
        # coordinate outside (0.01, 0.99) are invalid, their memory zeroed
        wh = torch.cat([torch.full((h * w, 2), 0.05 * 2.0**lvl, device=dev) for lvl, (h, w) in enumerate(shapes)])
        proposals = torch.cat([grid, wh], -1)
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        proposals = torch.where(valid, inverse_sigmoid(proposals), torch.full_like(proposals, float("inf")))
        output_memory = tr.enc_output_norm(tr.enc_output(memory.masked_fill(~valid[None], 0.0)))
        enc_logits = contrastive_embed(output_memory, text, text_mask, self.max_text_len)
        enc_boxes_unsig = tr.enc_out_bbox_embed(output_memory).float() + proposals[None]

        # top-k as jax.lax.top_k: among equal scores the lower index first
        scores = enc_logits.masked_fill(~torch.isfinite(enc_logits), float("-inf")).amax(-1)
        topk_idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, : self.num_queries]
        # JAX stops the gradient at the selected proposals (gdino.py:654)
        init_ref = torch.gather(enc_boxes_unsig, 1, topk_idx[..., None].expand(-1, -1, 4)).detach().sigmoid()

        tgt = tr.tgt_embed.weight[None].to(dt).expand(b, -1, -1)
        reference = init_ref
        classes, coords = [], []
        dec = tr.decoder
        for layer, bbox_embed in zip(dec.layers, self.bbox_embed):
            ref_input = reference[:, :, None, :].expand(-1, -1, len(shapes), 4)
            query_pos = dec.ref_point_head(gen_sineembed_for_position(reference).to(dt))
            tgt = layer(tgt, query_pos, ref_input, memory, shapes, text, text_mask)
            normed = dec.norm(tgt)
            new_ref = torch.sigmoid(bbox_embed(normed).float() + inverse_sigmoid(reference))
            classes.append(contrastive_embed(normed, text, text_mask, self.max_text_len))
            coords.append(new_ref)
            reference = new_ref.detach()  # as JAX (gdino.py:686): no gradient through the next layer's reference

        out = {
            "pred_logits": classes[-1],   # (B, Q, max_text_len)
            "pred_boxes": coords[-1],     # (B, Q, 4) cxcywh in [0, 1]
            "aux_logits": classes[:-1],
            "aux_boxes": coords[:-1],
            "enc_logits": enc_logits,
            "enc_boxes": enc_boxes_unsig.sigmoid(),
            "lang": lang,
        }
        if self.debug_outputs:
            out.update(dbg_memory=memory, dbg_text=text, dbg_output_memory=output_memory,
                       dbg_topk_idx=topk_idx, dbg_init_ref=init_ref)
        return out

    def forward(self, images, input_ids, attention_mask, queries=None, query_mask=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        srcs = self.encode_image(images, deterministic, generator)
        return self.forward_head(srcs, input_ids, attention_mask, queries, query_mask, deterministic, generator)


def gdino_postprocess(pred_logits: torch.Tensor, pred_boxes: torch.Tensor, agg_map: torch.Tensor,
                      image_sizes: torch.Tensor, box_threshold: float = 0.05) -> Detections:
    """Sigmoid token probabilities -> per-class mean over the class's tokens
    (agg_map rows are normalised) -> top-1 class per query, valid above
    box_threshold; cxcywh -> xyxy scaled to the image size and clipped. No
    NMS: one slot per query."""
    logits = pred_logits.float()
    probs = torch.sigmoid(torch.where(torch.isfinite(logits), logits, torch.full_like(logits, -1e9)))
    probs = probs[..., : agg_map.shape[-1]]
    scores_cls = torch.einsum("bqt,blt->bql", probs, agg_map.float())
    best, lab = scores_cls.max(dim=-1)
    cx, cy, w, h = pred_boxes.float().unbind(-1)
    boxes = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)
    sizes = image_sizes.float()
    scale = torch.stack([sizes[:, 1], sizes[:, 0], sizes[:, 1], sizes[:, 0]], -1)[:, None, :]
    boxes = torch.minimum((boxes * scale).clamp(min=0.0), (scale - 1.0).clamp(min=0.0))
    return Detections(boxes=boxes, scores=best, labels=(lab + 1).to(torch.int32), valid=best > box_threshold)
