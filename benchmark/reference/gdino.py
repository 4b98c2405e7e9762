"""The reference MQ-GroundingDINO: Swin-T, the input projections, GCP-BERT
with GroundingDINO's sub-sentence attention, 6 encoder layers (bi-attention
fusion, text enhancer, deformable self-attention), the two-stage proposals
and 6 decoder layers with iterative box refinement (Liu et al. 2023,
Grounding DINO; Zhu et al. 2021, Deformable DETR), in plain float32
PyTorch. Module names are the released checkpoints'.

The encoder's deformable attention clamps each sample to its query's window
(`ops.msda_windows`), the configuration's stated MSDA; the decoder's samples
are free. `proposals` runs the towers, the encoder and the two-stage heads;
`decode` runs the decoder on given proposals in a given slot order (the
program's selection, which the comparison checks on its own, or the
reference's own, `top_queries`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.glip import BiAttentionBlock, Norm
from benchmark.reference.towers import Conv2d, LayerNorm, Linear, QVBert, Swin, group_norm

SPECIAL_IDS = (101, 102, 1012, 1029)


def sub_sentence(ids):
    """(B, T) ids -> (attention (B, T, T) bool, position ids (B, T)): each
    interior special token ends a block (previous special, this special];
    a block's tokens see each other and count positions from 0; every other
    token (the ends, padding, position 0) sees only itself at position 0."""
    b, t = ids.shape
    special = torch.zeros_like(ids, dtype=torch.bool)
    for s in SPECIAL_IDS:
        special |= ids == s
    attn = torch.eye(t, dtype=torch.bool, device=ids.device).repeat(b, 1, 1)
    pos = torch.zeros_like(ids)
    for i in range(b):
        marks = [j for j in range(1, t - 1) if bool(special[i, j])]
        prev = 0
        for m in marks:
            lo = prev + 1
            attn[i, lo:m + 1, lo:m + 1] = True
            pos[i, lo:m + 1] = torch.arange(m + 1 - lo, device=ids.device)
            prev = m
    return attn, pos


def _sin_cos(p):
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2)


def _dim_t(n, temperature, device):
    d = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(d, 2, rounding_mode="floor") / n)


def sine_2d(h, w, n, device):
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w) / (h + 1e-6) * 2 * math.pi
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w) / (w + 1e-6) * 2 * math.pi
    d = _dim_t(n, 20, device)
    return torch.cat([_sin_cos(y[..., None] / d), _sin_cos(x[..., None] / d)], -1)


def sine_boxes(boxes):
    d = _dim_t(128, 10000, boxes.device)
    emb = lambda v: _sin_cos(v[..., None] * 2 * math.pi / d)  # noqa: E731
    return torch.cat([emb(boxes[..., 1]), emb(boxes[..., 0]), emb(boxes[..., 2]), emb(boxes[..., 3])], -1)


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class MLP(nn.Module):
    def __init__(self, cin, hidden, out, n):
        super().__init__()
        dims = [cin] + [hidden] * (n - 1)
        self.layers = nn.ModuleList(Linear(d, hidden if i < n - 1 else out) for i, d in enumerate(dims))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class Attention(nn.Module):
    """Multi-head attention with one packed input projection (3C, C)."""

    def __init__(self, c, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = Linear(c, c)

    def forward(self, q, k, v, keep=None):
        b, tq, c = q.shape
        h, d = self.heads, c // self.heads
        w, bias = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        qh, kh, vh = (ops.linear(x, w[i], bias[i]).reshape(b, -1, h, d).transpose(1, 2) for i, x in enumerate((q, k, v)))
        s = ops.matmul(qh, kh.transpose(-1, -2)) / d**0.5
        if keep is not None:
            s = s.masked_fill(~keep[:, None], -1e9)
        return self.out_proj(ops.matmul(torch.softmax(s, -1), vh).transpose(1, 2).reshape(b, tq, c))


class MSDeformAttn(nn.Module):
    def __init__(self, c, heads, levels, points):
        super().__init__()
        self.h, self.l, self.p = heads, levels, points
        self.value_proj, self.output_proj = Linear(c, c), Linear(c, c)
        self.sampling_offsets = Linear(c, heads * levels * points * 2)
        self.attention_weights = Linear(c, heads * levels * points)

    def forward(self, query, value, ref, shapes, windows=None):
        b, nq, c = query.shape
        v = self.value_proj(value).reshape(b, -1, self.h, c // self.h)
        off = self.sampling_offsets(query).reshape(b, nq, self.h, self.l, self.p, 2)
        wt = torch.softmax(self.attention_weights(query).reshape(b, nq, self.h, -1), -1)
        wt = wt.reshape(b, nq, self.h, self.l, self.p)
        r = ref[:, :, None, :, None, :]
        if ref.shape[-1] == 2:
            wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=query.device)
            loc = r + off / wh[None, None, None, :, None, :]
        else:
            loc = r[..., :2] + off / self.p * r[..., 2:] * 0.5
        return self.output_proj(ops.ms_deform_attn(v, shapes, loc, wt, windows))


class _FFN(nn.Module):
    def __init__(self, c, ffn):
        super().__init__()
        self.linear1, self.linear2 = Linear(c, ffn), Linear(ffn, c)
        self.norm1, self.norm2 = LayerNorm(c, eps=1e-5), LayerNorm(c, eps=1e-5)

    def ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class TextLayer(_FFN):
    def __init__(self, c, heads, ffn):
        super().__init__(c, ffn)
        self.self_attn = Attention(c, heads)

    def forward(self, text, attn, pos):
        qk = text + pos
        text = self.norm1(text + self.self_attn(qk, qk, text, attn))
        return self.norm2(text + self.ffn(text))


class EncoderLayer(_FFN):
    def __init__(self, c, ffn, heads, levels, points):
        super().__init__(c, ffn)
        self.self_attn = MSDeformAttn(c, heads, levels, points)

    def forward(self, src, pos, ref, shapes, windows):
        src = self.norm1(src + self.self_attn(src + pos, src, ref, shapes, windows))
        return self.norm2(src + self.ffn(src))


class DecoderLayer(_FFN):
    def __init__(self, c, ffn, heads, levels, points):
        super().__init__(c, ffn)
        self.self_attn, self.ca_text = Attention(c, heads), Attention(c, heads)
        self.cross_attn = MSDeformAttn(c, heads, levels, points)
        self.norm3, self.catext_norm = LayerNorm(c, eps=1e-5), LayerNorm(c, eps=1e-5)

    def forward(self, tgt, qpos, ref, memory, shapes, text, text_mask):
        qk = tgt + qpos
        tgt = self.norm2(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.catext_norm(tgt + self.ca_text(tgt + qpos, text, text, (text_mask > 0)[:, None, :]))
        tgt = self.norm1(tgt + self.cross_attn(tgt + qpos, memory, ref, shapes))
        return self.norm3(tgt + self.ffn(tgt))


class _Encoder(nn.Module):
    def __init__(self, s):
        super().__init__()
        c, ffn, h, nl = s["channels"], s["ffn"], s["nheads"], s["levels"]
        self.layers = nn.ModuleList(EncoderLayer(c, ffn, h, nl, s["points"]) for _ in range(s["enc_layers"]))
        self.text_layers = nn.ModuleList(TextLayer(c, h // 2, ffn // 2) for _ in range(s["enc_layers"]))
        self.fusion_layers = nn.ModuleList(BiAttentionBlock(c, c, ffn // 2, h // 2) for _ in range(s["enc_layers"]))


class _Decoder(nn.Module):
    def __init__(self, s):
        super().__init__()
        c = s["channels"]
        self.layers = nn.ModuleList(
            DecoderLayer(c, s["ffn"], s["nheads"], s["levels"], s["points"]) for _ in range(s["dec_layers"]))
        self.norm = LayerNorm(c, eps=1e-5)
        self.ref_point_head = MLP(512, c, c, 2)  # on the 4 x 128 sine box embedding


class _Transformer(nn.Module):
    def __init__(self, s):
        super().__init__()
        c = s["channels"]
        self.level_embed = nn.Parameter(torch.zeros(s["levels"], c))
        self.encoder, self.decoder = _Encoder(s), _Decoder(s)
        self.tgt_embed = nn.Embedding(s["num_queries"], c)
        self.enc_output = Linear(c, c)
        self.enc_output_norm = LayerNorm(c, eps=1e-5)
        self.enc_out_bbox_embed = MLP(c, c, 4, 3)


class _Proj(nn.Module):
    """A projection conv and its GroupNorm (32 groups, fewer for fewer channels), as modules "0" and "1"."""

    def __init__(self, conv, c):
        super().__init__()
        self.add_module("0", conv)
        self.add_module("1", Norm(c))

    def forward(self, x):
        norm = getattr(self, "1")
        return group_norm(getattr(self, "0")(x), min(32, norm.weight.shape[0]), norm.weight, norm.bias)


def contrastive(queries, text, text_mask):
    res = ops.matmul(queries, text.transpose(1, 2))
    return res.masked_fill(~(text_mask[:, None, :] > 0), float("-inf"))


class MQGroundingDINO(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.s = s
        c, e = s["channels"], s["swin_dim"]
        self.backbone = nn.ModuleList([Swin(e, s["swin_depths"], s["swin_heads"], s["swin_window"])])
        cin = [2 * e, 4 * e, 8 * e, 8 * e]
        self.input_proj = nn.ModuleList(
            _Proj(Conv2d(cin[i], c, 1) if i < 3 else Conv2d(cin[i], c, 3, 2, 1), c) for i in range(s["levels"]))
        self.bert = QVBert(s, c)
        self.feat_map = Linear(s["hidden"], c)
        self.transformer = _Transformer(s)
        self.bbox_embed = nn.ModuleList(MLP(c, c, 4, 3) for _ in range(s["dec_layers"]))

    def encode_image(self, images):
        feats = self.backbone[0](images)[1:4]
        return [proj(f) for proj, f in zip(self.input_proj, feats + feats[-1:])]

    def proposals(self, srcs, ids, mask, queries, query_mask):
        """The encoder and the two-stage heads: (memory, text, shapes, the
        proposals' scores (B, S) and unsigmoided boxes (B, S, 4))."""
        tr = self.transformer
        b = ids.shape[0]
        c = tr.level_embed.shape[1]
        shapes = [(int(x.shape[2]), int(x.shape[3])) for x in srcs]
        pooled = [F.avg_pool2d(x, 2, 2) for x in srcs]
        image_tokens = torch.cat([p.flatten(2).transpose(1, 2) for p in pooled], 1).expand(b, -1, -1)
        attn, pos_ids = sub_sentence(ids)
        hidden = self.bert(ids, mask, queries.float(), query_mask, image_tokens, attn, pos_ids)
        text = self.feat_map(hidden)
        dev = ids.device
        memory = torch.cat([x.flatten(2).transpose(1, 2) for x in srcs], 1).expand(b, -1, -1)
        pos = torch.cat([(sine_2d(h, w, c // 2, dev) + tr.level_embed[i]).reshape(1, h * w, c)
                         for i, (h, w) in enumerate(shapes)], 1)
        grid = torch.cat([torch.stack(torch.meshgrid((torch.arange(h, device=dev) + 0.5) / h,
                                                     (torch.arange(w, device=dev) + 0.5) / w, indexing="ij")[::-1],
                                      -1).reshape(-1, 2) for h, w in shapes])
        ref = grid[None, :, None, :].expand(b, -1, len(shapes), 2)
        windows = ops.msda_windows(shapes, dev)
        pos_text = _sin_cos(pos_ids.float()[..., None] * 2 * math.pi / _dim_t(c, 10000, dev))
        enc = tr.encoder
        for fusion, tlayer, layer in zip(enc.fusion_layers, enc.text_layers, enc.layers):
            memory, text = fusion(memory, text, mask)
            text = tlayer(text, attn, pos_text)
            memory = layer(memory, pos, ref, shapes, windows)
        wh = torch.cat([torch.full((h * w, 2), 0.05 * 2.0**i, device=dev) for i, (h, w) in enumerate(shapes)])
        props = torch.cat([grid, wh], -1)
        valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        props = torch.where(valid, inverse_sigmoid(props), torch.full_like(props, float("inf")))
        out_mem = tr.enc_output_norm(tr.enc_output(memory.masked_fill(~valid[None], 0.0)))
        logits = contrastive(out_mem, text, mask)
        scores = logits.masked_fill(~torch.isfinite(logits), float("-inf")).amax(-1)
        boxes = tr.enc_out_bbox_embed(out_mem) + props[None]
        return memory, text, shapes, scores, boxes

    def decode(self, memory, text, mask, shapes, boxes, order):
        """The decoder on the proposals `order` (B, Q) in that slot order:
        (logits (B, Q, T), boxes (B, Q, 4) cxcywh)."""
        tr = self.transformer
        b, nq = order.shape
        ref = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).sigmoid()
        tgt = tr.tgt_embed.weight[:nq][None].expand(b, -1, -1)
        dec = tr.decoder
        for layer, head in zip(dec.layers, self.bbox_embed):
            qpos = dec.ref_point_head(sine_boxes(ref))
            tgt = layer(tgt, qpos, ref[:, :, None, :].expand(-1, -1, len(shapes), 4), memory, shapes, text, mask)
            normed = dec.norm(tgt)
            ref = torch.sigmoid(head(normed) + inverse_sigmoid(ref))
        return contrastive(normed, text, mask), ref


def top_queries(scores, n):
    """The reference's own selection: the n best proposals, ties to the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :n]


def class_scores(logits, agg_map):
    """(B, Q, C): the mean token probability over each class's tokens."""
    probs = torch.sigmoid(torch.where(torch.isfinite(logits), logits, torch.full_like(logits, -1e9)))
    return torch.einsum("bqt,blt->bql", probs[..., :agg_map.shape[-1]], agg_map.float())


def to_xyxy(boxes, image_hw):
    h, w = image_hw
    cx, cy, bw, bh = boxes.unbind(-1)
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
    return torch.minimum((xyxy * scale).clamp(min=0.0), scale - 1.0)
