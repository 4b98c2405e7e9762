"""The benchmark's yardstick of work: the chip's peaks, and the least time
the protocol's kernel work needs, computed from shapes alone.

A kernel's bound is the larger of its flops over the bf16 peak and its
bytes over the memory bandwidth, each input byte read once and each output
byte written once, whatever a kernel reads again. The flops are those of
the products the operation needs: the DCN's (9 C, Cout) contraction, the
bi-attention's one score product and two value products (the l side
reuses the scores), the MSDA's bilinear blends (10 flops a channel a sample
point: 4 corner weights applied and summed, the attention weight and the
accumulation).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM, dense, at its 700 W limit (the data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def conv_out(n: int, stride: int) -> int:
    return -(-n // stride)


def glip_levels(image_hw, strides=(8, 16, 32, 64, 128)) -> List[Tuple[int, int]]:
    """The FPN's level sizes: strides 8, 16, 32 from Swin, P6 and P7 by
    stride-2 convs (pad 1) on the level above."""
    h, w = image_hw
    levels = [(conv_out(h, s), conv_out(w, s)) for s in strides[:3]]
    for _ in strides[3:]:
        levels.append((conv_out(levels[-1][0], 2), conv_out(levels[-1][1], 2)))
    return levels


def gdino_levels(image_hw, n_levels: int = 4) -> List[Tuple[int, int]]:
    """Strides 8, 16, 32 from Swin, a fourth by a stride-2 conv on the last."""
    levels = glip_levels(image_hw, (8, 16, 32, 64))
    return levels[:n_levels]


def dcn_bound(b: int, h: int, w: int, c: int, cout: int, stride: int) -> float:
    ho, wo = conv_out(h, stride), conv_out(w, stride)
    flops = 2.0 * b * ho * wo * 9 * c * cout
    nbytes = BF16 * (b * h * w * c + b * ho * wo * 27 + 9 * c * cout + cout + b * ho * wo * cout)
    return bound_s(flops, nbytes)


def bi_attention_bound(b: int, n: int, t: int, e: int) -> float:
    flops = 6.0 * b * n * t * e
    nbytes = BF16 * (3 * b * n * e + 3 * b * t * e) + F32 * b * t
    return bound_s(flops, nbytes)


def msda_bound(b: int, q: int, s: int, heads: int, head_dim: int, levels: int, points: int) -> float:
    samples = b * q * heads * levels * points
    flops = 10.0 * samples * head_dim
    nbytes = BF16 * (b * s * heads * head_dim + b * q * heads * head_dim) + F32 * 3 * samples
    return bound_s(flops, nbytes)


def glip_dcn_calls(levels, channels: int, batch: int):
    """(batch, H, W, C, Cout, stride) of one head stage's DCN calls: per level L
    the stride-1 conv at L, the stride-2 conv over L-1 (L > 0) and the
    stride-1 conv over L+1 (L < last)."""
    calls = []
    for i, (h, w) in enumerate(levels):
        calls.append((batch, h, w, channels, channels, 1))
        if i > 0:
            calls.append((batch, *levels[i - 1], channels, channels, 2))
        if i < len(levels) - 1:
            calls.append((batch, *levels[i + 1], channels, channels, 1))
    return calls


def protocol_bounds(family: str, sizes: Dict, mix: Dict) -> Dict[str, float]:
    """Seconds of kernel work one protocol call needs, by kernel family:
    image_batch images x every chunk slot of every group (the padded one
    too: the protocol computes it)."""
    hw = mix["image_hw"]
    n_chunks = -(-mix["classes"] // mix["chunk_size"])
    slots = -(-n_chunks // mix["chunk_parallelism"]) * mix["chunk_parallelism"]
    b = mix["image_batch"] * slots
    t = mix["text_len"]
    c = sizes["channels"]
    out = {}
    if family == "glip":
        levels = glip_levels(hw, sizes["anchor_strides"])
        stages = sizes["head_stages"]
        out["dcn"] = stages * sum(dcn_bound(*call) for call in glip_dcn_calls(levels, c, b))
        out["bi_attention"] = stages * bi_attention_bound(b, sum(h * w for h, w in levels), t, 2048)
    else:
        levels = gdino_levels(hw, sizes["levels"])
        s = sum(h * w for h, w in levels)
        heads, hd = sizes["nheads"], c // sizes["nheads"]
        out["bi_attention"] = sizes["enc_layers"] * bi_attention_bound(b, s, t, sizes["ffn"] // 2)
        out["msda"] = (sizes["enc_layers"] * msda_bound(b, s, s, heads, hd, len(levels), sizes["points"])
                       + sizes["dec_layers"] * msda_bound(b, sizes["num_queries"], s, heads, hd, len(levels),
                                                          sizes["points"]))
    return out


# the work a flop counter cannot see: the gathers of the deformable operations
def dcn_gather_flops(b, ho, wo, c) -> float:
    """Bilinear sampling and modulation of a 3x3 DCN's inputs: 8 flops a
    channel a tap (4 corner weights applied and summed, the mask)."""
    return 8.0 * b * ho * wo * 9 * c


def msda_gather_flops(b, q, heads, head_dim, levels, points) -> float:
    return 10.0 * b * q * heads * levels * points * head_dim
