"""Bidirectional vision-language cross-attention (X-MHA), eval only.

Counterpart of `mqdet_tpu/ops/pallas/bi_attention_pallas.py::
flash_bi_attention` and `flash_bi_attention_levels`, with their signatures
and layouts:

    flash_bi_attention(q (B,N,E) pre-scaled, k (B,T,E), vv (B,N,E), vl (B,T,E),
                       bias_l (B,T) f32 additive or None, num_heads,
                       dual_scores=None)
      -> out_v (B,N,E), out_l (B,T,E)
    flash_bi_attention_levels([q_l (B,N_l,E)], k, [vv_l (B,N_l,E)], vl, bias_l,
                              num_heads)
      -> [out_v_l (B,N_l,E)], out_l (B,T,E)

per head: s = q.k^T, out_v = softmax_T(s + bias_l).vl, out_l = softmax_N(s^T).vv.
The levels form is the same attention over the concatenation of the levels,
computed without concatenating them: the l side's online-softmax state
(acc (B,H,T,D), den (B,H,T), m (B,H,T), fp32, from (0, 0, -1e30)) is carried
from level to level and out_l = acc / den is taken once, after the last.

`dual_scores` selects the formulation as the JAX package does: None reads
`MQDET_FLASH_SCORES` (the value `dual` selects the dual-score form, anything
else the single-score one), a bool overrides it. The port reads the variable
at call time; JAX reads it when it traces. The levels form has only the
single-score formulation, as in JAX.

On a CUDA tensor each function launches its kernel of `csrc/bi_attention.cu`
(bf16 in and out, fp32 scores and accumulation; head width 256, T a multiple
of 64 up to 256, contiguous 16-byte aligned tensors) or raises; on a CPU
tensor it runs its plain PyTorch version below.

The flat form's kernel (both formulations launch the same one) is a
flash-attention tile run for both sides: the v side over T in 64-token
chunks, the l side over `l_splits` contiguous ranges of N (`split_ranges`)
whose fp32 partials (m, den, acc) a second kernel combines. The levels form
runs the same two kernels per level: the level's rows split into
`l_splits` ranges, and the combine merges their partials with the carried
state (`merge_l_partials`), writing out_l on the last level. The plain
models of those decompositions, for the tests and `chip_smoke.py` only:
`bi_attention_tiled_plain`, `bi_attention_levels_tiled_plain`,
`combine_l_partials` and `merge_l_partials`.
"""
from __future__ import annotations

import ctypes
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from mqdet_torch.ops import kernels

# wrapper launches since the last reset: one per call of the single-score
# pair, of the dual-score kernel, and per level of the levels form
launch_count = 0
dual_launch_count = 0
levels_launch_count = 0
HEAD_DIM = 256
NEG = -1e30
ROWS, CHUNK = 128, 64  # the flat kernel's query rows per block, key rows per chunk
L_BLOCKS_MIN = 264     # two waves of the H100's 132 SMs
MAX_SPLITS = 64        # the combine kernel's bound


def _softmax_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp((x - m).float())
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, e = x.shape
    return x.reshape(b, n, h, e // h).transpose(1, 2)  # (B, H, N, D)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _v_side(s, bias_l, vlh, drop=None):
    """out_v (B, H, N, D) from the scores s = q.k^T (B, H, N, T); `drop`
    (dropout) on the probabilities."""
    if bias_l is not None:
        s = s + bias_l[:, None, None, :].to(s.dtype)
    p = _softmax_f32(s, -1)
    return torch.matmul(drop(p) if drop is not None else p, vlh)


def bi_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    vv: torch.Tensor,
    vl: torch.Tensor,
    bias_l: Optional[torch.Tensor],
    num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain single-score bi-attention: ONE score product s = q.k^T (in the
    compute dtype) serves both sides, the l side reducing it over N, as the
    TPU kernel's single-score branch does; softmax in fp32."""
    h = num_heads
    qh, kh, vvh, vlh = (_heads(x, h) for x in (q, k, vv, vl))
    s = torch.matmul(qh, kh.transpose(-1, -2))   # (B, H, N, T)
    out_v = _v_side(s, bias_l, vlh)
    out_l = torch.matmul(_softmax_f32(s, -2).transpose(-1, -2), vvh)
    return _merge(out_v), _merge(out_l)


def bi_attention_dual_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    vv: torch.Tensor,
    vl: torch.Tensor,
    bias_l: Optional[torch.Tensor],
    num_heads: int,
    drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dual-score bi-attention: two explicit score products, s = q.k^T
    for the v side and s^T = k.q^T for the l side, each softmax over its
    minor axis in fp32 (the JAX package's composite). `drop`, the training
    composite's attention dropout, applies to both probability tensors."""
    h = num_heads
    qh, kh, vvh, vlh = (_heads(x, h) for x in (q, k, vv, vl))
    out_v = _v_side(torch.matmul(qh, kh.transpose(-1, -2)), bias_l, vlh, drop)
    p_l = _softmax_f32(torch.matmul(kh, qh.transpose(-1, -2)), -1)  # (B, H, T, N)
    out_l = torch.matmul(drop(p_l) if drop is not None else p_l, vvh)
    return _merge(out_v), _merge(out_l)


def bi_attention_levels_plain(
    qs: Sequence[torch.Tensor],
    k: torch.Tensor,
    vvs: Sequence[torch.Tensor],
    vl: torch.Tensor,
    bias_l: Optional[torch.Tensor],
    num_heads: int,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain levels form: per level, the v side as in `bi_attention_plain`
    and the carried online-softmax update of the l side's fp32 state on this
    level's rows only (no concatenation); out_l = acc / den after the last."""
    h = num_heads
    kh, vlh = _heads(k, h), _heads(vl, h)
    b, _, t, d = kh.shape
    acc = torch.zeros(b, h, t, d, dtype=torch.float32, device=k.device)
    den = torch.zeros(b, h, t, dtype=torch.float32, device=k.device)
    m = torch.full((b, h, t), NEG, dtype=torch.float32, device=k.device)
    out_vs = []
    for q, vv in zip(qs, vvs):
        qh, vvh = _heads(q, h), _heads(vv, h)
        s = torch.matmul(qh, kh.transpose(-1, -2))  # (B, H, N_l, T)
        out_vs.append(_merge(_v_side(s, bias_l, vlh)))
        s = s.float()
        m_new = torch.maximum(m, s.amax(dim=-2))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[:, :, None, :])
        acc = acc * alpha[..., None] + torch.matmul(e.to(vvh.dtype).transpose(-1, -2), vvh).float()
        den = den * alpha + e.sum(dim=-2)
        m = m_new
    out_l = (acc / den[..., None]).to(k.dtype)
    return out_vs, _merge(out_l)


def l_splits(b: int, h: int, t: int, n: int) -> int:
    """S, the number of contiguous ranges of N that the flat kernel's l side
    splits into: enough that its B * H * ceil(T/128) * S blocks fill two
    waves of 132 SMs, at most one range per 64-row chunk and at most 64."""
    chunks = -(-n // CHUNK)
    per_split = b * h * -(-t // ROWS)
    return max(1, min(MAX_SPLITS, chunks, -(-L_BLOCKS_MIN // per_split)))


def split_ranges(n: int, splits: int) -> List[Tuple[int, int]]:
    """The N rows [lo, hi) of each range: ceil(chunks / S) chunks of 64 rows
    each, cut at N. A range can be empty (lo == hi)."""
    chunks = -(-n // CHUNK)
    per = -(-chunks // splits) * CHUNK
    return [(min(s * per, n), min((s + 1) * per, n)) for s in range(splits)]


def _flash_rows(qh, kh, vh, bias):
    """Unnormalised online softmax of queries qh (B, H, M, D) over keys kh
    and values vh (B, H, K, D) in chunks of 64 keys, with an additive key
    bias (B, K) or None: fp32 (m, den, acc) of shapes (B, H, M), (B, H, M),
    (B, H, M, D), from (NEG, 0, 0). Scores in fp32, p cast to vh's dtype
    before the value product, as the kernel does."""
    b, h, m_rows, d = qh.shape
    m = torch.full((b, h, m_rows), NEG, dtype=torch.float32, device=qh.device)
    den = torch.zeros(b, h, m_rows, dtype=torch.float32, device=qh.device)
    acc = torch.zeros(b, h, m_rows, d, dtype=torch.float32, device=qh.device)
    for k0 in range(0, kh.shape[2], CHUNK):
        s = torch.matmul(qh.float(), kh[:, :, k0:k0 + CHUNK].float().transpose(-1, -2))
        if bias is not None:
            s = s + bias[:, None, None, k0:k0 + CHUNK].float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(vh.dtype).float(), vh[:, :, k0:k0 + CHUNK].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return m, den, acc


def merge_l_partials(m, den, acc, carry=None):
    """Plain version of the combine kernel's merge: the S partials m, den
    (S, B, H, T) and acc (S, B, H, T, D), fp32 and unnormalised, and the
    carried state `carry` = (m, den, acc) of one partial's shapes (or None)
    as one more partial, give the merged state (M, den, acc), unnormalised:
    weights e^(m - M), M the max over all of them. A partial (NEG, 0, 0)
    weighs 0."""
    if carry is not None:
        m, den, acc = (torch.cat([c[None], x]) for c, x in zip(carry, (m, den, acc)))
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    return top, (w * den).sum(dim=0), (w[..., None] * acc).sum(dim=0)


def combine_l_partials(m, den, acc, carry=None) -> torch.Tensor:
    """Plain version of the combine kernel's output: out_l (B, T, E) in fp32
    = acc / den of `merge_l_partials(m, den, acc, carry)`."""
    _, den, acc = merge_l_partials(m, den, acc, carry)
    return _merge(acc / den[..., None])


def bi_attention_tiled_plain(q, k, vv, vl, bias_l, num_heads, splits):
    """Plain model of the flat kernel's decomposition: the v side as an
    online softmax over 64-token chunks of T; the l side as `splits`
    contiguous ranges of N (`split_ranges`), each an online softmax over its
    64-row chunks giving a partial, then `combine_l_partials`."""
    h = num_heads
    qh, kh, vvh, vlh = (_heads(x, h) for x in (q, k, vv, vl))
    _, den, acc = _flash_rows(qh, kh, vlh, bias_l)
    out_v = _merge(acc / den[..., None]).to(q.dtype)
    return out_v, combine_l_partials(*_l_partials(kh, qh, vvh, splits)).to(k.dtype)


def _l_partials(kh, qh, vvh, splits):
    """The l side's partials of one run of the flat kernel: an online softmax
    over each of `split_ranges(N, splits)`, stacked (S, B, H, T[, D])."""
    parts = [_flash_rows(kh, qh[:, :, lo:hi], vvh[:, :, lo:hi], None)
             for lo, hi in split_ranges(qh.shape[2], splits)]
    return tuple(torch.stack(x) for x in zip(*parts))


def bi_attention_levels_tiled_plain(qs, k, vvs, vl, bias_l, num_heads, splits=None):
    """Plain model of the levels form's decomposition: per level, the v side
    as in `bi_attention_tiled_plain` and the l side's partials over the
    level's `l_splits` ranges (or `splits` on every level), merged with the
    carried state (none before the first level); out_l from the last merge."""
    h = num_heads
    kh, vlh = _heads(k, h), _heads(vl, h)
    b, _, t, _ = kh.shape
    out_vs, carry = [], None
    for q, vv in zip(qs, vvs):
        qh, vvh = _heads(q, h), _heads(vv, h)
        _, den, acc = _flash_rows(qh, kh, vlh, bias_l)
        out_vs.append(_merge(acc / den[..., None]).to(q.dtype))
        s = l_splits(b, h, t, q.shape[1]) if splits is None else splits
        carry = merge_l_partials(*_l_partials(kh, qh, vvh, s), carry)
    _, den, acc = carry
    return out_vs, _merge(acc / den[..., None]).to(k.dtype)


def _check_tensor(x, device):
    if x.device != device:
        raise ValueError("all inputs must be on one device")
    if not x.is_contiguous():
        raise ValueError("kernel takes contiguous tensors")
    if x.data_ptr() % 16:
        raise ValueError("kernel needs 16-byte aligned tensors")


def _check_rows(q, vv, k, num_heads):
    """Raises on a q / vv pair (one call's, or one level's) the kernels do
    not take beside k (B, T, E)."""
    b, n, e = q.shape
    if e % num_heads or e // num_heads != HEAD_DIM:
        raise ValueError(f"kernel takes head width {HEAD_DIM}, got {e}/{num_heads}")
    if n < 1 or vv.shape != q.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError("bad shapes")
    for x in (q, vv):
        _check_tensor(x, k.device)
        if x.dtype != torch.bfloat16:
            raise TypeError(f"kernel takes bfloat16, got {x.dtype}")


def _check(q, k, vv, vl, bias_l, num_heads):
    """Raises on what the kernels do not take; returns bias_l as (B, T) f32."""
    b, t, _ = k.shape
    if t % 64 or not 0 < t <= 256:
        raise ValueError(f"kernel takes T a multiple of 64 up to 256, got {t}")
    if vl.shape != k.shape:
        raise ValueError("bad shapes")
    _check_rows(q, vv, k, num_heads)
    if bias_l is None:
        bias_l = torch.zeros(b, t, dtype=torch.float32, device=k.device)
    if bias_l.shape != (b, t) or bias_l.dtype != torch.float32:
        raise ValueError("bias_l must be (B, T) float32")
    for x in (k, vl, bias_l):
        _check_tensor(x, k.device)
    for x in (k, vl):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"kernel takes bfloat16, got {x.dtype}")
    return bias_l


def _launch(q, k, vv, vl, bias_l, num_heads, dual, splits=None):
    """The flat kernel and the combine; `splits` overrides `l_splits` (the
    card tests hold S = 1 against the automatic S)."""
    global launch_count, dual_launch_count
    kernels.refuse_grad("mqdet_bi_attention_forward", q, k, vv, vl, bias_l)
    bias_l = _check(q, k, vv, vl, bias_l, num_heads)
    b, n, e = q.shape
    t, h = k.shape[1], num_heads
    s = l_splits(b, h, t, n) if splits is None else int(splits)
    if not 1 <= s <= MAX_SPLITS:
        raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got {s}")
    out_v = torch.empty_like(q)
    out_l = torch.empty_like(k)
    part_acc = torch.empty(s, b, h, t, HEAD_DIM, dtype=torch.float32, device=q.device)
    part_den = torch.empty(s, b, h, t, dtype=torch.float32, device=q.device)
    part_m = torch.empty_like(part_den)
    p = ctypes.c_void_p
    name = "mqdet_bi_attention_dual_forward" if dual else "mqdet_bi_attention_forward"
    code = getattr(kernels.lib(), name)(
        p(q.data_ptr()), p(k.data_ptr()), p(vv.data_ptr()), p(vl.data_ptr()),
        p(bias_l.data_ptr()), p(out_v.data_ptr()), p(out_l.data_ptr()),
        p(part_acc.data_ptr()), p(part_den.data_ptr()), p(part_m.data_ptr()),
        b, n, t, e, h, s, p(kernels.stream_ptr(q.device)),
    )
    kernels.check(code, name)
    if dual:
        dual_launch_count += 1
    else:
        launch_count += 1
    return out_v, out_l


def _launch_levels(qs, k, vvs, vl, bias_l, num_heads, splits=None):
    """One C call per level (the flat kernel over the level's rows, then the
    combine with the carry); `splits` overrides each level's `l_splits`."""
    global levels_launch_count
    kernels.refuse_grad("mqdet_bi_attention_carry_forward", *qs, k, *vvs, vl, bias_l)
    if not qs or len(qs) != len(vvs):
        raise ValueError("need one q and one vv per level")
    b, t, e = k.shape
    bias = _check(qs[0], k, vvs[0], vl, bias_l, num_heads)
    for q, vv in zip(qs[1:], vvs[1:]):
        _check_rows(q, vv, k, num_heads)
    h = num_heads
    ss = [l_splits(b, h, t, q.shape[1]) if splits is None else int(splits) for q in qs]
    if not all(1 <= s <= MAX_SPLITS for s in ss):
        raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got {ss}")
    f32 = dict(dtype=torch.float32, device=k.device)
    part_acc = torch.empty(max(ss), b, h, t, HEAD_DIM, **f32)  # reused level after level
    part_den = torch.empty(max(ss), b, h, t, **f32)
    part_m = torch.empty_like(part_den)
    carry_acc = torch.empty(b, h, t, HEAD_DIM, **f32)  # written by the first level
    carry_den = torch.empty(b, h, t, **f32)
    carry_m = torch.empty_like(carry_den)
    out_l = torch.empty_like(k)
    p = ctypes.c_void_p
    fn = kernels.lib().mqdet_bi_attention_carry_forward
    k_, vl_, bias_ = (p(x.data_ptr()) for x in (k, vl, bias))  # the same for every level
    scratch = [p(x.data_ptr()) for x in (part_acc, part_den, part_m, carry_acc, carry_den, carry_m)]
    stream = p(kernels.stream_ptr(k.device))
    out_vs = []
    for i, (q, vv, s) in enumerate(zip(qs, vvs, ss)):
        out_v = torch.empty_like(q)
        last = i == len(qs) - 1
        code = fn(p(q.data_ptr()), k_, p(vv.data_ptr()), vl_, bias_, p(out_v.data_ptr()), *scratch,
                  p(out_l.data_ptr() if last else None), b, q.shape[1], t, e, h, s, int(i == 0), stream)
        kernels.check(code, "mqdet_bi_attention_carry_forward")
        levels_launch_count += 1
        out_vs.append(out_v)
    return out_vs, out_l


def flash_bi_attention(q, k, vv, vl, bias_l, num_heads, dual_scores=None):
    """See module docstring."""
    if dual_scores is None:
        dual = os.environ.get("MQDET_FLASH_SCORES", "single") == "dual"
    else:
        dual = bool(dual_scores)
    if kernels.runs_plain(q):
        plain = bi_attention_dual_plain if dual else bi_attention_plain
        return plain(q, k, vv, vl, bias_l, num_heads)
    return _launch(q, k, vv, vl, bias_l, num_heads, dual)


def flash_bi_attention_levels(qs, k, vvs, vl, bias_l, num_heads):
    """See module docstring: one call of the two kernels per level on the card."""
    if kernels.runs_plain(k):
        return bi_attention_levels_plain(qs, k, vvs, vl, bias_l, num_heads)
    return _launch_levels(qs, k, vvs, vl, bias_l, num_heads)
