"""A plain numpy model of one launch of the gather DCN kernel
(`csrc/deform_conv.cu::dcn_gather_kernel`), shared by the CPU tests
(tests/test_torch_port_dcn.py) and the card tests
(tests/test_torch_port_cuda.py). It imports no JAX.

What it mirrors:
  * tiles of 128 positions over the flat m = (b, oy, ox), the last one ragged
    (positions past B*Ho*Wo take zero weights and are not written);
  * the per-block table of each (tap, position): the top-left pixel and four
    corner weights times the mask, in fp32, each mode's rule as the kernel
    computes it (exact: the whole sample is zero at or beyond one pixel
    outside the image; clipped: rel = clip(offset, +-radius) + tap), and zero
    for each corner outside the image; every corner in the image of a
    sample the mode keeps is read, whatever its weight (0 * NaN is NaN),
    and no other;
  * A stages of 64 channels, zero past C, the four corners blended in corner
    order, optionally rounded to bf16 as the kernel stores them;
  * the weight read as (tap, C rows, Cout) with zero rows past C;
  * the product summed in the kernel's K order: tap, then 64-channel chunk,
    then 16-channel group.
"""
import numpy as np
import torch

TILE = 128   # positions per block
CHUNK = 64   # channels per A stage
GROUP = 16   # channels per wgmma k-step


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def gather_kernel_model(x, off, mask, wt, bias, stride, radius=None, round_a=False):
    """(B, Ho, Wo, Cout) fp32. x (B,H,W,C), off (B,Ho,Wo,18), mask (B,Ho,Wo,9),
    wt (3,3,C,Cout), bias (Cout,) or None; radius None: the exact mode."""
    x, off, mask, wt = (np.asarray(a, np.float32) for a in (x, off, mask, wt))
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    cout = wt.shape[-1]
    total = b * ho * wo
    nchunks = -(-c // CHUNK)
    xf = np.zeros((b * h * w, nchunks * CHUNK), np.float32)
    xf[:, :c] = x.reshape(-1, c)
    wp = np.zeros((9, nchunks * CHUNK, cout), np.float32)
    wp[:, :c] = wt.reshape(9, c, cout)
    offs, mks = off.reshape(total, 9, 2), mask.reshape(total, 9)
    bias = np.zeros(cout, np.float32) if bias is None else np.asarray(bias, np.float32)
    ky, kx = np.divmod(np.arange(9), 3)
    out = np.zeros((total, cout), np.float32)
    for m0 in range(0, total, TILE):
        m = m0 + np.arange(TILE)
        real = m < total
        mm = np.minimum(m, total - 1)
        bi, r = np.divmod(mm, ho * wo)
        oy, ox = np.divmod(r, wo)
        dy, dx, mk = offs[mm, :, 0], offs[mm, :, 1], mks[mm]
        if radius is None:
            y = (oy[:, None] * stride - 1 + ky).astype(np.float32) + dy
            xx = (ox[:, None] * stride - 1 + kx).astype(np.float32) + dx
            live = (y > -1) & (y < h) & (xx > -1) & (xx < w)
            y0f, x0f = np.floor(y), np.floor(xx)
            ly, lx = y - y0f, xx - x0f
            y0, x0 = y0f.astype(np.int64), x0f.astype(np.int64)
        else:
            rad = np.float32(radius)
            rely = np.clip(dy, -rad, rad) + (ky - 1).astype(np.float32)
            relx = np.clip(dx, -rad, rad) + (kx - 1).astype(np.float32)
            fy, fx = np.floor(rely), np.floor(relx)
            y0 = oy[:, None] * stride + fy.astype(np.int64)
            x0 = ox[:, None] * stride + fx.astype(np.int64)
            ly, lx = rely - fy, relx - fx
            live = np.ones_like(y0, bool)
        live &= real[:, None]
        one = np.float32(1)
        pix = (bi[:, None] * h + y0) * w + x0
        weights = ((one - ly) * (one - lx) * mk, (one - ly) * lx * mk, ly * (one - lx) * mk, ly * lx * mk)
        corners = ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1))
        inside = [live & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w) for cy, cx in corners]
        gw = [np.where(i, wq, np.float32(0)) for wq, i in zip(weights, inside)]
        acc = np.zeros((TILE, cout), np.float32)
        for tap in range(9):
            for k in range(nchunks):
                a = np.zeros((TILE, CHUNK), np.float32)
                for q, dq in enumerate((0, 1, w, w + 1)):
                    g, read = gw[q][:, tap], inside[q][:, tap]
                    idx = np.where(read, pix[:, tap] + dq, 0)
                    a += np.where(read[:, None], g[:, None] * xf[idx, k * CHUNK:(k + 1) * CHUNK], 0)
                if round_a:
                    a = _bf16(a)
                for grp in range(CHUNK // GROUP):
                    rows = slice(k * CHUNK + grp * GROUP, k * CHUNK + (grp + 1) * GROUP)
                    acc += a[:, grp * GROUP:(grp + 1) * GROUP] @ wp[tap, rows]
        out[m[real]] = acc[real] + bias
    return out.reshape(b, ho, wo, cout)
