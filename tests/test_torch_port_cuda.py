"""The mqdet_torch CUDA kernels on a card (marker `cuda`; each test skips when
`torch.cuda.is_available()` is false, as on a CPU-only machine).

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX.) Each kernel is held
against its plain PyTorch version run in fp32, at small shapes with ragged
edges; bound 2e-2 * max|ref| (bf16 inputs and outputs, fp32 accumulation).
"""
import pytest
import torch

from mqdet_torch.ops import bi_attention as tba
from mqdet_torch.ops import deform_conv as tdc
from mqdet_torch.ops import ms_deform_attn as tms

BOUND = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    return (got.float() - ref).abs().max().item() <= BOUND * ref.abs().max().item()


GATHER_SHAPES = [  # (B, H, W, C, Cout)
    (2, 13, 21, 64, 136), (1, 5, 7, 8, 8), (4, 7, 11, 256, 256),
    (1, 3, 43, 40, 24),     # M = 129 at stride 1: one position past a tile; C = 40, a chunk's tail
    (1, 15, 17, 264, 264),  # M = 255; C past four 64-channel chunks; Cout past one column block
    (2, 9, 10, 40, 512),    # two full column blocks
]


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_dcn_kernel_matches_plain(dev, stride, shape):
    b, h, w, c, cout = shape
    ho, wo = -(-h // stride), -(-w // stride)
    g = torch.Generator(device=dev).manual_seed(stride)
    x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    off = (torch.randn(b, ho, wo, 18, generator=g, device=dev) * 3).bfloat16()
    mask = torch.rand(b, ho, wo, 9, generator=g, device=dev).bfloat16()
    wt = (torch.randn(3, 3, c, cout, generator=g, device=dev) * 0.1).bfloat16()
    bias = torch.randn(cout, generator=g, device=dev).bfloat16()
    n0 = tdc.launch_count
    got = tdc.modulated_deform_conv(x, off, mask, wt, bias, stride)
    torch.cuda.synchronize()
    assert tdc.launch_count == n0 + 1
    ref = tdc.modulated_deform_conv_plain(x.float(), off.float(), mask.float(), wt.float(), bias.float(), stride)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _close(got, ref)


@pytest.mark.cuda
def test_dcn_kernel_refuses_what_it_does_not_take(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    off = torch.zeros(1, 4, 4, 18, device=dev)
    mask = torch.zeros(1, 4, 4, 9, device=dev)
    wt = torch.zeros(3, 3, 8, 8, device=dev)
    with pytest.raises(TypeError):  # fp32
        tdc.modulated_deform_conv(x, off, mask, wt, None, 1)
    xb = x.bfloat16()
    with pytest.raises(ValueError):  # C not a multiple of 8
        tdc.modulated_deform_conv(
            torch.zeros(1, 4, 4, 6, device=dev).bfloat16(), off.bfloat16(), mask.bfloat16(),
            torch.zeros(3, 3, 6, 8, device=dev).bfloat16(), None, 1,
        )
    with pytest.raises(ValueError):  # stride 3
        tdc.modulated_deform_conv(xb, off.bfloat16(), mask.bfloat16(), wt.bfloat16(), None, 3)


def _dcn_clip_inputs(dev, shape, stride, radius, seed):
    """Offsets x3 (the clip bites), every fifth exactly at +-radius (an
    integer rel whose floor+1 corner has weight 0)."""
    b, h, w, c, cout = shape
    ho, wo = -(-h // stride), -(-w // stride)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    off = torch.randn(b, ho, wo, 18, generator=g, device=dev) * 3
    off[..., ::5] = radius * torch.sign(off[..., ::5])
    mask = torch.rand(b, ho, wo, 9, generator=g, device=dev).bfloat16()
    wt = (torch.randn(3, 3, c, cout, generator=g, device=dev) * 0.1).bfloat16()
    bias = torch.randn(cout, generator=g, device=dev).bfloat16()
    return x, off.bfloat16(), mask, wt, bias


def _clip_ref(args, stride, radius):
    return tdc.modulated_deform_conv_clipped_plain(*(a.float() for a in args), stride=stride, radius=radius)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape,radius", [
    ((2, 13, 21, 64, 136), 1), ((1, 5, 7, 8, 8), 2), ((4, 7, 11, 256, 256), 8),
    ((1, 3, 43, 40, 24), 0), ((1, 15, 17, 264, 264), 11), ((2, 9, 10, 40, 512), 2), ((1, 15, 17, 264, 24), 11),
])
def test_dcn_clip_kernel_matches_plain(dev, stride, shape, radius):
    """K2: the gather kernel's clipped mode, through both entry points."""
    args = _dcn_clip_inputs(dev, shape, stride, radius, seed=radius)
    n0 = tdc.clip_launch_count
    got = tdc.modulated_deform_conv_window(*args, stride=stride, radius=radius)
    again = tdc.modulated_deform_conv_pallas_gather(*args, stride=stride, radius=radius)
    torch.cuda.synchronize()
    assert tdc.clip_launch_count == n0 + 2
    assert torch.equal(got, again)
    assert _close(got, _clip_ref(args, stride, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 11])
def test_dcn_gather_samples_outside_the_image_give_the_bias(dev, radius):
    """Offsets of +40 put every sample past the image's bottom right (in the
    clipped mode at radius 11: rel >= 10 on a 5 x 7 image): the output is
    the bias, bitwise."""
    args = list(_dcn_clip_inputs(dev, (2, 5, 7, 40, 136), 1, 0, seed=3))
    args[1] = torch.full_like(args[1], 40.0)
    got = tdc._launch(*args, 1, radius)
    torch.cuda.synchronize()
    assert torch.equal(got, args[4].expand_as(got))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 2])
def test_dcn_gather_batch_items_are_independent(dev, radius):
    """Each item of a batch of 3 (tiles straddle the items: 9 x 10 positions
    each) gives its own launch's bits, and changing item 1's input leaves
    items 0 and 2 as they were."""
    args = list(_dcn_clip_inputs(dev, (3, 9, 10, 64, 136), 1, 2, seed=4))
    whole = tdc._launch(*args, 1, radius)
    for i in range(3):
        alone = tdc._launch(args[0][i:i + 1].clone(), args[1][i:i + 1].clone(), args[2][i:i + 1].clone(),
                            args[3], args[4], 1, radius)
        torch.cuda.synchronize()
        assert torch.equal(whole[i:i + 1], alone), i
    args[0] = args[0].clone()
    args[0][1] += 1.0
    changed = tdc._launch(*args, 1, radius)
    torch.cuda.synchronize()
    assert torch.equal(changed[0::2], whole[0::2]) and not torch.equal(changed[1], whole[1])


@pytest.mark.cuda
@pytest.mark.parametrize("stride,radius,shape", [
    (1, None, (2, 13, 21, 40, 136)), (2, 2, (1, 15, 17, 264, 264)), (1, 11, (1, 15, 17, 264, 512)),
    (2, None, (4, 7, 11, 256, 256)), (1, 0, (1, 3, 43, 8, 24)),
])
def test_dcn_gather_kernel_matches_its_model(dev, stride, radius, shape):
    """The kernel against `gather_kernel_model` (tests/dcn_gather_model.py)
    with A rounded to bf16 as the kernel stores it: what is left is the
    fp32 summation order and the bf16 output, bound 4e-3 * max|ref| (five
    times tighter than BOUND; bf16 rounding of the output alone is up to
    2^-9 of it)."""
    from dcn_gather_model import gather_kernel_model

    args = _dcn_clip_inputs(dev, shape, stride, radius or 0, seed=shape[3])
    got = tdc._launch(*args, stride, radius)
    torch.cuda.synchronize()
    ref = torch.from_numpy(gather_kernel_model(*(a.float().cpu().numpy() for a in args), stride=stride,
                                               radius=radius, round_a=True))
    assert (got.float().cpu() - ref).abs().max().item() <= 4e-3 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 2])
def test_dcn_gather_reads_every_corner_in_the_image(dev, radius):
    """Zero offsets put every sample on a pixel, so its three other corners
    weigh 0; one NaN pixel inside the image reaches each output that reads
    it, with weight 0 or not, as in the plain versions (0 * NaN)."""
    args = list(_dcn_clip_inputs(dev, (1, 11, 14, 64, 136), 1, 2, seed=6))
    args[0] = args[0].clone()
    args[0][0, 5, 6, 3] = float("nan")
    args[1] = torch.zeros_like(args[1])
    got = tdc._launch(*args, 1, radius)
    torch.cuda.synchronize()
    ref = _clip_ref(args, 1, radius) if radius is not None else tdc.modulated_deform_conv_plain(
        *(a.float() for a in args), 1)
    assert torch.isnan(got[0, 3, 4]).all()  # the NaN pixel is the zero-weight corner of its tap (4, 5)
    assert torch.equal(torch.isnan(got.float().cpu()), torch.isnan(ref.cpu()))
    fin = torch.isfinite(ref)
    assert (got.float()[fin] - ref[fin]).abs().max().item() <= BOUND * ref[fin].abs().max().item()


BAND_CASES = [  # (B, H, W, C, Cout), radius, block_rows: partial tiles at the right and bottom edges
    ((2, 13, 21, 64, 136), 1, 8),
    ((2, 13, 21, 64, 136), 8, 16),
    ((1, 5, 7, 16, 8), 2, 8),       # smaller than one tile
    ((4, 7, 11, 256, 256), 3, 16),  # the 800x1344 pyramid's last level
    ((1, 40, 50, 32, 64), 5, 4),
    ((4, 21, 37, 64, 256), 2, 16),  # B 4, ragged 16 x 8 tiles, a full 256-channel block
]


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", BAND_CASES)
def test_dcn_band_kernel_matches_plain(dev, version, stride, case):
    shape, radius, block_rows = case
    args = _dcn_clip_inputs(dev, shape, stride, radius, seed=version)
    counter = tdc._BAND_COUNTER[version]
    n0 = getattr(tdc, counter)
    got = tdc.modulated_deform_conv_pallas(*args, stride=stride, radius=radius, block_rows=block_rows,
                                           version=version)
    torch.cuda.synchronize()
    assert getattr(tdc, counter) == n0 + 1
    assert got.shape == (shape[0], -(-shape[1] // stride), -(-shape[2] // stride), shape[4])
    assert _close(got, _clip_ref(args, stride, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("stride,radius", [(1, 2), (2, 2), (2, 8), (1, 0)])
def test_dcn_band_kernel_at_the_band_edge(dev, version, stride, radius):
    """Every offset exactly +-radius: each sample's corners reach the band's
    first and last rows and columns (the last ones with weight 0), at ragged
    tiles, B 1."""
    b, h, w, c, cout = 1, 19, 29, 64, 256
    ho, wo = -(-h // stride), -(-w // stride)
    g = torch.Generator(device=dev).manual_seed(100 * version + radius)
    x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    off = (radius * torch.sign(torch.randn(b, ho, wo, 18, generator=g, device=dev))).bfloat16()
    mask = torch.rand(b, ho, wo, 9, generator=g, device=dev).bfloat16()
    wt = (torch.randn(3, 3, c, cout, generator=g, device=dev) * 0.1).bfloat16()
    bias = torch.randn(cout, generator=g, device=dev).bfloat16()
    args = (x, off, mask, wt, bias)
    got = tdc.modulated_deform_conv_pallas(*args, stride=stride, radius=radius, block_rows=8, version=version)
    torch.cuda.synchronize()
    assert _close(got, _clip_ref(args, stride, radius))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_band_variants_are_bitwise_version_2(dev, stride):
    """v5 (fast path), v6 (fp32 band) and x_tiles 2 and 3 give v2's bits.
    The first 8 rows carry small offsets (fast tiles), the rest large ones."""
    args = list(_dcn_clip_inputs(dev, (2, 24, 70, 64, 128), stride, 2, seed=11))
    args[1][:, :8] = (args[1][:, :8].float() * 0.02 + 0.3).bfloat16()
    ref = tdc.modulated_deform_conv_pallas(*args, stride=stride, radius=2, block_rows=8, version=2)
    assert tdc.band_fast_share(args[1], stride, 2, 8) > 0.2
    for version, tiles in ((5, 1), (6, 1), (2, 2), (2, 3), (5, 3)):
        got = tdc.modulated_deform_conv_pallas(*args, stride=stride, radius=2, block_rows=8, version=version,
                                               x_tiles=tiles)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (version, tiles)


@pytest.mark.cuda
def test_dcn_band_refuses_what_it_does_not_take(dev):
    args = _dcn_clip_inputs(dev, (1, 9, 9, 32, 32), 2, 8, seed=0)
    with pytest.raises(ValueError):  # past MAX_WINDOW_RADIUS
        tdc.modulated_deform_conv_pallas(*args, stride=2, radius=9)
    with pytest.raises(ValueError):  # a 64 x 2 tile's band at radius 8, stride 2 exceeds shared memory
        tdc.modulated_deform_conv_pallas(*args, stride=2, radius=8, block_rows=64)
    with pytest.raises(ValueError):  # a 128 x 1 tile's band is taller than a TMA box
        tdc.modulated_deform_conv_pallas(*args, stride=2, radius=2, block_rows=128)
    small = _dcn_clip_inputs(dev, (1, 9, 9, 8, 8), 1, 2, seed=0)
    with pytest.raises(ValueError):  # C = 8 is not a multiple of the 16-channel chunk
        tdc.modulated_deform_conv_pallas(*small, stride=1, radius=2)
    with pytest.raises(TypeError):  # fp32
        tdc.modulated_deform_conv_pallas(*(a.float() for a in args), stride=2, radius=2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,t,heads", [(1, 100, 64, 1), (2, 700, 128, 2), (1, 3000, 256, 8), (2, 2333, 256, 4)])
def test_bi_attention_kernel_matches_plain(dev, b, n, t, heads):
    e = 256 * heads
    g = torch.Generator(device=dev).manual_seed(n)
    q = (torch.randn(b, n, e, generator=g, device=dev) * 0.0625).bfloat16()
    k = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
    vv = torch.randn(b, n, e, generator=g, device=dev).bfloat16()
    vl = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
    keep = torch.rand(b, t, generator=g, device=dev) > 0.25
    keep[:, t - t // 4 :] = False
    bias = torch.where(keep, 0.0, -9e15).float()
    n0 = tba.launch_count
    gv, gl = tba.flash_bi_attention(q, k, vv, vl, bias, heads)
    torch.cuda.synchronize()
    assert tba.launch_count == n0 + 1
    rv, rl = tba.bi_attention_plain(q.float(), k.float(), vv.float(), vl.float(), bias, heads)
    assert _close(gv, rv) and _close(gl, rl)


@pytest.mark.cuda
def test_bi_attention_kernel_refuses_other_widths(dev):
    q = torch.zeros(1, 10, 256, device=dev).bfloat16()
    k = torch.zeros(1, 48, 256, device=dev).bfloat16()
    with pytest.raises(ValueError):  # T = 48 is not a multiple of 64
        tba.flash_bi_attention(q, k, q, k, None, 1)
    k = torch.zeros(1, 64, 256, device=dev).bfloat16()
    with pytest.raises(ValueError):  # head width 128
        tba.flash_bi_attention(q, k, q, k, None, 2)


def _bi_inputs(dev, b, n, t, heads, seed):
    e = 256 * heads
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, n, e, generator=g, device=dev) * 0.0625).bfloat16()
    k = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
    vv = torch.randn(b, n, e, generator=g, device=dev).bfloat16()
    vl = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
    keep = torch.rand(b, t, generator=g, device=dev) > 0.25  # masked text
    keep[:, t - t // 4 :] = False
    return q, k, vv, vl, torch.where(keep, 0.0, -9e15).float()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,t,heads", [(1, 100, 64, 1), (2, 700, 128, 2), (1, 3000, 256, 8), (2, 2333, 256, 4)])
def test_bi_attention_dual_kernel_matches_plain(dev, b, n, t, heads):
    q, k, vv, vl, bias = _bi_inputs(dev, b, n, t, heads, n + 1)
    counts = (tba.launch_count, tba.dual_launch_count)
    gv, gl = tba.flash_bi_attention(q, k, vv, vl, bias, heads, dual_scores=True)
    torch.cuda.synchronize()
    assert (tba.launch_count, tba.dual_launch_count) == (counts[0], counts[1] + 1)
    rv, rl = tba.bi_attention_dual_plain(q.float(), k.float(), vv.float(), vl.float(), bias, heads)
    assert _close(gv, rv) and _close(gl, rl)


def _bi_ref(args, heads):
    return tba.bi_attention_dual_plain(*(x.float() for x in args[:4]), args[4], heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("t", [64, 192])
@pytest.mark.parametrize("n", [1, 63, 65, 127, 129])
def test_bi_attention_kernel_ragged_n_and_t(dev, dual, t, n):
    """Tails of the 64-row chunks and 128-row tiles: N < 64, N % 64 != 0,
    N < 128; a T tile of 64 rows (the second consumer's rows all past T)."""
    args = _bi_inputs(dev, 2, n, t, 2, 7 * n + t)
    gv, gl = tba.flash_bi_attention(*args, 2, dual_scores=dual)
    torch.cuda.synchronize()
    rv, rl = _bi_ref(args, 2)
    assert _close(gv, rv) and _close(gl, rl)


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("case", ["first chunk masked", "item masked", "q x30"])
def test_bi_attention_kernel_masks_and_large_scores(dev, dual, case):
    """Bias -9e15 on every token of the first 64-token chunk (the online
    softmax's first step sees only masked text), on every token of one batch
    item (the uniform average), and q scaled x30 (scores of std ~30)."""
    q, k, vv, vl, bias = _bi_inputs(dev, 2, 700, 256, 2, 11)
    if case == "first chunk masked":
        bias[:, :64] = -9e15
    elif case == "item masked":
        bias[1] = -9e15
    else:
        q = (q.float() * 30).bfloat16()
    args = (q, k, vv, vl, bias)
    gv, gl = tba.flash_bi_attention(*args, 2, dual_scores=dual)
    torch.cuda.synchronize()
    rv, rl = _bi_ref(args, 2)
    assert bool(torch.isfinite(gv).all()) and bool(torch.isfinite(gl).all())
    assert _close(gv, rv) and _close(gl, rl)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,t,heads", [(2, 2333, 256, 4), (1, 3000, 192, 8), (2, 129, 64, 1)])
def test_bi_attention_split_invariance_and_k3_k3b_bitwise(dev, b, n, t, heads):
    """The l side's split count changes only rounding: S = 1 and S = 7 (at
    N 129, 3 chunks, four ranges without rows) against the automatic S,
    within 2e-2 * max|ref|; K3 and K3b launch one kernel, so their outputs
    are bitwise equal."""
    args = _bi_inputs(dev, b, n, t, heads, n)
    auto = tba._launch(*args, heads, False)
    dual = tba._launch(*args, heads, True)
    torch.cuda.synchronize()
    refs = _bi_ref(args, heads)
    for splits in (1, 7):
        forced = tba._launch(*args, heads, False, splits=splits)
        torch.cuda.synchronize()
        for x, y, r in zip(forced, auto, refs):
            assert (x.float() - y.float()).abs().max().item() <= BOUND * r.abs().max().item()
    assert all(torch.equal(x, y) for x, y in zip(auto, dual))
    assert _close(auto[0], refs[0]) and _close(auto[1], refs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,sizes,t,heads", [
    (2, [420, 180, 70, 30], 128, 2),               # the JAX package's test levels
    (1, [1050, 273, 77], 256, 8),                  # the 800x1344 pyramid's last levels: 77 rows < 2 tiles
    (2, [16800, 4200, 1050, 273, 77], 256, 1),     # the whole 800x1344 pyramid, every level with a tail
    (1, [5], 64, 1),                               # one level inside one tile
])
def test_bi_attention_levels_kernel_matches_plain(dev, b, sizes, t, heads):
    q, k, vv, vl, bias = _bi_inputs(dev, b, sum(sizes), t, heads, len(sizes))
    qs = [x.contiguous() for x in q.split(sizes, 1)]
    vvs = [x.contiguous() for x in vv.split(sizes, 1)]
    n0 = tba.levels_launch_count
    gvs, gl = tba.flash_bi_attention_levels(qs, k, vvs, vl, bias, heads)
    torch.cuda.synchronize()
    assert tba.levels_launch_count == n0 + len(sizes)
    rvs, rl = tba.bi_attention_levels_plain(
        [x.float() for x in qs], k.float(), [x.float() for x in vvs], vl.float(), bias, heads
    )
    assert [x.shape for x in gvs] == [x.shape for x in rvs]
    assert _close(torch.cat(gvs, 1), torch.cat(rvs, 1)) and _close(gl, rl)
    # the carried state over the levels is the attention over their concatenation
    fv, fl = tba.bi_attention_plain(q.float(), k.float(), vv.float(), vl.float(), bias, heads)
    assert _close(torch.cat(gvs, 1), fv) and _close(gl, fl)


LEVEL_CASES = [(2, [420, 180, 70, 30], 128, 2), (1, [1050, 273, 77], 256, 8), (2, [129, 64, 1], 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sizes,t,heads", LEVEL_CASES)
def test_bi_attention_levels_split_invariance(dev, b, sizes, t, heads):
    """K4 with one l range per level against the automatic l_splits: the
    split count changes only rounding (2e-2 * max|ref|), and each level's
    out_v, which no split touches, is bitwise equal."""
    q, k, vv, vl, bias = _bi_inputs(dev, b, sum(sizes), t, heads, 3 * len(sizes))
    qs = [x.contiguous() for x in q.split(sizes, 1)]
    vvs = [x.contiguous() for x in vv.split(sizes, 1)]
    auto = tba._launch_levels(qs, k, vvs, vl, bias, heads)
    one = tba._launch_levels(qs, k, vvs, vl, bias, heads, splits=1)
    torch.cuda.synchronize()
    _, rl = tba.bi_attention_levels_plain([x.float() for x in qs], k.float(), [x.float() for x in vvs],
                                          vl.float(), bias, heads)
    assert all(torch.equal(x, y) for x, y in zip(auto[0], one[0]))
    assert (auto[1].float() - one[1].float()).abs().max().item() <= BOUND * rl.abs().max().item()
    assert _close(auto[1], rl) and _close(one[1], rl)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sizes,t,heads", LEVEL_CASES)
def test_bi_attention_levels_kernel_matches_tiled_plain(dev, b, sizes, t, heads):
    """K4 against the plain model of its decomposition
    (`bi_attention_levels_tiled_plain`, fp32, the kernel's l_splits)."""
    q, k, vv, vl, bias = _bi_inputs(dev, b, sum(sizes), t, heads, 5 * len(sizes))
    qs = [x.contiguous() for x in q.split(sizes, 1)]
    vvs = [x.contiguous() for x in vv.split(sizes, 1)]
    gvs, gl = tba.flash_bi_attention_levels(qs, k, vvs, vl, bias, heads)
    torch.cuda.synchronize()
    tvs, tl = tba.bi_attention_levels_tiled_plain([x.float() for x in qs], k.float(), [x.float() for x in vvs],
                                                  vl.float(), bias, heads)
    assert all(_close(g, r) for g, r in zip(gvs, tvs)) and _close(gl, tl)


@pytest.mark.cuda
def test_dual_and_levels_kernels_refuse_what_they_do_not_take(dev):
    q, k, vv, vl, bias = _bi_inputs(dev, 2, 200, 64, 1, 0)
    with pytest.raises(ValueError):  # T = 48
        tba.flash_bi_attention(q, k[:, :48].contiguous(), vv, vl[:, :48].contiguous(), bias[:, :48].contiguous(),
                               1, dual_scores=True)
    with pytest.raises(ValueError):  # head width 128
        tba.flash_bi_attention(q, k, vv, vl, bias, 2, dual_scores=True)
    with pytest.raises(ValueError):  # more l splits than the combine takes
        tba._launch(q, k, vv, vl, bias, 1, False, splits=tba.MAX_SPLITS + 1)
    with pytest.raises(ValueError):  # T = 48
        tba.flash_bi_attention_levels([q], k[:, :48].contiguous(), [vv], vl[:, :48].contiguous(),
                                      bias[:, :48].contiguous(), 1)
    with pytest.raises(ValueError):  # a level that is a view into the whole (not contiguous)
        tba.flash_bi_attention_levels(list(q.split([150, 50], 1)), k, list(vv.split([150, 50], 1)), vl, bias, 1)
    with pytest.raises(TypeError):  # fp32
        tba.flash_bi_attention_levels([q.float()], k.float(), [vv.float()], vl.float(), bias, 1)
    with pytest.raises(ValueError):  # one vv short
        tba.flash_bi_attention_levels([q, q], k, [vv], vl, bias, 1)


GDINO_800 = [(100, 168), (50, 84), (25, 42), (13, 21)]  # the 800x1344 pyramid


def _msda(dev, b, shapes, q, lo, hi, nh=8, hd=32, p=4, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    q = s if q is None else q
    value = torch.randn(b, s, nh, hd, generator=g, device=dev).bfloat16()
    loc = torch.rand(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * (hi - lo) + lo
    attn = torch.rand(b, q, nh, len(shapes), p, generator=g, device=dev)
    attn = attn / attn.sum(dim=(3, 4), keepdim=True)
    return value, loc, attn


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, level shapes, Q (None: Q = S, encoder queries), loc range, hd)
    (2, [(25, 42), (13, 21), (7, 11), (4, 6)], None, (-0.2, 1.2), 32),
    (3, GDINO_800, 900, (0.0, 1.0), 32),
    (2, GDINO_800, 900, (-1.0, 2.0), 32),
    (2, [(9, 7), (5, 4)], 33, (-0.3, 1.3), 8),
    (1, [(16, 16), (8, 8), (4, 4)], None, (0.0, 1.0), 32),
])
def test_msda_kernel_matches_plain(dev, monkeypatch, case):
    """The exact mode (`gather`, which encoder queries take only under it)."""
    monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    b, shapes, q, (lo, hi), hd = case
    value, loc, attn = _msda(dev, b, shapes, q, lo, hi, hd=hd)
    n0 = tms.launch_count
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert tms.launch_count == n0 + 1
    ref = tms.ms_deform_attn_plain(value.float(), shapes, loc, attn)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _close(got, ref)
    # items are independent: the last item alone gives the same rows
    alone = tms.ms_deform_attn(value[-1:].contiguous(), shapes, loc[-1:].contiguous(), attn[-1:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(alone[0], got[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, level shapes, loc range, hd): encoder queries (Q = S) at uniform locations,
    # far outside every window and up to a map beyond each border
    (1, GDINO_800, (-1.0, 2.0), 32),
    (2, [(16, 16), (8, 8), (4, 4), (2, 2)], (-0.5, 1.5), 32),   # k 1/2/4/8, f 2/4/8
    (2, [(12, 20), (6, 10), (3, 5), (2, 3)], (-0.5, 1.5), 8),   # non-exact ratios
])
def test_msda_clip_kernel_matches_clipped_plain(dev, monkeypatch, case):
    """The clipped mode (MQDET_MSDA_IMPL unset, encoder queries) against
    `ms_deform_attn_clipped_plain`; `gather` launches the exact mode against
    the exact plain version; the two differ (the clip binds)."""
    b, shapes, (lo, hi), hd = case
    value, loc, attn = _msda(dev, b, shapes, None, lo, hi, hd=hd, seed=b + hd)
    monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
    counts = (tms.launch_count, tms.clip_launch_count)
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert (tms.launch_count, tms.clip_launch_count) == (counts[0], counts[1] + 1)
    ref = tms.ms_deform_attn_clipped_plain(value.float(), shapes, loc, attn)
    assert got.shape == ref.shape and _close(got, ref)
    monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    exact = tms.ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert (tms.launch_count, tms.clip_launch_count) == (counts[0] + 1, counts[1] + 1)
    exact_ref = tms.ms_deform_attn_plain(value.float(), shapes, loc, attn)
    assert _close(exact, exact_ref)
    assert (exact_ref - ref).abs().max().item() > 0.1


@pytest.mark.cuda
def test_msda_kernel_refuses_what_it_does_not_take(dev):
    shapes = [(4, 4), (2, 2)]
    value, loc, attn = _msda(dev, 1, shapes, 5, 0.0, 1.0, nh=2, hd=32, p=2)
    with pytest.raises(TypeError):  # fp32 value
        tms.ms_deform_attn(value.float(), shapes, loc, attn)
    with pytest.raises(TypeError):  # bf16 locations
        tms.ms_deform_attn(value, shapes, loc.bfloat16(), attn)
    with pytest.raises(ValueError):  # levels do not cover S
        tms.ms_deform_attn(value, [(4, 4), (2, 1)], loc, attn)
    for hd in (24, 64):  # head widths without an instantiation
        with pytest.raises(ValueError):
            tms.ms_deform_attn(torch.zeros(1, 20, 2, hd, device=dev).bfloat16(), shapes, loc, attn)
    with pytest.raises(ValueError):  # five levels
        v5 = torch.zeros(1, 23, 2, 32, device=dev).bfloat16()
        loc5 = torch.rand(1, 5, 2, 5, 2, 2, device=dev)
        tms.ms_deform_attn(v5, shapes + [(1, 1)] * 3, loc5, torch.rand(1, 5, 2, 5, 2, device=dev))
    with pytest.raises(ValueError):  # weights of another shape
        tms.ms_deform_attn(value, shapes, loc, attn[:, :4].contiguous())
    with pytest.raises(ValueError):  # not contiguous
        tms.ms_deform_attn(value, shapes, loc.transpose(1, 2).contiguous().transpose(1, 2), attn)


def _msda_edge(dev, b, shapes, hd=32, p=4, seed=0):
    """Encoder queries whose sample pixels lie exactly on their windows'
    edges (c - R, c + R + 1: the hi corner of weight 0 is the band's last
    row) or 0.25 past them (clamped onto them), per point alternately;
    pairs without a window sample anywhere within 2 pixels of the map."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in shapes)
    value = torch.randn(b, s, 8, hd, generator=g, device=dev).bfloat16()
    bnd = tms.window_bounds(shapes, dev)
    loc = torch.empty(b, s, 8, len(shapes), p, 2, device=dev)
    for lv, (h, w) in enumerate(shapes):
        for axis, size, (lo, hi) in ((0, w, (bnd[lv, 2], bnd[lv, 3])), (1, h, (bnd[lv, 0], bnd[lv, 1]))):
            side = torch.rand(b, s, 8, p, generator=g, device=dev) < 0.5
            past = 0.25 * (torch.arange(p, device=dev) % 2)  # odd points 0.25 beyond the edge
            edge = torch.where(side, lo[None, :, None, None] - past, hi[None, :, None, None] + past)
            anywhere = torch.rand(b, s, 8, p, generator=g, device=dev) * (size + 4) - 2
            pix = torch.where(torch.isfinite(edge), edge, anywhere)
            loc[:, :, :, lv, :, axis] = (pix + 0.5) / size
    attn = torch.rand(b, s, 8, len(shapes), p, generator=g, device=dev)
    return value, loc, attn / attn.sum(dim=(3, 4), keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [GDINO_800, [(100, 168), (50, 84)], [(21, 35), (11, 18)]])
def test_msda_clip_kernel_at_the_window_edges(dev, monkeypatch, shapes):
    """The band kernel with every sample on a window edge, at pyramids whose
    8 x 8 tiles end mid-map (168 = 21 tiles, 100 = 12.5): against
    `ms_deform_attn_clipped_plain` in fp32."""
    monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
    value, loc, attn = _msda_edge(dev, 2, shapes, seed=len(shapes))
    n0 = tms.clip_launch_count
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert tms.clip_launch_count == n0 + 1
    assert bool(torch.isfinite(got).all()) and _close(got, tms.ms_deform_attn_clipped_plain(value.float(), shapes,
                                                                                             loc, attn))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 32])
def test_msda_clip_kernel_items_are_independent(dev, monkeypatch, hd):
    """The band kernel's batch items are independent: the last item alone
    gives the same rows bit for bit (its tensor maps and tiles per item)."""
    monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
    shapes = [(25, 42), (13, 21), (7, 11), (4, 6)]
    value, loc, attn = _msda(dev, 3, shapes, None, -0.2, 1.2, hd=hd, seed=hd)
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    alone = tms.ms_deform_attn(value[-1:].contiguous(), shapes, loc[-1:].contiguous(), attn[-1:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(alone[0], got[-1])
    assert _close(got, tms.ms_deform_attn_clipped_plain(value.float(), shapes, loc, attn))


# ---- the vision-query path ------------------------------------------------------


ROI_BOXES = [[10, 12, 30, 40], [0, 0, 223, 159], [200, 140, 260, 190], [-30, -20, 5, 8],
             [40, 30, 140, 130], [60, 21, 460, 423], [3.3, 7.7, 13.1, 17.9], [-7, -3, 1993, 1903]]


@pytest.mark.cuda
def test_roi_align_on_the_card_matches_the_cpu(dev):
    """Both ROIAlign routes on bf16 maps cast to fp32, as extraction pools
    them: the card equals the CPU within fp32 rounding (no sample lies on
    the edge of the zero region)."""
    from mqdet_torch.ops import roi_align as troi

    g = torch.Generator().manual_seed(0)
    maps = [torch.randn(h, w, 64, generator=g).bfloat16() for h, w in [(20, 28), (10, 14), (5, 7), (3, 4), (2, 2)]]
    rois = torch.tensor(ROI_BOXES)
    scales = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
    for fn in (troi.multi_level_roi_align, troi.all_level_roi_align):
        want = fn([m.float() for m in maps], rois, scales)
        got = fn([m.to(dev).float() for m in maps], rois.to(dev), scales)
        assert got.device.type == "cuda"
        assert torch.allclose(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_eval_transform_on_the_card_matches_the_cpu(dev):
    """PIL's fixed-point resize in float64 on the card: the same bits as on
    the CPU, landscape and portrait at the LVIS protocol's sizes."""
    import numpy as np

    from mqdet_torch.data.transforms import EvalTransform
    from mqdet_torch.utils.builders import mq_glip_t_config

    tf = EvalTransform(mq_glip_t_config())
    for hw in ((480, 640), (640, 480), (333, 500)):
        img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
        want, size, scale = tf(img, "cpu")
        got, size_d, scale_d = tf(img, dev)
        assert (size_d, scale_d) == (size, scale) and got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_run_inference_on_the_card_launches_the_kernels(dev, tmp_path):
    """Tiny MQ-GLIP in bf16 on the card (T 64, the bi-attention kernel's
    multiple), 3 images of 60x80 (one portrait), 8 classes in chunks of 3, CP
    2 (2 groups): every head group launches 13 DCN (the gather kernel's
    clipped mode: C 16 is no multiple of 128) and one bi-attention; the
    detections and AP are finite. Images come from a `load_image` override:
    the card machine has no PIL."""
    import json

    import numpy as np

    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.inference import run_inference
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import build_model, init_params, tiny_test_config

    cfg = tiny_test_config()
    cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 64
    cfg.TPU.IMAGE_BUCKETS = ((64, 96),)
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 80
    cfg.TEST.CHUNKED_EVALUATION, cfg.TEST.CHUNK_PARALLELISM = 3, 2
    cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT, cfg.VISION_QUERY.NUM_QUERY_PER_CLASS = 3, 2
    cfg.MODEL.ATSS.INFERENCE_TH = 0.0
    sizes = [(60, 80), (60, 80), (80, 60)]
    images = [{"id": i, "file_name": f"{i}.png", "height": h, "width": w} for i, (h, w) in enumerate(sizes)]
    anns = [{"id": i + 1, "image_id": i, "category_id": i % 8 + 1, "bbox": [5.0, 6.0, 30.0, 20.0], "area": 600.0,
             "iscrowd": 0} for i in range(3)]
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(["cat", "dog", "hot_dog", "ski pole", "bow_(weapon)",
                                                             "tie", "frisbee", "person"])]
    (tmp_path / "ann.json").write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    pixels = {i: np.random.default_rng(i).integers(0, 256, hw + (3,), dtype=np.uint8) for i, hw in enumerate(sizes)}

    class Seeded(CocoDetectionDataset):
        def load_image(self, img_id):
            return pixels[img_id]

    bank = QueryBank(channels=16)
    for lab in (1, 2, 4, 7):
        bank.add(lab, np.random.default_rng(lab).standard_normal((3, 1, 16)).astype(np.float32))
    model = init_params(build_model(cfg), seed=0).eval().to(dev, torch.bfloat16)
    launch_counts(reset=True)
    res = run_inference(cfg, model, Seeded(str(tmp_path / "ann.json"), str(tmp_path)), WordPieceTokenizer(),
                        QuerySelector(bank, num_query_per_class=2, max_labels=3), verbose=False)
    used = {k: v for k, v in launch_counts().items() if v}
    assert used == {"dcn_gather_clip": 3 * 2 * 13, "bi_attention": 3 * 2}
    assert np.isfinite(res["AP"]) and res["images_per_second"] > 0


DCN_ROUTES = {  # the public function of each route and the plain VJP its Function's backward computes
    "band": (lambda *a, s: tdc.modulated_deform_conv_pallas(*a, stride=s, radius=2),
             lambda *a, s: tdc.modulated_deform_conv_window_vjp(*a, stride=s, radius=2)),
    "window": (lambda *a, s: tdc.modulated_deform_conv_window(*a, stride=s, radius=2),
               lambda *a, s: tdc.modulated_deform_conv_window_vjp(*a, stride=s, radius=2)),
    "exact": (lambda *a, s: tdc.modulated_deform_conv(*a, stride=s),
              lambda *a, s: tdc.modulated_deform_conv_exact_vjp(*a, stride=s)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(DCN_ROUTES))
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("offsets", ["x3", "integer"])
def test_dcn_function_gradients_match_the_plain_vjp(dev, route, stride, offsets):
    """Each DCN route's autograd Function on the card (the kernel forward,
    bf16 inputs saved) against its plain VJP in fp32 on the same inputs:
    every gradient within BOUND * max|ref|; the forward launched its
    kernel once."""
    from mqdet_torch.ops import launch_counts

    g = torch.Generator(device=dev).manual_seed(stride)
    b, h, w, c = 2, 13, 21, 128
    ho, wo = -(-h // stride), -(-w // stride)
    off = torch.randn(b, ho, wo, 18, generator=g, device=dev) * 3
    if offsets == "integer":
        off = off.round().clamp(-3, 3)
    ins = [torch.randn(b, h, w, c, generator=g, device=dev), off, torch.rand(b, ho, wo, 9, generator=g, device=dev),
           torch.randn(3, 3, c, c, generator=g, device=dev) * 0.05, torch.randn(c, generator=g, device=dev)]
    ins = [t.bfloat16() for t in ins]
    gout = torch.randn(b, ho, wo, c, generator=g, device=dev).bfloat16()
    fwd, vjp = DCN_ROUTES[route]
    leaves = [t.clone().requires_grad_(True) for t in ins]
    launch_counts(reset=True)
    y = fwd(*leaves, s=stride)
    assert sum(launch_counts().values()) == 1 and y.grad_fn is not None
    y.backward(gout)
    refs = vjp(*(t.float() for t in ins), gout.float(), s=stride)
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == torch.bfloat16 and _close(leaf.grad, ref)


@pytest.mark.cuda
def test_launchers_raise_under_grad_on_the_card(dev):
    """No kernel returns a detached output to a caller that needs a
    gradient: the DCN and MSDA routes go through their Functions, the
    bi-attention launchers and every launcher called outside its Function
    raise."""
    q = torch.randn(1, 128, 2048, device=dev, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 128, 2048, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no gradient"):
        tba.flash_bi_attention(q, k, q, k, None, 8)
    with pytest.raises(RuntimeError, match="no gradient"):
        tba.flash_bi_attention_levels([q], k, [q], k, None, 8)
    value = torch.randn(1, 64, 8, 32, device=dev, dtype=torch.bfloat16, requires_grad=True)
    loc = torch.rand(1, 64, 8, 1, 4, 2, device=dev)
    attn = torch.rand(1, 64, 8, 1, 4, device=dev)
    for clip in (False, True):
        with pytest.raises(RuntimeError, match="no gradient"):
            tms._launch(value, [(8, 8)], loc, attn, clip)
    assert tms.ms_deform_attn(value, [(8, 8)], loc, attn).grad_fn is not None  # through MSDeformAttnFunction
    x = torch.randn(1, 8, 8, 128, device=dev, dtype=torch.bfloat16, requires_grad=True)
    rest = [torch.zeros(1, 8, 8, 18, device=dev, dtype=torch.bfloat16), torch.ones(1, 8, 8, 9, device=dev,
            dtype=torch.bfloat16), torch.zeros(3, 3, 128, 128, device=dev, dtype=torch.bfloat16)]
    with pytest.raises(RuntimeError, match="no gradient"):
        tdc._launch_band(x, *rest, None, 1, 2, 8, 2)
    assert tdc.modulated_deform_conv_pallas(x, *rest, radius=2).grad_fn is not None


@pytest.mark.cuda
def test_tiny_train_step_on_the_card(dev):
    """Two training steps of tiny MQ-GLIP (C 128, so the band kernel runs) in
    bf16 on the card: 13 band-DCN launches per forward and no bi-attention
    kernel (the fusion's training composite); every loss finite; the
    trainable fp32 masters move, the frozen parameters do not."""
    import numpy as np

    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_train_step, step_generator
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import build_model, init_params, synthetic_batch, tiny_test_config

    cfg = tiny_test_config()
    cfg.MODEL.BACKBONE.OUT_CHANNELS = cfg.MODEL.DYHEAD.CHANNELS = 128
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE, cfg.SOLVER.MODEL_EMA, cfg.SOLVER.WARMUP_ITERS = "vision_query", 0.999, 0
    cfg.VISION_QUERY.TEXT_DROPOUT = 0.4
    b = synthetic_batch(cfg, 2, (64, 64), num_labels=3, k_shot=2, seed=1)
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    boxes = np.array([[[4, 6, 40, 30], [20, 20, 60, 62]]] * 2, np.float32)
    batch.update(gt_boxes=boxes, gt_labels=np.array([[1, 2]] * 2, np.int32), gt_valid=np.ones((2, 2), bool),
                 gt_token_map=b["agg_map"][:, :2], pos_category_map=(b["agg_map"] > 0).astype(np.float32),
                 has_query=np.ones((2, 3), np.int32))
    model = init_params(build_model(cfg), seed=0).to(dev, torch.bfloat16)
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n in state.frozen}
    start = {n: t.clone() for n, t in state.trainable.items()}
    step = make_train_step(model, tx, cfg)
    launch_counts(reset=True)
    for it in range(2):
        state, metrics = step(state, batch_to_device(batch, dev), step_generator(0, it, dev))
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert {k: v for k, v in launch_counts().items() if v} == {"dcn_band": 2 * 13}
    params = dict(model.named_parameters())
    assert all(torch.equal(params[n], t) for n, t in frozen.items())
    assert all(not torch.equal(t, start[n]) and t.dtype == torch.float32 for n, t in state.trainable.items())


MSDA_GRAD_CASES = [  # (level shapes, Q (None: encoder queries, Q = S), loc range, hd)
    ([(25, 42), (13, 21), (7, 11), (4, 6)], None, (-0.5, 1.5), 32),  # clipped: most points past their windows
    (GDINO_800, 900, (-0.2, 1.2), 32),                                # exact: decoder queries
    ([(9, 7), (5, 4)], None, (-0.5, 1.5), 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MSDA_GRAD_CASES)
def test_msda_function_gradients_match_the_plain_vjp(dev, monkeypatch, case):
    """The MSDA Function on the card (the clipped or exact kernel forward,
    bf16 value saved) against `ms_deform_attn_vjp`, the exact composite's
    VJP in fp32 at the unclipped locations: every gradient within BOUND *
    max|ref|; the forward launched its kernel once."""
    from mqdet_torch.ops import launch_counts

    monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
    shapes, q, (lo, hi), hd = case
    value, loc, attn = _msda(dev, 2, shapes, q, lo, hi, hd=hd, seed=hd)
    gout = torch.randn(2, loc.shape[1], 8 * hd, device=dev).bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
    launch_counts(reset=True)
    y = tms.ms_deform_attn(*leaves[:1], shapes, *leaves[1:])
    kernel = "ms_deform_attn_clip" if q is None else "ms_deform_attn"
    assert {k: v for k, v in launch_counts().items() if v} == {kernel: 1} and y.grad_fn is not None
    y.backward(gout)
    refs = tms.ms_deform_attn_vjp(value.float(), shapes, loc, attn, gout.float())
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == leaf.dtype and bool(torch.isfinite(leaf.grad).all()) and _close(leaf.grad, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["band", "window", "gather"])
def test_dcn_nan_offset_gives_nan_as_the_plain_version(dev, route):
    """A NaN offset (one tap's dy at one position, one tap's dx at the last
    position, whose tap-8 sample lies past the bottom edge whenever its dy
    is >= 0) through each DCN kernel: NaN at exactly the positions where the
    plain version is NaN, every other output within BOUND of it (Queue C 2:
    the clip's `fmaxf` and the exact mode's in-image tests dropped the NaN).
    The clipped routes give both positions NaN (the window composite has no
    out-of-image rule); the exact route only the first, as the exact
    composite drops a sample whose other coordinate lies outside."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, h, w, c = 2, 13, 21, 128
    x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    off = (torch.randn(b, h, w, 18, generator=g, device=dev) * 3).bfloat16()
    off[0, 4, 7, 6] = float("nan")
    off[1, 12, 20, 16:18] = torch.tensor([0.5, float("nan")])
    mask = torch.rand(b, h, w, 9, generator=g, device=dev).bfloat16()
    wt = (torch.randn(3, 3, c, c, generator=g, device=dev) * 0.05).bfloat16()
    fn, plain = {
        "band": (lambda *a: tdc.modulated_deform_conv_pallas(*a, radius=2), tdc.modulated_deform_conv_clipped_plain),
        "window": (lambda *a: tdc.modulated_deform_conv_window(*a, radius=2), tdc.modulated_deform_conv_clipped_plain),
        "gather": (tdc.modulated_deform_conv, tdc.modulated_deform_conv_plain),
    }[route]
    got = fn(x, off, mask, wt, None)
    torch.cuda.synchronize()
    ref = plain(*(t.float() for t in (x, off, mask, wt)), None) if route == "gather" else \
        plain(*(t.float() for t in (x, off, mask, wt)), None, radius=2)
    nan = torch.isnan(ref)
    want = 1 if route == "gather" else 2
    assert torch.equal(torch.isnan(got), nan) and int(nan.any(-1).sum()) == want and bool(nan[0, 4, 7].all())
    assert _close(torch.where(nan, 0.0, got.float()), torch.where(nan, 0.0, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["clipped", "exact encoder", "exact decoder"])
def test_msda_nan_location_gives_nan_as_the_plain_version(dev, monkeypatch, mode):
    """A NaN location, and an infinite one, through each MSDA kernel mode:
    NaN at exactly the (query, head) rows where the plain version is NaN
    (the NaN always; the inf where its pair has no window), every other
    output within BOUND of it."""
    shapes = [(25, 42), (13, 21), (7, 11), (4, 6)]
    q = 900 if mode == "exact decoder" else None
    if mode == "exact encoder":
        monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    else:
        monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
    value, loc, attn = _msda(dev, 2, shapes, q, -0.2, 1.2, seed=3)
    loc[0, 17, 3, 1, 2, 0] = float("nan")   # a COARSE pair for an encoder query at level 0
    loc[1, 700, 5, 3, 0, 1] = float("inf")  # level 3: lq 0 to lv 3 is no exact ratio (25/4), so no window
    loc[1, 60, 0, 0, 1, 1] = float("-inf")  # level 0, its own level: a window clamps it for encoder queries
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    plain = tms.ms_deform_attn_clipped_plain if mode == "clipped" else tms.ms_deform_attn_plain
    ref = plain(value.float(), shapes, loc, attn)
    nan = torch.isnan(ref)
    rows = nan.reshape(2, -1, 8, 32).any(-1)
    want_rows = 3 if mode != "clipped" else 2
    assert torch.equal(torch.isnan(got), nan) and int(rows.sum()) == want_rows and bool(rows[0, 17, 3])
    assert _close(torch.where(nan, 0.0, got.float()), torch.where(nan, 0.0, ref))


@pytest.mark.cuda
def test_tiny_gdino_train_step_on_the_card(dev):
    """Two training steps of tiny MQ-GroundingDINO in bf16 on the card: per
    forward one clipped MSDA launch (its one encoder layer) and two exact
    ones (its two decoder layers), no bi-attention kernel (the fusion's
    training composite); every loss finite; the trainable fp32 masters
    move, the frozen parameters do not."""
    import numpy as np

    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_gdino_train_step, step_generator
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import build_model, init_params, synthetic_caption_batch, tiny_gdino_config

    cfg = tiny_gdino_config()
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE, cfg.SOLVER.MODEL_EMA, cfg.SOLVER.WARMUP_ITERS = "vision_query", 0.999, 0
    cfg.VISION_QUERY.TEXT_DROPOUT = 0.4
    b = synthetic_caption_batch(cfg, 2, (96, 96), num_labels=3, k_shot=2, seed=1)
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    boxes = np.array([[[4, 6, 40, 30], [20, 20, 60, 62]]] * 2, np.float32)
    batch.update(gt_boxes=boxes, gt_labels=np.array([[1, 2]] * 2, np.int32), gt_valid=np.ones((2, 2), bool),
                 gt_token_map=b["agg_map"][:, :2], pos_category_map=(b["agg_map"] > 0).astype(np.float32),
                 has_query=np.ones((2, 3), np.int32), image_sizes=np.array([[96, 96]] * 2, np.float32))
    model = init_params(build_model(cfg), seed=0).to(dev, torch.bfloat16)
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n in state.frozen}
    start = {n: t.clone() for n, t in state.trainable.items()}
    step = make_gdino_train_step(model, tx, cfg)
    launch_counts(reset=True)
    for it in range(2):
        state, metrics = step(state, batch_to_device(batch, dev), step_generator(0, it, dev))
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert {k: v for k, v in launch_counts().items() if v} == {"ms_deform_attn_clip": 2, "ms_deform_attn": 4}
    params = dict(model.named_parameters())
    assert all(torch.equal(params[n], t) for n, t in frozen.items())
    assert all(not torch.equal(t, start[n]) and t.dtype == torch.float32 for n, t in state.trainable.items())


@pytest.mark.cuda
def test_eval_cli_on_the_card_against_the_cpu(dev, tmp_path):
    """The evaluation CLI's body (`mqdet_torch.tools.eval.evaluate`) on a
    yaml written by `dump_yaml` and read by the port's reader (the card
    machine has no PyYAML), a reference-layout .pth and an .npz bank, tiny
    MQ-GLIP (T 64) on the card in bf16 and on the CPU in fp32: the same
    import report (0 missing, 0 unused), 13 gather-kernel DCN and one
    bi-attention launch per head group on the card, the same result keys,
    finite AP, bbox.csv written by both, and per image as many detections
    with the top score within 2e-2 (bf16 against fp32)."""
    import argparse
    import json

    import numpy as np

    from mqdet_torch.data.coco import CocoDetectionDataset
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine import eval_dispatch
    from mqdet_torch.engine.evaluator import DetectionEvaluator
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools.eval import evaluate
    from mqdet_torch.tools.train import load_config
    from mqdet_torch.utils.builders import build_model, init_params, tiny_test_config

    cfg = tiny_test_config()
    cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 64
    cfg.TPU.IMAGE_BUCKETS = ((64, 96),)
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 80
    cfg.TEST.CHUNKED_EVALUATION, cfg.TEST.CHUNK_PARALLELISM = 3, 2
    cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT, cfg.VISION_QUERY.NUM_QUERY_PER_CLASS = 3, 2
    cfg.MODEL.ATSS.INFERENCE_TH, cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 0.0, 6
    sizes = [(60, 80), (60, 80), (80, 60)]
    images = [{"id": i, "file_name": f"{i}.png", "height": h, "width": w} for i, (h, w) in enumerate(sizes)]
    anns = [{"id": i + 1, "image_id": i, "category_id": i % 8 + 1, "bbox": [5.0, 6.0, 30.0, 20.0], "area": 600.0,
             "iscrowd": 0} for i in range(3)]
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(["cat", "dog", "hot_dog", "ski pole", "bow_(weapon)",
                                                             "tie", "frisbee", "person"])]
    (tmp_path / "ann.json").write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    pixels = {i: np.random.default_rng(i).integers(0, 256, hw + (3,), dtype=np.uint8) for i, hw in enumerate(sizes)}

    class Seeded(CocoDetectionDataset):
        def load_image(self, img_id):
            return pixels[img_id]

    bank = QueryBank(channels=16)
    for lab in (1, 2, 4, 7):
        bank.add(lab, np.random.default_rng(lab).standard_normal((3, 1, 16)).astype(np.float32))
    bank.save(str(tmp_path / "bank.npz"))
    model = init_params(build_model(cfg), seed=0)
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}}, tmp_path / "w.pth")
    cfg.DATASETS.TEST = ("coco_val",)
    (tmp_path / "c.yaml").write_text(cfg.dump_yaml())

    class Recording(DetectionEvaluator):
        def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw):
            self.seen[image_id] = np.asarray(det_scores, np.float32)
            super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw)

    runs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        c = load_config(argparse.Namespace(
            config_file=str(tmp_path / "c.yaml"), task_config=None, additional_model_config=None,
            opts=["MODEL.WEIGHT", str(tmp_path / "w.pth"), "VISION_QUERY.QUERY_BANK_PATH", str(tmp_path / "bank.npz"),
                  "OUTPUT_DIR", str(out)]))
        evaluators = []

        def build(cfg_, style):
            evaluators.append(Recording(style=style, max_dets=cfg_.MODEL.ATSS.DETECTIONS_PER_IMG))
            evaluators[-1].seen = {}
            return evaluators[-1]

        record = {}
        launch_counts(reset=True)
        original = eval_dispatch.build_evaluator
        eval_dispatch.build_evaluator = build
        try:
            res = evaluate(c, dataset=Seeded(str(tmp_path / "ann.json"), str(tmp_path)), device=device,
                           tokenizer=WordPieceTokenizer(), log=lambda m: None, record=record)
        finally:
            eval_dispatch.build_evaluator = original
        runs[device] = (res, record, evaluators[0].seen, {k: v for k, v in launch_counts().items() if v})
        assert (out / "bbox.csv").read_text().startswith("AP,")
    (card, card_rec, card_seen, used), (cpu, cpu_rec, cpu_seen, cpu_used) = runs["cuda"], runs["cpu"]
    assert used == {"dcn_gather_clip": 3 * 2 * 13, "bi_attention": 3 * 2} and not cpu_used
    assert {k: len(v) for k, v in card_rec["import_report"].items()} == \
        {k: len(v) for k, v in cpu_rec["import_report"].items()}
    assert not card_rec["import_report"]["missing"] and not card_rec["import_report"]["unused"]
    assert set(card) == set(cpu) and np.isfinite(card["AP"]) and np.isfinite(cpu["AP"])
    for i in card_seen:
        assert len(card_seen[i]) == len(cpu_seen[i]) > 0
        assert abs(float(card_seen[i].max()) - float(cpu_seen[i].max())) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(DCN_ROUTES))
def test_dcn_function_inside_the_remat_checkpoint(dev, route):
    """A DCN route's Function inside `models.layers.remat` (TPU.REMAT's
    checkpoint) on the card: the forward, then the recompute in the
    backward, each launch the kernel (2 launches against 1 unchecked); the
    gradients, checkpointed and not, each within BOUND * max|ref| of the
    plain VJP in fp32; outside autograd (no_grad) one launch, no recompute."""
    from mqdet_torch.models.layers import remat
    from mqdet_torch.ops import launch_counts

    g = torch.Generator(device=dev).manual_seed(3)
    b, h, w, c = 2, 13, 21, 128
    ins = [torch.randn(b, h, w, c, generator=g, device=dev), torch.randn(b, h, w, 18, generator=g, device=dev) * 3,
           torch.rand(b, h, w, 9, generator=g, device=dev), torch.randn(3, 3, c, c, generator=g, device=dev) * 0.05,
           torch.randn(c, generator=g, device=dev)]
    ins = [t.bfloat16() for t in ins]
    gout = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    fwd, vjp = DCN_ROUTES[route]
    refs = vjp(*(t.float() for t in ins), gout.float(), s=1)
    counts = {}
    for checked in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        launch_counts(reset=True)
        y = remat(lambda *a: fwd(*a, s=1), *leaves, enabled=checked)
        y.backward(gout)
        torch.cuda.synchronize()
        counts[checked] = sum(launch_counts().values())
        for leaf, ref in zip(leaves, refs):
            assert _close(leaf.grad, ref)
    assert counts == {False: 1, True: 2}
    launch_counts(reset=True)
    with torch.no_grad():
        remat(lambda *a: fwd(*a, s=1), *ins, enabled=True)
    assert sum(launch_counts().values()) == 1


@pytest.mark.cuda
def test_remat_protocol_launches_the_plain_protocols_kernels(dev):
    """Tiny MQ-GLIP-L (C 128, so the band kernel runs; T 64, the
    bi-attention kernel's multiple) in bf16 on the card, TPU.REMAT on and
    off, the same weights: the LVIS protocol (2 groups of 2 chunks) launches
    8 x 13 `dcn_band` and 8 `bi_attention` a group either way, and the
    detections are bitwise equal (evaluation recomputes nothing)."""
    import numpy as np

    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import build_model, init_params, synthetic_batch, tiny_l_config

    hw = (64, 64)
    outs, counts = {}, {}
    for remat in (False, True):
        cfg = tiny_l_config()
        cfg.MODEL.BACKBONE.OUT_CHANNELS = cfg.MODEL.DYHEAD.CHANNELS = 128
        cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 64
        cfg.MODEL.ATSS.INFERENCE_TH = 0.0
        cfg.TPU.REMAT = remat
        model = init_params(build_model(cfg), seed=0).eval().to(dev, torch.bfloat16)
        text = [torch.from_numpy(np.stack([np.stack([synthetic_batch(cfg, 1, hw, 3, 2, seed=10 * g + c)[k][0]
                                                     for c in range(2)]) for g in range(2)])).to(dev)
                for k in ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")]
        image = torch.from_numpy(synthetic_batch(cfg, 1, hw, 3, 2, seed=5)["images"]).permute(0, 3, 1, 2).to(dev)
        sizes = torch.tensor([[[64.0, 64.0], [60.0, 52.0]]] * 2, device=dev)
        protocol = make_protocol_fn(model, hw, cfg)
        launch_counts(reset=True)
        outs[remat] = protocol(image, *text, sizes)
        torch.cuda.synchronize()
        counts[remat] = {k: v for k, v in launch_counts().items() if v}
    assert counts[False] == counts[True] == {"dcn_band": 2 * 8 * 13, "bi_attention": 2 * 8}
    for field in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(outs[False], field), getattr(outs[True], field))


def _switch_model(switch):
    """A tiny MQ-GLIP (C 128, so the band kernel runs; T 64, the bi-attention
    kernel's multiple) under one of phase 14's switch sets: "S1" (the GCP and
    query switches with the learnable bank, ADD_LINEAR_LAYER, MLM_LOSS) or
    "MHA-S"; its inputs (the learnable bank's indices under S1). Returns
    (cfg, model on the CPU in fp32, [image, ids, mask, queries, query_mask])."""
    import numpy as np

    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.utils.builders import (
        build_model, init_params, install_learnable_bank, synthetic_batch, tiny_test_config,
    )

    cfg = tiny_test_config()
    cfg.MODEL.BACKBONE.OUT_CHANNELS = cfg.MODEL.DYHEAD.CHANNELS = 128
    cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN = 64
    shape, selector = None, None
    if switch == "S1":
        for key in ("ADD_ADAPT_LAYER", "SHARE_KV", "AUGMENT_IMAGE_WITH_QUERY", "NEW_MASK_TOKEN", "ADD_VISION_LAYER",
                    "QUERY_FUSION", "LEARNABLE_BANK"):
            cfg.VISION_QUERY[key] = True
        cfg.VISION_QUERY.NO_CAT = False
        cfg.MODEL.DYHEAD.FUSE_CONFIG.ADD_LINEAR_LAYER = cfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS = True
        bank = QueryBank(channels=128)
        rng = np.random.default_rng(0)
        for label in (1, 2, 3):
            bank.add(label, rng.standard_normal((3, 1, 128)).astype(np.float32))
        selector = QuerySelector(bank, num_query_per_class=2, max_labels=3, emit_indices=True)
        shape = selector.bank_table_shape()
    else:
        cfg.MODEL.DYHEAD.FUSE_CONFIG.TYPE = switch
    model = init_params(build_model(cfg, bank_shape=shape), seed=0).eval()
    b = synthetic_batch(cfg, 1, (64, 64), 3, 2, seed=1)
    if selector is not None:
        install_learnable_bank(model, selector)
        loc = np.zeros((3, 64), np.float32)
        loc[:, 1:5] = 1
        b["queries"], b["query_mask"] = (x[None] for x in selector.select([1, 2, 3], loc)[:2])
    args = [torch.from_numpy(b["images"]).permute(0, 3, 1, 2).contiguous()] + [
        torch.from_numpy(b[k]) for k in ("input_ids", "attention_mask", "queries", "query_mask")]
    return cfg, model, args


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["S1", "MHA-S"])
def test_switch_model_on_the_card_against_the_cpu(dev, switch):
    """A tiny MQ-GLIP under S1 and under MHA-S in bf16 on the card against
    the same weights in fp32 on the CPU (plain versions): the dot-product
    logits (and S1's `mlm_logits`) within twice the CPU bf16 drift by
    relative L2 (floor 1e-2, phase 3's rule); launches 13 `dcn_band`, and 1
    `bi_attention` under S1 (MHA-B), 0 under MHA-S (one-way attention, plain
    PyTorch)."""
    import copy

    from mqdet_torch.ops import launch_counts

    cfg, model, args = _switch_model(switch)

    def run(m, device):
        with torch.inference_mode():
            out = m(*(a.to(device) for a in args))
        return [torch.cat([d.float().cpu().reshape(-1) for d in out["dot_product_logits"]])] + (
            [out["mlm_logits"].float().cpu()] if "mlm_logits" in out else [])

    ref, plain = run(model, "cpu"), run(copy.deepcopy(model).to(torch.bfloat16), "cpu")
    launch_counts(reset=True)
    got = run(copy.deepcopy(model).to(dev, torch.bfloat16), dev)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == (
        {"dcn_band": 13, "bi_attention": 1} if switch == "S1" else {"dcn_band": 13})
    assert len(got) == (2 if switch == "S1" else 1)
    for g, p, r in zip(got, plain, ref):
        err, drift = ((g - r).norm() / r.norm()).item(), ((p - r).norm() / r.norm()).item()
        assert err <= max(2 * drift, 1e-2), (err, drift)


# ---- the legacy family's slice: new shapes and switches -----------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [False, True])
def test_msda_kernels_at_three_levels(dev, monkeypatch, gather):
    """GDINO at 3 feature levels: encoder queries on K5's clipped mode
    (unset) or the exact mode (`gather`), and decoder queries (Q 900) on the
    exact mode, with a 3-level table, against the plain versions in fp32."""
    shapes = GDINO_800[:3]
    if gather:
        monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    else:
        monkeypatch.delenv("MQDET_MSDA_IMPL", raising=False)
    value, loc, attn = _msda(dev, 2, shapes, None, -0.2, 1.2, seed=3)
    counts = (tms.launch_count, tms.clip_launch_count)
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert (tms.launch_count, tms.clip_launch_count) == ((counts[0] + 1, counts[1]) if gather
                                                         else (counts[0], counts[1] + 1))
    plain = tms.ms_deform_attn_plain if gather else tms.ms_deform_attn_clipped_plain
    assert _close(got, plain(value.float(), shapes, loc, attn))
    value, loc, attn = _msda(dev, 2, shapes, 900, -0.5, 1.5, seed=4)
    got = tms.ms_deform_attn(value, shapes, loc, attn)
    assert _close(got, tms.ms_deform_attn_plain(value.float(), shapes, loc, attn))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_band_on_the_merged_canvas(dev, monkeypatch, stride):
    """DeformConvGN with merge_max_positions 600 over GLIP's two smallest
    800x1344 levels (stride 1: 13x21, 7x11; stride 2: 25x42, 13x21), offsets
    x3: one `dcn_band` launch for both, each output within the bound of the
    per-level launches' (two launches)."""
    from mqdet_torch.models.vldyhead import DeformConvGN

    monkeypatch.delenv("MQDET_DEFORM_IMPL", raising=False)
    g = torch.Generator(device=dev).manual_seed(stride)
    mod = DeformConvGN(256, 256, stride, 16, merge_max_positions=600).to(dev, torch.bfloat16)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.randn(256, 256, 3, 3, generator=g, device=dev) * 0.02)
    levels = [(13, 21), (7, 11)] if stride == 1 else [(25, 42), (13, 21)]
    xs = [torch.randn(2, 256, h, w, generator=g, device=dev).bfloat16().contiguous(memory_format=torch.channels_last)
          for h, w in levels]
    outs = [(-(-h // stride), -(-w // stride)) for h, w in levels]
    offs = [(torch.randn(2, h, w, 18, generator=g, device=dev) * 3).bfloat16() for h, w in outs]
    masks = [torch.rand(2, h, w, 9, generator=g, device=dev).bfloat16() for h, w in outs]
    with torch.no_grad():
        n0 = tdc.band_launch_count
        merged = mod(xs, offs, masks)
        torch.cuda.synchronize()
        assert tdc.band_launch_count == n0 + 1
        mod.merge_max_positions = 0
        one = mod(xs, offs, masks)
        torch.cuda.synchronize()
        assert tdc.band_launch_count == n0 + 3
    for a, b in zip(merged, one):
        assert tuple(a.shape) == tuple(b.shape) and _close(a, b.float())


@pytest.mark.cuda
def test_fusion_impl_xla_launches_no_bi_attention(dev, monkeypatch):
    """MQDET_FUSION_IMPL=xla: the bi-attention runs its plain version on
    the card, no launch; the default launches the kernel; the two agree by
    the kernel bound."""
    from mqdet_torch.models.fusion import BiMultiHeadAttention

    g = torch.Generator(device=dev).manual_seed(0)
    attn = BiMultiHeadAttention(256, 768, 2048, 8).to(dev, torch.bfloat16).eval()
    v = [torch.randn(2, n, 256, generator=g, device=dev).bfloat16() for n in (1600, 400)]
    lang = torch.randn(2, 256, 768, generator=g, device=dev).bfloat16()
    mask = torch.ones(2, 256, device=dev, dtype=torch.int64)
    mask[1, 100:] = 0
    with torch.no_grad():
        monkeypatch.delenv("MQDET_FUSION_IMPL", raising=False)
        n0 = tba.launch_count
        kv, kl = attn(v, lang, mask)
        torch.cuda.synchronize()
        assert tba.launch_count == n0 + 1
        monkeypatch.setenv("MQDET_FUSION_IMPL", "xla")
        pv, pl = attn(v, lang, mask)
        torch.cuda.synchronize()
        assert tba.launch_count == n0 + 1
    for a, b in zip(kv + [kl], pv + [pl]):
        assert _close(a, b.float())


@pytest.mark.cuda
def test_pools_on_the_card_match_the_cpu(dev):
    from mqdet_torch.ops.deform_pool import deform_psroi_pool
    from mqdet_torch.ops.roi_align import roi_pool

    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 30, 40, 36, generator=g)
    rois = torch.tensor([[0, 10.3, 20.5, 300.1, 180.7], [1, -40.0, -12.0, 90.0, 70.0], [1, 33.0, 44.0, 37.0, 50.0]])
    trans = torch.randn(3, 2, 2, 3, 3, generator=g)
    kw = dict(spatial_scale=1.0 / 8, output_dim=4, pooled_size=5, group_size=3, part_size=3, sample_per_part=3)
    ref = deform_psroi_pool(feats, rois, trans, **kw)
    got = deform_psroi_pool(feats.to(dev), rois.to(dev), trans.to(dev), **kw).cpu()
    assert torch.allclose(got, ref, atol=1e-5)
    ref = roi_pool(feats[0], rois[:, 1:], 1.0 / 8, 7)
    assert torch.allclose(roi_pool(feats[0].to(dev), rois[:, 1:].to(dev), 1.0 / 8, 7).cpu(), ref, atol=1e-6)
