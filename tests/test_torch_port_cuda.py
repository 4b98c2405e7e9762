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
