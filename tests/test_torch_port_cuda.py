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


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 13, 21, 64, 136), (1, 5, 7, 8, 8), (4, 7, 11, 256, 256)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,t,heads", [(1, 100, 64, 1), (2, 700, 128, 2), (1, 3000, 256, 8)])
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
