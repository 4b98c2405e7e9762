"""mqdet_torch ops vs the JAX package: the plain versions of the two CUDA
kernels (DCNv2, bi-attention), the strided offset reinterpretation, NMS and
ATSS post-processing, plus the wrappers' device dispatch.

Inputs are numpy arrays from a seed, fp32 on both sides (conftest forces
highest matmul precision on the JAX side). Tolerances are fp32 rounding:
atol 1e-4 on O(1) outputs unless stated. The JAX bi-attention reference is
the Pallas kernel in interpret mode, as the JAX package's own tests run it.

The wrappers launch a kernel only for CUDA tensors; the kernels themselves
are tested on a card by tests/test_torch_port_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_torch.ops import bi_attention as tba
from mqdet_torch.ops import deform_conv as tdc

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _dcn_inputs(rng, b, h, w, c, cout, stride, off_scale):
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    off = np.clip(rng.standard_normal((b, ho, wo, 18)) * off_scale, -8, 8).astype(np.float32)
    mask = rng.random((b, ho, wo, 9)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, off, mask, wt, bias


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_plain_matches_jax_exact(stride):
    """Offsets up to +-8 px (far past the TPU kernel's +-2 window), samples
    off the image, odd sizes, B = 2."""
    from mqdet_tpu.ops.deform_conv import modulated_deform_conv

    rng = np.random.default_rng(stride)
    args = _dcn_inputs(rng, 2, 11, 14, 8, 16, stride, off_scale=4.0)
    assert np.abs(args[1]).max() == 8.0
    want = modulated_deform_conv(*map(jnp.asarray, args), stride=stride)
    got = tdc.modulated_deform_conv(*map(torch.from_numpy, args), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


def test_dcn_plain_without_bias_and_zero_offsets_is_a_conv():
    """Zero offsets and a unit mask reduce DCNv2 to a 3x3 pad-1 conv."""
    rng = np.random.default_rng(3)
    x, off, mask, wt, _ = _dcn_inputs(rng, 2, 9, 7, 8, 8, 2, 0.0)
    got = tdc.modulated_deform_conv(
        torch.from_numpy(x), torch.zeros_like(torch.from_numpy(off)),
        torch.ones_like(torch.from_numpy(mask)), torch.from_numpy(wt), None, 2,
    )
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(wt).permute(3, 2, 0, 1),
        stride=2, padding=1,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_reinterpret_offsets_strided_is_per_item():
    from mqdet_tpu.ops.deform_conv import reinterpret_offsets_strided as jr

    rng = np.random.default_rng(4)
    off = rng.standard_normal((2, 8, 10, 18)).astype(np.float32)
    mask = rng.random((2, 8, 10, 9)).astype(np.float32)
    jo, jm = jr(jnp.asarray(off), jnp.asarray(mask), 4, 5)
    to, tm = tdc.reinterpret_offsets_strided(torch.from_numpy(off), torch.from_numpy(mask), 4, 5)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # item 1's result depends on item 1 alone (no cross-item bleed)
    alone, _ = tdc.reinterpret_offsets_strided(
        torch.from_numpy(off[1:]), torch.from_numpy(mask[1:]), 4, 5
    )
    np.testing.assert_array_equal(to[1:].numpy(), alone.numpy())
    # and it is the first 18*4*5 values of the item's channel-major buffer
    flat = off[1].transpose(2, 0, 1).reshape(-1)[: 18 * 20]
    np.testing.assert_array_equal(to[1].numpy(), flat.reshape(18, 4, 5).transpose(1, 2, 0))


def _bi_inputs(rng, b, n, t, e):
    q = (rng.standard_normal((b, n, e)) * 0.1).astype(np.float32)
    k = rng.standard_normal((b, t, e)).astype(np.float32)
    vv = rng.standard_normal((b, n, e)).astype(np.float32)
    vl = rng.standard_normal((b, t, e)).astype(np.float32)
    keep = rng.uniform(0, 1, (b, t)) > 0.25
    keep[:, t - t // 4 :] = False  # a padded text tail
    bias = np.where(keep, 0.0, -9e15).astype(np.float32)
    return q, k, vv, vl, bias


def test_bi_attention_plain_matches_jax_flash_interpret():
    """700 vision rows = 2 full tiles of 256 + a padded tail in the JAX
    kernel; masked text tokens. atol 2e-3, the JAX package's own bound for
    this kernel (tests/test_ops.py)."""
    from mqdet_tpu.ops.pallas.bi_attention_pallas import flash_bi_attention

    rng = np.random.default_rng(5)
    args = _bi_inputs(rng, 2, 700, 128, 256)
    jv, jl = flash_bi_attention(*map(jnp.asarray, args), num_heads=2, block_n=256, interpret=True)
    tv, tl = tba.flash_bi_attention(*map(torch.from_numpy, args), num_heads=2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)


def test_bi_attention_plain_matches_jax_composite():
    """Against the XLA composite of fusion.BiMultiHeadAttention (the path the
    JAX package takes off the TPU), through the whole attention module."""
    from mqdet_tpu.models.fusion import BiMultiHeadAttention as JBi

    from mqdet_torch.io.from_jax import params_from_jax
    from mqdet_torch.models.fusion import BiMultiHeadAttention

    rng = np.random.default_rng(6)
    v = rng.standard_normal((2, 300, 16)).astype(np.float32)
    l = rng.standard_normal((2, 64, 32)).astype(np.float32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0
    jmod = JBi(v_dim=16, l_dim=32, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(v), jnp.asarray(l), jnp.asarray(mask))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params
    )
    jv, jl = jmod.apply(params, jnp.asarray(v), jnp.asarray(l), jnp.asarray(mask))
    tmod = BiMultiHeadAttention(16, 32)
    flat = {
        f"rpn/fuse_0/b_attn/attn/{'/'.join(str(getattr(k, 'key', k)) for k in p[1:])}": np.asarray(x)
        for p, x in jax.tree_util.tree_leaves_with_path(params)
    }
    sd = params_from_jax(flat)
    prefix = "rpn.head.dyhead_tower.0.b_attn.attn."
    tmod.load_state_dict({k[len(prefix):]: v_ for k, v_ in sd.items()})
    with torch.no_grad():
        tv, tl = tmod(torch.from_numpy(v), torch.from_numpy(l), torch.from_numpy(mask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_nms_matches_jax_matrix_nms():
    from mqdet_tpu.ops.nms import class_aware_nms_matrix

    from mqdet_torch.ops.nms import class_aware_nms

    rng = np.random.default_rng(7)
    n = 700
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    labels = rng.integers(1, 4, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    ji, jv = class_aware_nms_matrix(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid), 0.5, 100,
        row_block=256,
    )
    ti, tv = class_aware_nms(
        torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(labels)[None], torch.from_numpy(valid)[None], 0.5, 100, row_block=256,
    )
    jv = np.asarray(jv)
    assert jv.sum() > 20
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(ti[0].numpy()[jv], np.asarray(ji)[jv])


def test_atss_postprocess_matches_jax():
    from mqdet_tpu.models.postprocess import PostprocessParams as JP
    from mqdet_tpu.models.postprocess import atss_postprocess as jpost
    from mqdet_tpu.ops.anchors import anchors_for_fpn

    from mqdet_torch.models.postprocess import PostprocessParams, atss_postprocess

    rng = np.random.default_rng(8)
    b, t, c = 2, 16, 3
    hw = (64, 96)
    anchors = anchors_for_fpn(hw)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    bbox = [rng.standard_normal((b, h, w, 4)).astype(np.float32) for h, w in sizes]
    ctr = [rng.standard_normal((b, h, w, 1)).astype(np.float32) for h, w in sizes]
    dot = [(rng.standard_normal((b, h * w, t)) * 2).astype(np.float32) for h, w in sizes]
    agg = np.zeros((b, c, t), np.float32)
    for j in range(c):
        agg[:, j, [2 * j + 1, 2 * j + 2]] = 0.5
    image_sizes = np.array([[64, 96], [50, 70]], np.float32)
    kw = dict(pre_nms_thresh=0.3, pre_nms_top_n=40, nms_thresh=0.6, detections_per_img=30)
    want = jax.jit(lambda h, g, s: jpost(h, [jnp.asarray(a) for a in anchors], g, s, JP(**kw)))(
        {"bbox_reg": [jnp.asarray(x) for x in bbox], "centerness": [jnp.asarray(x) for x in ctr],
         "dot_product_logits": [jnp.asarray(x) for x in dot]},
        jnp.asarray(agg), jnp.asarray(image_sizes),
    )
    got = atss_postprocess(
        {"bbox_reg": [torch.from_numpy(x.transpose(0, 3, 1, 2)) for x in bbox],
         "centerness": [torch.from_numpy(x.transpose(0, 3, 1, 2)) for x in ctr],
         "dot_product_logits": [torch.from_numpy(x) for x in dot]},
        [torch.from_numpy(a) for a in anchors], torch.from_numpy(agg),
        torch.from_numpy(image_sizes), PostprocessParams(**kw),
    )
    v = np.asarray(want.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-4)


def test_wrappers_take_the_plain_path_only_on_cpu():
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in _dcn_inputs(rng, 1, 5, 6, 8, 8, 1, 1.0)]
    n0 = tdc.launch_count
    out = tdc.modulated_deform_conv(*args, stride=1)
    assert out.shape == (1, 5, 6, 8) and tdc.launch_count == n0
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        tdc.modulated_deform_conv(*meta, stride=1)
    bargs = [torch.from_numpy(a) for a in _bi_inputs(rng, 1, 10, 64, 256)]
    n0 = tba.launch_count
    ov, ol = tba.flash_bi_attention(*bargs, num_heads=1)
    assert ov.shape == (1, 10, 256) and ol.shape == (1, 64, 256) and tba.launch_count == n0
    with pytest.raises(ValueError):
        tba.flash_bi_attention(*[a.to("meta") for a in bargs], num_heads=1)


def test_kernel_library_name_tracks_the_sources(tmp_path, monkeypatch):
    """The build is keyed by a hash of csrc/*.cu: an edited source gives a
    new library path (no nvcc needed to check)."""
    import shutil

    from mqdet_torch.ops import kernels

    before = kernels.library_path()
    assert len(kernels.sources()) == 2
    for src in kernels.sources():
        shutil.copy(src, tmp_path)
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    assert kernels.library_path() == before
    with open(tmp_path / "deform_conv.cu", "a") as f:
        f.write("\n// edit\n")
    assert kernels.library_path() != before
