"""The port's flop accounting (`utils/flop_count.py`, `utils/stats.py`)
against the JAX package's.

Each JAX Pallas entry point is traced under JAX's `flop_count.measure()`
with `jax.make_jaxpr` (interpret mode; tracing runs no kernel), and the
port's wrapper runs on the CPU under the port's `measure()` at the same
shapes: the registries must be equal, key for key, for K1 (version 2), K3
(single and dual scores), K4 and K5. K5's pairs that JAX leaves to its
gather composite report under `msda_exact` in the port (its kernel computes
them): at a 3-level pyramid there are none and the registries are equal;
at 4 levels with a 1x1 level (ratios of 16) the port's `msda_pallas` equals
JAX's. The exact routes report their sibling's formula. `flops_of` counts a
kernel once: the plain version's products inside a wrapper are not counted
on top of its report. `count_params` equals JAX's on MQ-GLIP-T tiny,
MQ-GroundingDINO-T tiny and R-50-RETINANET; `flops_of` equals JAX's
compiler cost analysis on a bias-free dense and a 3x3 convolution within
1% at an 800x1344 level (the difference found: XLA leaves out the taps on
the zero padding, the operator counter does not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqdet_tpu.ops.pallas import bi_attention_pallas as jbi
from mqdet_tpu.ops.pallas import deform_conv_pallas as jdcn
from mqdet_tpu.ops.pallas import msda_pallas as jmsda
from mqdet_tpu.utils import flop_count as jfc
from mqdet_tpu.utils import stats as jstats
from mqdet_torch.ops import bi_attention as tbi
from mqdet_torch.ops import deform_conv as tdcn
from mqdet_torch.ops import ms_deform_attn as tmsda
from mqdet_torch.utils import flop_count as tfc
from mqdet_torch.utils import stats as tstats

torch.set_num_threads(2)


def jax_registry(fn, *args):
    with jfc.measure() as m:
        jax.make_jaxpr(lambda *a: fn(*a))(*args)
    return m.by_kernel()


def port_registry(fn, *args):
    with tfc.measure() as m:
        fn(*args)
    return m.by_kernel()


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def dcn_inputs(rng, b=2, h=16, w=24, c=16, cout=32, stride=1):
    ho, wo = -(-h // stride), -(-w // stride)
    return (_np(rng, b, h, w, c), _np(rng, b, ho, wo, 18, scale=3.0), rng.random((b, ho, wo, 9)).astype(np.float32),
            _np(rng, 3, 3, c, cout, scale=0.1), _np(rng, cout))


def bi_inputs(rng, b=2, n=160, t=16, e=64):
    return _np(rng, b, n, e), _np(rng, b, t, e), _np(rng, b, n, e), _np(rng, b, t, e), np.zeros((b, t), np.float32)


MSDA_SHAPES = {"3 levels": [(16, 16), (8, 8), (4, 4)], "4 levels": [(16, 16), (8, 8), (4, 4), (1, 1)]}


def msda_inputs(rng, shapes, b=2, q=None, nh=2, hd=8, p=3):
    s = sum(h * w for h, w in shapes)
    q = s if q is None else q
    return (_np(rng, b, s, nh, hd), rng.random((b, q, nh, len(shapes), p, 2)).astype(np.float32),
            rng.random((b, q, nh, len(shapes), p)).astype(np.float32))


def test_k1_reports_match_jax():
    rng = np.random.default_rng(0)
    for stride in (1, 2):
        x, off, mask, w, bias = dcn_inputs(rng, stride=stride)
        want = jax_registry(lambda *a: jdcn.modulated_deform_conv_pallas(*a, stride=stride, interpret=True),
                            *(jnp.asarray(a) for a in (x, off, mask, w, bias)))
        got = port_registry(lambda *a: tdcn.modulated_deform_conv_pallas(*a, stride=stride),
                            *(torch.from_numpy(a) for a in (x, off, mask, w, bias)))
        assert want and got == want


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_k3_reports_match_jax(dual):
    rng = np.random.default_rng(1)
    args = bi_inputs(rng)
    want = jax_registry(lambda *a: jbi.flash_bi_attention(*a, num_heads=4, interpret=True, dual_scores=dual),
                        *(jnp.asarray(a) for a in args))
    got = port_registry(lambda *a: tbi.flash_bi_attention(*a, num_heads=4, dual_scores=dual),
                        *(torch.from_numpy(a) for a in args))
    assert want and got == want


def test_k4_reports_match_jax():
    rng = np.random.default_rng(2)
    q, k, vv, vl, bias = bi_inputs(rng, n=224)
    cuts = (0, 128, 192, 224)
    qs = [q[:, a:b] for a, b in zip(cuts, cuts[1:])]
    vvs = [vv[:, a:b] for a, b in zip(cuts, cuts[1:])]
    want = jax_registry(lambda qs, k, vvs, vl, bias: jbi.flash_bi_attention_levels(qs, k, vvs, vl, bias, 4,
                                                                                   interpret=True),
                        [jnp.asarray(a) for a in qs], jnp.asarray(k), [jnp.asarray(a) for a in vvs],
                        jnp.asarray(vl), jnp.asarray(bias))
    got = port_registry(lambda: tbi.flash_bi_attention_levels([torch.from_numpy(a) for a in qs], torch.from_numpy(k),
                                                              [torch.from_numpy(a) for a in vvs], torch.from_numpy(vl),
                                                              torch.from_numpy(bias), 4))
    assert want and got == want


@pytest.mark.parametrize("pyramid", sorted(MSDA_SHAPES))
def test_k5_reports_match_jax(pyramid, monkeypatch):
    """The clipped call (MQDET_MSDA_IMPL=pallas_interpret on the CPU, K5's
    function): `msda_pallas` equal to JAX's; the pairs JAX's kernel leaves
    to its composite under `msda_exact`, the same per-point formula (at 4
    levels: 16x16 queries against the 1x1 level, a ratio of 16, and 1x1
    queries against the 16x and 8x finer levels)."""
    monkeypatch.setenv("MQDET_MSDA_IMPL", "pallas_interpret")
    shapes = MSDA_SHAPES[pyramid]
    rng = np.random.default_rng(3)
    value, loc, attn = msda_inputs(rng, shapes)
    want = jax_registry(lambda v, l, a: jmsda.ms_deform_attn_encoder(v, shapes, l, a, interpret=True),
                        *(jnp.asarray(a) for a in (value, loc, attn)))
    got = port_registry(lambda *a: tmsda.ms_deform_attn(a[0], shapes, a[1], a[2]),
                        *(torch.from_numpy(a) for a in (value, loc, attn)))
    assert want
    if pyramid == "3 levels":
        assert got == want
    else:
        assert got["msda_pallas"] == want["msda_pallas"]
        b, _, nh, hd = value.shape
        p = loc.shape[4]
        exact = [(0, 3), (3, 0), (3, 1)]  # (query level, value level)
        assert got["msda_exact"] == sum(b * shapes[lq][0] * shapes[lq][1] * nh * p * hd * 10.0 for lq, _ in exact)


def test_exact_routes_report_their_siblings_count(monkeypatch):
    """The exact DCN (`modulated_deform_conv`) and the window route report
    K1's count at the same shapes; the exact MSDA on encoder queries reports
    K5's total where K5 takes every pair, and on decoder queries the same
    per-point formula."""
    rng = np.random.default_rng(4)
    x, off, mask, w, bias = dcn_inputs(rng)
    k1 = jax_registry(lambda *a: jdcn.modulated_deform_conv_pallas(*a, interpret=True),
                      *(jnp.asarray(a) for a in (x, off, mask, w, bias)))
    targs = [torch.from_numpy(a) for a in (x, off, mask, w, bias)]
    for fn in (tdcn.modulated_deform_conv, tdcn.modulated_deform_conv_window, tdcn.modulated_deform_conv_pallas_gather):
        assert port_registry(fn, *targs) == k1, fn.__name__
    shapes = MSDA_SHAPES["3 levels"]
    value, loc, attn = msda_inputs(rng, shapes)
    k5 = jax_registry(lambda v, l, a: jmsda.ms_deform_attn_encoder(v, shapes, l, a, interpret=True),
                      *(jnp.asarray(a) for a in (value, loc, attn)))
    monkeypatch.setenv("MQDET_MSDA_IMPL", "gather")
    tv, tl, ta = (torch.from_numpy(a) for a in (value, loc, attn))
    assert port_registry(lambda: tmsda.ms_deform_attn(tv, shapes, tl, ta)) == {"msda_exact": k5["msda_pallas"]}
    value, loc, attn = msda_inputs(rng, shapes, q=7)  # decoder queries
    b, q, nh, levels, p, _ = loc.shape
    tv, tl, ta = (torch.from_numpy(a) for a in (value, loc, attn))
    got = port_registry(lambda: tmsda.ms_deform_attn(tv, shapes, tl, ta))
    assert got == {"msda_exact": b * q * nh * levels * p * value.shape[-1] * 10.0}


def _wrapped_calls():
    """(name, the wrapper's call, its plain version's call, its report) on
    CPU tensors."""
    rng = np.random.default_rng(5)
    x, off, mask, w, bias = (torch.from_numpy(a) for a in dcn_inputs(rng))
    q, k, vv, vl, bl = (torch.from_numpy(a) for a in bi_inputs(rng))
    shapes = MSDA_SHAPES["3 levels"]
    value, loc, attn = (torch.from_numpy(a) for a in msda_inputs(rng, shapes, q=7))
    return {
        "dcn": (lambda: tdcn.modulated_deform_conv_pallas(x, off, mask, w, bias),
                lambda: tdcn.modulated_deform_conv_clipped_plain(x, off, mask, w, bias),
                {"dcn_pallas": tdcn.dcn_flops(off, x, w)}),
        "bi_attention": (lambda: tbi.flash_bi_attention(q, k, vv, vl, bl, 4),
                         lambda: tbi.bi_attention_plain(q, k, vv, vl, bl, 4),
                         {"flash_bi_attention": tbi.bi_attention_flops(q.shape, k.shape[1], False)}),
        "msda": (lambda: tmsda.ms_deform_attn(value, shapes, loc, attn),
                 lambda: tmsda.ms_deform_attn_plain(value, shapes, loc, attn),
                 tmsda.msda_flops(shapes, 2, 7, 2, 3, 8, False)),
    }


@pytest.mark.parametrize("name", ["bi_attention", "dcn", "msda"])
def test_flops_of_counts_a_kernel_once(name):
    """flops_of(a dense product then the wrapper) = the product's flops + the
    wrapper's report: the plain version's own products inside the wrapper
    are not counted. The plain version called directly is counted by the
    operator counter alone."""
    wrapper, plain, report = _wrapped_calls()[name]
    a, b = torch.randn(8, 16), torch.randn(16, 12)
    product = 2.0 * 8 * 16 * 12

    def call(inner):
        def fn():
            a @ b
            inner()
        return fn

    total, ops, kernels_ = tstats.flops_with_kernels(call(wrapper))
    assert kernels_ == report and ops == product and total == product + sum(report.values())
    total, ops, kernels_ = tstats.flops_with_kernels(call(plain))
    assert kernels_ == {} and total == ops
    if name != "msda":  # the MSDA plain version gathers and sums: no product the counter counts
        assert ops > product


def test_measure_nests_and_restores_as_jax():
    def run(fc):
        out = []
        fc.add("outside", 1.0)  # no-op
        with fc.measure() as outer:
            fc.add("a", 1.0)
            with fc.measure() as inner:
                fc.add("a", 2.0)
                fc.add("b", 3.0)
            fc.add("c", 4.0)
            out += [inner.by_kernel(), inner.total()]
        out += [outer.by_kernel(), outer.total()]
        fc.add("after", 1.0)
        return out

    assert run(tfc) == run(jfc) == [{"a": 2.0, "b": 3.0}, 5.0, {"a": 1.0, "c": 4.0}, 5.0]
    with tfc.measure() as m:
        assert not tfc.inside_kernel()
        with tfc.kernel(x=2.0, y=1.0):
            assert tfc.inside_kernel()
        assert not tfc.inside_kernel()
    assert m.by_kernel() == {"x": 2.0, "y": 1.0}


def _glip_counts():
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.utils import builders as tb
    from test_torch_port_modules import jax_init_args

    jcfg, tcfg = jb.tiny_test_config(), tb.tiny_test_config()
    jm = jb.build_model(jcfg)
    _, args = jax_init_args(jcfg)
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), tb.build_model(tcfg)


def _gdino_counts():
    from mqdet_tpu.utils import builders as jb
    from mqdet_torch.utils import builders as tb

    jcfg, tcfg = jb.tiny_gdino_config(), tb.tiny_gdino_config()
    jm = jb.build_model(jcfg)
    b = tb.synthetic_caption_batch(tcfg, 1, (96, 96), num_labels=3, k_shot=2, seed=0)
    keys = ("images", "input_ids", "attention_mask", "queries", "query_mask")
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in keys)), tb.build_model(tcfg)


def _legacy_counts():
    from mqdet_tpu.core.config import default_config as jdefault
    from mqdet_tpu.models.legacy_heads import build_legacy_detector as jbuild
    from mqdet_torch.core.config import default_config as tdefault
    from mqdet_torch.models.legacy_heads import build_legacy_detector as tbuild

    cfgs = []
    for cfg in (jdefault(), tdefault()):
        cfg.MODEL.BACKBONE.CONV_BODY = "R-50-RETINANET"
        cfg.MODEL.RPN_ARCHITECTURE = "RETINA"
        cfgs.append(cfg)
    jm = jbuild(cfgs[0])
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), tbuild(cfgs[1])


@pytest.mark.parametrize("model", ["glip", "gdino", "legacy"])
def test_count_params_matches_jax(model):
    params, tmodel = {"glip": _glip_counts, "gdino": _gdino_counts, "legacy": _legacy_counts}[model]()
    n = tstats.count_params(tmodel)
    assert n == jstats.count_params(params) > 0
    by = tstats.count_params_by_prefix(tmodel, depth=1)
    assert sum(by.values()) == n and list(by.values()) == sorted(by.values(), reverse=True)
    assert tstats.model_complexity(torch.nn.Linear(4, 3, bias=False), torch.zeros(2, 4)) == (12, 48.0)


def _dense_conv(h, w, c=16, mid=24, cout=32):
    """(jax fn, port fn, input) of a bias-free dense then a 3x3 convolution,
    pad 1, on a (1, h, w, c) map."""
    rng = np.random.default_rng(6)
    x = _np(rng, 1, h, w, c)
    wd = _np(rng, c, mid)
    wc = _np(rng, 3, 3, mid, cout)

    def jfn(x):
        y = x @ jnp.asarray(wd)
        return jax.lax.conv_general_dilated(y, jnp.asarray(wc), (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def tfn(x):
        y = (x @ torch.from_numpy(wd)).permute(0, 3, 1, 2)
        return torch.nn.functional.conv2d(y, torch.from_numpy(wc).permute(3, 2, 0, 1), padding=1)

    return jfn, tfn, x


@pytest.mark.parametrize("hw", [(200, 336), (16, 20)], ids=["800x1344 stride 4", "16x20"])
def test_flops_of_matches_jax_cost_analysis(hw):
    """A bias-free dense then a 3x3 convolution (pad 1): the port's total
    (the operator counter) against XLA's cost analysis. The difference found:
    the counter counts every tap of the convolution, XLA only the taps that
    fall inside the map (none on the zero padding), so XLA's conv count is
    (3H - 2)(3W - 2) / (9 H W) of the counter's. That relation holds exactly
    at both sizes; at a level of the 800x1344 bucket (stride 4, 200x336) the
    two totals are within 1%, at 16x20 7.5% apart."""
    h, w = hw
    jfn, tfn, x = _dense_conv(h, w)
    want = jstats.flops_of(jfn, jnp.asarray(x))
    got = tstats.flops_of(tfn, torch.from_numpy(x))
    c, mid, cout = x.shape[-1], 24, 32
    dense, conv = 2.0 * h * w * c * mid, 2.0 * h * w * mid * cout * 9
    assert got == dense + conv
    assert want == dense + conv * (3 * h - 2) * (3 * w - 2) / (9 * h * w)
    if h >= 100:
        assert abs(got - want) <= 0.01 * want


def test_flops_of_under_inference_mode_with_a_parameter_as_a_module_input():
    """FlopCounterMode's own module tracker fails under inference mode where
    a parameter is a module's input (MQ-GroundingDINO's decoder layers);
    `flops_of` counts it."""
    class Inner(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 6, bias=False)

        def forward(self, x):
            return self.lin(x)

    class Outer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner, self.query = Inner(), torch.nn.Parameter(torch.randn(3, 4))

        def forward(self):
            return self.inner(self.query)

    with torch.inference_mode():
        assert tstats.flops_of(Outer()) == 2.0 * 3 * 4 * 6


@pytest.mark.parametrize("family", ["glip", "gdino"])
def test_protocol_registries_scale_with_the_image_batch(family):
    """On the CPU's plain route, one per-image protocol call and one batched
    call at B 2 (tiny configs; what chip_smoke phase 17 gates on the card):
    every kernel family of the registry reported, the batched call's entry 2
    x the per-image call's, exactly, and the operator counter's total
    positive."""
    from mqdet_torch.engine.predict import make_batched_protocol_fn, make_protocol_fn
    from mqdet_torch.utils import builders as tb

    cfg = tb.tiny_test_config() if family == "glip" else tb.tiny_gdino_config()
    hw = (64, 64) if family == "glip" else (96, 96)
    model = tb.init_params(tb.build_model(cfg), seed=0).eval()
    make = tb.synthetic_batch if family == "glip" else tb.synthetic_caption_batch
    b = make(cfg, batch=2, image_hw=hw, num_labels=3, k_shot=2, seed=1)  # CP 2 chunks, two groups of them
    keys = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map", "image_sizes")
    text = [torch.from_numpy(b[k])[None].expand(2, *b[k].shape).contiguous() for k in keys]
    images = torch.from_numpy(b["images"]).permute(0, 3, 1, 2).contiguous()
    image = images[:1]
    single = make_protocol_fn(model, hw, cfg)
    batched = make_batched_protocol_fn(model, hw, cfg, 2)
    _, ops_one, one = tstats.flops_with_kernels(single, image, *text)
    _, ops_two, two = tstats.flops_with_kernels(batched, images, text[5][0], *text[:5])
    want = {"dcn_pallas", "flash_bi_attention"} if family == "glip" else {"flash_bi_attention", "msda_exact"}
    assert set(one) == set(two) == want  # the CPU runs GDINO's MSDA exact, as the JAX package's CPU backend
    assert all(two[k] == 2 * one[k] > 0 for k in one)
    assert ops_one > 0 and ops_two > ops_one
