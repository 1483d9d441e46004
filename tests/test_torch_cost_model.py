"""The port's measured cost stack against the JAX package's.

Pins: the profiler's counts, kind by kind, against ``repro.core.profiler``
(XLA's ``cost_analysis``) — within [0.9, 1.1] of XLA's count, or at the
ratio ``EXPLAINED`` records with its cause; timing caches and calibration
files cross between the packages in both directions with identical layer
times and identical plans; ``OnlineCost`` fed one observation sequence
holds the JAX one's scales exactly (host arithmetic); and the measured /
blended cases of ``tests/test_cost_planner.py`` on the port.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcm  # noqa: E402
from repro.core import profiler as jprof  # noqa: E402
from repro.core.api import plan as jplan  # noqa: E402
from repro.core.constraints import DLA_ANALOGUE_CONSTRAINTS as JDLA  # noqa: E402
from repro.core.engine import jetson_orin_engines as jengines  # noqa: E402
import repro.models as jm  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core.api import plan as tplan  # noqa: E402
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS as TDLA  # noqa: E402
from repro_torch.core.engine import jetson_orin_engines as tengines  # noqa: E402
from repro_torch.core.graph import pointwise_meta  # noqa: E402
import repro_torch.models as tm  # noqa: E402

# ---- the profiler's counts against XLA's -----------------------------------

CONV = {
    "conv_k4s2": ((1, 32, 32, 3), 4, 2, 1, 8, False),  # a Pix2Pix down conv
    "conv_k3s1": ((1, 16, 16, 8), 3, 1, 1, 16, False),  # a YOLO ConvBlock
    "conv_k1": ((1, 8, 8, 16), 1, 1, 0, 66, False),  # a YOLO head 1x1
    "deconv_k4s2": ((1, 16, 16, 8), 4, 2, 1, 8, True),  # a Pix2Pix up deconv
}
FUSED = {
    "fused_conv_bn_lrelu": ((1, 32, 32, 3), 4, 2, 1, 8, False, "batch", "lrelu"),
    "fused_deconv_bn_relu": ((1, 16, 16, 8), 4, 2, 1, 8, True, "batch", "relu"),
    "fused_conv_bn_silu": ((1, 16, 16, 8), 3, 1, 1, 8, False, "batch", "silu"),
    "fused_deconv_tanh": ((1, 16, 16, 8), 4, 2, 1, 3, True, "none", "tanh"),
    "fused_conv_plain": ((1, 8, 8, 16), 1, 1, 0, 66, False, "none", "none"),
}
ELEMENTWISE_SHAPE = (1, 16, 16, 8)
SPPF = ((1, 8, 8, 16), 5, 3)

# why the port's count differs from XLA's by more than 10%
UPCAST = ("XLA's CPU backend computes bf16 in f32: it counts the converts as flops and "
          "the f32 copies as bytes; the port counts the bf16 op")
UNFUSED = ("XLA's CPU backend does not fuse the convolution with its epilogue (it writes the "
           "conv output and reads it back); the port counts the fused kernel's bytes: the "
           "block's inputs and output once")
FOLDED = "XLA folds the stand-in's multiply by one / add of zero; the port's op runs them"
POOL_PAD = ("the port's 2x2 SAME pool pads both sides and drops the leading row and column, "
            "so it evaluates (H+1)(W+1) windows where XLA evaluates HW")
SPPF_LEVELS = ("XLA's CPU backend materialises every pool level and the concat's copies; the "
               "port counts the kernel's bytes: the input once and the 4C concat once")
EXPLAINED = {
    ("bn", "float32", "flops"): (math.inf, FOLDED),
    ("norm", "float32", "flops"): (math.inf, FOLDED),
    ("dropout", "float32", "flops"): (math.inf, FOLDED),
    ("pool", "float32", "flops"): (1.1289, POOL_PAD),
    ("fused_conv_bn_lrelu", "float32", "bytes"): (0.574, UNFUSED),
    ("fused_deconv_bn_relu", "float32", "bytes"): (0.3928, UNFUSED),
    ("fused_conv_bn_silu", "float32", "bytes"): (0.5337, UNFUSED),
    ("fused_deconv_tanh", "float32", "bytes"): (0.457, UNFUSED),
    ("sppf", "float32", "bytes"): (0.3571, SPPF_LEVELS),
    ("conv_k4s2", "bfloat16", "bytes"): (0.2, UPCAST),
    ("conv_k3s1", "bfloat16", "bytes"): (0.2, UPCAST),
    ("conv_k1", "bfloat16", "bytes"): (0.2, UPCAST),
    ("deconv_k4s2", "bfloat16", "bytes"): (0.4741, UPCAST),
    ("act", "bfloat16", "flops"): (0.4286, UPCAST),
    ("tanh", "bfloat16", "flops"): (0.3333, UPCAST),
    ("bn", "bfloat16", "flops"): (math.inf, FOLDED),
    ("norm", "bfloat16", "flops"): (math.inf, FOLDED),
    ("concat", "bfloat16", "flops"): (0.0, UPCAST),
    ("crop", "bfloat16", "flops"): (0.0, UPCAST),
    ("crop", "bfloat16", "bytes"): (0.8673, UPCAST),
    ("pad", "bfloat16", "flops"): (0.0, UPCAST),
    ("pad", "bfloat16", "bytes"): (0.8673, UPCAST),
    ("pool", "bfloat16", "flops"): (0.3079, UPCAST + "; and " + POOL_PAD),
    ("pool", "bfloat16", "bytes"): (0.2129, UPCAST),
    ("dropout", "bfloat16", "flops"): (math.inf, FOLDED),
    ("add", "bfloat16", "flops"): (0.3333, UPCAST),
    ("fused_conv_bn_lrelu", "bfloat16", "bytes"): (0.2009, UPCAST + "; and " + UNFUSED),
    ("fused_deconv_bn_relu", "bfloat16", "bytes"): (0.1865, UPCAST + "; and " + UNFUSED),
    ("fused_conv_bn_silu", "bfloat16", "bytes"): (0.2011, UPCAST + "; and " + UNFUSED),
    ("fused_deconv_tanh", "bfloat16", "bytes"): (0.1891, UPCAST + "; and " + UNFUSED),
    ("fused_conv_plain", "bfloat16", "bytes"): (0.2, UPCAST),
    ("sppf", "bfloat16", "flops"): (0.3103, UPCAST),
    ("sppf", "bfloat16", "bytes"): (0.147, UPCAST + "; and " + SPPF_LEVELS),
}


def _counts(name, dtype):
    if name in CONV:
        return jprof._conv_cost(*CONV[name], dtype), tprof._conv_cost(*CONV[name], dtype)
    if name in FUSED:
        return jprof._fused_cost(*FUSED[name], dtype), tprof._fused_cost(*FUSED[name], dtype)
    if name == "sppf":
        return jprof._sppf_cost(*SPPF, dtype), tprof._sppf_cost(*SPPF, dtype)
    return (jprof._elementwise_cost(name, ELEMENTWISE_SHAPE, dtype),
            tprof._elementwise_cost(name, ELEMENTWISE_SHAPE, dtype))


def _ratio(port, xla):
    if port == xla == 0:
        return 1.0
    return math.inf if xla == 0 else port / xla


KINDS = [*CONV, *tprof.ELEMENTWISE_KINDS, *FUSED, "sppf"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", KINDS)
def test_profiler_counts_against_xla(name, dtype):
    """Ratio of the port's count to XLA's, flops and bytes: within [0.9,
    1.1], or the pinned ratio of ``EXPLAINED`` (rel 1e-3) — an explanation
    whose ratio moved back into range is stale and fails too."""
    xla, port = _counts(name, dtype)
    assert port[1] > 0  # every stand-in moves data
    for q, i in (("flops", 0), ("bytes", 1)):
        r = _ratio(port[i], xla[i])
        pinned = EXPLAINED.get((name, dtype, q))
        if pinned is None:
            assert 0.9 <= r <= 1.1, (name, dtype, q, port[i], xla[i])
        else:
            assert not 0.9 <= r <= 1.1, f"stale explanation: {(name, dtype, q)} is at {r}"
            assert r == pytest.approx(pinned[0], rel=1e-3), (name, dtype, q, r, pinned[1])


def test_profile_graph_counts_every_primitive_once():
    g = tm.Pix2PixGenerator(tm.Pix2PixConfig(img_size=16, base=4, deconv_mode="cropping")).layer_graph()
    prof = tprof.profile_graph(g, torch.float32)
    assert prof.model_name.endswith("[profiled]") and len(prof) == len(g)
    for a, b in zip(g, prof):
        if a.kind in ("conv", "deconv"):
            k = a.attrs
            want = tprof._conv_cost(tuple(a.in_shape), k["kernel"], k["stride"], k["padding"],
                                    a.out_shape[-1], a.kind == "deconv", "float32")
            assert (b.flops, b.bytes_accessed) == want
    y = tm.YOLOv8(tm.YOLOv8Config(img_size=32)).layer_graph()
    c2f = next(l for l in tprof.profile_graph(y) if l.kind == "c2f")
    assert c2f.flops == sum(p.flops for p in c2f.sublayers) > 0


# ---- the measured providers (tests/test_cost_planner.py's cases) -----------


@pytest.fixture(scope="module")
def engines():
    return tengines(constraints_dla=TDLA)


@pytest.fixture(scope="module")
def tiny_graph():
    return tm.Pix2PixGenerator(tm.Pix2PixConfig(img_size=8, base=4, deconv_mode="cropping")).layer_graph()


def test_make_cost_provider_names():
    assert tcm.make_cost_provider("analytic") is tcm.ANALYTIC
    assert tcm.make_cost_provider("measured").name == "measured"
    assert tcm.make_cost_provider("blended").name == "blended"
    oc = tcm.make_cost_provider("online")
    assert oc.name == "online" and oc.base.name == "blended"
    with pytest.raises(ValueError):
        tcm.make_cost_provider("vibes")


def test_measured_cost_cache_roundtrip(tmp_path, tiny_graph, engines):
    gpu, dla = engines
    path = str(tmp_path / "timings.json")
    mc = tcm.MeasuredCost(cache_path=path)
    times = [mc.layer_time(l, dla) for l in tiny_graph]
    n_measurable = sum(mc.available(l) for l in tiny_graph)
    n_unique = len({mc._key(l, dla) for l in tiny_graph if mc.available(l)})
    assert n_measurable > 0
    assert mc.measure_count == n_unique <= n_measurable
    assert all(t > 0 for t in times)
    assert mc.save() == path
    mc2 = tcm.MeasuredCost(cache_path=path)
    assert mc2.cache_size == n_unique
    assert [mc2.layer_time(l, dla) for l in tiny_graph] == times
    assert mc2.measure_count == 0 and mc2.hits == n_measurable
    mc2.layer_time(tiny_graph[0], gpu)  # the engine is part of the key
    assert mc2.cache_size > n_unique


def test_measured_cost_dtype_mismatch_rejected(tmp_path):
    path = str(tmp_path / "timings.json")
    mc = tcm.MeasuredCost(cache_path=path, dtype="bfloat16")
    mc._cache["x"] = 1.0
    mc.save()
    with pytest.raises(ValueError):
        tcm.MeasuredCost(cache_path=path, dtype="float32")


def test_measured_covers_elementwise_kinds(tiny_graph, engines):
    _, dla = engines
    mc = tcm.MeasuredCost()
    assert {"bn", "act", "tanh", "concat"} <= {l.kind for l in tiny_graph}
    assert mc.coverage(tiny_graph) == 1.0
    for l in tiny_graph:
        assert mc.available(l), l.kind
        assert mc.layer_time(l, dla) > 0.0


def test_measured_composites_covered_via_expansion(engines):
    gpu, _ = engines
    y = tm.YOLOv8(tm.YOLOv8Config(img_size=32)).layer_graph()
    mc = tcm.MeasuredCost()
    composite = [l for l in y if l.kind in ("c2f", "sppf", "head")]
    assert composite and all(l.is_composite and mc.available(l) for l in composite)
    assert mc.coverage(y) == 1.0
    c2f = next(l for l in y if l.kind == "c2f")
    assert mc.layer_time(c2f, gpu) == pytest.approx(sum(mc.layer_time(p, gpu) for p in c2f.sublayers))
    broken = composite[0].clone()
    broken.sublayers = [broken.sublayers[0].clone(kind="other")]
    assert not mc.available(broken)
    assert mc.layer_time(broken, gpu) == tcm.layer_time(broken, gpu)
    rep = mc.coverage_report(y)
    assert rep["xla"] == {"coverage": 1.0, "missing": []} and rep["pallas_fused"]["coverage"] == 1.0


def test_blended_falls_back_to_analytic(tiny_graph, engines):
    gpu, _ = engines
    blended = tcm.BlendedCost()
    other = pointwise_meta(0, "odd", "other", (1, 64))
    assert not blended.available(other)
    assert blended.layer_time(other, gpu) == tcm.layer_time(other, gpu)
    for l in tiny_graph:
        assert blended.layer_time(l, gpu) == blended.measured.layer_time(l, gpu)


def test_measured_provider_plans_end_to_end(tiny_graph, engines):
    gpu, dla = engines
    mc = tcm.MeasuredCost()
    ir = tplan([tiny_graph, tiny_graph], [dla, gpu], cost=mc)
    assert ir.cost_provider == "measured" and ir.expected_cycle > 0
    assert all(0 < p < len(tiny_graph) for p in ir.partitions)
    t_analytic = tcm.graph_time(tiny_graph, dla, gpu).elapsed
    t_measured = tcm.graph_time(tiny_graph, dla, gpu, provider=mc).elapsed
    assert t_measured > 0 and t_analytic > 0 and t_measured != t_analytic


# ---- wire formats across the packages ---------------------------------------


def _pair_graphs(models):
    cfg = models.Pix2PixConfig(img_size=8, base=4, deconv_mode="cropping")
    return [models.Pix2PixGenerator(cfg).layer_graph(), models.Pix2PixGenerator(cfg).layer_graph()]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_timing_cache_crosses_packages(tmp_path, writer, impl):
    """A cache written by one package loads in the other: identical layer
    times on every layer and engine (none re-counted) and identical plans."""
    path = str(tmp_path / "timings.json")
    (jg, jd), (tg, td) = jengines(constraints_dla=JDLA), tengines(constraints_dla=TDLA)
    jgraphs, tgraphs = _pair_graphs(jm), _pair_graphs(tm)
    if writer == "jax":
        first = jcm.MeasuredCost(cache_path=path)
        want = jplan(jgraphs, [jd, jg], cost=first, impl=impl).to_json()
        first.save()
        second = tcm.MeasuredCost(cache_path=path)
        got = tplan(tgraphs, [td, tg], cost=second, impl=impl).to_json()
        pairs = [(first, jgraphs, (jd, jg)), (second, tgraphs, (td, tg))]
    else:
        first = tcm.MeasuredCost(cache_path=path)
        want = tplan(tgraphs, [td, tg], cost=first, impl=impl).to_json()
        first.save()
        second = jcm.MeasuredCost(cache_path=path)
        got = jplan(jgraphs, [jd, jg], cost=second, impl=impl).to_json()
        pairs = [(first, tgraphs, (td, tg)), (second, jgraphs, (jd, jg))]
    assert got == want
    (p1, g1, e1), (p2, g2, e2) = pairs
    for i in ("xla",) if impl == "xla" else ("xla", "pallas_fused"):
        for la, lb in zip(g1[0], g2[0]):
            for ea, eb in zip(e1, e2):
                assert p1.layer_time(la, ea, i) == p2.layer_time(lb, eb, i)
    assert second.measure_count == 0 and second.hits > 0
    assert json.load(open(path))["version"] == 1


OBS = [("DLA", 2e-3, 1e-3), ("GPU", 1e-4, 1e-9), ("DLA|pallas_fused", 3e-3, 1e-3),
       ("GPU", 2.5e-3, 1e-3), ("DLA", 1.7e-3, 0.9e-3), ("GPU|b4", 4e-3, 1e-3),
       ("DLA", 0.0, 1e-3), ("GPU", 2.2e-3, 1.1e-3)]


def _online(pkg, base):
    oc = pkg.OnlineCost(base, alpha=0.35)
    for o in OBS:
        oc.observe(*o)
    return oc


def test_online_cost_scales_match_jax_exactly():
    jo, to = _online(jcm, jcm.ANALYTIC), _online(tcm, tcm.ANALYTIC)
    assert to.snapshot() == jo.snapshot() and to.state() == jo.state()
    assert to.observations == jo.observations
    for args in (("GPU",), ("GPU", "xla", 4), ("DLA", "pallas_fused"), ("DLA", "pallas_fused", 2), ("X",)):
        assert to.scale_for(*args) == jo.scale_for(*args)
    assert to.describe() == jo.describe()
    fresh = tcm.OnlineCost(tcm.ANALYTIC).load_state(jo.state())
    assert fresh.snapshot() == jo.snapshot()
    fresh.load_state({"DLA": {"num": 0.0, "den": 1.0}})  # non-positive entries are skipped
    assert fresh.snapshot() == jo.snapshot()
    with pytest.raises(ValueError):
        to.save()  # an analytic base has no timing cache
    with pytest.raises(ValueError):
        tcm.OnlineCost(alpha=0.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_crosses_packages(tmp_path, writer):
    path = str(tmp_path / "calib.json")
    src, dst = (jcm, tcm) if writer == "jax" else (tcm, jcm)
    a = _online(src, src.BlendedCost())
    a.save_calibration(path)
    b = dst.OnlineCost(dst.BlendedCost()).load_calibration(path)
    assert b.snapshot() == a.snapshot() and b.state() == a.state()
    for args in (("DLA",), ("DLA", "pallas_fused"), ("GPU", "xla", 4)):
        assert b.scale_for(*args) == a.scale_for(*args)
    with pytest.raises(ValueError, match="base provider"):
        dst.OnlineCost(dst.ANALYTIC).load_calibration(path)  # other units


def test_make_cost_provider_online_warm_starts(tmp_path):
    path = str(tmp_path / "calib.json")
    _online(jcm, jcm.BlendedCost(jcm.MeasuredCost())).save_calibration(path)
    oc = tcm.make_cost_provider("online", calibration_path=path)
    assert oc.snapshot() == _online(tcm, tcm.BlendedCost()).snapshot()
    assert tcm.make_cost_provider("online", calibration_path=str(tmp_path / "none.json")).snapshot() == {}


def test_plans_move_between_the_packages():
    """A plan the JAX planner wrote loads in the port and drives its
    executor (a hot swap onto it), and the port's JSON loads in the JAX
    package unchanged."""
    from repro.core.plan_ir import PlanIR as JPlanIR
    from repro_torch.core.plan_ir import PlanIR as TPlanIR
    from repro_torch.serve import build_server

    jg, jd = jengines(constraints_dla=JDLA)
    cfg = dict(img_size=32, base=8, deconv_mode="cropping")
    graphs = [jm.Pix2PixGenerator(jm.Pix2PixConfig(**cfg)).layer_graph(),
              jm.YOLOv8(jm.YOLOv8Config(img_size=32)).layer_graph()]
    jir = jplan(graphs, [jd, jg], impl="auto", max_cuts=2)
    ported = TPlanIR.from_json(jir.to_json())
    assert ported.to_json() == jir.to_json()
    assert JPlanIR.from_json(ported.to_json()) == jir
    bundle = build_server(img=32, base=8, n_pix=1, n_yolo=1, device="cpu")
    ex = bundle.server.executor
    for s in bundle.streams:
        ex.submit(s.model_index, bundle.frame_for(s.name, 0))
    ex.tick()
    assert ex.prepare_plan(ported) > 0
    assert ex.swap_plan(ported) == 1
    ex.run_until_drained()
    assert len(ex.completions) == 2 and ex.plan.cuts == jir.cuts
