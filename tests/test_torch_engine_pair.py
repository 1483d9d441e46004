"""The H100 engine pair (``repro_torch.core.h100_submesh_engines``, the
JAX package's ``tpu_submesh_engines`` over cards): its fields follow the
JAX function's formula with the card's peaks, and the planner gives the
same ``PlanIR`` JSON over it as the JAX planner over JAX ``EngineSpec``s
with the same field values."""
import pytest

torch = pytest.importorskip("torch")

from repro.core.api import plan as jplan  # noqa: E402
from repro.core.constraints import DLA_ANALOGUE_CONSTRAINTS as JDLA  # noqa: E402
from repro.core.engine import EngineSpec as JEngineSpec  # noqa: E402
from repro.core.engine import tpu_submesh_engines  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.api import plan as tplan  # noqa: E402
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS as TDLA  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
import repro_torch.models as tm  # noqa: E402

FIELDS = ("n_chips", "peak_flops", "hbm_bw", "link_bw", "efficiency")


def _graphs(models, img, base):
    pix = models.Pix2PixGenerator(models.Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping"))
    return [pix.layer_graph(), models.YOLOv8(models.YOLOv8Config(img_size=img)).layer_graph()]


@pytest.mark.parametrize("kw", [{}, {"n_big": 12, "n_small": 20, "efficiency": 0.45}])
def test_h100_pair_fields_follow_the_formula(kw):
    """Names, sizes and rates per the JAX function's formula over cards:
    each engine's peaks are its cards' sum, the link is one card's link per
    card of the smaller engine, constraints only on the small engine; the
    TPU pair's structure with the card's constants in place of the chip's."""
    big, small = tcore.h100_submesh_engines(constraints_small=TDLA, **kw)
    n_big, n_small, eff = kw.get("n_big", 192), kw.get("n_small", 64), kw.get("efficiency", 0.6)
    assert (big.name, small.name) == ("H100-BIG", "H100-SMALL")
    for e, n in ((big, n_big), (small, n_small)):
        assert e.n_chips == n and e.efficiency == eff
        assert e.peak_flops == n * tcore.H100_BF16_FLOPS and e.hbm_bw == n * tcore.H100_HBM_BW
        assert e.link_bw == tcore.H100_LINK_BW * min(n_big, n_small)
    assert big.constraints == () and small.constraints == tuple(TDLA)
    tbig, tsmall = tpu_submesh_engines(constraints_small=JDLA, **kw)
    assert (tbig.n_chips, tsmall.n_chips, tbig.efficiency) == (big.n_chips, small.n_chips, big.efficiency)
    assert (tbig.constraints, len(tsmall.constraints)) == ((), len(small.constraints))
    # the peaks the dry run's roofline divides by are these constants
    assert (roofline.H100_BF16_FLOPS, roofline.H100_HBM_BW, roofline.H100_LINK_BW) == (
        tcore.H100_BF16_FLOPS, tcore.H100_HBM_BW, tcore.H100_LINK_BW)


@pytest.mark.parametrize("img,base", [(32, 8), (256, 64)])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("granularity", ["coarse", "fine"])
def test_plan_over_the_h100_pair_equals_the_jax_planner(img, base, impl, granularity):
    """The paper's Pix2Pix + YOLOv8 graphs planned over the H100 pair (the
    small engine under the DLA-analogue constraints, listed first as the
    Jetson pair's DLA is) give the JAX planner's ``PlanIR`` JSON over JAX
    ``EngineSpec``s with the same field values."""
    big, small = tcore.h100_submesh_engines(constraints_small=TDLA)

    def jspec(e, constraints):
        return JEngineSpec(e.name, constraints=constraints, **{f: getattr(e, f) for f in FIELDS})

    jengines = [jspec(small, JDLA), jspec(big, ())]
    kw = dict(cost="analytic", impl=impl, granularity=granularity)
    want = jplan(_graphs(jm, img, base), jengines, **kw).to_json()
    got = tplan(_graphs(tm, img, base), [small, big], **kw).to_json()
    assert got == want
    assert '"H100-SMALL"' in got
