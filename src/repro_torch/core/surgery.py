"""Hardware-aware model surgery (§V.A.2 of the paper).

Rewrites engine-illegal layers into engine-legal equivalents at the
layer-graph level, and exposes the corresponding model-config rewrite for
Pix2Pix. The two paper-endorsed substitutions preserve or improve
accuracy (Table II); the four rejected alternatives are kept for the
ablation benchmark (the paper reports they "negatively impact accuracy").
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .constraints import Violation
from .graph import LayerGraph, LayerMeta, conv_meta, pointwise_meta


@dataclasses.dataclass(frozen=True)
class SurgeryRule:
    name: str
    quality: str  # "endorsed" | "rejected" (paper's verdict)
    matches: Callable[[LayerMeta, Violation], bool]
    apply: Callable[[LayerMeta], list[LayerMeta]]


def _match_deconv_padding(l: LayerMeta, v: Violation) -> bool:
    return l.kind == "deconv" and v.constraint == "deconv_padding"


def _deconv_nopad(l: LayerMeta) -> LayerMeta:
    """The same deconv with padding=0; output grows by 2*padding each dim."""
    B, h, w, c_in = l.in_shape
    c_out = l.out_shape[-1]
    k, s, p = l.attrs["kernel"], l.attrs["stride"], l.attrs["padding"]
    return conv_meta(l.idx, l.name, B, h, w, c_in, c_out, k, s, 0, transposed=True)


def _apply_cropping(l: LayerMeta) -> list[LayerMeta]:
    d = _deconv_nopad(l)
    p = l.attrs["padding"]
    crop = pointwise_meta(l.idx, l.name + ".crop", "crop", l.out_shape, flops_per_elem=0.0)
    crop.attrs = {"crop": p}
    crop.in_shape = d.out_shape
    return [d, crop]


def _apply_conv(l: LayerMeta) -> list[LayerMeta]:
    d = _deconv_nopad(l)
    B, h, w, c = d.out_shape
    # 3x3 VALID conv trims one row/col per border (paper eq. 8/9) iff padding==1
    conv = conv_meta(l.idx, l.name + ".conv", B, h, w, c, c, 3, 1, 0)
    return [d, conv]


def _apply_avg_pool(l: LayerMeta) -> list[LayerMeta]:
    d = _deconv_nopad(l)
    B, h, w, c = d.out_shape
    pool = pointwise_meta(l.idx, l.name + ".avgpool", "pool", (B, h - 2, w - 2, c), flops_per_elem=9.0)
    pool.in_shape = d.out_shape
    pool.attrs = {"window": 3, "stride": 1}
    return [d, pool]


def _apply_max_pool(l: LayerMeta) -> list[LayerMeta]:
    out = _apply_avg_pool(l)
    out[1].name = out[1].name.replace("avgpool", "maxpool")
    return out


def _apply_reduced_kernel(l: LayerMeta) -> list[LayerMeta]:
    """Reduce deconv kernel to 2 (stride 2, pad 0): out = 2*in exactly, but
    the receptive field shrinks — the paper found this hurts accuracy."""
    B, h, w, c_in = l.in_shape
    c_out = l.out_shape[-1]
    return [conv_meta(l.idx, l.name + ".k2", B, h, w, c_in, c_out, 2, 2, 0, transposed=True)]


def _apply_fused_crop(l: LayerMeta) -> list[LayerMeta]:
    """Beyond-paper: ONE kernel-backed op — the phase-decomposed deconv
    with the crop folded into output indexing (kernels.deconv). vs
    'cropping': removes the crop layer's full (B, 2H, 2W, C) read+write AND
    the border compute the crop discards. Illegal on the literal Jetson DLA
    (fixed-function); legal on engines where we control the kernel."""
    B, h, w, c_in = l.in_shape
    c_out = l.out_shape[-1]
    k, s, p = l.attrs["kernel"], l.attrs["stride"], l.attrs["padding"]
    fused = conv_meta(l.idx, l.name + ".fused", B, h, w, c_in, c_out, k, s, p, transposed=True)
    fused.kind = "deconv_fused"
    # phase decomposition computes only surviving outputs: scale flops by
    # the kept-area fraction ((2h-2p)/2h)^2 relative to the pad-free op
    keep = ((s * h - 2 * p) / (s * (h - 1) + k - 2 * p)) ** 2 if h > 1 else 1.0
    nopad_flops = 2.0 * B * h * w * c_in * k * k * c_out
    fused.flops = nopad_flops * keep
    return [fused]


RULE_CROPPING = SurgeryRule("cropping", "endorsed", _match_deconv_padding, _apply_cropping)
RULE_CONV = SurgeryRule("conv", "endorsed", _match_deconv_padding, _apply_conv)
RULE_FUSED_CROP = SurgeryRule("fused_crop", "endorsed", _match_deconv_padding, _apply_fused_crop)
RULE_AVG_POOL = SurgeryRule("avg_pool", "rejected", _match_deconv_padding, _apply_avg_pool)
RULE_MAX_POOL = SurgeryRule("max_pool", "rejected", _match_deconv_padding, _apply_max_pool)
RULE_REDUCED_KERNEL = SurgeryRule(
    "reduced_kernel", "rejected", _match_deconv_padding, _apply_reduced_kernel
)

RULES = {
    r.name: r
    for r in (
        RULE_CROPPING,
        RULE_CONV,
        RULE_FUSED_CROP,
        RULE_AVG_POOL,
        RULE_MAX_POOL,
        RULE_REDUCED_KERNEL,
    )
}


@dataclasses.dataclass
class SurgeryReport:
    rule: str
    replaced: list[str]
    param_delta: int
    layer_delta: int
    remaining_illegal: list[str]


def apply_surgery(graph: LayerGraph, engine, rule_name: str = "cropping"):
    """Rewrite every layer of ``graph`` that is illegal on ``engine`` using
    ``rule``. Returns (new_graph, SurgeryReport).

    Hierarchical graphs are rewritten at primitive granularity: when any
    node carries a composite decomposition, the pass runs on the expanded
    (primitive-only) graph — surgery rules match primitives, never
    composite kinds, so an illegal primitive buried inside a composite is
    only reachable there."""
    if any(l.is_composite for l in graph):
        graph = graph.expand()
    rule = RULES[rule_name]
    new_layers: list[LayerMeta] = []
    replaced = []
    p_before = graph.total_params()
    for l in graph:
        vs = [v for v in engine.supports(l) if v.severity == "illegal"]
        applicable = [v for v in vs if rule.matches(l, v)]
        if applicable:
            new_layers.extend(rule.apply(l))
            replaced.append(l.name)
        else:
            new_layers.append(l.clone())
    g = LayerGraph(f"{graph.model_name}->{rule_name}", new_layers).renumber()
    remaining = [
        l.name for l in g if any(v.severity == "illegal" for v in engine.supports(l))
    ]
    return g, SurgeryReport(
        rule=rule_name,
        replaced=replaced,
        param_delta=g.total_params() - p_before,
        layer_delta=len(g) - len(graph),
        remaining_illegal=remaining,
    )


def substitute_pix2pix(cfg, rule_name: str):
    """Model-level rewrite: returns a Pix2PixConfig in the requested mode.

    The weights of 'padded' and 'cropping' variants are interchangeable
    (identical pytrees, identical function); 'conv' adds 3x3 conv params.
    """
    mode = {"cropping": "cropping", "conv": "conv"}[rule_name]
    return dataclasses.replace(cfg, deconv_mode=mode)
