"""The PyTorch port's layers and models against the JAX package.

Inputs and parameter values come from a numpy seed, laid out as the JAX
package's parameter trees (``Module.abstract()``), and cross into the port
through ``repro_torch.nn.from_jax``. Tolerances (f32 on the CPU): single
convs atol 1e-5, norms 1e-4, whole models atol/rtol 1e-3 — the deep
blocks batch-normalise over 1-4 pixels at img 32, which amplifies the
rounding differences between XLA's and ATen's convolutions (jitted and
eager XLA alone differ by 2e-4 on YOLO).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
import repro.nn as jnn  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.nn as tnn  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.nn.module import Module, ParamSpec  # noqa: E402


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port(params):
    return tnn.from_jax(_np_tree(params))


def _jax_params(module, seed=0):
    """A JAX parameter tree for ``module`` with numpy-drawn values: weights
    N(0, 1/fan_in), norm scales and moving variances near 1, the rest
    near 0 (``Module.init`` through jax.random takes seconds per model)."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) > 1:
            return jnp.asarray(rs.randn(*s.shape) / np.sqrt(math.prod(s.shape[:-1])), s.dtype)
        base = 1.0 if ("scale" in name or "moving_var" in name) else 0.0
        return jnp.asarray(base + 0.1 * rs.randn(*s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(draw, module.abstract())


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol, rtol=0.0):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(
            g.detach().float().numpy(), np.asarray(w, np.float32), atol=atol, rtol=rtol
        )


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


# --------------------------------------------------------------------- nn


LAYER_CASES = [
    ("Conv2D", dict(c_in=4, c_out=6, kernel=4, stride=2, padding=1, use_bias=False), (2, 9, 9, 4), 1e-5),
    ("Conv2D", dict(c_in=4, c_out=6, kernel=3, stride=2, padding="SAME"), (1, 9, 8, 4), 1e-5),
    ("Conv2D", dict(c_in=4, c_out=6, kernel=3, stride=1, padding="VALID"), (1, 7, 7, 4), 1e-5),
    ("Conv2D", dict(c_in=4, c_out=6, kernel=1, stride=1, padding=0, groups=2), (1, 5, 5, 4), 1e-5),
    ("ConvTranspose2D", dict(c_in=4, c_out=3, kernel=4, stride=2, padding=1), (1, 5, 6, 4), 1e-5),
    ("ConvTranspose2D", dict(c_in=4, c_out=3, kernel=4, stride=2, padding=0, use_bias=False), (2, 3, 3, 4), 1e-5),
    ("BatchNorm2D", dict(c=6), (2, 5, 5, 6), 1e-4),
    ("InstanceNorm2D", dict(c=6), (2, 5, 5, 6), 1e-4),
    ("GroupNorm2D", dict(c=8, groups=4), (2, 5, 5, 8), 1e-4),
]


@pytest.mark.parametrize("name,kw,shape,atol", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, kw, shape, atol):
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    p = _jax_params(jl, seed=1)  # non-trivial affine/bias: their use is checked too
    x = _x(shape)
    _close(tl(_port(p), torch.from_numpy(x)), jl(p, jnp.asarray(x)), atol)


def test_pools_crop_and_lrelu_match_jax():
    x = _x((2, 9, 9, 3))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tnn.max_pool(xt, 5, 1, padding=2), jnn.max_pool(xj, 5, 1, padding=2), 0)
    _close(tnn.max_pool(xt, 2), jnn.max_pool(xj, 2), 0)
    _close(tnn.avg_pool(xt, 3), jnn.avg_pool(xj, 3), 1e-6)
    _close(tnn.Crop2D(1)(None, xt), jnn.Crop2D(1)(None, xj), 0)
    _close(tnn.leaky_relu(xt), jnn.leaky_relu(xj), 0)


def _spec_count(spec) -> int:
    if isinstance(spec, ParamSpec):
        return math.prod(spec.shape)
    if isinstance(spec, Module):
        return _spec_count(spec.specs())
    if isinstance(spec, dict):
        return sum(_spec_count(v) for v in spec.values())
    return sum(_spec_count(v) for v in spec)


def test_full_size_param_counts():
    """Paper Table II's Pix2Pix generator and YOLOv8n, from the specs."""
    for mode in ("padded", "cropping"):
        gen = tm.Pix2PixGenerator(tm.Pix2PixConfig(deconv_mode=mode))
        assert _spec_count(gen) == 54_425_859
    assert _spec_count(tm.YOLOv8(tm.YOLOv8Config())) == 5_401_910


def test_init_tree_matches_jax_structure_and_from_jax_roundtrips():
    cfg_t, cfg_j = tm.Pix2PixConfig(img_size=16, base=4), jm.Pix2PixConfig(img_size=16, base=4)
    g = torch.Generator().manual_seed(0)
    pt = tm.Pix2PixGenerator(cfg_t).init(g)
    # jax's own init tree, traced only (shapes, no draws)
    shapes_j = jax.tree.map(
        lambda a: tuple(a.shape), jax.eval_shape(jm.Pix2PixGenerator(cfg_j).init, jax.random.key(0))
    )
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), pt)
    assert shapes_t == shapes_j
    pj = _np_tree(_jax_params(jm.Pix2PixGenerator(cfg_j)))
    assert tnn.param_count(pt) == sum(a.size for a in jax.tree.leaves(pj))
    back = tnn.from_jax(pj)
    assert jax.tree.map(lambda a: tuple(a.shape), back) == shapes_j
    bf = tnn.from_jax({"w": np.asarray(jnp.ones((2,), jnp.bfloat16))})
    assert bf["w"].dtype == torch.bfloat16


def test_init_is_seeded_and_lands_on_the_device():
    m = tm.YOLOv8(tm.YOLOv8Config(img_size=32))
    a = m.init(torch.Generator().manual_seed(3), device="cpu")
    b = m.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a["stem"]["conv"]), _leaves(b["stem"]["conv"])))


def test_pallas_deconv_backend_is_queued():
    """The ``deconv_backend="pallas"`` generator (the deconv2d op, its
    plain version on the CPU), padded and cropping, against the JAX
    generator on ``xla`` at the pin of ``test_kernels.py``'s Pallas test
    (atol 2e-4). The name predates the port of the kernel."""
    x = _x((1, 32, 32, 3), seed=2)
    for mode in ("padded", "cropping"):
        kw = dict(img_size=32, base=8, deconv_mode=mode)
        gj = jm.Pix2PixGenerator(jm.Pix2PixConfig(**kw))
        pj = _jax_params(gj, seed=3)
        gt = tm.Pix2PixGenerator(tm.Pix2PixConfig(**kw, deconv_backend="pallas"))
        _close(gt(_port(pj), torch.from_numpy(x)), gj(pj, jnp.asarray(x)), 2e-4)


# ----------------------------------------------------------------- models


@pytest.mark.parametrize("norm", ["batch", "instance", "group"])
def test_pix2pix_generator_both_impls_match_jax_run_all(norm):
    kw = dict(img_size=32, base=8, deconv_mode="cropping", norm=norm)
    cfg_j, cfg_t = jm.Pix2PixConfig(**kw), tm.Pix2PixConfig(**kw)
    pj = {"generator": _jax_params(jm.Pix2PixGenerator(cfg_j))}
    sj = jpipe.pix2pix_staged(cfg_j, pj)
    st = tpipe.pix2pix_staged(cfg_t, _port(pj))
    x = _x((2, 32, 32, 3))
    want = jax.jit(sj.run_all)(jnp.asarray(x))
    xt = torch.from_numpy(x)
    _close(st.run_all(xt), want, 1e-3, 1e-3)
    fused = st.segment_fn(0, st.n_layers, impl="pallas_fused")
    _close(st.finalize(fused(st.params, st.init_state(xt))), want, 1e-3, 1e-3)
    _close(tm.Pix2PixGenerator(cfg_t)(st.params, xt), want, 1e-3, 1e-3)


@pytest.mark.parametrize("granularity", ["coarse", "fine"])
def test_yolo_both_impls_match_jax_run_all(granularity):
    cfg_j, cfg_t = jm.YOLOv8Config(img_size=32), tm.YOLOv8Config(img_size=32)
    pj = _jax_params(jm.YOLOv8(cfg_j), seed=1)
    sj = jpipe.yolo_staged(cfg_j, pj, granularity=granularity)
    st = tpipe.yolo_staged(cfg_t, _port(pj), granularity=granularity)
    assert [n for n, _ in st.ops] == [n for n, _ in sj.ops]
    assert st.variant_groups == sj.variant_groups and st.op_spans == sj.op_spans
    x = _x((1, 32, 32, 3), seed=1)
    want = jax.jit(sj.run_all)(jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = st.run_all(xt)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "p3": (1, 4, 4, 66), "p4": (1, 2, 2, 66), "p5": (1, 1, 1, 66)
    }
    _close(got, want, 1e-3, 1e-3)
    fused = st.segment_fn(0, st.n_layers, impl="pallas_fused")
    _close(st.finalize(fused(st.params, st.init_state(xt))), want, 1e-3, 1e-3)
    if granularity == "coarse":
        _close(tm.YOLOv8(cfg_t)(st.params, xt), want, 1e-3, 1e-3)


def test_layer_graphs_match_jax():
    for img, base in ((32, 8), (256, 64)):
        gj = jm.Pix2PixGenerator(jm.Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping"))
        gt = tm.Pix2PixGenerator(tm.Pix2PixConfig(img_size=img, base=base, deconv_mode="cropping"))
        yj, yt = jm.YOLOv8(jm.YOLOv8Config(img_size=img)), tm.YOLOv8(tm.YOLOv8Config(img_size=img))
        for a, b in ((gj.layer_graph(), gt.layer_graph()), (yj.layer_graph().expand(), yt.layer_graph().expand())):
            assert [(l.name, l.flops, l.bytes_accessed, l.params) for l in a] == [
                (l.name, l.flops, l.bytes_accessed, l.params) for l in b
            ]
            assert a.cut_points() == b.cut_points()
