"""The PyTorch port's training -> surgery -> evaluation path against the JAX
package: discriminator and Pix2Pix, synthetic data, losses, metrics,
optimizers, the train steps and the surgery reports.

Parameters are drawn with numpy in the JAX package's tree layout and cross
into the port through ``repro_torch.nn.from_jax``; inputs come from numpy
seeds. Tolerances (f32 on the CPU): data bit-exact (the same numpy code);
losses and metrics 1e-5; optimizers on identical gradients 1e-6; whole
models atol/rtol 1e-3, as ``test_torch_models.py`` states why; one train
step: losses rtol 1e-5, and gradients (the ``SGD(lr=1, momentum=0)``
delta) within atol 1e-5 plus a share of each leaf's largest gradient: 1e-4
for Pix2Pix, whose 2x2 -> 1x1 conv feeds a batch norm over two values
(measured 5.2e-5 there, 1e-6 elsewhere), and 2e-4 for YOLOv8n, whose
first layers' gradients come back through some 60 batch norms in f32
(measured 8e-5). The YOLOv8n step runs at img 64: at img 32 its deepest
maps are 1x1, where batch norm over a batch of two is sign(x1 - x2) and
the two frameworks' rounding decides it (the losses differ by 0.7%).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.train.losses as jlosses  # noqa: E402
import repro.train.metrics as jmetrics  # noqa: E402
import repro.train.optimizer as jopt  # noqa: E402
import repro.train.steps as jsteps  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.nn as tnn  # noqa: E402
import repro_torch.train as tt  # noqa: E402
from repro.core.constraints import DLA_ANALOGUE_CONSTRAINTS as J_DLA  # noqa: E402
from repro_torch.core.constraints import DLA_ANALOGUE_CONSTRAINTS as T_DLA  # noqa: E402
from repro_torch.nn.module import Module, ParamSpec, tree_leaves, tree_map  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once on the
    machine's cores, and with as many threads as cores in each file too,
    this file's small ops ran many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return tnn.from_jax(_np_tree(tree))


def _jax_params(module, seed=0):
    """numpy-drawn values in the JAX tree layout: weights N(0, 1/fan_in),
    norm scales and moving variances near 1, the rest near 0."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) > 1:
            return jnp.asarray(rs.randn(*s.shape) / np.sqrt(math.prod(s.shape[:-1])), s.dtype)
        base = 1.0 if ("scale" in name or "moving_var" in name) else 0.0
        return jnp.asarray(base + 0.1 * rs.randn(*s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(draw, module.abstract())


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(got, want, atol, rtol=0.0):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32), atol=atol, rtol=rtol)


def _spec_count(spec) -> int:
    if isinstance(spec, ParamSpec):
        return math.prod(spec.shape)
    if isinstance(spec, Module):
        return _spec_count(spec.specs())
    if isinstance(spec, dict):
        return sum(_spec_count(v) for v in spec.values())
    return sum(_spec_count(v) for v in spec)


# ----------------------------------------------------------------- models


def test_full_size_discriminator_and_conv_mode_param_counts():
    """The TF tutorial's PatchGAN and paper Table II's conv-mode generator."""
    assert _spec_count(tm.Pix2PixDiscriminator(tm.Pix2PixConfig())) == 2_770_433
    assert _spec_count(tm.Pix2PixGenerator(tm.Pix2PixConfig(deconv_mode="conv"))) == 64_637_268
    assert _spec_count(tm.Pix2Pix(tm.Pix2PixConfig())) == 54_425_859 + 2_770_433


@pytest.mark.parametrize("mode", ["padded", "conv"])
def test_pix2pix_generate_and_discriminate_match_jax(mode):
    kw = dict(img_size=32, base=8, deconv_mode=mode)
    jmod, tmod = jm.Pix2Pix(jm.Pix2PixConfig(**kw)), tm.Pix2Pix(tm.Pix2PixConfig(**kw))
    pj = _jax_params(jmod, seed=2)
    pt = _port(pj)
    src, dst = _x((2, 32, 32, 3), 0), _x((2, 32, 32, 3), 1)
    _close(tmod.generate(pt, torch.from_numpy(src)), jmod.generate(pj, jnp.asarray(src)), 1e-3, 1e-3)
    _close(
        tmod.discriminate(pt, torch.from_numpy(src), torch.from_numpy(dst)),
        jmod.discriminate(pj, jnp.asarray(src), jnp.asarray(dst)),
        1e-3,
        1e-3,
    )
    # the full-width PatchGAN's output grid: 256 -> 30 x 30 patches
    d = tm.Pix2PixDiscriminator(tm.Pix2PixConfig(img_size=64, base=8))
    out = d(d.init(torch.Generator().manual_seed(0)), torch.zeros(1, 64, 64, 3), torch.zeros(1, 64, 64, 3))
    assert tuple(out.shape) == (1, 6, 6, 1)


def test_generator_dropout_structure():
    """Dropout (not reproducible against jax.random) by its structure: it
    acts only with ``train=True`` and a generator, on up blocks 0-2, keeps
    about half the units and scales the kept ones by 1/keep."""
    cfg = tm.Pix2PixConfig(img_size=32, base=8)
    gen = tm.Pix2PixGenerator(cfg)
    p = gen.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 32, 32, 3)))
    base = gen(p, x)
    assert torch.equal(base, gen(p, x, train=True))  # no generator: no dropout
    assert torch.equal(base, gen(p, x, generator=torch.Generator().manual_seed(1)))  # eval
    a = gen(p, x, generator=torch.Generator().manual_seed(1), train=True)
    assert torch.equal(a, gen(p, x, generator=torch.Generator().manual_seed(1), train=True))
    assert not torch.equal(a, gen(p, x, generator=torch.Generator().manual_seed(2), train=True))

    # the up blocks' norm outputs and what reaches their relu
    from repro_torch.models import pix2pix

    norm_out, relu_in = [], []
    real_norm, real_relu = tnn.BatchNorm2D.__call__, pix2pix.F.relu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnn.BatchNorm2D, "__call__", lambda *a: norm_out.append(real_norm(*a)) or norm_out[-1])
        mp.setattr(pix2pix.F, "relu", lambda h: relu_in.append(h) or real_relu(h))
        gen(p, x, generator=torch.Generator().manual_seed(3), train=True)
    ups = len(cfg.up_channels())
    assert len(relu_in) == ups
    for i, (pre, post) in enumerate(zip(norm_out[-ups:], relu_in)):
        if i >= 3:
            assert torch.equal(post, pre)
            continue
        kept = post != 0
        assert torch.equal(post[kept], pre[kept] / 0.5)
        share = kept.float().mean().item()
        assert 0.4 < share < 0.6, (i, share)


def test_pallas_backend_routes_through_deconv2d_and_counts_nothing_on_cpu():
    from repro_torch.kernels.deconv import ops

    cfg = tm.Pix2PixConfig(img_size=32, base=8, deconv_mode="cropping", deconv_backend="pallas")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        real = ops.deconv2d
        mp.setattr(ops, "deconv2d", lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
        ops.reset_launches()
        gen = tm.Pix2PixGenerator(cfg)
        gen(gen.init(torch.Generator().manual_seed(0)), torch.zeros(2, 32, 32, 3))
    # one call per up block and the final layer; the CPU runs the plain version
    want, c_prev = [], cfg.down_channels()[-1]
    for i, ch in enumerate(cfg.up_channels() + (cfg.out_channels,)):
        want.append((2, 2**i, 2**i, c_prev))
        c_prev = 2 * ch
    assert calls == want
    assert ops.launches == {"deconv2d": 0}


# ------------------------------------------------------------------- data


def test_synthetic_data_bit_equal_to_jax_package():
    for b in (2, 3):
        cfg = jdata.PhantomConfig(img_size=32, lesion_p=1.0)
        tcfg = tdata.PhantomConfig(img_size=32, lesion_p=1.0)
        for jb, tb in zip(
            [next(jdata.phantom_batches(b, cfg, seed=5)), next(jdata.detection_batches(b, cfg, seed=6))],
            [next(tdata.phantom_batches(b, tcfg, seed=5)), next(tdata.detection_batches(b, tcfg, seed=6))],
        ):
            for x, y in zip(jax.tree.leaves(jb), jax.tree.leaves(tb)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    jt = next(jdata.token_batches(2, 16, 100, seed=1))
    tt_ = next(tdata.token_batches(2, 16, 100, seed=1))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(jt[k], tt_[k])


# ------------------------------------------------------- losses, metrics


def test_losses_match_jax():
    rs = np.random.RandomState(0)
    logits, fake, real = rs.randn(2, 6, 6, 1), np.tanh(rs.randn(2, 8, 8, 3)), np.tanh(rs.randn(2, 8, 8, 3))
    logits, fake, real = (a.astype(np.float32) for a in (logits, fake, real))
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    got = tt.pix2pix_g_loss(T(logits), T(fake), T(real))
    want = jlosses.pix2pix_g_loss(jnp.asarray(logits), jnp.asarray(fake), jnp.asarray(real))
    _close({"l": got[0], **got[1]}, {"l": want[0], **want[1]}, 1e-5, 1e-5)
    got = tt.pix2pix_d_loss(T(logits), T(-logits))
    want = jlosses.pix2pix_d_loss(jnp.asarray(logits), jnp.asarray(-logits))
    _close({"l": got[0], **got[1]}, {"l": want[0], **want[1]}, 1e-5, 1e-5)

    db = next(jdata.detection_batches(2, jdata.PhantomConfig(img_size=64, lesion_p=1.0), seed=2))
    preds = {k: rs.randn(2, 64 // s, 64 // s, 66).astype(np.float32) for k, s in (("p3", 8), ("p4", 16), ("p5", 32))}
    got = tt.yolo_loss({k: T(v) for k, v in preds.items()}, tnn.from_jax(db["targets"]), 2, 16)
    want = jlosses.yolo_loss(jax.tree.map(jnp.asarray, preds), jax.tree.map(jnp.asarray, db["targets"]), 2, 16)
    assert float(got[1]["n_pos"]) == float(want[1]["n_pos"]) > 0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)


def test_metrics_match_jax():
    rs = np.random.RandomState(1)
    a = np.tanh(rs.randn(3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(*a.shape), -1.2, 1.2).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    u8 = lambda m, x: m.to_uint8_range(x)  # noqa: E731
    _close(tt.to_uint8_range(tb), jmetrics.to_uint8_range(jb), 1e-5)
    _close(tt.mse(u8(tt, ta), u8(tt, tb)), jmetrics.mse(u8(jmetrics, ja), u8(jmetrics, jb)), 0, 1e-5)
    _close(tt.psnr(u8(tt, ta), u8(tt, tb)), jmetrics.psnr(u8(jmetrics, ja), u8(jmetrics, jb)), 0, 1e-5)
    _close(tt.ssim(u8(tt, ta), u8(tt, tb)), jmetrics.ssim(u8(jmetrics, ja), u8(jmetrics, jb)), 1e-5)
    _close(tt.ssim(u8(tt, ta), u8(tt, ta)), jnp.ones(3), 1e-5)
    boxes = rs.rand(5, 2, 4).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    _close(tt.box_iou(torch.from_numpy(boxes[:, 0]), torch.from_numpy(boxes[:, 1])),
           jmetrics.box_iou(jnp.asarray(boxes[:, 0]), jnp.asarray(boxes[:, 1])), 1e-5)


# ------------------------------------------------------------- optimizers


OPTIMIZERS = {
    "adamw_clip_decay": lambda m: m.AdamW(lr=m.warmup_cosine(1e-2, 2, 10), weight_decay=0.01, grad_clip_norm=1.0),
    "adamw_master": lambda m: m.AdamW(lr=3e-3, grad_clip_norm=None, master_weights=True),
    "adam": lambda m: m.Adam(lr=2e-4, b1=0.5),
    "sgd": lambda m: m.SGD(lr=m.warmup_cosine(0.1, 1, 5), momentum=0.9),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_jax_over_three_updates(name):
    rs = np.random.RandomState(2)
    params = {"b": rs.randn(5).astype(np.float32), "a": [rs.randn(3, 4).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: (rs.randn(*p.shape) * 3).astype(np.float32), params) for _ in range(3)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](tt)
    pj, pt = jax.tree.map(jnp.asarray, params), tnn.from_jax(params)
    sj, st = jo.init(pj), to.init(pt)
    for g in grads:
        pj, sj, ij = jo.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st, it = to.update(tnn.from_jax(g), st, pt)
        _close(pt, pj, 1e-6, 1e-6)
        _close({k: it[k] for k in ij}, ij, 1e-6, 1e-6)
    _close({k: v for k, v in st.items() if k != "step"}, {k: v for k, v in sj.items() if k != "step"}, 1e-6, 1e-6)
    assert int(st["step"]) == int(sj["step"]) == 3 and st["step"].dtype == torch.int32


def test_global_norm_and_clip_match_jax():
    rs = np.random.RandomState(3)
    tree = {"x": rs.randn(4, 3).astype(np.float32), "y": [rs.randn(7).astype(np.float32)]}
    gt, nt = tt.clip_by_global_norm(tnn.from_jax(tree), 0.5)
    gj, nj = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 0.5)
    _close({"n": nt, "g": gt}, {"n": nj, "g": gj}, 1e-6, 1e-6)
    np.testing.assert_allclose(float(tt.global_norm(gt)), 0.5, rtol=1e-6)


# ------------------------------------------------------------ train steps


def _grad_from_sgd_delta(before, after):
    return tree_map(lambda a, b: a - b, before, after)


def _close_grads(got, want, share):
    """atol 1e-5 plus ``share`` of each leaf's largest gradient."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 + share * float(np.abs(b).max()), rtol=0)


def test_pix2pix_train_step_matches_jax():
    kw = dict(img_size=32, base=8, deconv_mode="padded")
    jmod, tmod = jm.Pix2Pix(jm.Pix2PixConfig(**kw)), tm.Pix2Pix(tm.Pix2PixConfig(**kw))
    pj = _jax_params(jmod, seed=4)
    pt = _port(pj)
    b = next(jdata.phantom_batches(2, jdata.PhantomConfig(img_size=32), seed=0))
    jo, to = jopt.SGD(lr=1.0, momentum=0.0), tt.SGD(lr=1.0, momentum=0.0)
    jstep = jax.jit(jsteps.make_pix2pix_train_step(jmod, jo, jo))
    tstep = tt.make_pix2pix_train_step(tmod, to, to)
    sj = {"g": jo.init(pj["generator"]), "d": jo.init(pj["discriminator"])}
    st = {"g": to.init(pt["generator"]), "d": to.init(pt["discriminator"])}
    nj, _, mj = jstep(pj, sj, jax.tree.map(jnp.asarray, b), None)
    nt, _, mt = tstep(pt, st, tnn.from_jax(b), None)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    grads_t = _grad_from_sgd_delta(pt, nt)
    grads_j = jax.tree.map(lambda a, c: a - c, pj, nj)
    _close_grads(grads_t, grads_j, 1e-4)
    # BatchNorm's moving statistics get zero gradients, as jax.grad gives them
    for blk in grads_t["generator"]["ups"]:
        assert not blk["bn"]["moving_mean"].any() and not blk["bn"]["moving_var"].any()
    # the step leaves the caller's tensors alone and returns plain tensors
    assert all(not t.requires_grad for t in tree_leaves(nt))
    _close(pt, pj, 0)


def test_yolo_train_step_matches_jax():
    jmod, tmod = jm.YOLOv8(jm.YOLOv8Config(img_size=64)), tm.YOLOv8(tm.YOLOv8Config(img_size=64))
    pj = _jax_params(jmod, seed=5)
    pt = _port(pj)
    b = next(jdata.detection_batches(2, jdata.PhantomConfig(img_size=64, lesion_p=1.0), seed=2))
    jo, to = jopt.SGD(lr=1.0, momentum=0.0), tt.SGD(lr=1.0, momentum=0.0)
    nj, _, mj = jax.jit(jsteps.make_yolo_train_step(jmod, jo))(pj, jo.init(pj), jax.tree.map(jnp.asarray, b))
    nt, _, mt = tt.make_yolo_train_step(tmod, to)(pt, to.init(pt), tnn.from_jax(b))
    assert set(mt) == set(mj) and float(mt["n_pos"]) > 0
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    grads_j = jax.tree.map(lambda a, c: a - c, pj, nj)
    _close_grads(_grad_from_sgd_delta(pt, nt), grads_j, 2e-4)
    # AdamW's clipped step reports the global norm of the same gradients
    # (its own exactly; JAX's within the first layers' 8e-5)
    ta = tt.AdamW(1e-3)
    _, _, it = tt.make_yolo_train_step(tmod, ta)(pt, ta.init(pt), tnn.from_jax(b))
    own = tt.global_norm(_grad_from_sgd_delta(pt, nt))
    np.testing.assert_allclose(float(it["grad_norm"]), float(own), rtol=1e-6)
    np.testing.assert_allclose(float(it["grad_norm"]), float(jopt.global_norm(grads_j)), rtol=1e-4)


# ---------------------------------------------------------------- surgery


@pytest.mark.parametrize("rule", ["cropping", "conv", "fused_crop", "avg_pool", "max_pool", "reduced_kernel"])
def test_surgery_reports_match_jax(rule):
    jgpu, jdla = jcore.jetson_orin_engines(constraints_dla=J_DLA)
    tgpu, tdla = tcore.jetson_orin_engines(constraints_dla=T_DLA)
    for img, base in ((32, 8), (256, 64)):
        jg = jm.Pix2PixGenerator(jm.Pix2PixConfig(img_size=img, base=base)).layer_graph()
        tg = tm.Pix2PixGenerator(tm.Pix2PixConfig(img_size=img, base=base)).layer_graph()
        gj, rj = jcore.apply_surgery(jg, jdla, rule)
        gt, rt = tcore.apply_surgery(tg, tdla, rule)
        assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
        assert [(l.name, l.kind, l.flops, l.params, l.in_shape, l.out_shape) for l in gt] == [
            (l.name, l.kind, l.flops, l.params, l.in_shape, l.out_shape) for l in gj
        ]
    assert rt.replaced and (rule not in ("cropping", "conv") or not rt.remaining_illegal)


def test_substitute_pix2pix_matches_jax_and_keeps_weights():
    for rule in ("cropping", "conv"):
        cj = jcore.substitute_pix2pix(jm.Pix2PixConfig(img_size=32, base=8), rule)
        ct = tcore.substitute_pix2pix(tm.Pix2PixConfig(img_size=32, base=8), rule)
        assert ct.deconv_mode == cj.deconv_mode == rule
    # padded weights run unchanged after the cropping substitution
    cfg = tm.Pix2PixConfig(img_size=32, base=8)
    p = tm.Pix2Pix(cfg).init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((1, 32, 32, 3)))
    torch.testing.assert_close(
        tm.Pix2Pix(cfg).generate(p, x), tm.Pix2Pix(tcore.substitute_pix2pix(cfg, "cropping")).generate(p, x),
        atol=1e-5, rtol=0,
    )
    with pytest.raises(KeyError):
        tcore.substitute_pix2pix(cfg, "avg_pool")
