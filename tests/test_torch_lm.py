"""The PyTorch port's LM building blocks and Hymba-1.5B against the JAX
package: ``RMSNorm``, ``MLP``, ``Embedding``, the dense layouts,
``apply_rope``, ``Stacked``, ``HymbaLM`` at its ``SMOKE`` config (the
slice as a whole: forward, prefill, decode, greedy generation), the
full-width parameter count, and the config registry.

Inputs come from numpy seeds and JAX parameters cross through
``from_jax``. Every comparison is in f32: atol 1e-5 on single modules,
1e-4 on logits, unless a case states another with its reason.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.nn.rotary import apply_rope as j_apply_rope  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.nn.module import from_jax, param_count, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import greedy_generate, make_lm_decode_step, make_lm_prefill  # noqa: E402

HYMBA_PARAMS = 1_589_773_120


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def _pair(jmod, tmod, seed=0):
    jp = jax.tree.map(np.asarray, jmod.init(jax.random.key(seed)))
    return jp, from_jax(jp)


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------- small modules


@pytest.mark.parametrize("zero_centered", [False, True], ids=["plain", "zero_centered"])
def test_rmsnorm_matches_jax(zero_centered):
    jm, tm = jnn.RMSNorm(24, zero_centered=zero_centered), tnn.RMSNorm(24, zero_centered=zero_centered)
    jp = {"scale": (np.random.RandomState(0).randn(24) * 0.3).astype(np.float32)}
    x = _x(3, 5, 24) * 4
    np.testing.assert_allclose(_f32(tm(from_jax(jp), torch.from_numpy(x))), _f32(jm(jp, jnp.asarray(x))), atol=1e-5)
    assert tuple(tm.init(torch.Generator())["scale"].tolist()) == (0.0 if zero_centered else 1.0,) * 24


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "silu", "relu"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
def test_mlp_matches_jax(act, gated):
    """Every activation; ``gelu`` is jax's tanh approximation, not torch's
    exact default."""
    jm, tm = jnn.MLP(16, 40, act=act, gated=gated), tnn.MLP(16, 40, act=act, gated=gated)
    jp, tp = _pair(jm, tm)
    x = _x(2, 7, 16) * 2
    np.testing.assert_allclose(_f32(tm(tp, torch.from_numpy(x))), _f32(jm(jp, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("scale", [False, True], ids=["plain", "sqrt_d"])
def test_embedding_lookup_and_tied_logits_match_jax(scale):
    jm, tm = jnn.Embedding(50, 12, scale_by_sqrt_d=scale), tnn.Embedding(50, 12, scale_by_sqrt_d=scale)
    jp, tp = _pair(jm, tm)
    toks = np.random.RandomState(2).randint(0, 50, (3, 9)).astype(np.int32)
    np.testing.assert_allclose(_f32(tm(tp, torch.from_numpy(toks))), _f32(jm(jp, jnp.asarray(toks))), atol=1e-6)
    x = _x(3, 9, 12)
    np.testing.assert_allclose(_f32(tm.attend(tp, torch.from_numpy(x))), _f32(jm.attend(jp, jnp.asarray(x))),
                               atol=1e-5)


def test_dense_layouts_match_jax():
    """``Linear`` (with bias), ``MultiLinear`` (d, H, D) and ``OutputLinear``
    (H, D, d): the attention projections' head layouts."""
    x, xh = _x(2, 5, 16), _x(2, 5, 3, 8, seed=2)
    for jm, tm, inp in (
        (jnn.Linear(16, 24, use_bias=True), tnn.Linear(16, 24, use_bias=True), x),
        (jnn.MultiLinear(16, 3, 8), tnn.MultiLinear(16, 3, 8), x),
        (jnn.OutputLinear(3, 8, 16), tnn.OutputLinear(3, 8, 16), xh),
    ):
        jp, tp = _pair(jm, tm)
        if "b" in jp:
            jp["b"] = np.random.RandomState(4).randn(24).astype(np.float32)
            tp = from_jax(jp)
        np.testing.assert_allclose(_f32(tm(tp, torch.from_numpy(inp))), _f32(jm(jp, jnp.asarray(inp))), atol=1e-5)


@pytest.mark.parametrize("hd,base", [(16, 10000.0), (64, 500000.0)])
def test_apply_rope_matches_jax(hd, base):
    x = _x(2, 11, 3, hd)
    pos = np.random.RandomState(3).randint(0, 5000, (2, 11)).astype(np.int32)
    got = tnn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), base)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), base)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)


def test_stacked_init_and_abstract_keep_the_jax_layout():
    """``Stacked`` gives every leaf a leading layer axis (as the JAX
    package's ``Stacked``), draws distinct copies, and its ``abstract``
    tree of meta tensors has the same shapes."""
    inner = tnn.MLP(8, 16)
    st = tnn.Stacked(inner, 3)
    p = st.init(torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda s: s.shape, jnn.Stacked(jnn.MLP(8, 16), 3).abstract())
    tshapes = {k: {"w": tuple(v["w"].shape)} for k, v in p.items()}
    assert tshapes == {k: {"w": tuple(v["w"])} for k, v in jshapes.items()}
    assert not torch.equal(p["up"]["w"][0], p["up"]["w"][1])
    meta = st.abstract()
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    assert [tuple(t.shape) for t in tree_leaves(meta)] == [tuple(t.shape) for t in tree_leaves(p)]
    with pytest.raises(TypeError):
        st(p, torch.zeros(1, 8))


# ------------------------------------------------------------- Hymba LM


def _hymba(seed=0):
    jcfg = dataclasses.replace(jconfigs.get_arch("hymba_1_5b").smoke, act_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_arch("hymba_1_5b").smoke, act_dtype=torch.float32)
    jm, tm = jconfigs.build_model(jcfg), tconfigs.build_model(tcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, tm, jp, from_jax(jp)


def _tokens(B, S, vocab, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def test_hymba_smoke_config_is_a_copy():
    jc = jconfigs.get_arch("hymba_1_5b")
    tc = tconfigs.get_arch("hymba_1_5b")
    skip = {"act_dtype", "remat", "act_spec"}  # JAX-only knobs, and the dtype's type
    for cfg_j, cfg_t in ((jc.config, tc.config), (jc.smoke, tc.smoke)):
        fj = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j) if f.name not in skip}
        ft = {f.name: getattr(cfg_t, f.name) for f in dataclasses.fields(cfg_t) if f.name not in skip}
        assert fj == ft
        assert cfg_t.windows() == cfg_j.windows()
    assert tc.config.act_dtype == torch.bfloat16 and tc.family == "hymba"


def test_hymba_forward_matches_jax():
    """``__call__`` logits over 16 tokens (window 8 and global layers,
    ragged SSD chunks of 8), and with the caller's positions; f32, 1e-4."""
    jm, tm, jp, tp = _hymba()
    toks = _tokens(2, 16, 512)
    want, _ = jm(jp, jnp.asarray(toks))
    got, aux = tm(tp, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 16, 512) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)
    pos = (np.arange(16, dtype=np.int32)[None] + np.array([[0], [5]], np.int32))
    np.testing.assert_allclose(
        _f32(tm(tp, torch.from_numpy(toks), torch.from_numpy(pos))[0]),
        _f32(jm(jp, jnp.asarray(toks), jnp.asarray(pos))[0]), atol=1e-4,
    )
    hid, _ = tm(tp, torch.from_numpy(toks), return_hidden=True)
    np.testing.assert_allclose(_f32(tm.head(tp, hid)), _f32(want), atol=1e-4)


def test_hymba_prefill_matches_jax():
    """``prefill`` logits and every cache (KV, conv tail, SSM state) with
    f32 caches, 1e-4 on logits and 1e-5 on caches; and ``make_lm_prefill``
    with the default bf16 caches, within one bf16 ulp (up to 2^-7
    relative: a 1e-7 difference in f32 can round to the neighbouring bf16
    value)."""
    jm, tm, jp, tp = _hymba(seed=3)
    toks = _tokens(2, 20, 512, seed=4)
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    logits, caches = tm.prefill(tp, torch.from_numpy(toks), cache_dtype=torch.float32)
    wl, wc = jm.prefill(jp, jnp.asarray(toks), cache_dtype=jnp.float32)
    assert attn_ops.launches == {"flash_attention": 0} and ssd_ops.launches == {"ssd": 0}  # the CPU: plain ops
    assert tuple(logits.shape) == (2, 1, 512)
    np.testing.assert_allclose(_f32(logits), _f32(wl), atol=1e-4)
    for path in (("kv", "k"), ("kv", "v"), ("ssm", "conv"), ("ssm", "ssm")):
        got, want = caches[path[0]][path[1]], wc[path[0]][path[1]]
        assert tuple(got.shape) == want.shape and got.shape[0] == 3
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    bl, bc = make_lm_prefill(tm)(tp, torch.from_numpy(toks))
    jbl, jbc = jsteps.make_lm_prefill(jm)(jp, jnp.asarray(toks))
    np.testing.assert_allclose(_f32(bl), _f32(jbl), atol=1e-4)
    for path in (("kv", "k"), ("kv", "v"), ("ssm", "conv")):
        got, want = bc[path[0]][path[1]], jbc[path[0]][path[1]]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=2**-7)
    np.testing.assert_allclose(_f32(bc["ssm"]["ssm"]), _f32(jbc["ssm"]["ssm"]), atol=1e-5)


def test_hymba_decode_steps_match_jax():
    """``make_lm_decode_step`` over 10 tokens from ``init_caches`` (f32
    caches of length 10): logits 1e-4, caches 1e-5 after every step."""
    jm, tm, jp, tp = _hymba(seed=5)
    toks = _tokens(2, 10, 512, seed=6)
    tc, jc = tm.init_caches(2, 10, dtype=torch.float32), jm.init_caches(2, 10, dtype=jnp.float32)
    tstep, jstep = make_lm_decode_step(tm), jsteps.make_lm_decode_step(jm)
    for t in range(10):
        tl, tc = tstep(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        jl, jc = jstep(jp, jnp.asarray(toks[:, t : t + 1]), jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_hymba_greedy_tokens_identical_to_jax(cache_dtype):
    """``greedy_generate``: prompt 6, 8 new tokens, the same token ids."""
    jm, tm, jp, tp = _hymba(seed=7)
    prompt = _tokens(2, 6, 512, seed=8)
    got = greedy_generate(tm, tp, torch.from_numpy(prompt), 8, 16, cache_dtype=getattr(torch, cache_dtype))
    want = jsteps.greedy_generate(jm, jp, jnp.asarray(prompt), 8, 16, cache_dtype=getattr(jnp, cache_dtype))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hymba_decode_matches_full_forward():
    """The JAX package's own consistency pin (tests/test_models_smoke.py:
    decode vs the full forward, atol 5e-2, rtol 1e-2), on the port."""
    _, tm, _, tp = _hymba(seed=0)
    toks = torch.from_numpy(_tokens(2, 8, 512))
    full, _ = tm(tp, toks)
    caches = tm.init_caches(2, 8, dtype=torch.float32)
    outs = []
    for t in range(8):
        lg, caches = tm.decode_step(tp, toks[:, t : t + 1], caches, t)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-2, rtol=1e-2)


def test_hymba_full_width_parameter_count_from_shapes():
    """1,589,773,120 parameters at full width, counted from meta tensors
    (nothing allocated), equal to the JAX package's ``abstract()`` count and
    to the config's analytic ``n_params``."""
    cfg = tconfigs.get_arch("hymba_1_5b").config
    meta = tconfigs.build_model(cfg).abstract()
    assert param_count(meta) == HYMBA_PARAMS == cfg.n_params()
    jcfg = jconfigs.get_arch("hymba_1_5b").config
    jabs = jconfigs.build_model(jcfg).abstract()
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jabs)) == HYMBA_PARAMS
    assert [tuple(t.shape) for t in tree_leaves(meta)] == [tuple(s.shape) for s in jax.tree.leaves(jabs)]


# -------------------------------------------------------------- registry


@pytest.mark.parametrize("arch", ["gemma2_2b", "deepseek_v2_lite_16b", "mamba2_2_7b", "whisper_small"])
def test_registry_serves_every_family_with_copied_configs(arch):
    """``get_arch`` serves the ``lm``, ``mamba2`` and ``whisper`` families,
    each config and smoke config a field-for-field copy of the JAX
    package's (the dtype as a torch dtype) with its skip shapes and
    training knobs, and ``build_model`` builds the family's model."""
    from repro_torch.models import Mamba2LM, TransformerLM, WhisperModel

    assert arch in tconfigs.ARCH_IDS
    jc, tc = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for cfg_j, cfg_t in ((jc.config, tc.config), (jc.smoke, tc.smoke)):
        assert type(cfg_t).__name__ == type(cfg_j).__name__
        fj = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j) if f.name != "act_dtype"}
        ft = {f.name: getattr(cfg_t, f.name) for f in dataclasses.fields(cfg_t) if f.name != "act_dtype"}
        assert fj == ft
        assert cfg_t.act_dtype == torch.bfloat16 and cfg_j.act_dtype == jnp.bfloat16
    assert (tc.family, tc.skip_shapes, tc.skip_reasons, tc.train_micro, tc.train_fsdp) == (
        jc.family, jc.skip_shapes, jc.skip_reasons, jc.train_micro, jc.train_fsdp)
    model = tconfigs.build_model(tc.smoke)
    assert isinstance(model, {"lm": TransformerLM, "mamba2": Mamba2LM, "whisper": WhisperModel}[tc.family])


def test_registry_builds_the_ported_families():
    from repro_torch.models import HymbaLM, Pix2Pix, YOLOv8

    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and tconfigs.SHAPES == jconfigs.SHAPES
    assert isinstance(tconfigs.build_model(tconfigs.get_arch("hymba_1_5b").smoke), HymbaLM)
    pix = tconfigs.get_arch("pix2pix_mri")
    assert pix.family == "pix2pix" and isinstance(tconfigs.build_model(pix.config), Pix2Pix)
    yolo = tconfigs.get_arch("yolov8-stroke")
    assert yolo.family == "yolo" and isinstance(tconfigs.build_model(yolo.smoke), YOLOv8)
    with pytest.raises(KeyError):
        tconfigs.get_arch("llama_7b")
    with pytest.raises(TypeError):
        tconfigs.build_model(object())


# ------------------------------------------------------------- card only


@pytest.mark.cuda
def test_cuda_hymba_prefill_goes_through_both_kernels():
    """On the card a prefill at the smoke config launches each LM kernel
    once per layer and matches the CPU's plain prefill (f32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tm, _, tp = _hymba()
    toks = torch.from_numpy(_tokens(2, 40, 512))
    want, wc = tm.prefill(tp, toks, cache_dtype=torch.float32)
    dev = torch.device("cuda")
    tpd = tree_map(lambda t: t.to(dev), tp)
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    got, gc = tm.prefill(tpd, toks.to(dev), cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert attn_ops.launches == {"flash_attention": 3} and ssd_ops.launches == {"ssd": 3}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    for a, b in zip(tree_leaves(gc), tree_leaves(wc)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
