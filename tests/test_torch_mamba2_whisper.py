"""The PyTorch port's Mamba2LM and Whisper against the JAX package:
``LayerNorm``, ``sinusoid_pos``, ``Mamba2LM`` and ``WhisperModel`` at their
``SMOKE`` configs (forward, prefill and every cache leaf, decode from
``init_caches``, decode after prefill, ``greedy_generate``, the
decode-vs-forward pin), Whisper's positions past ``max_text`` (tiled in
the forward, clamped in decode), and on the card the two models' prefills
through the SSD and flash kernels (the encoder and cross-attention on the
kernel's non-causal mode).

Inputs come from numpy seeds. Parameters are drawn once by the port's
``init`` (the JAX package's distributions; its eager ``init`` compiles one
program per leaf shape, seconds per model), handed to the JAX module as
numpy arrays and carried back through ``from_jax``. Every comparison is in
f32: atol 1e-5 on single modules and caches, 1e-4 on logits, unless a case
states another with its reason. The JAX side runs jitted.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.models.whisper import sinusoid_pos as j_sinusoid_pos  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import sinusoid_pos  # noqa: E402
from repro_torch.nn.module import from_jax, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import greedy_generate, make_lm_prefill  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the files the suite runs beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tokens(B, S, vocab=512, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(np.int32)


def _close_trees(got, want, atol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_f32(a), _f32(b), atol=atol)


def _params(tm, jm, seed=0):
    """One parameter tree for both sides: the port's ``init`` as numpy
    arrays (the JAX module's tree: same structure and shapes as its
    ``abstract()``), and the same carried across by ``from_jax``."""
    jp = tree_map(lambda t: t.numpy(), tm.init(torch.Generator().manual_seed(seed)))
    assert [a.shape for a in tree_leaves(jp)] == [s.shape for s in jax.tree.leaves(jm.abstract())]
    return jp, from_jax(jp)


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, act_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, act_dtype=torch.float32)
    jm, tm = jconfigs.build_model(jcfg), tconfigs.build_model(tcfg)
    jp, tp = _params(tm, jm, seed)
    jit = types.SimpleNamespace(
        call=jax.jit(jm.__call__),
        prefill=jax.jit(functools.partial(jm.prefill, cache_dtype=jnp.float32)),
        prefill_bf16=jax.jit(jm.prefill),
        decode=jax.jit(jm.decode_step),
    )
    return jm, tm, jp, tp, jit


def _frames(cfg, B=2, seed=2):
    return _x(B, cfg.n_frames, cfg.d_model, seed=seed)


# ---------------------------------------------------------- modules


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
def test_layernorm_matches_jax(use_bias):
    """Biased variance (``jnp.var``) in f32; random scale and bias; atol
    1e-5, and bf16 input cast back to bf16."""
    jm, tm = jnn.LayerNorm(24, use_bias=use_bias), tnn.LayerNorm(24, use_bias=use_bias)
    rs = np.random.RandomState(0)
    jp = {"scale": rs.randn(24).astype(np.float32)}
    if use_bias:
        jp["bias"] = rs.randn(24).astype(np.float32)
    x = _x(3, 5, 24) * 3 + 1
    np.testing.assert_allclose(_f32(tm(from_jax(jp), torch.from_numpy(x))), _f32(jm(jp, jnp.asarray(x))), atol=1e-5)
    got = tm(from_jax(jp), torch.from_numpy(x).to(torch.bfloat16))
    want = jm(jp, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=2**-7)
    assert set(tm.init(torch.Generator())) == set(jax.eval_shape(jm.init, jax.random.key(0)))


def test_sinusoid_pos_matches_jax():
    """atol 1e-5 at the smoke config's 32 frames. At whisper-small's 1500,
    atol 2.5e-4: XLA's and torch's f32 ``exp`` differ in the last bit for
    some frequencies (6e-8 relative), which the angle at position 1499
    multiplies to about one f32 ulp of 1499 rad (1.2e-4)."""
    np.testing.assert_allclose(sinusoid_pos(32, 64).numpy(), np.asarray(j_sinusoid_pos(32, 64)), atol=1e-5)
    np.testing.assert_allclose(sinusoid_pos(1500, 768).numpy(), np.asarray(j_sinusoid_pos(1500, 768)), atol=2.5e-4)


# -------------------------------------------------------- the two models


def _call(arch, m, p, toks, frames=None, jit=None):
    """``__call__`` logits of either side (Whisper takes the frames)."""
    if arch == "whisper_small":
        return (jit.call if jit else m)(p, frames, toks)
    return (jit.call if jit else m)(p, toks)


def _prefill(arch, m, p, toks, frames=None, fn=None):
    fn = fn or m.prefill
    return fn(p, frames, toks) if arch == "whisper_small" else fn(p, toks)


ARCHS = ("mamba2_2_7b", "whisper_small")


def _inputs(arch, tm, S, seed):
    toks = _tokens(2, S, seed=seed)
    frames = _frames(tm.cfg, seed=seed + 100) if arch == "whisper_small" else None
    t = (torch.from_numpy(toks), None if frames is None else torch.from_numpy(frames))
    j = (jnp.asarray(toks), None if frames is None else jnp.asarray(frames))
    return t, j


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """``__call__`` logits over 20 tokens (Mamba2: ragged SSD chunks of 8;
    Whisper: a 32-frame encoder, causal decoder and cross-attention), aux,
    and ``return_hidden`` + ``head``; f32, 1e-4."""
    jm, tm, jp, tp, jit = _model(arch)
    (tt, tf), (jt, jf) = _inputs(arch, tm, 20, seed=3)
    got, aux = _call(arch, tm, tp, tt, tf)
    want, waux = _call(arch, jm, jp, jt, jf, jit)
    assert tuple(got.shape) == (2, 20, 512) and float(aux) == float(waux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)
    hid, _ = (tm(tp, tf, tt, return_hidden=True) if arch == "whisper_small" else tm(tp, tt, return_hidden=True))
    np.testing.assert_allclose(_f32(tm.head(tp, hid)), _f32(want), atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """``prefill`` logits (1e-4) and every cache leaf (1e-5: Mamba2's conv
    tail and SSM state, Whisper's self KV and cross K/V) with f32 caches;
    the default bf16 caches within one bf16 ulp (``make_lm_prefill`` for
    Mamba2; Whisper's prefill takes the frames). No kernel launches on the
    CPU."""
    jm, tm, jp, tp, jit = _model(arch)
    (tt, tf), (jt, jf) = _inputs(arch, tm, 20, seed=4)
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    logits, caches = _prefill(arch, tm, tp, tt, tf, functools.partial(tm.prefill, cache_dtype=torch.float32))
    assert attn_ops.launches == {"flash_attention": 0} and ssd_ops.launches == {"ssd": 0}
    wl, wc = _prefill(arch, jm, jp, jt, jf, jit.prefill)
    assert tuple(logits.shape) == (2, 1, 512)
    np.testing.assert_allclose(_f32(logits), _f32(wl), atol=1e-4)
    _close_trees(caches, wc, 1e-5)
    bl, bc = (tm.prefill(tp, tf, tt) if arch == "whisper_small" else make_lm_prefill(tm)(tp, tt))
    jbl, jbc = _prefill(arch, jm, jp, jt, jf, jit.prefill_bf16)
    np.testing.assert_allclose(_f32(bl), _f32(jbl), atol=1e-4)
    for a, b in zip(tree_leaves(bc), jax.tree.leaves(jbc)):
        assert a.dtype == (torch.float32 if b.dtype == jnp.float32 else torch.bfloat16)  # Mamba2's SSM state: f32
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=2**-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """10 ``decode_step``s from ``init_caches`` (f32, length 10; Whisper's
    zero cross caches): logits 1e-4 and every cache leaf 1e-5 after every
    step."""
    jm, tm, jp, tp, jit = _model(arch)
    toks = _tokens(2, 10, seed=5)
    tc, jc = tm.init_caches(2, 10, dtype=torch.float32), jm.init_caches(2, 10, dtype=jnp.float32)
    _close_trees(tc, jc, 0)
    for t in range(10):
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        jl, jc = jit.decode(jp, jnp.asarray(toks[:, t : t + 1]), jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
        _close_trees(tc, jc, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_jax(arch):
    """Two decode steps on a 12-token prefill's caches: Mamba2 carries its
    states on; Whisper's self caches are the prompt's length, so the step
    at t = 12 overwrites position 0 (the JAX package's behaviour,
    reproduced), and it attends to the prefill's cross K/V; logits 1e-4,
    caches 1e-5."""
    jm, tm, jp, tp, jit = _model(arch)
    (tt, tf), (jt, jf) = _inputs(arch, tm, 14, seed=6)
    _, tc = _prefill(arch, tm, tp, tt[:, :12], tf, functools.partial(tm.prefill, cache_dtype=torch.float32))
    _, jc = _prefill(arch, jm, jp, jt[:, :12], jf, jit.prefill)
    for t in (12, 13):
        tl, tc = tm.decode_step(tp, tt[:, t : t + 1], tc, t)
        jl, jc = jit.decode(jp, jt[:, t : t + 1], jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
        _close_trees(tc, jc, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_identical_to_jax(arch):
    """``greedy_generate``: prompt 6, 8 new tokens, the same token ids (the
    JAX loop's decode step jitted). Whisper decodes only, against its zero
    cross caches, in both packages."""
    jm, tm, jp, tp, jit = _model(arch)
    prompt = _tokens(2, 6, seed=7)
    got = greedy_generate(tm, tp, torch.from_numpy(prompt), 8, 14, cache_dtype=torch.float32)
    jmodel = types.SimpleNamespace(init_caches=jm.init_caches, decode_step=jit.decode)
    want = jsteps.greedy_generate(jmodel, jp, jnp.asarray(prompt), 8, 14, cache_dtype=jnp.float32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The JAX package's consistency pin (tests/test_models_smoke.py: decode
    vs the full forward, atol 5e-2, rtol 1e-2). Whisper's decode takes its
    cross K/V from a prefill of the same frames, put into ``init_caches``
    (decode from zero cross caches attends to no audio)."""
    _, tm, _, tp, _ = _model(arch)
    (toks, frames), _ = _inputs(arch, tm, 8, seed=8)
    full, _ = _call(arch, tm, tp, toks, frames)
    caches = tm.init_caches(2, 8, dtype=torch.float32)
    if arch == "whisper_small":
        _, pc = tm.prefill(tp, frames, toks[:, :1], cache_dtype=torch.float32)
        caches = dict(caches, cross_k=pc["cross_k"], cross_v=pc["cross_v"])
    outs = []
    for t in range(8):
        lg, caches = tm.decode_step(tp, toks[:, t : t + 1], caches, t)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-2, rtol=1e-2)


def test_whisper_positions_past_max_text_match_jax():
    """The smoke config's ``max_text`` is 64: a 70-token forward tiles
    ``pos_embed`` (positions 64.. reuse rows 0..), and decode steps at t =
    63..66 clamp to the last row; logits 1e-4."""
    jm, tm, jp, tp, jit = _model("whisper_small")
    (tt, tf), (jt, jf) = _inputs("whisper_small", tm, 70, seed=9)
    np.testing.assert_allclose(_f32(tm(tp, tf, tt)[0]), _f32(jit.call(jp, jf, jt)[0]), atol=1e-4)
    tc, jc = tm.init_caches(2, 70, dtype=torch.float32), jm.init_caches(2, 70, dtype=jnp.float32)
    for t in range(63, 67):
        tl, tc = tm.decode_step(tp, tt[:, t : t + 1], tc, t)
        jl, jc = jit.decode(jp, jt[:, t : t + 1], jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)


# ------------------------------------------------------------- card only


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,launches", [("mamba2_2_7b", {"flash_attention": 0, "ssd": 3}),
                                           ("whisper_small", {"flash_attention": 6, "ssd": 0})])
def test_cuda_prefill_goes_through_the_kernels(arch, launches):
    """On the card a smoke prefill launches ``ssd`` once per Mamba2 layer,
    and ``flash_attention`` once per Whisper encoder layer (non-causal),
    decoder self-attention (causal) and cross-attention (non-causal); it
    matches the CPU's plain prefill (f32, TF32 off, atol 1e-4)."""
    dev = _card()
    _, tm, _, tp, _ = _model(arch)
    (tt, tf), _ = _inputs(arch, tm, 40, seed=10)
    want, wc = _prefill(arch, tm, tp, tt, tf, functools.partial(tm.prefill, cache_dtype=torch.float32))
    attn_ops.reset_launches()
    ssd_ops.reset_launches()
    tpd = tree_map(lambda t: t.to(dev), tp)
    got, gc = _prefill(arch, tm, tpd, tt.to(dev), None if tf is None else tf.to(dev),
                       functools.partial(tm.prefill, cache_dtype=torch.float32))
    torch.cuda.synchronize()
    assert {**attn_ops.launches, **ssd_ops.launches} == launches
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    for a, b in zip(tree_leaves(gc), tree_leaves(wc)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_non_causal_attention_takes_the_kernel_and_matches_the_cpu():
    """Non-causal self-attention with the caller's positions (the mask is
    all ones whatever they are) and cross-attention (Sq 17 against Sk 300,
    neither a multiple of a tile) launch the kernel and match the CPU's
    plain route, f32 (atol 3e-4, the kernel's pin); bf16 against the f32
    plain route on bf16-rounded inputs at the JAX package's bf16 pin (atol
    5e-2: the projections round in bf16 too)."""
    dev = _card()
    tm = tnn.Attention(128, 4, 2, 64)
    tp = tm.init(torch.Generator().manual_seed(0))
    x, kv = torch.from_numpy(_x(2, 17, 128, seed=11)), torch.from_numpy(_x(2, 300, 128, seed=12))
    pos = torch.arange(17)[None].expand(2, 17) * 3
    want_self = tm(tp, x, pos, causal=False)
    want_cross = tm(tp, x, causal=False, kv_x=kv)
    tpd = tree_map(lambda t: t.to(dev), tp)
    attn_ops.reset_launches()
    got_self = tm(tpd, x.to(dev), pos.to(dev), causal=False)
    got_cross = tm(tpd, x.to(dev), causal=False, kv_x=kv.to(dev))
    tp16 = tree_map(lambda t: t.to(dev, torch.bfloat16), tp)
    got16 = tm(tp16, x.to(dev, torch.bfloat16), causal=False, kv_x=kv.to(dev, torch.bfloat16))
    torch.cuda.synchronize()
    assert attn_ops.launches == {"flash_attention": 3}
    torch.testing.assert_close(got_self.cpu(), want_self, atol=3e-4, rtol=0)
    torch.testing.assert_close(got_cross.cpu(), want_cross, atol=3e-4, rtol=0)
    want16 = tm(tree_map(lambda t: t.to(torch.bfloat16).float(), tp), x.to(torch.bfloat16).float(), causal=False,
                kv_x=kv.to(torch.bfloat16).float())
    assert got16.dtype == torch.bfloat16 and bool(torch.isfinite(got16).all())
    torch.testing.assert_close(got16.float().cpu(), want16, atol=5e-2, rtol=0)
