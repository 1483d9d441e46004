"""The PyTorch port's transformer LM zoo against the JAX package: the
modules it adds (``apply_mrope``, ``MoE``, ``MLAAttention``,
``Attention.project_kv``/``attend_kv``), ``TransformerLM`` at each of the
seven ``SMOKE`` configs of the ``lm`` family (gemma-2b, gemma2-2b,
gemma2-27b, phi4-mini, deepseek-moe-16b, deepseek-v2-lite, qwen2-vl-7b:
forward, prefill and every cache leaf, decode from ``init_caches``, decode
after prefill, ``greedy_generate``, the decode-vs-forward pin), the
full-width parameter counts, and the ported analytic FLOP and byte model.

Inputs come from numpy seeds. Parameters are drawn once by the port's
``init`` (the JAX package's distributions; its eager ``init`` compiles one
program per leaf shape, seconds per model), handed to the JAX module as
numpy arrays and carried back through ``from_jax``. Every comparison is in f32: atol 1e-5 on single modules, 1e-4
on logits, unless a case states another with its reason. The JAX side runs
jitted (the same functions, compiled once per shape).
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
from repro.launch import analytic as janalytic  # noqa: E402
from repro.nn.rotary import apply_mrope as j_apply_mrope  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.launch import analytic as tanalytic  # noqa: E402
from repro_torch.nn.module import from_jax, param_count, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import greedy_generate, make_lm_prefill  # noqa: E402

LM_ARCHS = ("gemma_2b", "gemma2_2b", "gemma2_27b", "phi4_mini_3_8b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
            "qwen2_vl_7b")
# the full-width parameter counts, from the JAX package's abstract() trees
FULL_PARAMS = {
    "gemma2_2b": 2_614_341_888,
    "gemma_2b": 2_506_172_416,
    "gemma2_27b": 27_227_128_320,
    "phi4_mini_3_8b": 3_836_021_760,
    "deepseek_moe_16b": 16_377_694_208,
    "deepseek_v2_lite_16b": 15_708_436_480,
    "qwen2_vl_7b": 7_615_487_488,
    "mamba2_2_7b": 2_702_579_200,
    "whisper_small": 238_452_480,
}


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


def _params(tm, jm, seed=0):
    """One parameter tree for both sides: the port's ``init`` as numpy
    arrays (the JAX module's tree: same structure and shapes as its
    ``abstract()``), and the same carried across by ``from_jax``."""
    jp = tree_map(lambda t: t.numpy(), tm.init(torch.Generator().manual_seed(seed)))
    assert [a.shape for a in tree_leaves(jp)] == [s.shape for s in jax.tree.leaves(jm.abstract())]
    return jp, from_jax(jp)


def _close_trees(got, want, atol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_f32(a), _f32(b), atol=atol)


@functools.lru_cache(maxsize=None)
def _zoo(arch, seed=0, **overrides):
    """The JAX and port models of ``arch``'s smoke config (f32 activations),
    one parameter tree, and the JAX side's jitted entry points."""
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, act_dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, act_dtype=torch.float32, **overrides)
    jm, tm = jconfigs.build_model(jcfg), tconfigs.build_model(tcfg)
    jp, tp = _params(tm, jm, seed)
    jit = types.SimpleNamespace(
        call=jax.jit(jm.__call__),
        prefill=jax.jit(functools.partial(jm.prefill, cache_dtype=jnp.float32)),
        prefill_bf16=jax.jit(jm.prefill),
        decode=jax.jit(jm.decode_step),
    )
    return jm, tm, jp, tp, jit


# ---------------------------------------------------------- modules


@pytest.mark.parametrize("sections,base", [((2, 3, 3), 10000.0), ((16, 24, 24), 1000000.0)])
def test_apply_mrope_matches_jax(sections, base):
    """Distinct (t, h, w) ids per token, so each frequency band reads its
    own component."""
    hd = 2 * sum(sections)
    x = _x(2, 7, 3, hd)
    pos = np.random.RandomState(3).randint(0, 4000, (2, 7, 3)).astype(np.int32)
    got = tnn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, base)
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, base)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    with pytest.raises(ValueError):
        tnn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (1, 1, 1), base)


@pytest.mark.parametrize("capacity_factor", [0.5, 16.0], ids=["drops", "no_drop"])
def test_moe_matches_jax(capacity_factor):
    """The experts chosen equal ``jax.lax.top_k``'s, and the output and aux
    loss equal JAX's, so the same tokens were dropped: 80 tokens route 160
    slots to 4 experts, which take 20 each at capacity factor 0.5 (tokens
    dropped) and 320 at 16 (none dropped). f32; atol 1e-5 on the output
    (``index_add_`` sums in another order than ``segment_sum``)."""
    kw = dict(d_model=16, d_ff_expert=12, n_experts=4, top_k=2, n_shared=1, capacity_factor=capacity_factor)
    jm, tm = jnn.MoE(**kw), tnn.MoE(**kw)
    jp, tp = _params(tm, jm, seed=4)
    jp["router"] = (np.asarray(jp["router"]) * 50).astype(np.float32)  # sharp routing: uneven expert loads
    tp = from_jax(jp)
    x = _x(2, 40, 16, seed=5)
    y, aux = tm(tp, torch.from_numpy(x))
    wy, waux = jax.jit(jm.__call__)(jp, jnp.asarray(x))
    np.testing.assert_allclose(_f32(y), _f32(wy), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    xf = torch.from_numpy(x).reshape(80, 16)
    probs, gates, eidx = tm.route(tp, xf)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(80, 16) @ jnp.asarray(jp["router"]), axis=-1)
    jgates, jeidx = jax.lax.top_k(jprobs, 2)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    slot_tok, _ = tm.dispatch(eidx, gates, 80)
    kept = int((slot_tok < 80).sum())
    assert (kept < 160) == (capacity_factor < 1), kept  # 80 tokens x top 2


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = tnn.moe.top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_matches_jax(absorb):
    """``__call__`` (unchunked causal and not, and chunked with a window),
    ``prefill`` and its latent caches, and ``decode`` from ``init_cache``
    for 10 steps on a cache of 8 (steps 8 and 9 write the last slot, as
    ``dynamic_update_slice`` clamps); f32, atol 1e-5."""
    kw = dict(d_model=32, n_q=4, kv_lora=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8, absorb=absorb)
    x = _x(2, 16, 32, seed=6)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for chunk in (0, 8):
        jm, tm = jnn.MLAAttention(**kw, attn_chunk=chunk), tnn.MLAAttention(**kw, attn_chunk=chunk)
        jp, tp = _params(tm, jm, seed=7)
        assert [tuple(t.shape) for t in tree_leaves(tp)] == [a.shape for a in jax.tree.leaves(jp)]
        jcall = jax.jit(jm.__call__, static_argnames=("window", "causal"))
        for window, causal in (((0, True), (0, False)) if chunk == 0 else ((4, True),)):
            np.testing.assert_allclose(_f32(tm(tp, tx, window=window, causal=causal)),
                                       _f32(jcall(jp, jx, window=window, causal=causal)), atol=1e-5)
        y, cache = tm.prefill(tp, tx, window=4, cache_dtype=torch.float32)
        wy, wcache = jax.jit(functools.partial(jm.prefill, window=4, cache_dtype=jnp.float32))(jp, jx)
        np.testing.assert_allclose(_f32(y), _f32(wy), atol=1e-5)
        _close_trees(cache, wcache, 1e-5)
    tc, jc = tm.init_cache(2, 8, torch.float32), jm.init_cache(2, 8, jnp.float32)
    jdecode = jax.jit(jm.decode)
    for t in range(10):
        ty, tc = tm.decode(tp, tx[:, t : t + 1], tc, t)
        jy, jc = jdecode(jp, jx[:, t : t + 1], jc, t)
        np.testing.assert_allclose(_f32(ty), _f32(jy), atol=1e-5)
        _close_trees(tc, jc, 1e-5)


def test_project_kv_and_attend_kv_match_jax():
    """Cross-attention caches and attention against them, with the default
    all-keys mask and with a caller's mask; f32, atol 1e-5."""
    kw = dict(d_model=32, n_q=4, n_kv=2, head_dim=16, use_rope=False)
    jm, tm = jnn.Attention(**kw), tnn.Attention(**kw)
    jp, tp = _params(tm, jm, seed=8)
    x, kv = _x(2, 3, 32, seed=9), _x(2, 11, 32, seed=10)
    tk, tv = tm.project_kv(tp, torch.from_numpy(kv))
    jk, jv = jm.project_kv(jp, jnp.asarray(kv))
    np.testing.assert_allclose(_f32(tk), _f32(jk), atol=1e-5)
    np.testing.assert_allclose(_f32(tv), _f32(jv), atol=1e-5)
    mask = np.random.RandomState(11).rand(1, 1, 3, 11) > 0.3
    mask[..., 0] = True
    for m in (None, mask):
        got = tm.attend_kv(tp, torch.from_numpy(x), tk, tv, None if m is None else torch.from_numpy(m))
        want = jm.attend_kv(jp, jnp.asarray(x), jk, jv, None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    # and the same function as cross-attention through __call__ (non-causal, kv_x)
    np.testing.assert_allclose(_f32(tm(tp, torch.from_numpy(x), causal=False, kv_x=torch.from_numpy(kv))),
                               _f32(jm.attend_kv(jp, jnp.asarray(x), jk, jv)), atol=1e-5)


# ---------------------------------------------------- the smoke configs


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_matches_jax(arch):
    """``__call__`` logits over 16 tokens (windows of 8 on the gemma2
    local layers, MoE, MLA, M-RoPE from the model's own positions), aux
    loss, and ``return_hidden`` + ``head``; f32, 1e-4."""
    jm, tm, jp, tp, jit = _zoo(arch)
    toks = _tokens(2, 16, seed=12)
    got, aux = tm(tp, torch.from_numpy(toks))
    want, waux = jit.call(jp, jnp.asarray(toks))
    assert tuple(got.shape) == (2, 16, 512)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6)
    hid, _ = tm(tp, torch.from_numpy(toks), return_hidden=True)
    np.testing.assert_allclose(_f32(tm.head(tp, hid)), _f32(want), atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_matches_jax(arch):
    """``prefill`` logits (1e-4) and every cache leaf (1e-5) with f32
    caches; ``make_lm_prefill``'s default bf16 caches within one bf16 ulp
    (2^-7 relative: a 1e-7 difference in f32 can round to the neighbouring
    bf16 value). On the CPU no kernel launches."""
    jm, tm, jp, tp, jit = _zoo(arch)
    toks = _tokens(2, 20, seed=13)
    attn_ops.reset_launches()
    logits, caches = tm.prefill(tp, torch.from_numpy(toks), cache_dtype=torch.float32)
    assert attn_ops.launches == {"flash_attention": 0}
    wl, wc = jit.prefill(jp, jnp.asarray(toks))
    assert tuple(logits.shape) == (2, 1, 512)
    np.testing.assert_allclose(_f32(logits), _f32(wl), atol=1e-4)
    _close_trees(caches, wc, 1e-5)
    bl, bc = make_lm_prefill(tm)(tp, torch.from_numpy(toks))
    jbl, jbc = jit.prefill_bf16(jp, jnp.asarray(toks))
    np.testing.assert_allclose(_f32(bl), _f32(jbl), atol=1e-4)
    for a, b in zip(tree_leaves(bc), jax.tree.leaves(jbc)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=2**-7)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_steps_match_jax(arch):
    """10 ``decode_step``s from ``init_caches`` (f32, length 10: ring
    caches of the window's length 8 on the gemma2 local layers, which
    wrap): logits 1e-4 and every cache leaf 1e-5 after every step."""
    jm, tm, jp, tp, jit = _zoo(arch)
    toks = _tokens(2, 10, seed=14)
    tc, jc = tm.init_caches(2, 10, dtype=torch.float32), jm.init_caches(2, 10, dtype=jnp.float32)
    _close_trees(tc, jc, 0)
    for t in range(10):
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        jl, jc = jit.decode(jp, jnp.asarray(toks[:, t : t + 1]), jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
        _close_trees(tc, jc, 1e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_after_prefill_matches_jax(arch):
    """Two decode steps on the caches of a 12-token prefill. The caches are
    the prompt's length, and ``decode`` treats a cache as a ring buffer of
    its own length, so the step at t = 12 overwrites position 0 (the JAX
    package's behaviour, reproduced); logits 1e-4, caches 1e-5."""
    jm, tm, jp, tp, jit = _zoo(arch)
    toks = _tokens(2, 14, seed=15)
    _, tc = tm.prefill(tp, torch.from_numpy(toks[:, :12]), cache_dtype=torch.float32)
    _, jc = jit.prefill(jp, jnp.asarray(toks[:, :12]))
    for t in (12, 13):
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        jl, jc = jit.decode(jp, jnp.asarray(toks[:, t : t + 1]), jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
        _close_trees(tc, jc, 1e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_greedy_tokens_identical_to_jax(arch):
    """``greedy_generate``: prompt 6, 8 new tokens, the same token ids (the
    JAX loop's decode step jitted)."""
    jm, tm, jp, tp, jit = _zoo(arch)
    prompt = _tokens(2, 6, seed=16)
    got = greedy_generate(tm, tp, torch.from_numpy(prompt), 8, 14, cache_dtype=torch.float32)
    jmodel = types.SimpleNamespace(init_caches=jm.init_caches, decode_step=jit.decode)
    want = jsteps.greedy_generate(jmodel, jp, jnp.asarray(prompt), 8, 14, cache_dtype=jnp.float32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_matches_full_forward(arch):
    """The JAX package's own consistency pin (tests/test_models_smoke.py:
    decode vs the full forward, atol 5e-2, rtol 1e-2) on the port, with the
    MoE capacity raised to 16 as there: a one-token decode never drops a
    token, a full forward can."""
    over = {"capacity_factor": 16.0} if tconfigs.get_arch(arch).smoke.moe else {}
    _, tm, _, tp, _ = _zoo(arch, **over)
    toks = torch.from_numpy(_tokens(2, 8, seed=1))
    full, _ = tm(tp, toks)
    caches = tm.init_caches(2, 8, dtype=torch.float32)
    outs = []
    for t in range(8):
        lg, caches = tm.decode_step(tp, toks[:, t : t + 1], caches, t)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=5e-2, rtol=1e-2)


def test_qwen2_vl_extra_embeds_and_caller_positions_match_jax():
    """The VLM stub: patch embeddings scattered at ``embed_positions``, with
    the caller's (t, h, w) ids (distinct per component, as an image's
    patches have); logits 1e-4."""
    jm, tm, jp, tp, _ = _zoo("qwen2_vl_7b")
    toks = _tokens(2, 12, seed=17)
    extra = _x(2, 4, 64, seed=18)
    at = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None, :, None], (2, 12, 3)).copy()
    pos[:, 1:5, 1] = [0, 0, 1, 1]
    pos[:, 1:5, 2] = [0, 1, 0, 1]
    got, _ = tm(tp, torch.from_numpy(toks), torch.from_numpy(pos), extra_embeds=torch.from_numpy(extra),
                embed_positions=torch.from_numpy(at))
    want, _ = jm(jp, jnp.asarray(toks), jnp.asarray(pos), extra_embeds=jnp.asarray(extra),
                 embed_positions=jnp.asarray(at))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)
    plain, _ = tm(tp, torch.from_numpy(toks), torch.from_numpy(pos))
    assert not torch.allclose(plain, got)


def test_gemma2_decode_past_its_window_wraps_the_ring_buffer():
    """gemma2's smoke window is 8: 20 decode steps on caches of 20, so the
    local layers' ring caches (8 slots) wrap twice and the global layers'
    do not; logits 1e-4 after every step, and the local layers' caches
    hold 8 positions."""
    jm, tm, jp, tp, jit = _zoo("gemma2_2b")
    toks = _tokens(2, 20, seed=19)
    tc, jc = tm.init_caches(2, 20, dtype=torch.float32), jm.init_caches(2, 20, dtype=jnp.float32)
    assert tm.cfg.windows() == (8, 0, 8, 0) and tuple(tc["scan"]["k"].shape)[:3] == (4, 2, 20)
    assert [tm._cache_len(i, 20) for i in range(4)] == [8, 20, 8, 20]
    for t in range(20):
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t : t + 1]), tc, t)
        jl, jc = jit.decode(jp, jnp.asarray(toks[:, t : t + 1]), jc, t)
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
    _close_trees(tc, jc, 1e-5)


# ---------------------------------------------------------- full width


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_width_parameter_count_from_shapes(arch):
    """At full width the meta-tensor tree (nothing allocated) has the JAX
    package's ``abstract()`` shapes leaf by leaf, and both count the
    config's analytic ``n_params``."""
    cfg = tconfigs.get_arch(arch).config
    meta = tconfigs.build_model(cfg).abstract()
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    jabs = jconfigs.build_model(jconfigs.get_arch(arch).config).abstract()
    assert [tuple(t.shape) for t in tree_leaves(meta)] == [tuple(s.shape) for s in jax.tree.leaves(jabs)]
    assert param_count(meta) == FULL_PARAMS[arch] == cfg.n_params()
    assert cfg.n_active_params() == jconfigs.get_arch(arch).config.n_active_params()


def test_analytic_model_matches_jax_for_every_cell():
    """``fwd_flops_per_token``, ``analytic_flops`` and ``analytic_bytes`` (1
    and 256 chips) equal the JAX package's for every architecture and
    shape, and ``whisper_encoder_flops`` for whisper."""
    for arch in tconfigs.ARCH_IDS:
        tspec, jspec = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
        for shape, sh in tconfigs.SHAPES.items():
            assert tanalytic.fwd_flops_per_token(tspec.config, sh["seq_len"], sh["kind"]) == \
                janalytic.fwd_flops_per_token(jspec.config, sh["seq_len"], sh["kind"])
            assert tanalytic.analytic_flops(tspec, shape) == janalytic.analytic_flops(jspec, shape)
            for chips in (1, 256):
                assert tanalytic.analytic_bytes(tspec, shape, chips) == janalytic.analytic_bytes(jspec, shape, chips)
    wt, wj = tconfigs.get_arch("whisper_small").config, jconfigs.get_arch("whisper_small").config
    assert tanalytic.whisper_encoder_flops(wt, 2) == janalytic.whisper_encoder_flops(wj, 2) > 0


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_launcher_serves_every_architecture(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch <a> --tokens
    4 --batch 2 --prompt-len 8`` for every architecture: the tokens
    ``greedy_generate`` gives on the same smoke model, prompt and seed."""
    from repro_torch.launch import serve

    gen = serve.main(["--arch", arch, "--tokens", "4", "--batch", "2", "--prompt-len", "8", "--device", "cpu"])
    assert f"[serve] arch={arch} generated (2, 4)" in capsys.readouterr().out
    cfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, act_dtype=torch.float32)
    model = tconfigs.build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    assert torch.equal(gen, greedy_generate(model, params, prompt, 4, 12, cache_dtype=torch.float32))


# ------------------------------------------------------------- card only


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_prefill_goes_through_the_flash_kernel(arch):
    """On the card a smoke prefill launches ``flash_attention`` once per GQA
    layer (none for MLA, which takes the plain route) and matches the CPU's
    plain prefill (f32, TF32 off, atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tm, _, tp, _ = _zoo(arch)
    toks = torch.from_numpy(_tokens(2, 40, seed=20))
    want, wc = tm.prefill(tp, toks, cache_dtype=torch.float32)
    dev = torch.device("cuda")
    attn_ops.reset_launches()
    got, gc = tm.prefill(tree_map(lambda t: t.to(dev), tp), toks.to(dev), cache_dtype=torch.float32)
    torch.cuda.synchronize()
    n = 0 if tm.cfg.attn_type == "mla" else tm.cfg.n_layers
    assert attn_ops.launches == {"flash_attention": n}
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    for a, b in zip(tree_leaves(gc), tree_leaves(wc)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
