"""The PyTorch port's LM training against the JAX package: the two
cross-entropies (value and gradient), one ``make_lm_train_step`` step of
every LM family at its ``SMOKE`` config (dense and MoE ``TransformerLM``,
``HymbaLM``, ``Mamba2LM``, Whisper), micro-batched steps, ``remat`` on
against off, the in-place (donating) AdamW update, the config fields the
JAX training path sets, and the synthetic-Markov learning check.

Inputs come from numpy seeds. Model parameters are drawn once by the
port's ``init`` and handed to the JAX model as numpy arrays (its eager
``init`` compiles one program per leaf shape). Everything runs in f32 on
one intra-op thread; the JAX side runs jitted. Each test states its
tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.nn.module import from_jax, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamW,
    chunked_cross_entropy,
    cross_entropy,
    make_lm_train_step,
    warmup_cosine,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: as fast at these sizes, bit-stable across runs,
    and it leaves the cores to the files the suite runs beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def _logits_case(dtype, masked, B=2, S=8, V=37, seed=0):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(B, S, V) * 3).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    mask = (rs.uniform(size=(B, S)) < 0.6).astype(np.float32) if masked else None
    jl = jnp.asarray(logits, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tl = torch.from_numpy(logits).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jl, tl, labels, mask


CE_CASES = [(dt, m) for dt in ("f32", "bf16") for m in (False, True)]
CE_IDS = [f"{dt}-{'mask' if m else 'nomask'}" for dt, m in CE_CASES]


@pytest.mark.parametrize("dtype,masked", CE_CASES, ids=CE_IDS)
def test_cross_entropy_matches_jax(dtype, masked):
    """Value and gradient with respect to the logits. f32: value rtol 1e-6,
    gradient atol 1e-7 (summation order only). bf16: the shifted logits are
    the same bf16 values on both sides and reduce in f32, so the value
    within rtol 1e-6; the gradient, rounded to bf16 on both sides, within
    one bf16 ulp (rtol 2^-7) and atol 1e-7."""
    jl, tl, labels, mask = _logits_case(dtype, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    jv, jg = jax.value_and_grad(lambda x: jlosses.cross_entropy(x, jnp.asarray(labels), jmask))(jl)
    x = tl.clone().requires_grad_()
    v = cross_entropy(x, torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(v, x)
    assert v.dtype == torch.float32 and g.dtype == tl.dtype
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6)
    rtol = 2.0**-7 if dtype == "bf16" else 0
    np.testing.assert_allclose(_f32(g), _f32(jg), rtol=rtol, atol=1e-7)


def _head_case(dtype, masked, B=2, S=16, d=12, V=41, seed=1):
    rs = np.random.RandomState(seed)
    hidden = rs.randn(B, S, d).astype(np.float32)
    table = (rs.randn(V, d) * 0.5).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    mask = (rs.uniform(size=(B, S)) < 0.6).astype(np.float32) if masked else None
    return hidden, table, labels, mask


@pytest.mark.parametrize("dtype,masked", CE_CASES, ids=CE_IDS)
@pytest.mark.parametrize("chunk", [4, 16, 5], ids=["chunked", "S<=chunk", "S%chunk"])
def test_chunked_cross_entropy_matches_jax(dtype, masked, chunk):
    """The head (a tied embedding's ``attend``, in the activations' dtype)
    fused with the loss, against the JAX function at the same chunk: value,
    and gradients with respect to the hidden states and the f32 table.
    Chunks of 4 split S = 16; chunks of 16 and 5 fall through to the plain
    loss. f32: value rtol 1e-6, gradients atol 1e-6. bf16: gradients atol
    2e-3 (bf16 matmul outputs, one ulp of their largest entries); the value
    within rtol 1e-5 where the loss falls through, and within rtol 2^-8 in
    chunks, where XLA keeps each chunk's logits in f32 inside the fused
    ``lax.map`` body while the port rounds them to the head's bf16 (half an
    ulp of the logits, carried to the loss)."""
    hidden, table, labels, mask = _head_case(dtype, masked)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)

    def jhead(p, h):
        return h @ p["table"].astype(h.dtype).T

    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p, h):
        return jlosses.chunked_cross_entropy(jhead, p, h.astype(jdt), jnp.asarray(labels), jmask, chunk=chunk)

    jv, (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))({"table": jnp.asarray(table)}, jnp.asarray(hidden))
    p = {"table": torch.from_numpy(table).requires_grad_()}
    h = torch.from_numpy(hidden).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    v = chunked_cross_entropy(lambda p, x: x @ p["table"].to(x.dtype).T, p, h.to(tdt), torch.from_numpy(labels),
                              tmask, chunk=chunk)
    gp, gh = torch.autograd.grad(v, [p["table"], h])
    f32 = dtype == "f32"
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6 if f32 else 2.0**-8 if chunk == 4 else 1e-5)
    np.testing.assert_allclose(_f32(gh), _f32(jgh), atol=1e-6 if f32 else 2e-3)
    np.testing.assert_allclose(_f32(gp), _f32(jgp["table"]), atol=1e-6 if f32 else 2e-3)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_chunked_equals_plain_in_the_port(masked):
    """Chunks of 4 of S = 16 against the whole head on the plain loss: the
    same per-token terms, concatenated before one mean; value rtol 1e-6,
    gradients atol 1e-7."""
    hidden, table, labels, mask = _head_case("f32", masked)
    tmask = None if mask is None else torch.from_numpy(mask)
    out = []
    for chunk in (4, 16):
        p = {"table": torch.from_numpy(table).requires_grad_()}
        h = torch.from_numpy(hidden).requires_grad_()
        v = chunked_cross_entropy(lambda p, x: x @ p["table"].T, p, h, torch.from_numpy(labels), tmask, chunk=chunk)
        out.append((v, *torch.autograd.grad(v, [p["table"], h])))
    (v4, gp4, gh4), (v16, gp16, gh16) = out
    np.testing.assert_allclose(v4.item(), v16.item(), rtol=1e-6)
    np.testing.assert_allclose(gp4.numpy(), gp16.numpy(), atol=1e-7)
    np.testing.assert_allclose(gh4.numpy(), gh16.numpy(), atol=1e-7)


def test_chunked_loss_recomputes_each_chunk_in_backward(monkeypatch):
    """The head runs once per chunk in the forward and once more per chunk
    in backward (its logits are not kept), and not again under no_grad."""
    hidden, table, labels, _ = _head_case("f32", False)
    calls = []

    def head(p, x):
        calls.append(x.shape[1])
        return x @ p["table"].T

    p = {"table": torch.from_numpy(table).requires_grad_()}
    v = chunked_cross_entropy(head, p, torch.from_numpy(hidden), torch.from_numpy(labels), chunk=4)
    assert calls == [4] * 4
    v.backward()
    assert calls == [4] * 8
    with torch.no_grad():
        chunked_cross_entropy(head, p, torch.from_numpy(hidden), torch.from_numpy(labels), chunk=4)
    assert calls == [4] * 12


# ---------------------------------------------------------------- train steps

ARCHS = ["gemma2_2b", "deepseek_moe_16b", "hymba_1_5b", "mamba2_2_7b", "whisper_small",
         "deepseek_v2_lite_16b", "qwen2_vl_7b", "gemma_2b", "gemma2_27b", "phi4_mini_3_8b"]
B, S, CHUNK = 4, 16, 8
N_IMG = 4  # qwen2-vl's patch embeddings per row


@functools.lru_cache(maxsize=None)
def _models(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).smoke, act_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, act_dtype=torch.float32, **over)
    tm = tconfigs.build_model(tcfg)
    jp = tree_map(lambda t: t.numpy(), tm.init(torch.Generator().manual_seed(0)))
    return jconfigs.build_model(jcfg), tm, jp


def _batch(arch, masked=False, seed=3):
    cfg = tconfigs.get_arch(arch).smoke
    b = next(token_batches(B, S, cfg.vocab, seed=seed))
    rs = np.random.RandomState(seed)
    if arch == "whisper_small":
        b["frames"] = rs.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)
    if arch == "qwen2_vl_7b":  # M-RoPE ids and patch embeddings written into the sequence
        b["positions"] = rs.randint(0, S, (B, S, 3)).astype(np.int32)
        b["extra_embeds"] = rs.randn(B, N_IMG, cfg.d_model).astype(np.float32)
        b["embed_positions"] = np.stack([rs.permutation(S)[:N_IMG] for _ in range(B)]).astype(np.int32)
    if masked:  # a different share of every row: which rows share a micro-batch matters
        b["mask"] = (np.arange(S)[None] < np.array([16, 3, 9, 6])[:, None]).astype(np.float32)
    return b


# AdamW's eps for the steps held against JAX: its first step moves each
# parameter by lr * g / (|g| + eps), whose slope 1 / eps turns the f32 noise
# of a gradient entry that cancels to ~1e-8 (1e-9 apart between two
# summation orders) into 1e-4 of the parameter at the default eps of 1e-8;
# at 1e-6 the two packages' parameters agree within 2e-6 at these sizes
STEP_EPS = 1e-6


def _jax_step(jm, jp, batch, n_micro=1, lr=1e-3, eps=STEP_EPS):
    opt = jopt.AdamW(lr=lr, eps=eps)
    step = jax.jit(jsteps.make_lm_train_step(jm, opt, n_micro=n_micro, loss_chunk=CHUNK))
    return step(jp, opt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})


def _port_step(tm, jp, batch, n_micro=1, lr=1e-3, eps=STEP_EPS, donate=False):
    opt = AdamW(lr=lr, eps=eps)
    p = from_jax(jp)
    step = make_lm_train_step(tm, opt, n_micro=n_micro, loss_chunk=CHUNK, donate=donate)
    return step(p, opt.init(p), {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_jax(arch):
    """One step of ``AdamW(1e-3, eps=STEP_EPS)`` from the same parameters
    on the same batch (S 16 in chunks of 8 through the fused head): loss,
    ce and aux within rtol 1e-5 (atol 1e-7 for a zero aux), the gradient
    norm within rtol 1e-4, and every parameter after the step within atol
    2e-5 (the JAX package's own pin between two gradient computations of
    one step, ``tests/test_train_infra.py``); the MoE config's aux is the
    routers' load-balancing term."""
    jm, tm, jp = _models(arch)
    batch = _batch(arch)
    jnew, _, jmet = _jax_step(jm, jp, batch)
    tnew, tstate, tmet = _port_step(tm, jp, batch)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    if arch == "deepseek_moe_16b":
        assert float(tmet["aux"]) > 0
    assert int(tstate["step"]) == 1
    got, want = tree_leaves(tnew), jax.tree.leaves(jnew)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-5)


def test_microbatched_step_matches_full_batch():
    """``n_micro=4`` against ``n_micro=1`` in the port at the JAX package's
    own pins and optimizer (``tests/test_train_infra.py``: ``AdamW(1e-3)``,
    ce rel 1e-4, parameters atol 2e-5)."""
    _, tm, jp = _models("gemma2_2b")
    batch = _batch("gemma2_2b")
    p1, _, m1 = _port_step(tm, jp, batch, eps=1e-8)
    p4, _, m4 = _port_step(tm, jp, batch, n_micro=4, eps=1e-8)
    assert float(m4["ce"]) == pytest.approx(float(m1["ce"]), rel=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("arch", ["gemma2_2b", "deepseek_moe_16b"])
def test_masked_microbatches_take_the_jax_rows(arch):
    """With a mask that differs between rows, the micro-batched loss is the
    mean of per-micro-batch masked means, so it depends on which rows share
    a micro-batch: the port's ``n_micro=2`` (rows j, j+2) matches the JAX
    package's ``n_micro=2`` (loss, ce, aux rtol 1e-5; parameters atol
    2e-5) and differs from the full-batch loss by more than that."""
    jm, tm, jp = _models(arch)
    batch = _batch(arch, masked=True)
    jnew, _, jmet = _jax_step(jm, jp, batch, n_micro=2)
    tnew, _, tmet = _port_step(tm, jp, batch, n_micro=2)
    _, _, full = _port_step(tm, jp, batch)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert abs(float(tmet["ce"]) - float(full["ce"])) > 1e-3
    for a, b in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-5)


class _Capture:
    """An optimizer that records the gradients it is given and leaves the
    parameters as they are."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state, {}


REMAT_CASES = [("gemma2_2b", "full"), ("gemma2_2b", "dots"), ("deepseek_moe_16b", "full"),
               ("hymba_1_5b", "full"), ("mamba2_2_7b", "full"), ("whisper_small", "full")]


@pytest.mark.parametrize("arch,policy", REMAT_CASES, ids=[f"{a}-{p}" for a, p in REMAT_CASES])
def test_remat_gradients_equal_the_unchecked_ones(arch, policy, monkeypatch):
    """Each block (encoder and decoder blocks for Whisper) runs under
    ``torch.utils.checkpoint`` once per layer when ``remat`` is on and
    autograd records, never with ``remat`` off or under ``no_grad``; the
    recompute replays the same ops in f32 on one thread, so loss and every
    gradient leaf are bit-equal to the run without remat."""
    cfg = tconfigs.get_arch(arch).smoke
    if arch == "whisper_small":
        n_blocks = cfg.n_enc_layers + cfg.n_dec_layers
    else:
        n_blocks = cfg.n_layers
    over = {"remat_policy": policy} if policy != "full" else {}
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn) or real(fn, *a, **kw))
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    out = {}
    for remat in (True, False):
        tm = tconfigs.build_model(dataclasses.replace(cfg, act_dtype=torch.float32, remat=remat, **over))
        params = tm.init(torch.Generator().manual_seed(0))
        cap = _Capture()
        calls.clear()
        _, _, m = make_lm_train_step(tm, cap, loss_chunk=CHUNK)(params, {}, batch)
        out[remat] = (m, cap.grads)
        assert len(calls) == (n_blocks if remat else 0) + S // CHUNK  # the blocks, and the loss's chunks
        with torch.no_grad():
            calls.clear()
            tm(params, *([batch["frames"]] if "frames" in batch else []), batch["tokens"])
            assert not calls
    for k in ("loss", "ce", "aux"):
        assert torch.equal(out[True][0][k], out[False][0][k]), k
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)


def test_donating_step_is_bit_equal_and_writes_in_place():
    """``donate=True`` (``AdamW.update_``) returns the same bits as the
    functional step and writes them into the parameter and moment buffers
    it was given."""
    _, tm, jp = _models("gemma2_2b")
    batch = {k: torch.from_numpy(v) for k, v in _batch("gemma2_2b").items()}
    opt = AdamW(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.01)
    p = from_jax(jp)
    state = opt.init(p)
    want_p, want_s, want_m = make_lm_train_step(tm, opt, loss_chunk=CHUNK, n_micro=2)(p, state, batch)
    got_p, got_s, got_m = make_lm_train_step(tm, opt, loss_chunk=CHUNK, n_micro=2, donate=True)(p, state, batch)
    assert got_p is p and got_s is state
    assert all(a is b for a, b in zip(tree_leaves(got_p), tree_leaves(p)))
    for a, b in zip(tree_leaves((got_p, got_s, got_m)), tree_leaves((want_p, want_s, want_m))):
        assert torch.equal(a, b)


UPDATE_CASES = [
    dict(lr=1e-2, weight_decay=0.01),
    dict(lr=warmup_cosine(1e-2, 2, 10), grad_clip_norm=None),
    dict(lr=3e-3, weight_decay=0.1, master_weights=True),
    dict(lr=1e-3, grad_clip_norm=1e3),
]


@pytest.mark.parametrize("kw", UPDATE_CASES, ids=["decay-clip", "schedule-noclip", "master", "clip-inactive"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_update_in_place_is_bit_equal_to_update(kw, dtype):
    """Three AdamW steps, functional and in place, from copies of the same
    trees: every parameter, moment, master copy, step and info bit-equal,
    and the in-place update's outputs are its inputs."""
    opt = AdamW(**kw)
    g = torch.Generator().manual_seed(0)

    def tree(scale=1.0):
        return {"a": (torch.randn(5, 7, generator=g) * scale).to(dtype),
                "b": [torch.randn(3, generator=g).to(dtype), (torch.randn(2, 2, generator=g) * scale).to(dtype)]}

    p = tree()
    st = opt.init(p)
    for _ in range(3):
        grads = tree(3.0)
        want = opt.update(grads, st, p)
        copies = tree_map(lambda t: t.clone(), (grads, st, p))
        got = opt.update_(*copies)
        assert got[0] is copies[2] and got[1] is copies[1]
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)
        p, st = want[0], want[1]


def test_lm_learns_synthetic_markov():
    """A port of ``tests/test_train_infra.py::test_lm_learns_synthetic_markov``:
    a 2-layer LM learns the synthetic order-2 Markov stream, ce falling by
    more than 0.5 nats in 50 steps of AdamW(3e-3) (chunks of 32 of S 64)."""
    cfg = tmodels.LMConfig(name="t", n_layers=2, d_model=64, n_q=4, n_kv=2, head_dim=16, d_ff=128,
                           vocab=512, act_dtype=torch.float32)
    lm = tmodels.TransformerLM(cfg)
    p = lm.init(torch.Generator().manual_seed(1))
    opt = AdamW(lr=3e-3)
    st = opt.init(p)
    step = make_lm_train_step(lm, opt, loss_chunk=32, donate=True)
    data = token_batches(8, 64, 512, seed=0)
    first = None
    for _ in range(50):
        p, st, m = step(p, st, {k: torch.from_numpy(v) for k, v in next(data).items()})
        first = float(m["ce"]) if first is None else first
    assert float(m["ce"]) < first - 0.5


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["LMConfig", "HymbaConfig", "Mamba2Config", "WhisperConfig"])
def test_lm_configs_have_the_jax_fields(name):
    """Every field of the JAX package's LM configs (``remat``,
    ``act_spec``, ...), with the same defaults but ``act_dtype``, so a
    config built as in the JAX package builds in the port; and
    ``n_active_params`` agrees at every assigned architecture."""
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jmodels, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tmodels, name))}
    assert list(tf) == list(jf)
    assert {k: v for k, v in tf.items() if k != "act_dtype"} == {k: v for k, v in jf.items() if k != "act_dtype"}
    for arch in jconfigs.ARCH_IDS:
        jc, tc = jconfigs.get_arch(arch).config, tconfigs.get_arch(arch).config
        if type(tc).__name__ == name:
            assert tc.n_active_params() == jc.n_active_params()
    if name == "HymbaConfig":
        cfg = dataclasses.replace(tconfigs.get_arch("hymba_1_5b").smoke, remat=False, act_spec=("data", None))
        assert not cfg.remat and cfg.n_active_params() == cfg.n_params()
