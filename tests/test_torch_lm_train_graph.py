"""The captured LM train step (``make_lm_train_step(..., donate=True)``): on
the card the step is what the JAX launcher's ``jax.jit(step,
donate_argnums=(0, 1))`` compiles, one CUDA graph per key replayed at every
call and written into the parameter and optimizer-state buffers it was
captured on, on plain tensors and on the DTensors ``on_mesh`` hands it.

On the CPU the shared stand-in of ``test_torch_train_graph.py``
(``fake_card``) drives the capture logic. Held here, for the smoke
gemma2-2b, mamba2-2.7b, hymba-1.5b, whisper-small and deepseek-moe-16b
(f32, remat on, AdamW with a ``warmup_cosine`` rate, ``n_micro`` 1 and 2),
on plain tensors and on a one-rank gloo mesh through ``on_mesh``, over 3
steps (the first the key's warm-up, the second its capture and first
replay): every loss, parameter and optimizer-state leaf bit-equal to
``step.eager`` (the same ops without the graph); the returned trees are
the caller's own buffers (the same addresses at every step); each count
comes back holding the step's number (a CPU int32 tensor on plain
tensors, the mesh's own DTensor on the mesh); one capture and two replays;
from the third call each call copies only the batch in and clones only the
metrics out. Trees of the same shapes at other addresses (a restored
checkpoint) reuse the capture and are copied in once, and the step returns
the graph's buffers; another batch shape is another key. On the CPU
without the stand-in the step is the eager step and captures nothing. Two
captured steps of the smoke gemma2-2b agree with the JAX package's step
under ``jax.jit(..., donate_argnums=(0, 1))`` within
``test_torch_lm_train.py``'s pins. The ``cuda`` cases run on real graphs
(cuDNN deterministic, TF32 off): the same checks for the five families
(``n_micro`` 2) and gemma2-2b on a one-rank NCCL mesh, 4 captured steps
bit-equal to 4 eager ones, plain and on the mesh, and a host sync planted
in the loss making the capture raise, naming the model. Every run uses one
intra-op thread.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import shard_batch, token_batches  # noqa: E402
from repro_torch.dist import device_put, on_mesh, train_shardings  # noqa: E402
from repro_torch.nn.module import from_jax, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import AdamW, make_lm_train_step, warmup_cosine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_train_graph import HostCopies, _one_thread, card, fake_card  # noqa: E402,F401

ARCHS = ("gemma2_2b", "mamba2_2_7b", "hymba_1_5b", "whisper_small", "deepseek_moe_16b")
B, S, CHUNK = 4, 16, 8  # test_torch_lm_train.py's batch and loss chunk
STEPS = 3


def _opt():
    return AdamW(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.01)


def _model(arch):
    cfg = dataclasses.replace(tconfigs.get_arch(arch).smoke, act_dtype=torch.float32, remat=True)
    return tconfigs.build_model(cfg)


def _host_batches(arch, n, seed=3):
    cfg = tconfigs.get_arch(arch).smoke
    data = token_batches(B, S, cfg.vocab, seed=seed)
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = next(data)
        if arch == "whisper_small":
            b["frames"] = rs.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)
        out.append(b)
    return out


class _Plain:
    """Trees as plain tensors on ``device``."""

    def __init__(self, device="cpu"):
        self.device = device

    def trees(self, params, opt):
        params = tree_map(lambda t: t.to(self.device, copy=True), params)
        return params, opt.init(params)

    def batch(self, host):
        return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def wrap(self, step):
        return step


class _Mesh(_Plain):
    """Trees as DTensors on a one-rank mesh (the launcher's placement)."""

    def __init__(self, model, opt, device="cpu"):
        from repro_torch.launch.mesh import make_host_mesh

        super().__init__(device)
        mesh = make_host_mesh(1, device=device)
        self.sh = train_shardings(mesh, model.axes(), model.abstract(), opt.abstract_state(model.abstract()), B)

    def trees(self, params, opt):
        params, state = super().trees(params, opt)
        return device_put(params, self.sh.params), device_put(state, self.sh.opt_state)

    def batch(self, host):
        return shard_batch(host, self.sh.batch)

    def wrap(self, step):
        return on_mesh(step)


@pytest.fixture
def placement(request):
    """The trees' placement, "plain" or "mesh"; the mesh's world-1 gloo
    group is destroyed after the test."""
    import torch.distributed as dist

    yield request.param
    if dist.is_initialized():
        dist.destroy_process_group()


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _values(tree):
    """Every leaf's local value, cloned (the next donated step overwrites it)."""
    return [_local(t).clone() for t in tree_leaves(tree)]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def _is_count(t):
    return t.ndim == 0 and not t.dtype.is_floating_point


def _buffers(trees):
    """The addresses of the leaves a donated step writes: all but the
    counts on the host (a count placed on a mesh is donated too)."""
    return [_local(t).data_ptr() for t in tree_leaves(trees) if not _is_count(t) or hasattr(t, "placements")]


def _eager_run(step, params, state, batches):
    """``step.eager`` from copies of the trees: each call's values."""
    params, state = tree_map(torch.clone, params), tree_map(torch.clone, state)
    out = []
    for b in batches:
        params, state, m = step.eager(params, state, b)
        out.append(_values((params, state, m)))
    return out


def check_donated(step, params, state, batches, captures=None):
    """``step`` against ``step.eager`` over ``STEPS`` calls from (params,
    state): the checks this file's docstring lists. ``captures``: the
    stand-in's list (None on the card)."""
    want = _eager_run(step, params, state, batches[:STEPS])
    buffers = _buffers((params, state))
    n_batch, got = len(tree_leaves(batches[0])), []
    for k, b in enumerate(batches[:STEPS], start=1):
        with HostCopies() as copies:
            params, state, m = step(params, state, b)
        if k > 2:  # the first call is the warm-up, the second captures
            assert copies.rows == {"copy_": n_batch, "clone": len(tree_leaves(m))}, copies.rows
        assert _buffers((params, state)) == buffers
        counts = [t for t in tree_leaves(state) if _is_count(t)]
        assert counts and all(_local(c).dtype == torch.int32 and int(_local(c)) == k for c in counts)
        if not hasattr(counts[0], "placements"):
            assert all(c.device.type == "cpu" for c in counts)
        got.append(_values((params, state, m)))
    for g, w in zip(got, want):
        _same(g, w)
    assert [g.replays for g in step.graphs.values()] == [STEPS - 1]
    if captures is not None:
        assert len(captures) == 1 and captures[0].startswith("the train step of ")
    return params, state


# ---- CPU, through the stand-in ------------------------------------------------


@pytest.mark.parametrize("placement", ["plain", "mesh"], indirect=True)
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_fake_card_step_equals_eager(fake_card, placement, arch, n_micro):
    model, opt = _model(arch), _opt()
    where = _Plain() if placement == "plain" else _Mesh(model, opt)
    params, state = where.trees(model.init(torch.Generator().manual_seed(0)), opt)
    batches = [where.batch(b) for b in _host_batches(arch, STEPS)]
    step = where.wrap(make_lm_train_step(model, opt, n_micro=n_micro, loss_chunk=CHUNK, donate=True))
    check_donated(step, params, state, batches, fake_card)
    assert fake_card == [f"the train step of {model.cfg.name}"]


@pytest.mark.parametrize("placement", ["plain", "mesh"], indirect=True)
def test_fake_card_restored_trees_reuse_the_capture(fake_card, placement):
    """Trees of the same shapes at other addresses are copied into the
    graph's buffers once, the graph's buffers come back, and the result is
    the eager step's from those trees; another batch shape is another key,
    warmed up, then captured."""
    model, opt = _model("gemma2_2b"), _opt()
    where = _Plain() if placement == "plain" else _Mesh(model, opt)
    init = model.init(torch.Generator().manual_seed(0))
    params, state = where.trees(init, opt)
    batches = [where.batch(b) for b in _host_batches("gemma2_2b", 4)]
    step = where.wrap(make_lm_train_step(model, opt, loss_chunk=CHUNK, donate=True))
    params, state = check_donated(step, params, state, batches, fake_card)
    buffers = _buffers((params, state))

    restored = where.trees(init, opt)  # the checkpoint: step 0's values at new addresses
    want = _eager_run(step, *restored, batches[3:4])[0]
    n_trees = len(_buffers(restored))
    with HostCopies() as copies:
        params, state, m = step(*restored, batches[3])
    assert copies.rows == {"copy_": n_trees + len(tree_leaves(batches[3])), "clone": len(tree_leaves(m))}
    assert _buffers((params, state)) == buffers
    _same(_values((params, state, m)), want)
    with HostCopies() as copies:  # passed back: the batch alone is copied
        step(params, state, batches[0])
    assert copies.rows == {"copy_": len(tree_leaves(batches[0])), "clone": len(tree_leaves(m))}
    assert len(fake_card) == 1 and [g.replays for g in step.graphs.values()] == [STEPS + 1]

    short = {k: v[:, : S // 2] for k, v in _host_batches("gemma2_2b", 1)[0].items()}
    for _ in range(3):
        params, state, _ = step(params, state, where.batch(short))
    assert len(fake_card) == 2 and sorted(g.replays for g in step.graphs.values()) == [2, STEPS + 1]


# ---- CPU, no stand-in -------------------------------------------------------


@pytest.mark.parametrize("placement", ["plain", "mesh"], indirect=True)
def test_cpu_step_is_the_eager_step_and_captures_nothing(placement):
    model, opt = _model("hymba_1_5b"), _opt()
    where = _Plain() if placement == "plain" else _Mesh(model, opt)
    params, state = where.trees(model.init(torch.Generator().manual_seed(0)), opt)
    batches = [where.batch(b) for b in _host_batches("hymba_1_5b", STEPS)]
    step = where.wrap(make_lm_train_step(model, opt, n_micro=2, loss_chunk=CHUNK, donate=True))
    want = _eager_run(step, params, state, batches)
    written = [_local(t).data_ptr() for t in tree_leaves((params, state)) if not _is_count(t)]
    for k, b in enumerate(batches):
        params, state, m = step(params, state, b)  # update_ replaces the count, as before any capture
        assert [_local(t).data_ptr() for t in tree_leaves((params, state)) if not _is_count(t)] == written
        _same(_values((params, state, m)), want[k])
    assert step.graphs == {} and int(_local(state["step"])) == STEPS


# ---- CPU, against JAX ---------------------------------------------------------


def test_fake_card_steps_match_the_jitted_donating_jax_step(fake_card):
    """Two captured steps of the smoke gemma2-2b (the key warmed up on a
    copy of the trees first) against ``jax.jit(make_lm_train_step(...),
    donate_argnums=(0, 1))`` from the same parameters on the same batches,
    at ``test_torch_lm_train.py``'s pins: loss, ce and aux rtol 1e-5 (atol
    1e-7), the gradient norm rtol 1e-4, every parameter atol 2e-5 (AdamW
    1e-3 with eps 1e-6, its STEP_EPS); counts and rates equal."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro import configs as jconfigs
    from repro.train import optimizer as jopt
    from repro.train import steps as jsteps

    tm = _model("gemma2_2b")
    jcfg = dataclasses.replace(jconfigs.get_arch("gemma2_2b").smoke, act_dtype=jnp.float32)
    jm = jconfigs.build_model(jcfg)
    jp = tree_map(lambda t: t.numpy(), tm.init(torch.Generator().manual_seed(0)))
    host = _host_batches("gemma2_2b", 2, seed=5)
    jo, to = jopt.AdamW(lr=1e-3, eps=1e-6), AdamW(lr=1e-3, eps=1e-6)
    jstep = jax.jit(jsteps.make_lm_train_step(jm, jo, loss_chunk=CHUNK), donate_argnums=(0, 1))
    tstep = make_lm_train_step(tm, to, loss_chunk=CHUNK, donate=True)

    scratch = from_jax(jp)
    tstep(scratch, to.init(scratch), {k: torch.from_numpy(v) for k, v in host[0].items()})  # the warm-up
    pt = from_jax(jp)
    st = to.init(pt)
    pj = jax.tree.map(jnp.asarray, jp)
    sj = jo.init(pj)
    for k, b in enumerate(host, start=1):
        pt, st, mt = tstep(pt, st, {n: torch.from_numpy(v) for n, v in b.items()})
        pj, sj, mj = jstep(pj, sj, {n: jnp.asarray(v) for n, v in b.items()})
        for name in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(mt[name]), float(mj[name]), rtol=1e-5, atol=1e-7, err_msg=f"{k} {name}")
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4)
        assert float(mt["lr"]) == float(mj["lr"]) and int(st["step"]) == int(sj["step"]) == k
        got, want = tree_leaves(pt), jax.tree.leaves(pj)
        assert len(got) == len(want)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w, np.float32), atol=2e-5, err_msg=f"step {k}")
    assert len(fake_card) == 1 and [g.replays for g in tstep.graphs.values()] == [2]


# ---- on the card --------------------------------------------------------------


def _card_where(placement, model, opt, dev):
    return _Plain(dev) if placement == "plain" else _Mesh(model, opt, dev)


CARD_CASES = [(arch, "plain", 2) for arch in ARCHS] + [("gemma2_2b", "plain", 1), ("gemma2_2b", "mesh", 1),
                                                       ("gemma2_2b", "mesh", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,placement,n_micro", CARD_CASES, ids=[f"{a}-{p}-{n}" for a, p, n in CARD_CASES],
                         indirect=["placement"])
def test_card_step_equals_eager(card, arch, placement, n_micro):
    """Every family's step is capturable (no host copy or sync inside it)
    and bit-equal to its eager ops. MoE's combine is an ``index_add`` of
    ``top_k`` = 2 terms a token into zeros, the same sum in either order."""
    model, opt = _model(arch), _opt()
    where = _card_where(placement, model, opt, card)
    params, state = where.trees(model.init(torch.Generator().manual_seed(0)), opt)
    batches = [where.batch(b) for b in _host_batches(arch, STEPS)]
    step = where.wrap(make_lm_train_step(model, opt, n_micro=n_micro, loss_chunk=CHUNK, donate=True))
    check_donated(step, params, state, batches)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["plain", "mesh"], indirect=True)
def test_card_four_captured_steps_with_a_warmup_cosine_rate_equal_eager(card, placement):
    """The key warmed up on a copy of the trees, then 4 steps from them,
    each a replay: a count or rate baked into the graph at its capture
    would repeat step 1's bias corrections and rate at every replay."""
    model, opt = _model("gemma2_2b"), _opt()
    where = _card_where(placement, model, opt, card)
    init = model.init(torch.Generator().manual_seed(0))
    batches = [where.batch(b) for b in _host_batches("gemma2_2b", 4)]
    step = where.wrap(make_lm_train_step(model, opt, loss_chunk=CHUNK, donate=True))
    step(*where.trees(init, opt), batches[0])
    params, state = where.trees(init, opt)
    want = _eager_run(step, params, state, batches)
    for k, b in enumerate(batches):
        params, state, m = step(params, state, b)
        _same(_values((params, state, m)), want[k])
    lrs = [float(w[-1]) for w in want]  # "lr", the last metric in tree order
    assert len(set(lrs)) == 4 and int(_local(state["step"])) == 4
    assert [g.replays for g in step.graphs.values()] == [4]


@pytest.mark.cuda
def test_card_capture_with_a_host_sync_raises_naming_the_model(card, monkeypatch):
    real = tsteps.chunked_cross_entropy

    def syncing(*args, **kw):
        loss = real(*args, **kw)
        if loss.item() < -1:  # a branch on a tensor value
            loss = loss + 0
        return loss

    monkeypatch.setattr(tsteps, "chunked_cross_entropy", syncing)
    model, opt = _model("gemma2_2b"), _opt()
    where = _Plain(card)
    params, state = where.trees(model.init(torch.Generator().manual_seed(0)), opt)
    batches = [where.batch(b) for b in _host_batches("gemma2_2b", 2)]
    step = make_lm_train_step(model, opt, loss_chunk=CHUNK, donate=True)
    params, state, _ = step(params, state, batches[0])  # the warm-up runs eagerly
    with pytest.raises(RuntimeError, match=rf"CUDA-graph capture of the train step of {model.cfg.name} failed"):
        step(params, state, batches[1])
    assert step.graphs == {}
