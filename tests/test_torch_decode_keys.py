"""The captured LM decode step keyed as ``jax.jit`` caches the JAX step
(``make_lm_decode_step``): a graph per signature and set of buffers, not per
params container; one warm-up per signature; each graph dropped with the
buffers it reads; the mesh step captured too.

On the CPU the shared stand-in of ``test_torch_train_graph.py``
(``fake_card``) drives the key, warm-up and eviction logic. For gemma2-2b,
Hymba-1.5B and mamba2-2.7b at their smoke configs (f32; caches filled from a
numpy seed), on plain tensors and on a one-rank gloo mesh (DTensors placed
by ``dist``, the position a replicated DTensor, as the dry run's decode
cell passes it), one sequence of calls: request A on fresh caches, request
B on other fresh caches, A's caches deleted, B continued with the params in
a container rebuilt over the same leaves, then with the final norm's scale
replaced in its dict by a leaf of other values (the old one collected).
Held: every logit and cache leaf bit-equal to the port's eager step
(``model.decode_step``) along the same calls, and within
``test_torch_decode_position.py``'s pins (logits 1e-4, cache leaves 1e-5)
of ``jax.jit(model.decode_step)`` fed the same params (numpy) and the same
replacement; captures 1 after A, 2 after B, none for the new container, a
third for the replaced leaf; one warm-up in all (a call of
``model.decode_step`` outside a capture and a replay: the scratch run on
plain tensors, the first call itself on the mesh); ``step.graphs`` 2 after
B, 1 once A's caches are collected, 0 once the replaced leaf is; no op of
B's first call (its capture, outside the stand-in's run) makes a tensor of
a cache leaf's size, where A's warm-up makes its scratch caches. Also: no
captured graph keeps the caller's params or caches alive, and its
finalizers are detached when it is dropped; another batch is another
signature, warmed up once more; without the stand-in (CPU, mesh, ``meta``)
the step is the model's and captures nothing.

The ``cuda`` cases run on real graphs (TF32 off): three fresh-cache
requests of gemma2-2b and Hymba, tokens bit-equal to the eager step's, one
warm-up, and ``torch.cuda.memory_allocated()`` back to its level after
each (the first request may keep the side stream's library workspaces, at
most 64 MiB); a replaced leaf's logits within 1e-6 of eager; the step on a
one-rank NCCL mesh bit-equal to the eager mesh step, captured once and
replayed every token after the warm-up; a host sync planted in the mesh
step making its capture raise, naming the model. Every run uses one
intra-op thread.
"""
import contextlib
import dataclasses
import functools
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves as flat  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import make_lm_decode_step  # noqa: E402
from test_torch_train_graph import HostCopies, _one_thread, fake_card  # noqa: E402,F401

ARCHS = ("gemma2_2b", "hymba_1_5b", "mamba2_2_7b")
B, LEN, K = 2, 8, 4  # batch, cache slots, calls of request A (request B: K + 4)


def _model(arch, act_dtype=torch.float32):
    return configs.build_model(dataclasses.replace(configs.get_arch(arch).smoke, act_dtype=act_dtype))


@functools.lru_cache(maxsize=None)
def _host(arch):
    """numpy inputs: the params (the port's init, seed 0), caches A and B,
    the tokens of A and B, and the final norm's replacement scale."""
    model = _model(arch)
    params = tree_map(lambda t: t.numpy(), model.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(8)
    shapes = model.init_caches(B, LEN, dtype=torch.float32)
    caches = [tree_map(lambda c: rng.standard_normal(tuple(c.shape)).astype(np.float32), shapes) for _ in "AB"]
    toks = [rng.integers(0, model.cfg.vocab, (n, B, 1)).astype(np.int32) for n in (K, K + 4)]
    scale = params["final_norm"]["scale"]
    new_scale = (1.0 + 0.5 * rng.standard_normal(scale.shape)).astype(scale.dtype)
    return params, caches, toks, new_scale


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _placed(t):
    return (t.device_mesh, tuple(t.placements)) if hasattr(t, "placements") else None


def _storage(x):
    """The address of a tensor's storage (a DTensor's local one)."""
    return getattr(x, "_local_tensor", x).untyped_storage().data_ptr()


def _values(tree):
    return [_local(t).clone() for t in tree_leaves(tree)]


def _bit_equal(got, want):
    return len(got) == len(want) and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


class _Plain:
    """Trees as plain tensors on ``device``; request B passes ``t`` as a
    0-d int32 tensor (the signature of an int)."""

    def __init__(self, model, device="cpu"):
        self.device = device

    def params(self, tree):
        return tree_map(lambda t: t.to(self.device), tree)

    caches = params

    def scale(self, x):
        """A new final-norm scale, placed as the params' own."""
        return x.to(self.device)

    def token(self, x):
        return x.to(self.device)

    def position(self, t, request):
        return t if request == "A" else torch.tensor(t, dtype=torch.int32, device=self.device)

    def ops(self):
        return contextlib.nullcontext()


class _Mesh(_Plain):
    """Trees as DTensors on a one-rank mesh (gloo on the CPU, NCCL on the
    card), placed as the dry run's decode cell places them; the position a
    replicated int32 DTensor."""

    def __init__(self, model, device="cpu"):
        from repro_torch.dist import NamedSharding, PartitionSpec, batch_sharding, default_rules
        from repro_torch.launch.mesh import make_host_mesh

        super().__init__(model, device)
        self.model = model
        self.mesh = make_host_mesh(1, device=device)
        self.rules = default_rules(False, self.mesh.mesh_dim_names)
        self.bsh, self.rep = batch_sharding(self.mesh, B, self.rules), NamedSharding(self.mesh, PartitionSpec())

    def params(self, tree):
        from repro_torch.dist import device_put, tree_shardings_shaped

        self.psh = tree_shardings_shaped(self.mesh, self.model.axes(), tree, self.rules)
        return device_put(tree, self.psh)

    def scale(self, x):
        from repro_torch.dist import device_put

        return device_put(x, self.psh["final_norm"]["scale"])

    def caches(self, tree):
        from repro_torch.dist import cache_shardings, device_put

        return device_put(tree, cache_shardings(self.mesh, tree, self.rules))

    def token(self, x):
        from repro_torch.dist import device_put

        return device_put(x, self.bsh)

    def position(self, t, request):
        from repro_torch.dist import device_put

        return device_put(torch.tensor(t, dtype=torch.int32), self.rep)

    def ops(self):
        from repro_torch.dist import mesh_ops

        return mesh_ops()


@pytest.fixture
def group():
    """Destroys the world-1 process group a mesh test made."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


class _Watch(TorchDispatchMode):
    """Counts, for calls made under ``watching()``, the model's
    ``decode_step`` calls outside a capture (``capturing``) and a stand-in
    replay (the warm-ups), and, while entered as a dispatch mode, the ops
    outside those that output a new tensor with as many elements as a
    cache leaf (``hits``)."""

    capturing = False

    def __init__(self, monkeypatch, model, numels=()):
        super().__init__()
        self.warm_ups, self.active, self.numels, self.hits = 0, False, set(numels), []
        cls, inner = type(model), type(model).decode_step
        capture = pipeline.capture_graph

        def counted(m, *args):
            if self.active and not _Watch.capturing and not HostCopies.replaying:
                self.warm_ups += 1
            return inner(m, *args)

        def flagged(*args, **kw):
            _Watch.capturing = True
            try:
                return capture(*args, **kw)
            finally:
                _Watch.capturing = False

        monkeypatch.setattr(cls, "decode_step", counted)
        monkeypatch.setattr(pipeline, "capture_graph", flagged)

    @contextlib.contextmanager
    def watching(self):
        self.active = True
        try:
            yield
        finally:
            self.active = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _Watch.capturing or HostCopies.replaying:
            return out
        inputs = {_storage(x) for x in flat((args, kwargs)) if isinstance(x, torch.Tensor)}
        for o in flat(out):
            if isinstance(o, torch.Tensor) and o.numel() in self.numels and _storage(o) not in inputs:
                self.hits.append(f"{func} -> {tuple(o.shape)}")
        return out


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The sequence through ``jax.jit(model.decode_step)``: A's logits and
    final caches, B's logits and final caches (numpy)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro import configs as jconfigs

    jm = jconfigs.build_model(dataclasses.replace(jconfigs.get_arch(arch).smoke, act_dtype=jnp.float32))
    jdecode = jax.jit(jm.decode_step)
    params, caches, toks, new_scale = _host(arch)
    out = []
    for r, (start, tok) in enumerate(zip(caches, toks)):
        jc, logits, p = tree_map(jnp.asarray, start), [], params
        for t in range(len(tok)):
            if r == 1 and t == K + 2:
                p = {**params, "final_norm": {**params["final_norm"], "scale": new_scale}}
            lg, jc = jdecode(p, jnp.asarray(tok[t]), jc, jnp.asarray(t, jnp.int32))
            logits.append(np.asarray(lg))
        out.append((logits, [np.asarray(c, np.float32) for c in jax.tree.leaves(jc)]))
    return out


@pytest.mark.parametrize("placement", ["plain", "mesh"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fake_card_requests_keys_and_drops_match_eager_and_jax(fake_card, monkeypatch, group, arch, placement):
    model = _model(arch)
    where = (_Plain if placement == "plain" else _Mesh)(model)
    host_params, host_caches, toks, new_scale = _host(arch)
    watch = _Watch(monkeypatch, model, {int(np.prod(c.shape)) for c in tree_leaves(host_caches[0])})
    step = make_lm_decode_step(model)
    params = where.params(_torch(host_params))
    got, want = {"A": [], "B": []}, {"A": [], "B": []}

    def call(request, caches, eager_caches, t, sizes=False):
        token = where.token(torch.from_numpy(toks[request == "B"][t]))
        with watch.watching(), watch if sizes else contextlib.nullcontext():
            logits, out = step(params, token, caches, where.position(t, request))
        with torch.no_grad(), where.ops():
            e_logits, e_out = model.decode_step(params, token, eager_caches, where.position(t, request))
        assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(caches))), "not the caller's caches"
        assert _placed(logits) == _placed(e_logits)
        got[request].append(_local(logits).clone())
        want[request].append(_local(e_logits).clone())

    caches_a, eager_a = (where.caches(_torch(host_caches[0])) for _ in range(2))
    call("A", caches_a, eager_a, 0, sizes=True)
    if placement == "plain":  # the warm-up's scratch caches: what the watch is for
        assert watch.hits, "the warm-up made no scratch caches"
    for t in range(1, K):
        call("A", caches_a, eager_a, t)
    assert len(fake_card) == 1 and watch.warm_ups == 1 and len(step.graphs) == 1
    assert _bit_equal(_values(caches_a), _values(eager_a))
    jax_a, jax_b = _jax_run(arch)
    a_values = _values(caches_a)

    caches_b, eager_b = (where.caches(_torch(host_caches[1])) for _ in range(2))
    watch.hits.clear()
    call("B", caches_b, eager_b, 0, sizes=True)
    assert not watch.hits, f"B's capture made tensors of a cache leaf's size: {watch.hits}"
    for t in range(1, K):
        call("B", caches_b, eager_b, t)
    assert len(fake_card) == 2 and watch.warm_ups == 1 and len(step.graphs) == 2

    del caches_a, eager_a
    gc.collect()
    assert len(step.graphs) == 1, "A's graph outlived A's caches"

    params = tree_map(lambda x: x, params)  # a new container over the same leaves
    for t in (K, K + 1):
        call("B", caches_b, eager_b, t)
    assert len(fake_card) == 2, "a new params container was captured again"

    params["final_norm"]["scale"] = where.scale(torch.from_numpy(new_scale.copy()))
    gc.collect()
    assert len(step.graphs) == 0, "the graph outlived the params leaf it read"
    for t in (K + 2, K + 3):
        call("B", caches_b, eager_b, t)
    assert len(fake_card) == 3 and watch.warm_ups == 1 and len(step.graphs) == 1
    assert fake_card == [f"the decode step of {model.cfg.name}"] * 3

    for request in "AB":
        assert _bit_equal(got[request], want[request]), f"request {request}: the logits differ from the eager step's"
    assert _bit_equal(_values(caches_b), _values(eager_b))
    for request, (j_logits, j_caches), values in (("A", jax_a, a_values), ("B", jax_b, _values(caches_b))):
        for t, (a, b) in enumerate(zip(got[request], j_logits, strict=True)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, err_msg=f"request {request} call {t}")
        for a, b in zip(values, j_caches, strict=True):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=f"request {request} caches")


@pytest.mark.parametrize("placement", ["plain", "mesh"])
def test_fake_card_graph_keeps_no_leaf_alive(fake_card, group, placement):
    """The captured graph holds no caller's params or cache leaf: with
    them gone the graph is dropped, its finalizers detached."""
    model = _model("gemma2_2b")
    where = (_Plain if placement == "plain" else _Mesh)(model)
    host_params, host_caches, toks, _ = _host("gemma2_2b")
    step = make_lm_decode_step(model)
    params, caches = where.params(_torch(host_params)), where.caches(_torch(host_caches[0]))
    for t in range(2):  # on the mesh the first call is the warm-up
        step(params, where.token(torch.from_numpy(toks[0][t])), caches, where.position(t, "B"))
    assert len(fake_card) == 1 and len(step.graphs) == 1
    g = next(iter(step.graphs.values()))
    assert g.params is None and len(g.finalizers) == len(tree_leaves((params, caches)))
    refs = [weakref.ref(a) for a in tree_leaves((params, caches))]
    del params, caches
    gc.collect()
    assert not [r for r in refs if r() is not None], "a graph keeps the caller's leaves alive"
    assert step.graphs == {} and not any(f.alive for f in g.finalizers)
    assert step.captures == 1 and len(step.warmed) == 1


def test_fake_card_one_warm_up_per_signature(fake_card, monkeypatch):
    """Requests on fresh caches of one shape warm up once; another batch is
    another signature, warmed up once more; each cache set is captured."""
    model = _model("gemma2_2b")
    watch = _Watch(monkeypatch, model)
    host_params, _, toks, _ = _host("gemma2_2b")
    params = _torch(host_params)
    step = make_lm_decode_step(model)
    live = []
    for batch in (B, B, 1, 1, B):
        caches = model.init_caches(batch, LEN, dtype=torch.float32)
        with watch.watching():
            for t in range(2):
                step(params, torch.from_numpy(toks[0][t][:batch]), caches, t)
        live.append(caches)
    assert watch.warm_ups == 2 and len(step.warmed) == 2
    assert len(fake_card) == step.captures == 5 and len(step.graphs) == 5 and step.replays == 10
    del live, caches
    gc.collect()
    assert step.graphs == {}


def test_fake_card_mesh_step_leaves_the_callers_mesh_ops_on(fake_card, group):
    """The step enters ``dist.mesh_ops`` on DTensors; under the caller's
    own it leaves the caller's implicit replication on, so the caller's
    eager mesh ops after it still join plain tensors to DTensors."""
    model = _model("gemma2_2b")
    where = _Mesh(model)
    host_params, host_caches, toks, _ = _host("gemma2_2b")
    params, caches = where.params(_torch(host_params)), where.caches(_torch(host_caches[0]))
    eager = where.caches(_torch(host_caches[0]))
    step = make_lm_decode_step(model)
    with torch.no_grad(), where.ops():
        for t in range(3):  # the warm-up, the capture, a replay
            token = where.token(torch.from_numpy(toks[0][t]))
            logits, caches = step(params, token, caches, t)
            want, eager = model.decode_step(params, token, eager, t)  # t an int: a plain tensor joins the DTensors
            assert torch.equal(_local(logits), _local(want))
    assert len(fake_card) == 1 and step.replays == 2


@pytest.mark.parametrize("placement", ["plain", "mesh", "meta"])
def test_without_the_stand_in_the_step_is_the_models(group, placement):
    """CPU tensors (the caller asked for the CPU), DTensors on the CPU and
    ``meta`` tensors (the dry run's cells) run ``model.decode_step`` as it
    is: the same values, nothing warmed or captured."""
    model = _model("hymba_1_5b")
    host_params, host_caches, toks, _ = _host("hymba_1_5b")
    where = _Mesh(model) if placement == "mesh" else _Plain(model, "meta" if placement == "meta" else "cpu")
    params = where.params(_torch(host_params))
    caches, eager = (where.caches(_torch(host_caches[0])) for _ in range(2))
    step = make_lm_decode_step(model)
    for t in range(3):
        token = where.token(torch.from_numpy(toks[0][t]))
        with where.ops():
            logits, caches = step(params, token, caches, where.position(t, "B"))
            with torch.no_grad():
                e_logits, eager = model.decode_step(params, token, eager, where.position(t, "B"))
        assert tuple(logits.shape) == tuple(e_logits.shape)
        if placement != "meta":
            assert torch.equal(_local(logits), _local(e_logits))
    if placement != "meta":
        assert _bit_equal(_values(caches), _values(eager))
    assert step.graphs == {} and step.warmed == set() and step.captures == 0


# ---- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _greedy(step, params, prompt, caches, put, n=12, ops=contextlib.nullcontext):
    """``n`` decode calls, the prompt first, then greedy tokens; the tokens
    generated (``put`` places a token)."""
    tok, outs = put(prompt[:, :1]), []
    for t in range(n):
        with ops():
            logits, caches = step(params, tok, caches, t)
            if t + 1 < prompt.shape[1]:
                tok = put(prompt[:, t + 1 : t + 2])
            else:
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                outs.append(_local(tok).clone())
    return torch.cat(outs, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("gemma2_2b", "hymba_1_5b"))
def test_card_fresh_cache_requests_warm_up_once_and_release_their_memory(arch):
    _card()
    model = _model(arch)
    params = tree_map(lambda t: t.to("cuda"), _torch(_host(arch)[0]))
    step = make_lm_decode_step(model)
    eager = torch.no_grad()(model.decode_step)
    rng = np.random.default_rng(9)
    levels = []
    for r in range(3):
        prompt = torch.from_numpy(rng.integers(0, model.cfg.vocab, (B, 4)).astype(np.int32)).cuda()
        want = _greedy(eager, params, prompt, model.init_caches(B, 16, dtype=torch.float32, device="cuda"),
                       lambda x: x)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        got = _greedy(step, params, prompt, model.init_caches(B, 16, dtype=torch.float32, device="cuda"),
                      lambda x: x)
        same = torch.equal(got, want)
        del got
        gc.collect()
        torch.cuda.synchronize()
        levels.append(torch.cuda.memory_allocated() - before)
        assert same, f"request {r}: the captured step's tokens differ from the eager step's"
        assert step.graphs == {}, f"request {r}: its graph outlived its caches"
    assert step.captures == 3 and len(step.warmed) == 1 and step.replays == 36
    assert levels[1] == levels[2] == 0 and 0 <= levels[0] <= 64 * 2**20, levels


@pytest.mark.cuda
def test_card_replaced_leaf_gets_a_graph_of_its_own():
    _card()
    model = _model("gemma2_2b")
    host_params, host_caches, toks, new_scale = _host("gemma2_2b")
    params = tree_map(lambda t: t.to("cuda"), _torch(host_params))
    caches, eager_caches = (tree_map(lambda t: t.to("cuda"), _torch(host_caches[1])) for _ in range(2))
    step = make_lm_decode_step(model)
    for t in range(len(toks[1])):
        if t == K + 2:
            params["final_norm"]["scale"] = torch.from_numpy(new_scale.copy()).cuda()
            gc.collect()
            assert step.graphs == {}
        token = torch.from_numpy(toks[1][t]).cuda()
        logits, caches = step(params, token, caches, t)
        with torch.no_grad():
            want, eager_caches = model.decode_step(params, token, eager_caches, t)
        torch.testing.assert_close(logits, want, atol=1e-6, rtol=0)
    assert step.captures == 2 and len(step.warmed) == 1 and len(step.graphs) == 1


@pytest.mark.cuda
def test_card_nccl_mesh_step_equals_the_eager_mesh_step(group):
    _card()
    model = _model("gemma2_2b")
    where = _Mesh(model, "cuda")
    params = where.params(tree_map(lambda t: t.to("cuda"), _torch(_host("gemma2_2b")[0])))
    prompt = torch.from_numpy(np.random.default_rng(10).integers(0, model.cfg.vocab, (B, 4)).astype(np.int32))

    def run(step):
        caches = where.caches(model.init_caches(B, 16, dtype=torch.float32, device="cuda"))
        return _greedy(step, params, prompt.cuda(), caches, where.token, ops=where.ops)

    want = run(torch.no_grad()(model.decode_step))
    step = make_lm_decode_step(model)
    got = run(step)
    assert torch.equal(got, want)
    assert step.captures == 1 and len(step.warmed) == 1 and step.replays == 11  # call 1: the warm-up
    again = run(step)  # fresh caches: captured at once, no warm-up
    assert torch.equal(again, want) and step.captures == 2 and step.replays == 23


@pytest.mark.cuda
def test_card_mesh_capture_with_a_host_sync_raises_naming_the_model(group, monkeypatch):
    _card()
    model = _model("gemma2_2b")
    cls = type(model)
    inner = cls.decode_step

    def syncing(self, p, token, caches, t):
        if _local(token).sum().item() < -1:  # a branch on a tensor value
            token = token + 0
        return inner(self, p, token, caches, t)

    monkeypatch.setattr(cls, "decode_step", syncing)
    where = _Mesh(model, "cuda")
    params = where.params(tree_map(lambda t: t.to("cuda"), _torch(_host("gemma2_2b")[0])))
    caches = where.caches(model.init_caches(B, 16, dtype=torch.float32, device="cuda"))
    token = where.token(torch.zeros((B, 1), dtype=torch.int32, device="cuda"))
    step = make_lm_decode_step(model)
    step(params, token, caches, 0)  # the warm-up runs eagerly
    with pytest.raises(RuntimeError, match=r"CUDA-graph capture of the decode step of gemma2.* failed"):
        step(params, token, caches, 1)
    assert step.graphs == {}
