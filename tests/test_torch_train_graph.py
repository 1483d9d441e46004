"""The captured Pix2Pix and YOLOv8 train steps (``make_pix2pix_train_step``,
``make_yolo_train_step``): on the card each step is captured into one CUDA
graph per key and replayed at every call, as the JAX callers' ``jax.jit``
compiles the JAX steps (donating nothing).

On the CPU a stand-in for ``core.pipeline.capture_graph`` drives the capture
logic (``fake_card``, shared with ``test_torch_lm_train_graph.py``): its
"graph" reruns the captured function on the same input buffers and writes
into the same output buffers, as a replay does, and its capture leaves the
tensors the function wrote and the registered generators as it found them,
as a capture does.
Held here, for Pix2Pix (img 32, base 8, padded and cropping, with the
dropout generator and without it) and YOLOv8n (img 64) over 3 steps with
each optimizer of ``test_torch_train.py`` (two of them with a
``warmup_cosine`` rate): every output is bit-equal to the eager step's
(``step.eager``: the same ops without the graph); the counts come back as
CPU int32 tensors holding the step's number and the rate is the step's
own; the caller's trees are left as they were; a tree returned at step 1
is unchanged after step 3; one capture per key, a new one for a new batch
shape or generator; and outside the stand-in's replays each call copies
every input leaf in once (a fill for each count) and clones every output
leaf out once, nothing else. On the CPU without the stand-in the step is
the eager step and captures nothing; 3 eager Adam and AdamW steps agree
with the ``jax.jit``'d JAX steps along the JAX trajectory within
``test_torch_train.py``'s pins (losses rtol 1e-5, gradients atol 1e-5 plus
1e-4 or 2e-4 of the leaf's largest, parameters atol 1e-5 plus 1e-4 of each
leaf's largest value plus what that gradient pin moves Adam's step by).
The ``cuda`` cases run the same
checks on real graphs with cuDNN deterministic and TF32 off, 4 captured
Adam steps with a ``warmup_cosine`` rate bit-equal to 4 eager ones, and a
host sync planted in the loss making the capture raise, naming the model.
Every run uses one intra-op thread.
"""
import math
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch.data as tdata  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.train as tt  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.nn.module import tree_def, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

COPY_OPS = ("copy_", "clone", "cat", "_to_copy")
STEPS = 3

# test_torch_train.py's OPTIMIZERS
OPTIMIZERS = {
    "adamw_clip_decay": lambda m: m.AdamW(lr=m.warmup_cosine(1e-2, 2, 10), weight_decay=0.01, grad_clip_norm=1.0),
    "adamw_master": lambda m: m.AdamW(lr=3e-3, grad_clip_norm=None, master_weights=True),
    "adam": lambda m: m.Adam(lr=2e-4, b1=0.5),
    "sgd": lambda m: m.SGD(lr=m.warmup_cosine(0.1, 1, 5), momentum=0.9),
}
SCHEDULED = ("adamw_clip_decay", "sgd")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HostCopies(TorchDispatchMode):
    """While entered, counts the host-issued ops that copy a tensor
    (``COPY_OPS``) by op name, but those of a stand-in graph's replay
    (``replaying``)."""

    replaying = False

    def __init__(self):
        super().__init__()
        self.rows = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if not HostCopies.replaying and name in COPY_OPS:
            self.rows[name] = self.rows.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


class FakeGraph:
    """A captured graph's stand-in: ``replay`` reruns the captured function
    on the same input buffers and writes its results into the same output
    buffers, outside the counting mode."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        HostCopies.replaying = True
        try:
            for o, n in zip(tree_leaves(self.out), tree_leaves(self.run())):
                if o is not n:
                    o.copy_(n)
        finally:
            HostCopies.replaying = False


class Untouched(TorchDispatchMode):
    """While entered, keeps a copy of each tensor an op writes (an argument
    its schema marks written) from before its first write; ``restore``
    writes the copies back, the latest first. So the ops run, yet leave
    what existed before them as a capture leaves it: a capture executes
    nothing."""

    def __init__(self):
        super().__init__()
        self.saved = {}  # id -> (tensor, its value before the first write); holding it keeps the id unique

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(a.name)
            for t in value if isinstance(value, (list, tuple)) else (value,):
                if isinstance(t, torch.Tensor) and id(t) not in self.saved:
                    self.saved[id(t)] = (t, t.clone())
        return func(*args, **kwargs)

    def restore(self):
        with torch.no_grad():
            for t, before in reversed(list(self.saved.values())):
                t.copy_(before)
        self.saved.clear()


@pytest.fixture
def fake_card(monkeypatch):
    """Steps on the CPU run as the stand-in graphs; yields the list of
    captures made, by what they name. The stand-in's capture runs the
    function once for its outputs and leaves every tensor it wrote, and
    the registered generators, as they were (``Untouched``)."""
    captures = []

    def capture_graph(stream, side, run, what, owner=None, generators=()):
        states = [g.get_state() for g in generators]
        with Untouched() as untouched:
            out = run()
        untouched.restore()
        for g, s in zip(generators, states):  # a capture draws nothing from them
            g.set_state(s)
        captures.append(what)
        return FakeGraph(run, out), out, weakref.WeakSet()

    monkeypatch.setattr(pipeline, "captures_on", lambda device: True)
    monkeypatch.setattr(pipeline, "capture_graph", capture_graph)
    yield captures


# ---- cases ------------------------------------------------------------------


def _on(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _pix2pix(mode, opt, device="cpu", batch=2):
    model = tm.Pix2Pix(tm.Pix2PixConfig(img_size=32, base=8, deconv_mode=mode))
    params = _on(model.init(torch.Generator().manual_seed(0)), device)
    state = {"g": opt.init(params["generator"]), "d": opt.init(params["discriminator"])}
    data = tdata.phantom_batches(batch, tdata.PhantomConfig(img_size=32), seed=0)
    batches = [_on(tree_map(torch.from_numpy, next(data)), device) for _ in range(STEPS + 1)]
    return tt.make_pix2pix_train_step(model, opt, opt), params, state, batches


def _yolo(opt, device="cpu", batch=2):
    model = tm.YOLOv8(tm.YOLOv8Config(img_size=64))
    params = _on(model.init(torch.Generator().manual_seed(1)), device)
    data = tdata.detection_batches(batch, tdata.PhantomConfig(img_size=64, lesion_p=1.0), seed=2)
    batches = [_on(tree_map(torch.from_numpy, next(data)), device) for _ in range(STEPS + 1)]
    return tt.make_yolo_train_step(model, opt), params, opt.init(params), batches


def _same(got, want):
    assert tree_def(got) == tree_def(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def _counts(state):
    return [x for x in tree_leaves(state) if x.ndim == 0 and not x.dtype.is_floating_point]


def _run(step, params, state, batches, seed, steps=STEPS):
    """``steps`` calls from (params, state), the dropout generator seeded
    ``seed`` (None: no dropout); each call's outputs."""
    generator = None if seed is None else torch.Generator(tree_leaves(batches[0])[0].device).manual_seed(seed)
    outs = []
    for b in batches[:steps]:
        params, state, metrics = step(params, state, b, *(() if generator is None else (generator,)))
        outs.append((params, state, metrics))
    return outs, generator


def check_captured(step, params, state, batches, seed, captures=None):
    """The captured step against ``step.eager`` over ``STEPS`` calls: the
    checks this file's docstring lists. ``captures``: the stand-in's list
    (None on the card)."""
    want, want_gen = _run(step.eager, params, state, batches, seed)
    generator = None if seed is None else torch.Generator(tree_leaves(batches[0])[0].device).manual_seed(seed)
    n_in = len(tree_leaves((params, state, batches[0])))
    got, first = [], None
    for k, b in enumerate(batches[:STEPS], start=1):
        given = (params, state, b)
        ids, values = [id(x) for x in tree_leaves(given)], tree_map(torch.clone, given)
        with HostCopies() as copies:
            out = step(*given, *(() if generator is None else (generator,)))
        # the caller's trees are left as they were, leaf for leaf
        assert [id(x) for x in tree_leaves(given)] == ids
        _same(given, values)
        n_counts = len(_counts(state))
        if k > 1:  # the first call also captures
            assert copies.rows == {"copy_": n_in - n_counts, "clone": len(tree_leaves(out)) - n_counts}, copies.rows
        params, state, metrics = out
        for c in _counts(state):
            assert c.device.type == "cpu" and c.dtype == torch.int32 and int(c) == k
        if k == 1:
            first = (out, tree_map(torch.clone, out))
        got.append(out)
    for g, w in zip(got, want):
        _same(g, w)
    _same(first[0], first[1])  # a tree returned at step 1 is unchanged after step 3
    if generator is not None:  # the capture drew nothing from the caller's generator
        assert torch.equal(generator.get_state(), want_gen.get_state())
    lrs = [float(m["lr"]) for _, _, m in got if "lr" in m]
    assert len(step.graphs) == 1 and next(iter(step.graphs.values())).replays == STEPS
    if captures is not None:
        assert len(captures) == 1 and captures[0].startswith("the train step of ")
    return got, lrs


# ---- CPU, through the stand-in ------------------------------------------------


@pytest.mark.parametrize("dropout", [None, 7], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("mode", ["padded", "cropping"])
def test_fake_card_pix2pix_step_equals_eager(fake_card, mode, opt, dropout):
    step, params, state, batches = _pix2pix(mode, OPTIMIZERS[opt](tt))
    check_captured(step, params, state, batches, dropout, fake_card)
    assert fake_card == ["the train step of pix2pix"]


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_fake_card_yolo_step_equals_eager(fake_card, opt):
    step, params, state, batches = _yolo(OPTIMIZERS[opt](tt))
    _, lrs = check_captured(step, params, state, batches, None, fake_card)
    assert fake_card == ["the train step of yolov8n"]
    sched = OPTIMIZERS[opt](tt).lr
    want = [float(sched(torch.tensor(k, dtype=torch.int32))) if callable(sched) else sched for k in (1, 2, 3)]
    assert lrs == [pytest.approx(w, rel=1e-6) for w in want]
    if opt in SCHEDULED:
        assert len(set(lrs)) == STEPS  # each step's own rate, not the capture's


def test_fake_card_captures_once_per_key(fake_card):
    step, params, state, batches = _pix2pix("padded", OPTIMIZERS["adam"](tt))
    gen = torch.Generator().manual_seed(0)
    out = step(params, state, batches[0], gen)
    step(*out[:2], batches[1], gen.manual_seed(1))  # the same generator, reseeded: the same key
    assert len(fake_card) == 1
    step(params, state, batches[0], torch.Generator().manual_seed(0))  # another generator
    step(params, state, batches[0])  # no dropout
    assert len(fake_card) == 3
    one = _on(tree_map(torch.from_numpy, next(tdata.phantom_batches(1, tdata.PhantomConfig(img_size=32), seed=3))),
              "cpu")
    step(params, state, one)  # another batch shape
    step(params, state, one)
    assert len(fake_card) == 4 and sorted(g.replays for g in step.graphs.values()) == [1, 1, 2, 2]

    ystep, yparams, ystate, ybatches = _yolo(OPTIMIZERS["sgd"](tt))
    ystep(yparams, ystate, ybatches[0])
    ystep(yparams, ystate, ybatches[1])
    ystep(yparams, ystate, tree_map(lambda t: t[:1], ybatches[0]))
    assert fake_card[4:] == ["the train step of yolov8n"] * 2 and len(ystep.graphs) == 2


# ---- CPU, no stand-in -------------------------------------------------------


@pytest.mark.parametrize("model", ["pix2pix", "yolov8n"])
def test_cpu_step_is_the_eager_step_and_captures_nothing(model):
    opt = OPTIMIZERS["adamw_clip_decay"](tt)
    step, params, state, batches = _pix2pix("padded", opt) if model == "pix2pix" else _yolo(opt)
    seed = 3 if model == "pix2pix" else None
    got, _ = _run(step, params, state, batches, seed)
    want, _ = _run(step.eager, params, state, batches, seed)
    for g, w in zip(got, want):
        _same(g, w)
    assert step.graphs == {} and all(int(c) == STEPS for c in _counts(got[-1][1]))


# ---- CPU, against JAX ---------------------------------------------------------


def _jax_params(jax, module, seed):
    """numpy-drawn values in the JAX tree layout (``test_torch_train.py``'s)."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) > 1:
            return np.asarray(rs.randn(*s.shape) / np.sqrt(math.prod(s.shape[:-1])), s.dtype)
        base = 1.0 if ("scale" in name or "moving_var" in name) else 0.0
        return np.asarray(base + 0.1 * rs.randn(*s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(draw, module.abstract())


GRAD_SHARE = {"pix2pix": 1e-4, "yolov8n": 2e-4}  # test_torch_train.py's gradient pins


def _adam_slack(jo, k, g, gtol, m, v, step_max):
    """How far a gradient within ``gtol`` of ``g`` can move Adam's step
    ``lr * m_hat / (sqrt(v_hat) + eps)`` at count ``k`` (first order, from
    the new moments ``m`` and ``v``), at most twice the leaf's largest step:
    the step is scale-free in the gradient, so where the gradient is at the
    frameworks' rounding it may go either way by up to ``lr``."""
    lr = float(jo._lr(np.int32(k)))
    bc1, bc2 = 1.0 - jo.b1**k, 1.0 - jo.b2**k
    root = np.sqrt(v / bc2)
    d_m = (1 - jo.b1) / bc1 * gtol / (root + jo.eps)
    num = np.abs(m / bc1) * (1 - jo.b2) / bc2 * (2 * np.abs(g) + gtol) * gtol
    d_v = np.divide(num, 2 * root * (root + jo.eps) ** 2, out=np.full_like(num, np.inf), where=root > 0)
    return np.minimum(lr * (d_m + d_v), 2 * step_max)


@pytest.mark.parametrize("opt", ["adam", "adamw_clip_decay"])
@pytest.mark.parametrize("model", ["pix2pix", "yolov8n"])
def test_eager_steps_match_jitted_jax_steps_along_jaxs_trajectory(model, opt):
    """3 Adam or AdamW steps, each taken by both from the JAX step's
    params and state (a trajectory of its own drifts apart: from step 2
    YOLOv8n's losses differ by 1e-4, and at the ``warmup_cosine`` rate of
    1e-2 by 1% at step 3). Each step: losses rtol 1e-5; its gradients,
    recovered from each side's first moment ``(m - b1 m_prev) / (1 - b1)``,
    within ``test_torch_train.py``'s gradient pins; parameters within atol
    1e-5 plus 1e-4 of each leaf's largest value plus what a gradient within
    that pin moves Adam's step by (``_adam_slack``); counts and rates
    equal."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import repro.data as jdata
    import repro.models as jm
    import repro.train.optimizer as jopt
    import repro.train.steps as jsteps
    from repro_torch.nn import from_jax

    jo, to = OPTIMIZERS[opt](jopt), OPTIMIZERS[opt](tt)
    if model == "pix2pix":
        kw = dict(img_size=32, base=8, deconv_mode="padded")
        jmod, tmod = jm.Pix2Pix(jm.Pix2PixConfig(**kw)), tm.Pix2Pix(tm.Pix2PixConfig(**kw))
        data = jdata.phantom_batches(2, jdata.PhantomConfig(img_size=32), seed=0)
        jfn = jax.jit(jsteps.make_pix2pix_train_step(jmod, jo, jo))
        jstep = lambda p, s, b: jfn(p, s, b, None)  # noqa: E731
        tstep = tt.make_pix2pix_train_step(tmod, to, to)
        init = lambda o, p: {"g": o.init(p["generator"]), "d": o.init(p["discriminator"])}  # noqa: E731
        moments = lambda s, name: [x for k in ("d", "g") for x in tree_leaves(s[k][name])]  # noqa: E731
    else:
        jmod, tmod = jm.YOLOv8(jm.YOLOv8Config(img_size=64)), tm.YOLOv8(tm.YOLOv8Config(img_size=64))
        data = jdata.detection_batches(2, jdata.PhantomConfig(img_size=64, lesion_p=1.0), seed=2)
        jstep = jax.jit(jsteps.make_yolo_train_step(jmod, jo))
        tstep = tt.make_yolo_train_step(tmod, to)
        init = lambda o, p: o.init(p)  # noqa: E731
        moments = lambda s, name: tree_leaves(s[name])  # noqa: E731
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    pj = jax.tree.map(jnp.asarray, _jax_params(jax, jmod, seed=4))
    sj = init(jo, pj)
    for k in range(1, STEPS + 1):
        b = next(data)
        p_prev, s_prev = as_np(pj), as_np(sj)
        pt, st, mt = tstep(from_jax(p_prev), from_jax(s_prev), from_jax(b))
        pj, sj, mj = jstep(pj, sj, jax.tree.map(jnp.asarray, b))
        for name in ("g_loss", "d_loss", "loss"):
            if name in mj:
                np.testing.assert_allclose(float(mt[name]), float(mj[name]), rtol=1e-5, err_msg=f"step {k} {name}")
        if "lr" in mj:
            assert float(mt["lr"]) == float(mj["lr"])
        m0, mj_, vj = moments(s_prev, "m"), moments(as_np(sj), "m"), moments(as_np(sj), "v")
        leaves = zip(tree_leaves(pt), jax.tree.leaves(as_np(pj)), jax.tree.leaves(p_prev), moments(st, "m"), mj_,
                     vj, m0)
        for i, (a, w, w0, m_t, m_j, v_j, m_0) in enumerate(leaves):
            g_t, g_j = ((np.asarray(x) - jo.b1 * m_0) / (1 - jo.b1) for x in (m_t.numpy(), m_j))
            gtol = 1e-5 + GRAD_SHARE[model] * float(np.abs(g_j).max())
            np.testing.assert_allclose(g_t, g_j, atol=gtol, rtol=0, err_msg=f"step {k} gradient of leaf {i}")
            slack = _adam_slack(jo, k, g_j, gtol, m_j, v_j, float(np.abs(w - w0).max()))
            bad = np.abs(a.numpy() - w) > 1e-5 + 1e-4 * float(np.abs(w).max()) + slack
            assert not bad.any(), f"step {k} leaf {i}: {int(bad.sum())} of {w.size} parameters off"
        assert [int(c) for c in _counts(st)] == [k] * len(_counts(st))


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    """The card with the plain ops deterministic: cuDNN's deterministic
    algorithms and no TF32 (restored after the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pix2pix-padded-adam-dropout", "pix2pix-cropping-sgd", "yolov8n-adamw_clip_decay",
                                  "yolov8n-adamw_master"])
def test_card_step_equals_eager(card, case):
    model, *rest = case.split("-")
    if model == "pix2pix":
        mode, opt, *dropout = rest
        step, params, state, batches = _pix2pix(mode, OPTIMIZERS[opt](tt), card)
        seed = 5 if dropout else None
    else:
        step, params, state, batches = _yolo(OPTIMIZERS[rest[0]](tt), card)
        seed = None
    check_captured(step, params, state, batches, seed)


@pytest.mark.cuda
def test_card_four_adam_steps_with_a_warmup_cosine_rate_equal_eager(card):
    """A count or rate baked into the graph at its capture would repeat
    step 1's bias corrections and rate at every replay."""
    opt = tt.Adam(lr=tt.warmup_cosine(2e-3, 2, 6), b1=0.5)
    step, params, state, batches = _pix2pix("padded", opt, card)
    batches = batches + batches[:1]
    got, gen = _run(step, params, state, batches, 11, steps=4)
    want, want_gen = _run(step.eager, params, state, batches, 11, steps=4)
    for g, w in zip(got, want):
        _same(g, w)
    assert torch.equal(gen.get_state(), want_gen.get_state())
    assert [int(c) for c in _counts(got[-1][1])] == [4, 4]
    assert next(iter(step.graphs.values())).replays == 4 and len(step.graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["pix2pix", "yolov8n"])
def test_card_capture_with_a_host_sync_raises_naming_the_model(card, monkeypatch, model):
    name = "pix2pix_g_loss" if model == "pix2pix" else "yolo_loss"
    real = getattr(tsteps, name)

    def syncing(*args, **kw):
        loss, parts = real(*args, **kw)
        if loss.item() < -1:  # a branch on a tensor value
            loss = loss + 0
        return loss, parts

    monkeypatch.setattr(tsteps, name, syncing)
    opt = OPTIMIZERS["adam"](tt)
    step, params, state, batches = _pix2pix("padded", opt, card) if model == "pix2pix" else _yolo(opt, card)
    with pytest.raises(RuntimeError, match=rf"CUDA-graph capture of the train step of {model} failed"):
        step(params, state, batches[0])
