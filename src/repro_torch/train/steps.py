"""Train / eval step factories for the paper's two models.

The returned steps mirror the JAX package's pure functions: they take the
parameter and optimizer-state trees and return new ones. Gradients come
from ``torch.autograd.grad`` over the leaves of the trees being trained,
on leaf copies that require grad, so the caller's tensors are left as they
were. A leaf the loss does not reach (BatchNorm's ``moving_*`` statistics)
gets a zero gradient, as ``jax.grad`` gives it, so the global norm and the
optimizer state match the reference. Training runs the plain ops
(``impl``/``deconv_backend="xla"``): the kernels have no backward and
refuse to run under autograd. On the card the Pix2Pix and YOLOv8 train
steps are what the JAX callers' ``jax.jit`` compiles (donating nothing):
each is captured into one CUDA graph per key and replayed at every call
(``_captured_train_step``).

The LM entry points serve and train every LM family (``TransformerLM``,
``Mamba2LM``, ``HymbaLM``, ``WhisperModel``: each has the same method
names). ``make_lm_prefill``, ``make_lm_decode_step`` and
``greedy_generate`` run under ``torch.no_grad()`` where the parameters
are: on the card their prefills go through the LM kernels, and the decode
step, on plain tensors or DTensors, is captured into a CUDA graph per
signature and set of buffers and replayed for every token, as ``jax.jit``
caches it (``_DecodeStep``; ``greedy_generate`` calls the model's step
eagerly, as the JAX package's loop calls it un-jitted).
``make_lm_train_step`` differentiates the models, whose attention and SSD
modules then take the plain ops on both devices (``kernels.grad_route``).
With ``donate=True`` on the card it is what the JAX launcher's ``jax.jit``
with ``donate_argnums=(0, 1)`` compiles: one CUDA graph per key, replayed
at every call and written into the parameter and optimizer-state buffers
it was captured on (``_donated_train_step``), on plain tensors and on
DTensors alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from ..core import pipeline
from ..core.pipeline import CapturedGraph
from ..dist import mesh_ops
from ..nn.module import tree_def, tree_leaves, tree_map, tree_unflatten
from .losses import chunked_cross_entropy, pix2pix_d_loss, pix2pix_g_loss, yolo_loss


def _trainable(tree):
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def _grads(loss, tree):
    """d loss / d leaves of ``tree``, as a tree; unreached leaves get zeros."""
    leaves = tree_leaves(tree)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got)])


def make_pix2pix_train_step(model, g_opt, d_opt, lambda_l1: float = 100.0):
    """params = {"generator": ..., "discriminator": ...};
    opt_state = {"g": ..., "d": ...}; batch = {"src": CT, "dst": MRI} in [-1,1].

    ``step(params, opt_state, batch, generator=None)``: ``generator`` (a
    ``torch.Generator`` on the batch's device) draws the generator's
    dropout; None runs without dropout, as JAX's ``rng=None``. On the card
    the step is captured (``_captured_train_step``)."""

    def train_step(params, opt_state, batch, generator=None):
        src, dst = batch["src"], batch["dst"]
        g_params = _trainable(params["generator"])
        fake = model.generate({"generator": g_params}, src, generator=generator, train=True)
        d_fake = model.discriminate(params, src, fake)
        g_loss, g_parts = pix2pix_g_loss(d_fake, fake, dst, lambda_l1)
        g_grads = _grads(g_loss, g_params)

        d_params = _trainable(params["discriminator"])
        d_real = model.discriminate({"discriminator": d_params}, src, dst)
        d_fake = model.discriminate({"discriminator": d_params}, src, fake.detach())
        d_loss, d_parts = pix2pix_d_loss(d_real, d_fake)
        d_grads = _grads(d_loss, d_params)

        new_g, g_state, _ = g_opt.update(g_grads, opt_state["g"], params["generator"])
        new_d, d_state, _ = d_opt.update(d_grads, opt_state["d"], params["discriminator"])
        metrics = {"g_loss": g_loss.detach(), "d_loss": d_loss.detach()}
        metrics.update({k: v.detach() for k, v in {**g_parts, **d_parts}.items()})
        return {"generator": new_g, "discriminator": new_d}, {"g": g_state, "d": d_state}, metrics

    return _captured_train_step(train_step, f"the train step of {model.cfg.name}")


def make_pix2pix_infer(model):
    @torch.no_grad()
    def infer(params, src):
        return model.generate(params, src, train=False)

    return infer


def make_yolo_train_step(model, optimizer):
    """``step(params, opt_state, batch)``, batch = {"image", "targets"}; on
    the card the step is captured (``_captured_train_step``)."""
    cfg = model.cfg

    def train_step(params, opt_state, batch, generator=None):
        p = _trainable(params)
        preds = model(p, batch["image"])
        loss, parts = yolo_loss(preds, batch["targets"], cfg.n_classes, cfg.reg_max)
        grads = _grads(loss, p)
        params, opt_state, opt_info = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "n_pos": parts["n_pos"], **opt_info}

    captured = _captured_train_step(train_step, f"the train step of {cfg.name}")

    def step(params, opt_state, batch):
        return captured(params, opt_state, batch)

    def eager(params, opt_state, batch):
        return captured.eager(params, opt_state, batch)

    step.graphs, step.eager = captured.graphs, eager
    return step


def _is_count(x) -> bool:
    """Whether an optimizer-state leaf is a step count as the optimizers'
    ``init`` makes it: a plain 0-d integer tensor on the host (a count
    placed on a mesh is a DTensor, updated where it lies)."""
    return x.device.type == "cpu" and x.ndim == 0 and not x.dtype.is_floating_point and not hasattr(x, "placements")


def _counts_on(opt_state, device):
    """``opt_state`` with each count (``_is_count``) a 0-d tensor of its
    value on ``device`` (a fill, no copy from the host)."""
    return tree_map(lambda x: torch.full((), int(x), dtype=x.dtype, device=device) if _is_count(x) else x, opt_state)


def _counts_eager(run, params, opt_state, batch, *args):
    """``run`` on ``opt_state`` with its counts put on the batch's device
    (``_counts_on``), each count handed back as the host's ``count + 1``: a
    captured step's ops without the graph."""
    new_params, new_state, metrics = run(params, _counts_on(opt_state, tree_leaves(batch)[0].device), batch, *args)
    leaves = [x + 1 if _is_count(x) else y for x, y in zip(tree_leaves(opt_state), tree_leaves(new_state))]
    return new_params, tree_unflatten(new_state, leaves), metrics


@dataclasses.dataclass(eq=False)
class _TrainGraph(CapturedGraph):
    counts: frozenset = frozenset()  # flat indices of the optimizer counts (inputs and outputs alike)


def _captured_train_step(run, what):
    """``run(params, opt_state, batch, generator)`` (a train step, out of
    place) as the JAX callers' ``jax.jit`` compiles it, donating nothing.

    On CUDA tensors it is captured into a ``torch.cuda.CUDAGraph`` once per
    key: the trees' structure, each leaf's shape, dtype, strides and
    device, the dropout ``generator`` (None or the object) and the current
    stream; not the leaves' addresses, since every call brings new ones.
    Each call copies the params, the optimizer state and the batch into
    the graph's input buffers and fills each optimizer count (``_is_count``)
    into a 0-d buffer on the card with its host value (no sync), so the
    bias corrections and the schedule run in the graph on the call's own
    count; it then replays and clones every output leaf out. So the
    caller's trees are left as they were, every returned tree is fresh and
    outlives later calls, and each count comes back as the host's ``count
    + 1`` (``update`` advances it by one), a CPU tensor as ``init`` made
    it. The ``generator`` is registered with the graph: a replay draws the
    masks the eager ops would and advances it as much. Before a capture
    ``run`` goes once through on the side stream, with a scratch generator
    (the caller's stays where it was). Each capture takes a memory pool of
    its own. A capture that fails raises, naming ``what``; nothing falls
    back to eager. On CPU tensors (the caller asked for the CPU) ``run`` is
    called as it is. ``step.graphs`` holds the captures by key;
    ``step.eager`` is the captured ops without the graph (``run`` on the
    counts put on the batch's device, the counts handed back as the
    step's)."""
    graphs: dict[tuple, _TrainGraph] = {}

    def eager(params, opt_state, batch, generator=None):
        return _counts_eager(run, params, opt_state, batch, generator)

    def step(params, opt_state, batch, generator=None):
        device = tree_leaves(batch)[0].device
        if not pipeline.captures_on(device):
            return run(params, opt_state, batch, generator)
        trees = (params, opt_state, batch)
        leaves = tree_leaves(trees)
        stream = pipeline._current_stream(device)
        key = (tree_def(trees), tuple((tuple(t.shape), t.dtype, t.stride(), t.device) for t in leaves), generator,
               None if stream is None else stream.cuda_stream)
        g = graphs.get(key)
        if g is None:
            g = graphs[key] = _capture_train(run, what, trees, generator, stream, device)
        for i, (buf, x) in enumerate(zip(g.static_in, leaves)):
            if i in g.counts:
                buf.fill_(int(x))
            else:
                buf.copy_(x)
        g.graph.replay()
        g.replays += 1
        out = [leaves[i] + 1 if i in g.counts else o.clone() for i, o in enumerate(tree_leaves(g.static_out))]
        return tree_unflatten(g.static_out, out)

    step.graphs, step.eager = graphs, eager
    return step


def _capture_train(run, what, trees, generator, stream, device) -> _TrainGraph:
    """``run`` on static copies of ``trees`` (each optimizer count a 0-d
    buffer on ``device``), captured into a CUDA graph with a pool of its
    own after one run on the side stream."""
    params, opt_state, batch = trees
    static = (tree_map(torch.clone, params), tree_map(torch.clone, _counts_on(opt_state, device)),
              tree_map(torch.clone, batch))
    n_params = len(tree_leaves(params))
    counts = frozenset(n_params + j for j, x in enumerate(tree_leaves(opt_state)) if _is_count(x))
    side = pipeline._capture_stream(device)
    if side is not None:
        side.wait_stream(stream)
    with torch.cuda.stream(side):
        # warm-up: first-use work (library handles, kernel loads) stays out of the graph
        run(*static, None if generator is None else torch.Generator(generator.device))
    graph, out, pool_graphs = pipeline.capture_graph(
        stream, side, lambda: run(*static, generator), what, owner=object(),
        generators=() if generator is None else (generator,))
    if tree_def(out[:2]) != tree_def(trees[:2]):
        raise ValueError(f"{what}: the returned params and optimizer state are not trees of the ones given")
    captured = _TrainGraph(graph, None, tree_leaves(static), out, [], {}, counts=counts)
    pool_graphs.add(captured)
    return captured


def _local(t):
    """A DTensor's local tensor (on one rank, its whole buffer); any other
    tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _placed(t):
    """A DTensor's mesh and placements; None for any other tensor or value."""
    return (t.device_mesh, tuple(t.placements)) if hasattr(t, "placements") else None


def _leaf_key(t):
    """What a captured graph depends on in a leaf: its shape, dtype,
    strides, device and, for a DTensor, its mesh and placements."""
    return tuple(t.shape), t.dtype, t.stride(), t.device, _placed(t)


def _donated_train_step(run, what):
    """``run(params, opt_state, batch)`` (a train step that writes its
    update into the ``params`` and ``opt_state`` it is given, as
    ``AdamW.update_`` does) as the JAX launcher's ``jax.jit(...,
    donate_argnums=(0, 1))`` compiles it.

    On CUDA tensors, plain or DTensors, one ``torch.cuda.CUDAGraph`` per
    key: the trees' structure, each leaf's shape, dtype, strides, device
    and DTensor placements (``_leaf_key``) and the current stream; not the
    leaves' addresses. The first call of a key is its warm-up: ``run`` on
    the side stream, eagerly, on the caller's trees (``_counts_eager``:
    first-use work, library handles and DTensor's sharding propagation of
    every op, stay out of the graph), returned as the step it is. The
    second call captures ``run`` on the trees it is given, after the
    warm-up's cached blocks are released (``torch.cuda.empty_cache``), into
    a memory pool of its own; a capture executes nothing, so it advances no
    state, and that call's replay is its step. The graph writes into those
    trees' buffers (each optimizer count too, where ``run`` replaces it), so
    they are the graph's buffers from then on and every call returns them,
    in new containers. Each call fills each optimizer count that is a
    host tensor (``_is_count``) into its 0-d buffer on the card (no sync),
    so the bias corrections and the schedule run on the call's own count,
    and hands it back as the host's ``count + 1``; it copies the batch into
    the graph's batch buffers and every other leaf in only where it does
    not already lie in the graph's buffer (a tree restored from a
    checkpoint: copied in once, and the caller's tree is consumed), then
    replays and clones the metrics out. So a loop that passes back what it
    got copies only the batch in and the metrics out, and each key holds
    one graph and one pool, as ``jax.jit`` keeps one executable a shape.

    A capture that fails raises, naming ``what``; nothing falls back to
    eager. On CPU and ``meta`` tensors ``run`` is called as it is.
    ``step.graphs`` holds the captures by key; ``step.eager`` is the
    captured ops without the graph (``_counts_eager``)."""
    graphs: dict[tuple, _TrainGraph] = {}
    warmed: set[tuple] = set()

    def eager(params, opt_state, batch):
        return _counts_eager(run, params, opt_state, batch)

    def step(params, opt_state, batch):
        device = tree_leaves(batch)[0].device
        if not pipeline.captures_on(device):
            return run(params, opt_state, batch)
        trees = (params, opt_state, batch)
        leaves = tree_leaves(trees)
        stream = pipeline._current_stream(device)
        key = (tree_def(trees), tuple(_leaf_key(t) for t in leaves), None if stream is None else stream.cuda_stream)
        g = graphs.get(key)
        if g is None:
            if key not in warmed:
                warmed.add(key)
                return _warm_up(eager, what, trees, stream, device)
            g = graphs[key] = _capture_donated(run, what, trees, stream, device)
        n_trees = len(tree_leaves(trees[:2]))
        with torch.no_grad():
            for i, (buf, x) in enumerate(zip(g.static_in, leaves)):
                if i in g.counts:
                    buf.fill_(int(x))
                else:
                    buf, x = _local(buf), _local(x)
                    if i >= n_trees or buf.data_ptr() != x.data_ptr():
                        buf.copy_(x)
        g.graph.replay()
        g.replays += 1
        out = [leaves[i] + 1 if i in g.counts else b for i, b in enumerate(g.static_in[:n_trees])]
        new_params, new_state = tree_unflatten(trees[:2], out)
        return new_params, new_state, tree_map(torch.clone, g.static_out)

    step.graphs, step.eager = graphs, eager
    return step


def _written_back(given, returned, what):
    """``returned`` (the params and optimizer state a donating step
    returned) as the leaves of ``given`` (the ones it was handed): a leaf
    it returns anew (``update_``'s count) is copied into the leaf it
    replaces; a count on the host is returned as it is."""
    if tree_def(returned) != tree_def(given):
        raise ValueError(f"{what}: the returned params and optimizer state are not trees of the ones given")
    out = []
    with torch.no_grad():
        for a, b in zip(tree_leaves(given), tree_leaves(returned)):
            if b is not a and not _is_count(a):
                a.copy_(b)
                b = a
            out.append(b)
    return tree_unflatten(given, out)


def _on_side_stream(run, stream, device):
    """``run()`` on the device's side stream, where the captures run (so
    its first-use work serves them), waited for."""
    side = pipeline._capture_stream(device)
    if side is not None:
        side.wait_stream(stream)
    with torch.cuda.stream(side):
        out = run()
    if side is not None:
        torch.cuda.synchronize(device)  # its outputs were made on the side stream: done before the caller's ops
    return out


def _warm_up(eager, what, trees, stream, device):
    """``eager(*trees)`` on the side stream, waited for, written into the
    trees it was given (``_written_back``)."""

    def run():
        *new, metrics = eager(*trees)
        return (*_written_back(trees[:2], tuple(new), what), metrics)

    return _on_side_stream(run, stream, device)


def _capture_donated(run, what, trees, stream, device) -> _TrainGraph:
    """``run`` on ``trees``' params and optimizer state (each host count a
    0-d buffer on ``device``) and on batch buffers of the batch's shapes,
    captured into a CUDA graph with a pool of its own. The graph writes
    each leaf ``run`` returns anew (the count) into the leaf it replaces,
    so every output but the metrics lies in an input buffer."""
    params, opt_state, batch = trees
    inputs = tree_leaves((params, _counts_on(opt_state, device), tree_map(torch.clone, batch)))
    n_params = len(tree_leaves(params))
    counts = frozenset(n_params + j for j, x in enumerate(tree_leaves(opt_state)) if _is_count(x))

    def body():
        # containers made anew: ``run`` may replace a leaf in the ones it is given (``update_``'s count)
        *new, metrics = run(*tree_unflatten(trees, inputs))
        _written_back(tree_unflatten(trees[:2], inputs), tuple(new), what)
        return metrics

    torch.cuda.empty_cache()  # the warm-up's cached blocks: the graph's pool takes the step's working set
    side = pipeline._capture_stream(device)
    if side is not None:
        side.wait_stream(stream)
    graph, metrics, pool_graphs = pipeline.capture_graph(stream, side, body, what, owner=object())
    captured = _TrainGraph(graph, None, inputs, metrics, [], {}, counts=counts)
    pool_graphs.add(captured)
    return captured


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def make_lm_train_step(model, optimizer, aux_weight: float = 0.01, n_micro: int = 1, loss_chunk: int = 512,
                       donate: bool = False):
    """batch = {"tokens": (B,S), "labels": (B,S), optional "mask", "positions",
    "extra_embeds", "embed_positions" (VLM), "frames" (Whisper)}.

    ``step(params, opt_state, batch) -> (params, opt_state, metrics)`` with
    metrics ``{"loss", "ce", "aux", **the optimizer's info}``; the loss is
    ``ce + aux_weight * aux``. ``loss_chunk`` fuses the LM head with the
    loss over sequence chunks (``chunked_cross_entropy``), so the (B, S,
    vocab) logits never exist at once. ``n_micro > 1`` accumulates the
    gradients of ``n_micro`` micro-batches, one after another, so the
    activations of one micro-batch are alive at a time: micro-batch ``j``
    takes rows ``j, j + n_micro, ...`` (the rows the JAX package's
    ``reshape(B // n, n, ...)`` then ``moveaxis`` gives it); loss, parts and
    gradients are summed in fp32 and scaled by ``1 / n_micro``.

    ``donate`` updates through ``optimizer.update_``, into the buffers of
    the parameters and optimizer state it is given (the JAX launcher's
    ``jax.jit`` with ``donate_argnums=(0, 1)``): the caller's trees are
    overwritten. On the card, plain tensors or the DTensors ``on_mesh``
    hands it, that step is one CUDA graph per key (``_donated_train_step``:
    the first call of a key runs eagerly as its warm-up, the second
    captures, every call after replays, written into the trees the capture
    was given, which every call returns); ``step.eager`` is its ops
    uncaptured and ``step.graphs`` its captures. On the CPU and on ``meta``
    tensors it runs eagerly. Without ``donate`` the step returns new
    trees and runs eagerly on every device."""

    def grad_fn(params, batch):
        p = _trainable(params)
        kwargs = {k: batch[k] for k in ("positions", "extra_embeds", "embed_positions") if k in batch}
        if "frames" in batch:
            hidden, aux = model(p, batch["frames"], batch["tokens"], return_hidden=True)
        else:
            hidden, aux = model(p, batch["tokens"], return_hidden=True, **kwargs)
        ce = chunked_cross_entropy(model.head, p, hidden, batch["labels"], batch.get("mask"), chunk=loss_chunk)
        loss = ce + aux_weight * aux
        return [loss.detach(), ce.detach(), aux.detach()], _grads(loss, p)

    def accumulated(params, batch):
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} micro-batches")
        sums = grads = None
        for j in range(n_micro):
            parts, g = grad_fn(params, {k: v[j::n_micro] for k, v in batch.items()})
            if sums is None:
                sums, grads = [x.float() for x in parts], tree_map(lambda t: t.float(), g)
            else:
                sums = [a + b for a, b in zip(sums, parts)]
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b)
            del parts, g  # before the next micro-batch's backward
        inv = 1.0 / n_micro
        for a in tree_leaves(grads):
            a.mul_(inv)
        return [x * inv for x in sums], grads

    update = optimizer.update_ if donate else optimizer.update

    def train_step(params, opt_state, batch):
        (loss, ce, aux), grads = grad_fn(params, batch) if n_micro == 1 else accumulated(params, batch)
        params, opt_state, opt_info = update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux, **opt_info}

    return _donated_train_step(train_step, f"the train step of {_name(model)}") if donate else train_step


def _name(model) -> str:
    return getattr(getattr(model, "cfg", None), "name", type(model).__name__)


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------


def make_lm_decode_step(model):
    """One serving decode step: (params, token, caches, t) -> (logits,
    caches), ``t`` an int or a 0-d integer tensor. The step writes the new
    token into the caches it is given and returns them (the JAX cell's
    ``donate_argnums=(2,)``): the caller's caches are overwritten; a caller
    that keeps them passes a clone.

    On the card, plain tensors or DTensors, the step is what the JAX
    launcher's ``jax.jit`` caches: ``model.decode_step`` captured into a
    ``torch.cuda.CUDAGraph`` and replayed for every token (``_DecodeStep``).
    A graph is keyed by its signature (the token's shape, dtype and
    placements, whether ``t`` is a DTensor, the params' and caches' trees,
    each of their leaves' shape, dtype, strides, device and placements,
    the current stream) and by the addresses of the params and cache
    leaves it reads; not by the params' container. It is dropped, its pool
    released, when any leaf it was captured on is collected. On CPU
    tensors (the caller asked for the CPU) and ``meta`` tensors the step
    runs ``model.decode_step`` as it is."""
    return _DecodeStep(model)


@dataclasses.dataclass(eq=False)
class _DecodeGraph(CapturedGraph):
    finalizers: list = dataclasses.field(default_factory=list)  # one a leaf it reads, detached when it is dropped


def _drop_decode_graph(step_ref, key):
    """A leaf the graph of ``key`` reads was collected: the graph leaves
    its step's ``graphs``, and its pool is released with it."""
    step = step_ref()
    g = None if step is None else step.graphs.pop(key, None)
    if g is not None:
        for f in g.finalizers:
            f.detach()


class _DecodeStep:
    """``make_lm_decode_step``'s step. On the card, each call fills the
    graph's token and 0-d int32 position buffers on the device (no host
    sync), replays the graph and returns a clone of its logits with the
    caller's own caches, which the graph writes: a decode loop that passes
    back the caches it got replays one graph and copies no cache.

    The first call of a signature is its warm-up, which keeps first-use work
    (library handles, and on DTensors the sharding propagation of every op)
    out of the graphs: on plain tensors ``model.decode_step`` runs once on
    scratch caches of the same shapes (a run on the caller's would advance
    their SSM states a second time) and the call goes on to capture; on
    DTensors (their ops under ``dist.mesh_ops``) the call is the step
    itself, run eagerly on the caller's trees, and the next call captures.
    A capture at new addresses of a warmed signature (caches allocated per
    request, a replaced params leaf) captures directly; a capture executes
    nothing. A graph holds weak references only to the leaves it reads, and
    a finalizer on each drops the graph when the leaf is collected, so a
    server holds at most one graph per live cache set. A capture that fails
    raises, naming the model; nothing falls back to eager. ``graphs``: the
    live captures by key; ``warmed``: the signatures warmed up;
    ``captures`` and ``replays``: counts since the step was made."""

    def __init__(self, model):
        self.model, self.what = model, f"the decode step of {_name(model)}"
        self.graphs: dict[tuple, _DecodeGraph] = {}
        self.warmed: set[tuple] = set()
        self.captures = self.replays = 0

    @torch.no_grad()
    def __call__(self, params, token, caches, t):
        device = token.device
        if not pipeline.captures_on(device):
            return self.model.decode_step(params, token, caches, t)
        leaves = tree_leaves((params, caches))
        on_mesh = any(hasattr(a, "placements") for a in (token, *leaves))
        with mesh_ops() if on_mesh else contextlib.nullcontext():
            stream = pipeline._current_stream(device)
            sig = (tuple(token.shape), token.dtype, _placed(token), _placed(t),
                   tree_def(params), tree_def(caches), tuple(_leaf_key(a) for a in leaves),
                   None if stream is None else stream.cuda_stream)
            key = (sig, tuple(_local(a).data_ptr() for a in leaves))
            g = self.graphs.get(key)
            if g is None:
                warm = sig not in self.warmed
                self.warmed.add(sig)
                if warm and on_mesh:  # the step itself, eagerly on the caller's trees
                    return _on_side_stream(lambda: self.model.decode_step(params, token, caches, t), stream, device)
                g = self._capture(params, token, caches, t, leaves, stream, device, key, warm)
            _local(g.static_in[0]).copy_(_local(token))
            position = _local(g.static_in[1])
            if isinstance(t, torch.Tensor):
                position.copy_(_local(t))
            else:
                position.fill_(t)
            g.graph.replay()
            g.replays += 1
            self.replays += 1
            return g.static_out.clone(), caches

    def _capture(self, params, token, caches, t, leaves, stream, device, key, warm) -> _DecodeGraph:
        """``model.decode_step`` on static token and position buffers and
        the caller's params and caches, captured into a CUDA graph of
        ``stream``'s pool (after the scratch warm-up where ``warm``), with
        a finalizer on each of those leaves that drops it."""
        model, what = self.model, self.what
        side = pipeline._capture_stream(device)
        if side is not None:
            side.wait_stream(stream)
        with torch.cuda.stream(side):
            static_token = token.clone()
            if hasattr(t, "placements"):
                position = torch.zeros_like(t, dtype=torch.int32)
            else:
                position = torch.zeros((), dtype=torch.int32, device=device)
            if warm:
                model.decode_step(params, static_token, tree_map(torch.zeros_like, caches), position)
        p_skel, c_skel = tree_map(lambda _: None, params), tree_map(lambda _: None, caches)
        refs, n = [weakref.ref(a) for a in leaves], len(tree_leaves(params))

        def body():
            # the leaves through weak references: what the capture closes over keeps no cache alive
            given = [r() for r in refs]
            logits, out = model.decode_step(tree_unflatten(p_skel, given[:n]), static_token,
                                            tree_unflatten(c_skel, given[n:]), position)
            if any(a is not b for a, b in zip(tree_leaves(out), given[n:], strict=True)):
                raise ValueError(f"{what}: the step returned other caches than those it was given")
            return logits

        graph, logits, pool_graphs = pipeline.capture_graph(stream, side, body, what)
        captured = _DecodeGraph(graph, None, [static_token, position], logits, [], {})
        pool_graphs.add(captured)
        me = weakref.ref(self)
        for a in leaves:
            f = weakref.finalize(a, _drop_decode_graph, me, key)
            f.atexit = False  # at exit there is nothing left to release
            captured.finalizers.append(f)
        self.graphs[key] = captured
        self.captures += 1
        return captured


def make_lm_prefill(model):
    """(params, tokens) -> (last-token logits, caches)."""

    @torch.no_grad()
    def prefill(params, tokens):
        return model.prefill(params, tokens)

    return prefill


@torch.no_grad()
def greedy_generate(model, params, prompt, steps: int, max_len: int, cache_dtype=torch.bfloat16):
    """Reference sampling loop: the prompt fed one token at a time through
    ``decode_step``, then ``steps`` greedy tokens. prompt (B, S) int ->
    (B, steps). A Whisper model decodes against its zero cross caches (no
    audio is encoded), as the JAX package's loop does. Each step writes
    into the loop's own caches."""
    B, S = prompt.shape
    caches = model.init_caches(B, max_len, dtype=cache_dtype, device=prompt.device)
    tok = prompt[:, :1]
    outs = []
    for t in range(S + steps - 1):
        logits, caches = model.decode_step(params, tok, caches, t)
        if t + 1 < S:
            tok = prompt[:, t + 1 : t + 2]
        else:
            tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
            outs.append(tok)
    return torch.cat(outs, dim=1)
