"""The LM families' stacked-layer gradients, against the parent formulation.

The JAX package scans over its stacked layers, and the scan's backward
writes layer i's gradient into row i of the stacked gradient. The port's
four LM families loop over ``nn.module.unstack``'s per-layer views: one
``unbind`` of each stacked leaf a forward, whose backward stacks the
layers' gradients into one tensor of the leaf's shape. The parent
formulation, kept here (``_parent_unstack``), took ``t[i]`` of every leaf
for every layer, and each of those views backpropagated a zero-filled
tensor of the leaf's full shape.

Held here: the train step's loss, gradients and updated parameters are
bit-equal to the parent formulation's for the ten archs of
``tests/test_torch_lm_train.py`` at their smoke widths (f32, remat on and
off, the ``dots`` policy, two micro-batches); under a dispatch mode the
backward makes one tensor of each stacked leaf's full shape, at every
depth; a step leaves no tensor in a reference cycle (where only the
garbage collector would free it); and on a fake (4, 4) process group
(``launch.dryrun.dry_run``, ``launch.roofline.RankCounter``) the gradients
keep the parent's placements, no collective count rises, and fewer bytes
are moved, also under the torch 2.11 emulation of
``tests/test_torch_dist_views.py``.
Inputs come from numpy seeds; everything runs on one intra-op thread.
"""
import collections
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves as pytree_leaves  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.models import hymba, lm, mamba2, whisper  # noqa: E402
from repro_torch.nn.module import layer, tree_leaves, unstack  # noqa: E402
from repro_torch.train import AdamW, make_lm_train_step  # noqa: E402

ARCHS = ["gemma2_2b", "deepseek_moe_16b", "hymba_1_5b", "mamba2_2_7b", "whisper_small",
         "deepseek_v2_lite_16b", "qwen2_vl_7b", "gemma_2b", "gemma2_27b", "phi4_mini_3_8b"]
B, S, CHUNK = 4, 16, 8
N_IMG = 4  # qwen2-vl's patch embeddings per row
FAMILY_MODULES = (lm, hymba, mamba2, whisper)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parent_unstack(tree):
    """The parent formulation: layer i's views taken as ``t[i]`` of every leaf."""
    return [layer(tree, i) for i in range(tree_leaves(tree)[0].shape[0])]


@contextlib.contextmanager
def parent_formulation():
    """The four families' layer loops as the parent tree ran them."""
    saved = [(m, m.unstack) for m in FAMILY_MODULES]
    for m, _ in saved:
        m.unstack = _parent_unstack
    try:
        yield
    finally:
        for m, fn in saved:
            m.unstack = fn


def _layers(arch, depth):
    return {"n_enc_layers": depth, "n_dec_layers": depth} if arch == "whisper_small" else {"n_layers": depth}


def _model(arch, **over):
    return configs.build_model(dataclasses.replace(configs.get_arch(arch).smoke, act_dtype=torch.float32, **over))


def _batch(arch, seed=3, B=B, S=S):
    cfg = configs.get_arch(arch).smoke
    b = next(token_batches(B, S, cfg.vocab, seed=seed))
    rs = np.random.RandomState(seed)
    if arch == "whisper_small":
        b["frames"] = rs.randn(B, cfg.n_frames, cfg.d_model).astype(np.float32)
    if arch == "qwen2_vl_7b":  # M-RoPE ids and patch embeddings written into the sequence
        b["positions"] = rs.randint(0, S, (B, S, 3)).astype(np.int32)
        b["extra_embeds"] = rs.randn(B, N_IMG, cfg.d_model).astype(np.float32)
        b["embed_positions"] = np.stack([rs.permutation(S)[:N_IMG] for _ in range(B)]).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


class _Recording:
    """AdamW that keeps the gradients it is given."""

    def __init__(self):
        self.opt, self.grads = AdamW(lr=1e-3, weight_decay=0.01), None

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def _step(model, params, batch, n_micro=1):
    """(metrics, gradient leaves, updated parameter leaves) of one step."""
    opt = _Recording()
    new, _, m = make_lm_train_step(model, opt, n_micro=n_micro, loss_chunk=CHUNK)(params, opt.opt.init(params), batch)
    return m, tree_leaves(opt.grads), tree_leaves(new)


def _stacked_leaves(params):
    return [t for k, sub in params.items() if k in ("blocks", "enc_blocks", "dec_blocks") for t in tree_leaves(sub)]


VARIANTS = {"remat": {}, "no_remat": {"remat": False}, "dots": {"remat_policy": "dots"}, "n_micro2": {}}
CASES = [(a, v) for a in ARCHS for v in VARIANTS
         if v != "dots" or configs.get_arch(a).family == "lm"]


@pytest.mark.parametrize("arch,variant", CASES, ids=[f"{a}-{v}" for a, v in CASES])
def test_step_is_bit_equal_to_the_parent_formulation(arch, variant):
    """Loss, ce, aux, every gradient leaf and every parameter after AdamW,
    with ``torch.equal``: the per-layer gradients are the same arithmetic,
    and the parent's sum of zero-filled tensors adds exact zeros."""
    model = _model(arch, **VARIANTS[variant])
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(arch)
    n_micro = 2 if variant == "n_micro2" else 1
    with parent_formulation():
        want = _step(model, params, batch, n_micro)
    got = _step(model, params, batch, n_micro)
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert torch.equal(got[0][k], want[0][k]), k
    for what, a_leaves, b_leaves in (("gradient", got[1], want[1]), ("parameter", got[2], want[2])):
        assert len(a_leaves) == len(b_leaves)
        for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), f"{what} leaf {i}"


class FullShapeCounter(TorchDispatchMode):
    """Counts, while entered, the new tensors (not in an input's storage)
    of a stacked leaf's shape and dtype that the backward makes in a node
    which hands its gradient to a leaf of that shape (an edge into the
    leaf's ``AccumulateGrad``): the gradients of the stacked leaves and the
    sums they are added into, by op and shape in ``rows``. A per-layer
    tensor whose shape happens to be a stacked leaf's (Mamba2's four conv
    taps at four layers) feeds no leaf and is not counted."""

    def __init__(self, leaves):
        super().__init__()
        self.kinds = {(tuple(t.shape), t.dtype) for t in leaves}
        self.rows = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        node = torch._C._current_autograd_node()
        if node is None:
            return out
        feeds = {(tuple(f.variable.shape), f.variable.dtype) for f, _ in node.next_functions
                 if f is not None and hasattr(f, "variable")}
        ins = {x.untyped_storage().data_ptr() for x in pytree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)}
        for o in pytree_leaves(out):
            kind = (tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor) else None
            if kind in self.kinds and kind in feeds and o.untyped_storage().data_ptr() not in ins:
                self.rows[(str(func), kind[0])] += 1
        return out


def _counted_step(model, params, batch):
    leaves = _stacked_leaves(params)
    with FullShapeCounter(leaves) as counter:
        make_lm_train_step(model, AdamW(lr=1e-3), loss_chunk=CHUNK)(params, AdamW(lr=1e-3).init(params), batch)
    by_shape = collections.Counter()
    for (_, shape), n in counter.rows.items():
        by_shape[shape] += n
    return leaves, counter.rows, by_shape


COUNT_CASES = [(a, d) for a in ("gemma2_2b", "mamba2_2_7b", "whisper_small") for d in (2, 4, 8, 16)]
# a batch whose sizes are no depth counted, so no activation has a stacked leaf's shape
COUNT_B, COUNT_S = 3, 12


@pytest.mark.parametrize("arch,depth", COUNT_CASES, ids=[f"{a}-{d}" for a, d in COUNT_CASES])
def test_backward_makes_one_full_shape_tensor_per_stacked_leaf(arch, depth):
    """One train step (remat on) under ``FullShapeCounter``: its backward
    makes exactly one new tensor of each stacked leaf's shape (the stack
    of the layers' gradients), so the count is the number of stacked
    leaves at every depth; the parent formulation, counted the same way,
    makes ``depth`` of them per leaf (``select_backward``) and more."""
    model = _model(arch, **_layers(arch, depth))
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(arch, B=COUNT_B, S=COUNT_S)
    leaves, rows, by_shape = _counted_step(model, params, batch)
    per_shape = collections.Counter(tuple(t.shape) for t in leaves)
    assert by_shape == per_shape, rows
    assert sum(rows.values()) == len(leaves)
    with parent_formulation():
        _, parent_rows, _ = _counted_step(model, params, batch)
    selects = sum(n for (op, _), n in parent_rows.items() if "select_backward" in op)
    assert selects == depth * len(leaves), parent_rows


def test_unstack_splits_each_leaf_once_into_views():
    """``unstack`` gives one tree per layer, of the stacked tree's
    structure and key order, whose leaves are views of the stacked ones
    equal to ``layer(tree, i)``'s."""
    g = torch.Generator().manual_seed(0)
    tree = {"b": torch.randn(3, 2, 4, generator=g), "a": [torch.randn(3, 5, generator=g), torch.randn(3, generator=g)]}
    out = unstack(tree)
    assert len(out) == 3
    for i, sub in enumerate(out):
        assert list(sub) == ["b", "a"] and isinstance(sub["a"], list)
        for x, y, t in zip(tree_leaves(sub), tree_leaves(layer(tree, i)), tree_leaves(tree)):
            assert torch.equal(x, y) and x._base is t


@pytest.mark.parametrize("arch", ["gemma2_2b", "hymba_1_5b", "mamba2_2_7b", "whisper_small"])
def test_a_step_leaves_no_tensor_in_a_reference_cycle(arch):
    """After a warm-up step, a donated train step leaves no tensor that
    only the garbage collector would free: a tensor in a reference cycle
    (``tree_unflatten``'s self-calling closure held the gradients it was
    given, and ``unstack`` calls it every forward) lives until the
    collector's next pass, so the previous step's gradients could still
    hold the card's memory at the next step's peak."""
    import gc

    model = _model(arch)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3)
    step = make_lm_train_step(model, opt, loss_chunk=CHUNK, donate=True)
    batch = _batch(arch)
    params, state, _ = step(params, opt.init(params), batch)  # first calls: lazy imports, caches
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        params, state, _ = step(params, state, batch)
        gc.collect()
        cyclic = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cyclic == []


# ------------------------------------------------------ on a fake (4, 4) group


# the train cell's batch: 16 rows, 4 a rank of "data" (at 8 rows the 2.11
# emulation refuses gemma2's MLP flatten, in either formulation)
MESH_SHAPES = {"train": {"kind": "train", "seq_len": 32, "global_batch": 16}}


def _mesh_cell(mesh, arch, depth):
    """``arch``'s smoke config at ``depth`` layers (gemma2-2b's with 8
    query and 4 KV heads, so the heads split over "model" of 4), its train
    cell (``specs.build_cell``: FSDP weights, the batch over "data") on
    ``meta`` DTensors."""
    from repro_torch.launch import specs

    spec = configs.get_arch(arch)
    over = {"n_q": 8, "n_kv": 4} if arch == "gemma2_2b" else {}
    spec = dataclasses.replace(spec, config=dataclasses.replace(spec.smoke, n_layers=depth, **over))
    return specs.build_cell(spec, "train", mesh, n_micro=1, shapes=MESH_SHAPES)


def _count_mesh_step(mesh, arch, depth, monkeypatch):
    """The cell's counts and its gradients' placements, recorded at AdamW."""
    from repro_torch.launch import roofline
    from repro_torch.train.optimizer import AdamW as _AdamW

    placements = []
    real = _AdamW.update_

    def recording(self, grads, state, params):
        placements.append([tuple(g.placements) for g in tree_leaves(grads)])
        return real(self, grads, state, params)

    with monkeypatch.context() as m:
        m.setattr(_AdamW, "update_", recording)  # before the cell's step takes it
        cell = _mesh_cell(mesh, arch, depth)
        _, counts = roofline.count_run(cell.fn, cell.args)
    (got,) = placements
    return counts, got


@pytest.mark.parametrize("emulate", [False, True], ids=["this_torch", "as_torch_2_11"])
@pytest.mark.parametrize("arch", ["gemma2_2b", "mamba2_2_7b"])
def test_mesh_step_keeps_placements_and_collectives(arch, emulate, monkeypatch):
    """On a fake (4, 4) group at 8 layers, against the parent formulation:
    each gradient has the parent's placements (partial sums over both mesh
    dims, where the optimizer's update reduces them); no kind of
    collective is counted more often; the counted bytes are lower, and the
    peak of live bytes above the arguments (``temps``) no higher."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from test_torch_dist_views import emulated_2_11  # noqa: F401

    with dryrun.dry_run(16), emulated_2_11() if emulate else contextlib.nullcontext():
        mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
        with parent_formulation():
            want, want_pl = _count_mesh_step(mesh, arch, 8, monkeypatch)
        got, got_pl = _count_mesh_step(mesh, arch, 8, monkeypatch)
    assert got_pl == want_pl
    assert sum(want.collective_counts.values()) > 0
    for kind, n in got.collective_counts.items():
        assert n <= want.collective_counts[kind], (kind, got.collective_counts, want.collective_counts)
    assert got.bytes_accessed < want.bytes_accessed
    assert got.memory["temps"] <= want.memory["temps"]
