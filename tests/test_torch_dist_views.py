"""The sharded steps under torch 2.11's DTensor, emulated on any version, and
``dist.blockwise`` against the plain ops.

torch 2.11 refused what later versions run: a view that flattens dims
of which one other than the first is split (an einsum
lowered to ``bmm`` views its batch-like dims into one, and the sharded
steps split the batch over "data" and the heads over "model"), an
in-place ``index_put_`` (no strategy), and an out-of-place ``index_put``
whose ``values`` are split on an indexed dim (its strategy splits ``self``
there too). ``as_torch_2_11`` makes this version do the same: it refuses
those views as 2.11 does, takes away the version's strategies for
``index_put_`` and ``var_mean`` (2.11 has none; the port registers its
own where a version lacks one) and puts 2.11's rule in place of the
version's ``index_put`` strategy, clearing DTensor's caches on entry and
on exit. The attention core, MLA's contractions, the SSD scan
and its decode step run ``dist.blockwise`` over the batch and the heads;
on plain tensors each is the plain op, bit for bit (the parent code's
arithmetic is copied here to hold it).
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.dist import mesh_ops  # noqa: E402
from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402
from test_torch_dryrun import check_cell, fake_mesh, small_shapes  # noqa: E402,F401

REFUSAL = "Attempted to flatten multiple dimensions, with dimension {} being sharded."
# the version strategies torch 2.11 lacks
MISSING_IN_2_11 = (torch.ops.aten.index_put_.default, torch.ops.aten.var_mean.correction)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_caches(prop):
    from repro_torch.dist import sharding

    sharding._register_strategies.cache_clear()
    prop.propagate_op_sharding.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:
        native()


def _flattens(cmd):
    """The ``Flatten`` commands in one output dim's view rule."""
    from torch.distributed.tensor._ops import _view_ops as vo

    if isinstance(cmd, vo.Flatten):
        yield cmd
    for sub in getattr(cmd, "input_dims", None) or [getattr(cmd, "input_dim", None)]:
        if isinstance(sub, vo.DimSpec) and not isinstance(sub, vo.InputDim):
            yield from _flattens(sub)


def _torch_2_11_index_put(op_schema):
    """torch 2.11's ``index_put`` strategy: the indices whole, ``values``'
    leading dims taken for ``self``'s indexed ones (``values`` [a, b, d, e]
    against ``self`` [d, e]), and one strategy for each of ``self``'s and
    ``values``' placements, the other following it."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    dst, indices, values = op_schema.args_schema[:3]
    mesh = values.mesh
    idx = [DTensorSpec(mesh, (Replicate(),) * mesh.ndim, tensor_meta=c.strategies[0].output_spec.tensor_meta)
           for c in indices.children]
    offset = dst.strategies[0].output_spec.ndim - values.strategies[0].output_spec.ndim
    out = OpStrategy([])
    for exemplar in (dst, values):
        for strategy in exemplar.strategies:
            d_pl, v_pl = [], []
            for p in strategy.output_spec.placements:
                if not p.is_shard() or (exemplar is dst and p.dim < offset):
                    d_pl.append(Replicate())
                    v_pl.append(Replicate())
                elif exemplar is dst:
                    d_pl.append(p)
                    v_pl.append(Shard(p.dim - offset))
                else:
                    d_pl.append(Shard(p.dim + offset))
                    v_pl.append(p)
            d_new = DTensorSpec(mesh, tuple(d_pl), tensor_meta=dst.strategies[0].output_spec.tensor_meta)
            v_new = DTensorSpec(mesh, tuple(v_pl), tensor_meta=values.strategies[0].output_spec.tensor_meta)
            out.strategies.append(OpSpec(
                output_specs=d_new, input_specs=(d_new, *idx, v_new),
                redistribute_cost=[generate_redistribute_costs(dst, d_new),
                                   *[generate_redistribute_costs(c, s) for c, s in zip(indices.children, idx)],
                                   generate_redistribute_costs(values, v_new)]))
    return out


@contextlib.contextmanager
def emulated_2_11():
    """torch 2.11's DTensor on this version (see the module docstring)."""
    from torch.distributed.tensor._ops import _view_ops as vo

    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    prop = DTensor._op_dispatcher.sharding_propagator
    ops = MISSING_IN_2_11 + (torch.ops.aten.index_put.default,)
    tables = [prop.op_strategy_funcs, getattr(prop, "op_single_dim_strategy_funcs", {}), prop.op_to_schema_info]
    saved = [{op: t[op] for op in ops if op in t} for t in tables]
    version_rule = vo.propagate_shape_and_sharding

    def refusing(placements, shape, rule, mesh_sizes, strict_view=False):
        for cmd in rule if strict_view else ():
            for flat in _flattens(cmd):
                for d in flat.input_dims[1:]:
                    if any(p.is_shard() and getattr(p, "dim", None) == d.input_dim for p in placements):
                        raise RuntimeError(REFUSAL.format(d.input_dim))
        return version_rule(placements, shape, rule, mesh_sizes, strict_view)

    for t in tables:
        for op in ops:
            t.pop(op, None)
    prop.register_op_strategy(torch.ops.aten.index_put.default, _torch_2_11_index_put,
                              RuntimeSchemaInfo(needs_pytree=True))
    vo.propagate_shape_and_sharding = refusing
    _clear_caches(prop)
    try:
        yield
    finally:
        vo.propagate_shape_and_sharding = version_rule
        for t, entries in zip(tables, saved):
            for op in ops:
                t.pop(op, None)
            t.update(entries)
        _clear_caches(prop)


@pytest.fixture
def as_torch_2_11():
    with emulated_2_11():
        yield


def _mesh(fake_mesh):  # noqa: F811
    return fake_mesh((2, 2), ("data", "model"))


def _put(x, mesh, placements):
    """``x`` as a DTensor whose rank-0 block holds ``x``'s values there (on
    the fake group only rank 0's block has values)."""
    from torch.distributed.tensor import distribute_tensor

    local = distribute_tensor(x, mesh, placements, src_data_rank=None).to_local().shape
    block = x[tuple(slice(0, n) for n in local)].clone()
    return DTensor.from_local(block, mesh, placements, run_check=False, shape=x.shape, stride=x.stride())


# ------------------------------------------- the refused cells, one per class


@pytest.mark.parametrize("family,kind", [("lm", "train"), ("lm", "decode"), ("mamba2", "decode"), ("mla", "train"),
                                         ("mrope", "train")])
def test_formerly_refused_cells_run_as_on_torch_2_11(family, kind, fake_mesh, small_shapes, as_torch_2_11):  # noqa: F811
    """One smoke-width cell of each class torch 2.11 refused on the fake 2 x 2
    group: the attention core's views in a train cell and a batch-8 decode,
    the SSD decode step's, MLA's contractions in its train cell, and the
    M-RoPE model's in-place write of its patch embeddings (``index_put_``)."""
    check_cell(_mesh(fake_mesh), family, kind)


def test_emulation_refuses_what_torch_2_11_refuses(fake_mesh, as_torch_2_11):  # noqa: F811
    """Under the emulation the parent's attention core (the einsums over
    DTensors, batch over "data" and heads over "model") raises 2.11's
    refusal, and an in-place ``index_put_`` has the port's strategy only."""
    mesh = _mesh(fake_mesh)
    q = _put(torch.randn(4, 8, 2, 1, 16), mesh, (Shard(0), Shard(2)))
    k = _put(torch.randn(4, 8, 2, 16), mesh, (Shard(0), Shard(2)))
    with mesh_ops(), pytest.raises(RuntimeError, match="Attempted to flatten multiple dimensions"):
        torch.einsum("bqhgd,bkhd->bhgqk", q, k)
    prop = DTensor._op_dispatcher.sharding_propagator
    from repro_torch.dist.sharding import _index_put_strategy

    assert prop.op_strategy_funcs[torch.ops.aten.index_put_.default] is _index_put_strategy


# --------------------------------------------------------- index_put, index_add


def _moe():
    from repro_torch.nn.moe import MoE

    return MoE(d_model=16, d_ff_expert=8, n_experts=4, top_k=2, capacity_factor=1.25)


def test_moe_dispatch_as_on_torch_2_11(fake_mesh, as_torch_2_11):  # noqa: F811
    """MoE's sort-based dispatch (two out-of-place ``index_put``s) on
    replicated DTensors through the port's ``index_put`` strategy: its slots
    equal the plain dispatch's, bit for bit."""
    mesh = _mesh(fake_mesh)
    moe, T = _moe(), 12
    g = torch.Generator().manual_seed(3)
    eidx = torch.stack([torch.randperm(4, generator=g)[:2] for _ in range(T)])
    gates = torch.rand(T, 2, generator=g)
    want_tok, want_gate = moe.dispatch(eidx, gates, T)
    with mesh_ops():
        tok, gate = moe.dispatch(_put(eidx, mesh, (Replicate(),) * 2), _put(gates, mesh, (Replicate(),) * 2), T)
    assert isinstance(tok, DTensor) and tok.placements == (Replicate(), Replicate())
    assert torch.equal(tok.to_local(), want_tok) and torch.equal(gate.to_local(), want_gate)


def test_in_place_index_put_keeps_a_trailing_split(fake_mesh, as_torch_2_11):  # noqa: F811
    """``x[rows, cols] = v`` (the VLM stub's patch embeddings) with the
    feature dim split over "model": the port's strategy keeps ``x``'s
    placements, and rank 0's block equals the plain write on its columns."""
    mesh = _mesh(fake_mesh)
    g = torch.Generator().manual_seed(4)
    x, v = torch.randn(4, 8, 6, generator=g), torch.randn(4, 2, 6, generator=g)
    rows, cols = torch.arange(4)[:, None], torch.tensor([[1, 5]] * 4)
    pl = (Replicate(), Shard(2))
    dx = _put(x, mesh, pl)
    with mesh_ops():
        dx[_put(rows, mesh, (Replicate(),) * 2), _put(cols, mesh, (Replicate(),) * 2)] = _put(v, mesh, pl)
    want = x.clone()
    want[rows, cols] = v
    assert dx.placements == pl and torch.equal(dx.to_local(), want[..., :3])


def test_index_put_gathers_values_split_on_an_indexed_dim(fake_mesh, as_torch_2_11):  # noqa: F811
    """The gradient of MoE's gather ``x_pad[slot_tok]``: an accumulating
    ``index_put`` whose values are split over the indexed rows (the experts
    over "model"). 2.11's strategy splits ``self`` there too, and the
    write on each rank's block then refuses; the port's gathers the values
    and keeps ``self`` whole."""
    mesh = _mesh(fake_mesh)
    g = torch.Generator().manual_seed(5)
    x, v, idx = torch.zeros(9, 6), torch.randn(8, 6, generator=g), torch.randint(0, 9, (8,), generator=g)
    whole = (Replicate(),) * 2
    with mesh_ops():
        out = _put(x, mesh, whole).index_put((_put(idx, mesh, whole),), _put(v, mesh, (Replicate(), Shard(0))),
                                             accumulate=True)
    assert out.placements == whole and out.to_local().shape == x.shape


def test_index_add_strategy_places_the_combine():
    """The port's ``index_add`` placements over one mesh dim: everything
    replicated, both partial sums, or a dim other than the indexed one
    split alike in ``self`` and ``source``, the index whole."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Partial

    from repro_torch.dist.sharding import _index_add_strategy

    R, x = Replicate(), SimpleNamespace(shape=(9, 16))
    assert _index_add_strategy(x, 0, None, None) == [([R], [R, None, R, R]), ([Partial()], [Partial(), None, R, Partial()]),
                                                     ([Shard(1)], [Shard(1), None, R, Shard(1)])]
    assert _index_add_strategy(x, -1, None, None)[2] == ([Shard(0)], [Shard(0), None, R, Shard(0)])


def test_moe_combine_with_the_features_split(fake_mesh):  # noqa: F811
    """MoE's combine (an out-of-place ``index_add`` over the slots) with the
    features split over "model": the sum keeps the split, and rank 0's block
    equals the plain combine's on its columns."""
    mesh = _mesh(fake_mesh)
    g = torch.Generator().manual_seed(5)
    weighted, slot_tok = torch.randn(10, 8, generator=g), torch.randint(0, 7, (10,), generator=g)
    pl = (Replicate(), Shard(1))
    with mesh_ops():
        y = _put(torch.zeros(7, 8), mesh, pl).index_add(0, _put(slot_tok, mesh, (Replicate(),) * 2),
                                                        _put(weighted, mesh, pl))
    assert y.placements == pl
    assert torch.equal(y.to_local(), torch.zeros(7, 8).index_add(0, slot_tok, weighted)[:, :4])


# ------------------------------------------------------------- dist.blockwise


@pytest.mark.parametrize("emulate", [False, True])
def test_attention_core_keeps_batch_and_heads_split(emulate, fake_mesh):  # noqa: F811
    """``_sdpa`` with the batch over "data" and the KV heads over "model"
    (torch 2.11's refused case, here also under the emulation): no
    collective, the output keeps both splits, and rank 0's block equals the
    plain op on its rows and heads, bit for bit."""
    from repro_torch.launch.roofline import RankCounter
    from repro_torch.nn.attention import _sdpa, causal_window_mask

    mesh = _mesh(fake_mesh)
    g = torch.Generator().manual_seed(6)
    q, k, v = torch.randn(4, 8, 2, 2, 16, generator=g), torch.randn(4, 8, 2, 16, generator=g), torch.randn(
        4, 8, 2, 16, generator=g)
    pos = torch.arange(8)[None]
    mask = causal_window_mask(pos, pos)[:, None]
    pq, pk = (Shard(0), Shard(2)), (Shard(0), Shard(2))
    with emulated_2_11() if emulate else contextlib.nullcontext(), mesh_ops(), RankCounter() as counter:
        out = _sdpa(_put(q, mesh, pq), _put(k, mesh, pk), _put(v, mesh, pk), mask, 0.25, softcap=30.0)
    assert sum(counter.collective_counts.values()) == 0
    assert out.placements == pq and out.shape == q.shape
    assert torch.equal(out.to_local(), _sdpa(q[:2, :, :1], k[:2, :, :1], v[:2, :, :1], mask, 0.25, softcap=30.0))


def test_blockwise_takes_dims_that_are_not_free_whole(fake_mesh):  # noqa: F811
    """Keys split over "model" (a dim the softmax reduces) with the batch
    over "data": ``blockwise`` keeps the batch split, gathers the keys
    (one all-gather each for k and v) and runs each block whole."""
    from repro_torch.launch.roofline import RankCounter
    from repro_torch.nn.attention import _sdpa

    mesh = _mesh(fake_mesh)
    q, k = torch.randn(4, 1, 2, 2, 16), torch.randn(4, 8, 2, 16)
    mask = torch.ones(1, 1, 1, 8, dtype=torch.bool)
    with mesh_ops(), RankCounter() as counter:
        out = _sdpa(_put(q, mesh, (Shard(0), Replicate())), _put(k, mesh, (Shard(0), Shard(1))),
                    _put(k, mesh, (Shard(0), Shard(1))), mask, 0.25)
    assert counter.collective_counts["all-gather"] == 2
    assert out.placements == (Shard(0), Replicate()) and out.shape == (4, 1, 2, 2, 16)


def test_blockwise_on_plain_tensors_and_without_a_split_free_dim(fake_mesh):  # noqa: F811
    """On plain tensors ``blockwise`` is ``fn``; over DTensors that split no
    free dim, ``fn`` gets the DTensors as they are."""
    from repro_torch.dist.sharding import blockwise

    seen = []

    def fn(*t):
        seen.append(t)
        return t[0] + 1

    x = torch.zeros(4, 6)
    assert torch.equal(blockwise(fn, "bh->bh", "b", x), x + 1) and seen[-1][0] is x
    mesh = _mesh(fake_mesh)
    dx = _put(x, mesh, (Replicate(), Shard(1)))
    with mesh_ops():
        blockwise(fn, "bh->bh", "b", dx)
    assert seen[-1][0] is dx


# ------------------------------------- bit for bit on plain tensors (parent code)


def _parent_sdpa(q, k, v, mask, scale, softcap=None):
    """The plain arithmetic of the attention core: in each batch row the
    scores one ``bmm`` over the KV heads of a view of ``k``, the output one
    over a view of ``v`` (the einsums these replaced copied k and v whole)."""
    from repro_torch.nn.attention import _mask_bias

    B, Sq, Hk, G, D = q.shape
    scores = torch.stack([torch.bmm(q[b].permute(1, 2, 0, 3).reshape(Hk, G * Sq, D), k[b].permute(1, 2, 0))
                          .view(Hk, G, Sq, -1) for b in range(B)]).float() * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + _mask_bias(mask)[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.stack([torch.bmm(probs[b].reshape(Hk, G * Sq, -1), v[b].transpose(0, 1)).view(Hk, G, Sq, -1)
                        .permute(2, 0, 1, 3) for b in range(B)])


def _parent_mla(q_nope, q_rope, k_nope, k_r, v, mask, scale):
    from repro_torch.nn.attention import _mask_bias

    scores = torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope) + torch.einsum("bqhd,bkd->bhqk", q_rope, k_r)
    scores = scores.float() * scale + _mask_bias(mask)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1).to(v.dtype), v)


def _parent_ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)
    Ch = C_t.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt_t * A)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt_t, Bh, x_t)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


def _inputs(name, g, dtype):
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    mask = torch.rand(2, 1, 6, 6, generator=g) > 0.3
    if name == "sdpa":
        return (r(2, 6, 2, 3, 8), r(2, 6, 2, 8), r(2, 6, 2, 8), mask)
    if name == "mla":
        return (r(2, 6, 3, 8), r(2, 6, 3, 4), r(2, 6, 3, 8), r(2, 6, 4), r(2, 6, 3, 5), mask)
    if name == "ssd_decode":  # the decode step runs in f32 (Mamba2Block.decode)
        return tuple(t.float() for t in (r(2, 6, 4, 3), r(2, 6, 4), F.softplus(r(2, 6)), -torch.rand(6, generator=g),
                                         r(2, 2, 3), r(2, 2, 3)))
    return (r(2, 12, 6, 4), F.softplus(r(2, 12, 6)), -torch.rand(6, generator=g).to(dtype), r(2, 12, 2, 3),
            r(2, 12, 2, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["sdpa", "mla", "ssd_decode", "ssd_scan"])
def test_touched_functions_equal_the_parent_code_bit_for_bit(name, dtype):
    """On plain tensors the attention core, MLA's scores and output, the SSD
    decode step and the SSD scan (groups spread to heads first) give the
    parent code's values and input gradients, bit for bit."""
    from repro_torch.nn import attention, ssm

    new, old = {
        "sdpa": (lambda *t: attention._sdpa(*t, 0.3, softcap=20.0), lambda *t: _parent_sdpa(*t, 0.3, softcap=20.0)),
        "mla": (lambda *t: attention._mla_block(*t, 0.3), lambda *t: _parent_mla(*t, 0.3)),
        "ssd_decode": (ssm.ssd_decode_step, _parent_ssd_decode_step),
        "ssd_scan": (lambda *t: ssm._scan_blocks(*t, chunk=4, return_state=True),
                     lambda *t: ssm.ssd_chunked(*t, chunk=4, return_state=True)),
    }[name]
    base = _inputs(name, torch.Generator().manual_seed(7), dtype)
    grads = []
    outs = []
    for f in (new, old):
        args = [t.clone().requires_grad_(t.is_floating_point()) for t in base]
        out = f(*args)
        out = out if isinstance(out, tuple) else (out,)
        sum((o.float() * (i + 1)).sum() for i, o in enumerate(out)).backward()
        outs.append(out)
        grads.append([a.grad for a in args if a.requires_grad])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------- the decode's slot write and the VLM's patch write


def _parent_write_slot(cache, new, slot):
    """The parent code's slot write: an item assignment into a clone."""
    out = cache.clone()
    out[:, slot] = new[:, 0].to(out.dtype)
    return out


def _attention(kind):
    from repro_torch.nn.attention import Attention, MLAAttention

    if kind == "mla":
        return MLAAttention(d_model=16, n_q=2, kv_lora=8, qk_nope_dim=4, qk_rope_dim=4, v_head_dim=4)
    return Attention(d_model=16, n_q=4, n_kv=2, head_dim=8, softcap=20.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,S,window", [("ring", 4, None), ("ring", 6, 3), ("window_1", 1, 1),
                                           ("mla", 4, None)])
def test_decode_equals_the_parent_slot_write_bit_for_bit(kind, S, window, dtype, monkeypatch):
    """``Attention.decode`` past its cache length (the ring buffer wraps;
    a windowed ring; the window-1 cache) and ``MLAAttention.decode`` past
    it (the write clamps to the last slot), from a random cache in
    ``dtype``: each step's output and cache equal those of the parent
    code's item assignment into a clone, bit for bit, and the cache
    returned is the one given, written in place."""
    from repro_torch.nn import attention

    mod = _attention(kind)
    g = torch.Generator().manual_seed(8)
    p = mod.init(torch.Generator().manual_seed(0))
    xs = torch.randn(S + 3, 2, 1, 16, generator=g)
    start = tree_map(lambda t: torch.randn(t.shape, generator=g).to(dtype), mod.init_cache(2, S, dtype))
    runs = []
    for write in (attention._write_slot, _parent_write_slot):
        monkeypatch.setattr(attention, "_write_slot", write)
        cache, outs = tree_map(torch.clone, start), []
        for t in range(S + 3):
            y, new = mod.decode(p, xs[t], cache, t, window=window)
            in_place = all(a is b for a, b in zip(tree_leaves(new), tree_leaves(cache), strict=True))
            assert in_place == (write is not _parent_write_slot)
            cache = new
            outs += [y, *map(torch.clone, tree_leaves(new))]
        runs.append(outs)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_write_equals_the_parent_code_bit_for_bit(dtype):
    """qwen2-vl's patch embeddings written into the sequence, with a
    position written twice in a row: the embeddings and the gradients of
    the table and the patches equal the parent code's in-place write, bit
    for bit (the later patch kept, as before)."""
    import dataclasses

    from repro_torch.configs import build_model, get_arch
    from repro_torch.nn.embed import Embedding

    model = build_model(dataclasses.replace(get_arch("qwen2_vl_7b").smoke, act_dtype=dtype))
    c = model.cfg
    g = torch.Generator().manual_seed(9)
    table = model.init(torch.Generator().manual_seed(0))["embed"]
    tokens = torch.randint(0, c.vocab, (2, 8), generator=g)
    patches = torch.randn(2, 3, c.d_model, generator=g)
    pos = torch.tensor([[1, 5, 1], [0, 7, 3]], dtype=torch.int32)
    grad = torch.randn(2, 8, c.d_model, generator=g).to(dtype)

    def parent(p, extra):
        x = Embedding(c.vocab, c.d_model, scale_by_sqrt_d=c.embed_scale)(p, tokens).to(c.act_dtype)
        x = x.clone()
        x[torch.arange(2)[:, None], pos.long()] = extra.to(c.act_dtype)
        return x

    runs = []
    for f in (lambda p, extra: model._embed({"embed": p}, tokens, extra, pos), parent):
        p, extra = tree_map(lambda t: t.clone().requires_grad_(), table), patches.clone().requires_grad_()
        x = f(p, extra)
        (x.float() * grad.float()).sum().backward()
        runs.append([x, extra.grad, *(t.grad for t in tree_leaves(p))])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _parent_write_at_(x, value, dim, index: int):
    """The slot write into a sequence-split DTensor as it was with an int
    index: the rank whose block holds ``index`` writes it, the others
    write nothing (a host branch on the index)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    value = value.redistribute(mesh, [Replicate() if pl.is_shard(dim) else pl for pl in x.placements])
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
    if offset[dim] <= index < offset[dim] + shape[dim]:
        x.to_local().narrow(dim, index - offset[dim], 1).copy_(value.to_local())
    return x


def slot_write_case(mesh, shape, put=_put, seed=10):
    """The decode's slot write (``_write_slot``, through ``dist.write_at_``)
    into a cache of ``shape`` split on the sequence over every mesh dim but
    the last and over the last on the KV heads, where it has them (the
    batch-1 layout), at each slot of the sequence with a 0-d int32 index,
    plain and as a replicated DTensor: for each, whether the cache given
    came back with its placements, the collectives counted
    (``RankCounter``) and whether this rank's block equals the int-index
    write's (``_parent_write_at_``), bit for bit. ``put(x, mesh,
    placements)`` places the cache and the new token (``_put`` on the
    fake group; on ranks with data, where ``full`` also holds the whole
    cache gathered against the parent code's item assignment)."""
    from repro_torch.launch.roofline import RankCounter
    from repro_torch.nn.attention import _write_slot

    g = torch.Generator().manual_seed(seed)
    cache, new = torch.randn(*shape, generator=g), torch.randn(1, 1, *shape[2:], generator=g)
    split = Shard(2) if len(shape) == 4 else Replicate()
    pl = (Shard(1),) * (mesh.ndim - 1) + (split,)
    new_pl = (Replicate(),) * (mesh.ndim - 1) + (split,)
    rows = []
    for slot in range(shape[1]):
        for kind in ("tensor", "dtensor"):
            index = torch.tensor(slot, dtype=torch.int32)
            if kind == "dtensor":
                index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim, run_check=False)
            given, want = put(cache, mesh, pl), put(cache, mesh, pl)
            with mesh_ops(), RankCounter() as counter:
                out = _write_slot(given, put(new, mesh, new_pl), index)
            with mesh_ops():
                _parent_write_at_(want, put(new, mesh, new_pl), 1, slot)
            rows.append({"slot": slot, "kind": kind, "same": out is given and out.placements == pl,
                         "collectives": sum(counter.collective_counts.values()),
                         "equal": torch.equal(out.to_local(), want.to_local())})
            if put is not _put:
                rows[-1]["full"] = torch.equal(out.full_tensor(), _parent_write_slot(cache, new, slot))
    return rows


@pytest.mark.parametrize("mesh_shape,shape", [((2, 2), (1, 8, 4, 6)), ((2, 2), (1, 8, 6)),
                                              ((2, 2, 2), (1, 8, 4, 6))], ids=["kv", "mla", "kv-pod-and-data"])
def test_slot_write_on_a_sequence_split_cache_as_on_torch_2_11(mesh_shape, shape, fake_mesh,  # noqa: F811
                                                              as_torch_2_11):
    """The decode's slot write into a cache split on the sequence over
    "data" (over "pod" and "data" on the 2 x 2 x 2 group, the batch-1
    layout of the 2 x 16 x 16 mesh) and over "model" on the KV heads, where
    it has them, at every slot with a 0-d int32 index (plain, and a
    replicated DTensor as the dry run's decode cell passes it): the cache
    given comes back, written in place, with its placements, and no
    collective is counted; rank 0's block equals the int-index write's
    (``_parent_write_at_``), bit for bit, and so the parent code's item
    assignment at a slot it holds and its old values at one it does not."""
    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = fake_mesh(mesh_shape, names)
    rows = slot_write_case(mesh, shape)
    assert len(rows) == 2 * shape[1] and all(r["same"] and r["equal"] and not r["collectives"] for r in rows), rows
    g = torch.Generator().manual_seed(10)
    cache, new = torch.randn(*shape, generator=g), torch.randn(1, 1, *shape[2:], generator=g)
    held = shape[1] // (2 ** (len(mesh_shape) - 1))  # rank 0 holds slots [0, held)
    split = Shard(2) if len(shape) == 4 else Replicate()
    for slot in (held - 1, held):
        given = _put(cache, mesh, (Shard(1),) * (len(mesh_shape) - 1) + (split,))
        with mesh_ops():
            out = _parent_write_at_(given, _put(new, mesh, (Replicate(),) * (len(mesh_shape) - 1) + (split,)), 1, slot)
        want = _parent_write_slot(cache, new, slot)[:, :held]
        assert torch.equal(out.to_local(), want[:, :, :2] if len(shape) == 4 else want)


@pytest.mark.parametrize("family", ["lm", "mla", "whisper"])
def test_long_decode_cells_run_as_on_torch_2_11(family, fake_mesh, small_shapes, as_torch_2_11):  # noqa: F811
    """The batch-1 decode cell (caches split over "data" on the sequence)
    of an attention family, MLA and Whisper's decoder on the fake 2 x 2
    group under the emulation: the slot writes place without a refusal."""
    check_cell(_mesh(fake_mesh), family, "long")
