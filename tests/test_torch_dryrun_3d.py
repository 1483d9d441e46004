"""The port's dry-run cells on a fake 2 x 2 x 2 group ("pod", "data",
"model", the multi-pod mesh's dims), each family's smoke config, through
``test_torch_dryrun.check_cell``.

DTensor plans each redistribution on a mesh by a graph search over its
placements, and on a 3-D mesh at smoke widths, where every mesh dim
divides every dim, that search dominates: each family's prefill and
batch-1 decode take seconds here, but the batch-8 decode of gemma2-2b,
qwen2-vl and hymba (caches split over batch and heads) and the train
cells of gemma2-2b, whisper and both DeepSeeks each ran past 5 to 12
minutes on the host. Those are left to the 2 x 2 mesh
(test_torch_dryrun.py) and to the full-size sweep (`launch.dryrun
--both-meshes`); the 3-D mesh runs the rest, and a train cell of mamba2.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import FAMILIES, check_cell, fake_mesh, small_shapes  # noqa: E402,F401

# (family, kind) on the 3-D mesh, beyond every family's prefill and long decode
EXTRA = [("mla", "decode"), ("mamba2", "train")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family,kind", [(f, k) for f in sorted(FAMILIES) for k in ("prefill", "long")] + EXTRA)
def test_cells_run_on_a_2x2x2_mesh(family, kind, fake_mesh, small_shapes):  # noqa: F811
    check_cell(fake_mesh((2, 2, 2), ("pod", "data", "model")), family, kind)


# ------------------------------------- the multi-pod mesh on every torch version
#
# torch 2.11 (the card's machine) refused ops of the 2 x 16 x 16 cells that
# 2.13 runs: the lookup table[tokens] with the batch over "pod" and "data",
# LayerNorm's var_mean (no strategy), Mamba2's causal pad (a strategy for a
# one-dim mesh) and the SSD scan backward's flip (none). The lookup is
# F.embedding now, and dist.mesh_ops registers strategies for var_mean
# (where a version has none), constant_pad_nd and flip. On the fake group only rank
# 0's block has values, so each op is held where it needs no collective:
# rank 0's block against the plain op on the same rows, bit for bit.

from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.dist import mesh_ops  # noqa: E402

BATCH = (Shard(0), Shard(0), Replicate())  # the batch over "pod" and "data"


def _put(x, mesh, placements):
    """``x`` as a DTensor whose rank-0 block holds ``x``'s values there."""
    from torch.distributed.tensor import distribute_tensor

    local = distribute_tensor(x, mesh, placements, src_data_rank=None).to_local().shape
    block = x[tuple(slice(0, n) for n in local)].clone()
    return DTensor.from_local(block, mesh, placements, run_check=False, shape=x.shape, stride=x.stride())


def _mesh(fake_mesh):  # noqa: F811
    return fake_mesh((2, 2, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_is_table_index_bit_for_bit_on_plain_tensors(dtype):
    """``Embedding`` is ``F.embedding``: on plain tensors its rows and its
    table gradient equal ``table[tokens]``'s bit for bit (repeated tokens
    summed in the same order here, on the CPU)."""
    from repro_torch.nn.embed import Embedding

    g = torch.Generator().manual_seed(0)
    emb = Embedding(50, 16, scale_by_sqrt_d=True)
    table = torch.randn(50, 16, generator=g).to(dtype)
    tokens = torch.randint(0, 50, (4, 64), generator=g, dtype=torch.int32)
    grad = torch.randn(4, 64, 16, generator=g).to(dtype)
    a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
    got = emb({"table": a}, tokens)
    want = b[tokens] * b.new_tensor(16**0.5)
    assert torch.equal(got, want)
    (got * grad).sum().backward()
    (want * grad).sum().backward()
    assert torch.equal(a.grad, b.grad)


def test_lookup_with_the_batch_over_pod_and_data(fake_mesh):  # noqa: F811
    """The lookup with the tokens split over "pod" and "data" (torch 2.11's
    ``aten.index`` refused it): the rows and the table's gradient keep the
    batch's split, and rank 0's block equals the plain lookup of its rows
    and their gradient, bit for bit."""
    from repro_torch.nn.embed import Embedding

    mesh = _mesh(fake_mesh)
    g = torch.Generator().manual_seed(1)
    table = torch.randn(64, 8, generator=g)
    tokens = torch.randint(0, 64, (8, 16), generator=g, dtype=torch.int32)
    grad = torch.randn(8, 16, 8, generator=g)
    t = _put(table, mesh, (Replicate(),) * 3).requires_grad_()
    with mesh_ops():
        x = Embedding(64, 8)({"table": t}, _put(tokens, mesh, BATCH))
        (x * _put(grad, mesh, BATCH)).sum().backward()
    assert x.placements == BATCH and x.shape == (8, 16, 8)
    plain = table.clone().requires_grad_()
    want = plain[tokens[:2]]
    (want * grad[:2]).sum().backward()
    assert torch.equal(x.to_local(), want)
    assert torch.equal(t.grad.to_local(), plain.grad)


@pytest.mark.parametrize("table_placements", [(Replicate(), Shard(0), Replicate()), (Replicate(), Shard(0), Shard(0))])
def test_lookup_from_a_vocab_sharded_table(table_placements, fake_mesh):  # noqa: F811
    """A table split over the vocab (FSDP training) and tokens whole along
    that split (micro-batches sliced from the batch): DTensor's lookup gives
    a masked partial sum with one mask per splitting mesh dim, which it
    refuses as conflicting where two dims split the vocab, and releases at
    the first reduction. The lookup splits the vocab over one mesh dim and
    reduces the partial sum where it is made, so a remat block over the
    rows (a residual beside a norm, recomputed in the backward) and the
    backward run, and the partial sum's gradient goes back replicated."""
    from repro_torch.dist.sharding import reduce_partials
    from repro_torch.nn.embed import Embedding
    from repro_torch.nn.norm import RMSNorm

    mesh = _mesh(fake_mesh)
    t = _put(torch.randn(64, 8), mesh, table_placements).requires_grad_()
    tokens = _put(torch.randint(0, 64, (8, 16), dtype=torch.int32), mesh, (Shard(0), Replicate(), Replicate()))

    def block(x):
        return x + RMSNorm(8)({"scale": torch.ones(8)}, x)

    with mesh_ops():
        x = Embedding(64, 8)({"table": t}, tokens)
        y = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)  # remat: the block runs twice
        y.sum().backward()
    assert not any(pl.is_partial() for pl in x.placements) and y.shape == (8, 16, 8)
    assert isinstance(t.grad, DTensor) and t.grad.shape == t.shape
    plain = torch.zeros(2, 3)
    assert reduce_partials(plain) is plain


@pytest.fixture(params=["version's", "port's"])
def var_mean_strategy(request):
    """The ``var_mean`` strategy the LayerNorm tests run under: this torch
    version's own, and the port's (``dist.mesh_ops`` registers it where a
    version has none, as torch 2.11), swapped in for the test."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    from repro_torch.dist.sharding import _register, _var_mean_strategy

    if request.param == "version's":
        yield
        return
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.var_mean.correction
    with mesh_ops():  # the other registrations first: they run once
        pass
    saved = prop.op_strategy_funcs.get(op), prop.op_to_schema_info.get(op)
    _register(op, _var_mean_strategy, RuntimeSchemaInfo(1, ["keepdim"], needs_pytree=True))
    _clear_placement_caches(prop)
    yield
    for table, entry in zip((prop.op_strategy_funcs, prop.op_to_schema_info), saved):
        if entry is None:
            table.pop(op, None)
        else:
            table[op] = entry
    _clear_placement_caches(prop)


def _clear_placement_caches(prop):
    """DTensor's cached placements: the propagator's, and the native fast
    path's where the torch version has one."""
    prop.propagate_op_sharding.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:
        native()


def test_var_mean_strategy_places_the_statistics():
    """The port's ``var_mean`` placements over one mesh dim: everything
    replicated, or one unreduced dim sharded in the input and the
    statistics (renumbered without ``keepdim``)."""
    from types import SimpleNamespace

    from repro_torch.dist.sharding import _var_mean_strategy

    x = SimpleNamespace(shape=(8, 4, 16))
    R = Replicate()
    assert _var_mean_strategy(x, (1,)) == [([R, R], [R, None]), ([Shard(0)] * 2, [Shard(0), None]),
                                           ([Shard(1)] * 2, [Shard(2), None])]
    assert _var_mean_strategy(x, [-1], keepdim=True) == [([R, R], [R, None]), ([Shard(0)] * 2, [Shard(0), None]),
                                                         ([Shard(1)] * 2, [Shard(1), None])]
    assert _var_mean_strategy(x) == [([R, R], [R])]


@pytest.mark.parametrize("placements", [BATCH, (Replicate(), Shard(1), Replicate())])
def test_layer_norm_on_the_multi_pod_mesh(placements, fake_mesh, var_mean_strategy):  # noqa: F811
    """LayerNorm under this version's and the port's ``var_mean`` strategy
    (torch 2.11 has none): the output keeps the input's split, which leaves
    the normalised dim whole, and rank 0's block is the plain LayerNorm of
    its rows, bit for bit."""
    from repro_torch.nn.norm import LayerNorm

    mesh = _mesh(fake_mesh)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(8, 4, 16, generator=g)
    p = {"scale": torch.randn(16, generator=g), "bias": torch.randn(16, generator=g)}
    with mesh_ops():
        y = LayerNorm(16)(p, _put(x, mesh, placements))
    assert y.placements == placements
    block = y.to_local()
    assert torch.equal(block, LayerNorm(16)(p, x[tuple(slice(0, n) for n in block.shape)]))


def test_var_mean_strategy_keeps_the_unreduced_splits(fake_mesh, var_mean_strategy):  # noqa: F811
    """The statistics keep the input's split on every dim left whole
    (renumbered without ``keepdim``); a split reduced dim is gathered first."""
    mesh = _mesh(fake_mesh)
    x = torch.randn(8, 4, 16)
    with mesh_ops():
        v, m = torch.var_mean(_put(x, mesh, (Shard(0), Replicate(), Shard(2))), dim=(1,), correction=0)
        kv, km = torch.var_mean(_put(x, mesh, (Shard(0), Replicate(), Shard(2))), dim=-1, keepdim=True,
                                correction=0)
    assert v.shape == m.shape == (8, 16) and v.placements == m.placements == (Shard(0), Replicate(), Shard(1))
    assert kv.shape == km.shape == (8, 4, 1)
    assert not any(isinstance(pl, Shard) and pl.dim == 2 for pl in kv.placements)


@pytest.mark.parametrize("placements", [BATCH, (Shard(0), Shard(0), Shard(2))])
def test_causal_pad_on_the_multi_pod_mesh(placements, fake_mesh):  # noqa: F811
    """Mamba2's causal pad (``F.pad`` of the sequence dim) through the
    registered ``constant_pad_nd`` strategy (torch 2.11's gives one
    placement on any mesh and raised ``IndexError``): the unpadded dims keep
    their split, and rank 0's block is the plain pad of its block, bit for
    bit; a split padded dim is gathered first."""
    import torch.nn.functional as F

    mesh = _mesh(fake_mesh)
    x = torch.randn(8, 16, 12, generator=torch.Generator().manual_seed(3))
    with mesh_ops():
        y = F.pad(_put(x, mesh, placements), (0, 0, 3, 0))
        z = F.pad(_put(x, mesh, (Replicate(), Shard(1), Replicate())), (0, 0, 3, 0))
    assert y.placements == placements and y.shape == (8, 19, 12)
    block = y.to_local()
    assert torch.equal(block, F.pad(x[: block.shape[0], :, : block.shape[2]], (0, 0, 3, 0)))
    assert z.shape == (8, 19, 12) and not any(isinstance(pl, Shard) and pl.dim == 1 for pl in z.placements)


def test_flip_on_the_multi_pod_mesh(fake_mesh):  # noqa: F811
    """``flip`` (the backward of the SSD scan's cumsum) through the
    registered strategy (torch 2.11 has none): the unflipped dims keep
    their split and rank 0's block is the plain flip of its block, bit for
    bit; a split flipped dim is gathered first."""
    mesh = _mesh(fake_mesh)
    x = torch.randn(8, 16, 12, generator=torch.Generator().manual_seed(4))
    with mesh_ops():
        y = torch.flip(_put(x, mesh, BATCH), dims=[-2])
        z = torch.flip(_put(x, mesh, (Replicate(), Shard(1), Replicate())), dims=[1])
    assert y.placements == BATCH and y.shape == x.shape
    block = y.to_local()
    assert torch.equal(block, torch.flip(x[: block.shape[0]], dims=[-2]))
    assert not any(isinstance(pl, Shard) and pl.dim == 1 for pl in z.placements)
