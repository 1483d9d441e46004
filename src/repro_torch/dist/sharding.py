"""Axis-name -> mesh-axis sharding rules (the counterpart of
``repro.dist.sharding``), onto a ``torch.distributed`` ``DeviceMesh``.

Params carry logical axis names (``Module.axes()``: "embed", "mlp",
"heads", "vocab", ...). A *rule table* maps each name to the mesh axes it
may shard over; ``spec_for_axes`` applies the table left-to-right, never
reusing a mesh axis within one param, and ``_fit_spec`` drops proposed
axes that do not divide the actual dimension (kv-head dims of size 1 on a
16-way model axis, ragged vocab remainders, ...).

``PartitionSpec`` and ``NamedSharding`` are this package's counterparts of
``jax.sharding``'s: a spec entry is None, a mesh-axis name or a tuple of
names; a ``NamedSharding`` over a ``DeviceMesh`` with named dims gives the
DTensor's mesh (its dims of more than one rank) and ``placements``
(``Shard(d)`` on each mesh dim that shards tensor dim ``d``, ``Replicate()``
elsewhere). Where one tensor dim is split over two
mesh axes, DTensor orders the blocks by mesh dim and JAX by the spec: the
global values are the same either way. ``device_put`` places a tree by its
shardings (``jax.device_put``), ``abstract_put`` places a tree of ``meta``
tensors without a copy (the dry-run's ``ShapeDtypeStruct``s passed with
``in_shardings``), ``on_mesh`` runs a step over DTensors (``jax.jit`` with
``in_shardings``), ``constrain`` is the models' activation constraint
(``jax.lax.with_sharding_constraint``) and ``carry`` the layer loops' one
placement of the residual from layer to layer (a ``lax.scan`` carry's one
sharding; ``to_residual`` keeps it through a decode block's adds).
``cache_shardings`` places the
decode caches, ``blockwise`` runs an op whose batch-like dims are
independent on each rank's block of them (the attention core, the SSD scan
and its decode step) and ``write_at_`` is the donated decode's slot write
(``dynamic_update_slice`` into a donated buffer), made by the rank whose
block holds the slot; the JAX package has no counterpart to hold them
against (GSPMD partitions those ops itself).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import torch

from ..nn.module import RowMajorGrad, axes_map, tree_def, tree_map

# logical param axes that carry the bulk of the bytes: shard these over
# tensor-parallel + data (fsdp) mesh axes when model sharding is on
_BIG_AXES = ("mlp", "vocab")
# axes sharded over the tensor-parallel mesh axis only
_MODEL_AXES = ("heads", "expert", "conv_out")
_MODEL_MESH_NAMES = ("model", "tensor")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim (None, a
    mesh-axis name, or a tuple of names); trailing dims not listed replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _placed_dims(mesh) -> tuple[str, ...]:
    """The mesh dims a DTensor is placed over: those of more than one rank,
    or all of them where none has (one rank)."""
    names = tuple(n for n, k in _mesh_sizes(mesh).items() if k > 1)
    return names or tuple(mesh.mesh_dim_names)


def _device_mesh(mesh):
    names = _placed_dims(mesh)
    return mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a ``DeviceMesh`` with named dims and
    a ``PartitionSpec`` over those names.

    The DTensor lives on ``device_mesh``: the mesh without its dims of one
    rank (where the mesh has a dim of more than one). DTensor picks among
    equally cheap placements in an order that can differ from process to
    process, and on a dim of one rank every choice is free: ranks of an
    (N, 1) mesh then held one value as ``Partial`` and ``Replicate`` on the
    "model" dim, and issued different collectives at the next reduction."""

    mesh: Any
    spec: PartitionSpec

    @property
    def device_mesh(self):
        return _device_mesh(self.mesh)

    @property
    def placements(self) -> tuple:
        """The DTensor placements over ``device_mesh``'s dims: ``Shard(d)``
        on each dim of more than one rank named in entry ``d`` of the spec,
        ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {name: d for d, entry in enumerate(self.spec) for name in _names(entry)}
        unknown = set(dim_of) - set(self.mesh.mesh_dim_names)
        if unknown:
            raise ValueError(f"spec {self.spec} names {sorted(unknown)}, not dims of mesh {self.mesh.mesh_dim_names}")
        sizes = _mesh_sizes(self.mesh)
        return tuple(Shard(dim_of[n]) if n in dim_of and sizes[n] > 1 else Replicate()
                     for n in _placed_dims(self.mesh))


def default_rules(shard_model: bool, mesh_axes: tuple[str, ...]) -> dict[str, tuple[str, ...] | None]:
    """Rule table for a mesh. Mesh axes named 'model'/'tensor' are
    tensor-parallel; everything else ('data', 'pod', 'fsdp', ...) is
    data-like. Unlisted logical axes replicate."""
    model = tuple(a for a in mesh_axes if a in _MODEL_MESH_NAMES)
    data = tuple(a for a in mesh_axes if a not in _MODEL_MESH_NAMES)
    rules: dict[str, tuple[str, ...] | None] = {"batch": data or None}
    if shard_model:
        for name in _BIG_AXES:
            rules[name] = model + data
        for name in _MODEL_AXES:
            rules[name] = model or None
    return rules


def spec_for_axes(axes, rules) -> PartitionSpec:
    """PartitionSpec for one param's logical axes; a mesh axis is consumed
    by the first logical axis that claims it."""
    used: set[str] = set()
    out = []
    for a in axes or ():
        m = rules.get(a) if a is not None else None
        if m is None:
            out.append(None)
            continue
        m = (m,) if isinstance(m, str) else tuple(m)
        m = tuple(x for x in m if x not in used)
        used.update(m)
        out.append(m if len(m) > 1 else (m[0] if m else None))
    return P(*out)


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fit_spec(spec, shape, mesh):
    """Drop proposed mesh axes that do not divide the dimension they
    shard (trailing-first), so every sharding is actually placeable."""
    sizes = _mesh_sizes(mesh)
    out = []
    for entry, dim in zip(tuple(spec), shape):
        if entry is None:
            out.append(None)
            continue
        names = _names(entry)
        while names and dim % math.prod(sizes[n] for n in names) != 0:
            names = names[:-1]
        out.append(names if len(names) > 1 else (names[0] if names else None))
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def spec_for_axes_shaped(axes, shape, mesh, rules) -> PartitionSpec:
    return P(*_fit_spec(tuple(spec_for_axes(axes, rules)), shape, mesh))


def tree_shardings(mesh, axes_tree, rules):
    """NamedSharding per param from logical axes alone (no divisibility
    fitting — prefer ``tree_shardings_shaped``)."""
    return axes_map(lambda ax: NamedSharding(mesh, spec_for_axes(ax, rules)), axes_tree)


def tree_shardings_shaped(mesh, axes_tree, shapes_tree, rules):
    """NamedSharding per param, divisibility-fitted against the leaf
    shapes (meta tensors or tensors)."""
    return axes_map(
        lambda ax, sd: NamedSharding(mesh, spec_for_axes_shaped(ax, tuple(sd.shape), mesh, rules)),
        axes_tree,
        shapes_tree,
    )


def batch_sharding(mesh, batch_size: int, rules) -> NamedSharding:
    """Sharding for a batch leaf: leading dim over the data-like axes."""
    fitted = _fit_spec((rules.get("batch"),), (batch_size,), mesh)
    return NamedSharding(mesh, P(*fitted))


def opt_state_shardings(mesh, params_shardings, opt_state):
    """Shardings for an optimizer-state tree, derived from the param
    shardings: any sub-tree structurally identical to the params (AdamW's
    moments, master weights, ...) inherits them; everything else (step
    counters, scalars) replicates."""
    replicated = NamedSharding(mesh, P())
    pstruct = tree_def(params_shardings)

    def branch(sub):
        if tree_def(sub) == pstruct:
            return params_shardings
        return tree_map(lambda _: replicated, sub)

    if isinstance(opt_state, dict):
        return {k: branch(v) for k, v in opt_state.items()}
    return branch(opt_state)


# a decode cache leaf's dims by its key (a stacked leaf has the layer dim
# before them): "batch", "seq", "heads" are placed by ``cache_shardings``
_CACHE_AXES = {
    "k": ("batch", "seq", "heads", None),
    "v": ("batch", "seq", "heads", None),
    "cross_k": ("batch", "seq", "heads", None),
    "cross_v": ("batch", "seq", "heads", None),
    "c_kv": ("batch", "seq", None),
    "k_r": ("batch", "seq", None),
    "conv": ("batch", None, None),
    "ssm": ("batch", "heads", None, None),
}


def _map_named(fn, tree, name=None):
    """``fn(key, leaf)`` over a tree's leaves, ``key`` the innermost dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def cache_shardings(mesh, caches, rules, seq_sharded=False):
    """NamedSharding per leaf of a model's decode caches (``init_caches``'
    tree, stacked or not), by the leaf's key:

    ======================  =======================  ==========================
    leaf                    dims                     spec
    ======================  =======================  ==========================
    k, v, cross_k, cross_v  (B, S, kv heads, D)      (batch, seq, model, None)
    c_kv, k_r (MLA)         (B, S, width)            (batch, seq, None)
    conv (SSM)              (B, d_conv - 1, chans)   (batch, None, None)
    ssm (SSM)               (B, H, P, N)             (batch, model, None, None)
    ======================  =======================  ==========================

    ``batch`` is ``rules["batch"]`` (the data-like dims) and ``seq`` None;
    with ``seq_sharded`` (batch-1 decode: sequence parallelism) ``seq`` is
    ``rules["batch"]`` and ``batch`` None. ``model`` is the mesh's
    tensor-parallel dims. A stacked leaf keeps its leading layer dim whole.
    Every spec is fitted by ``_fit_spec``: a dim that a mesh axis does not
    divide (4 KV heads on a 16-way model axis) drops it."""
    data = rules.get("batch")
    model = tuple(a for a in mesh.mesh_dim_names if a in _MODEL_MESH_NAMES) or None
    dims = {"batch": None if seq_sharded else data, "seq": data if seq_sharded else None, "heads": model}

    def leaf(name, x):
        axes = _CACHE_AXES[name]
        lead = x.ndim - len(axes)
        if lead not in (0, 1):
            raise ValueError(f"cache leaf {name!r} of shape {tuple(x.shape)} is not {axes}, stacked or not")
        spec = (None,) * lead + tuple(dims.get(a) for a in axes)
        return NamedSharding(mesh, P(*_fit_spec(spec, tuple(x.shape), mesh)))

    return _map_named(leaf, caches)


@dataclasses.dataclass(frozen=True)
class TrainShardings:
    """The full sharding plumbing of one train launch."""

    params: Any
    opt_state: Any
    batch: NamedSharding
    rules: dict


def train_shardings(mesh, axes_tree, abstract_params, opt_state, batch_size: int, rules=None):
    """One-call config plumbing for a sharded train launch: divisibility-
    fitted param shardings (``tree_shardings_shaped``), structurally
    derived optimizer-state shardings, and the batch sharding."""
    rules = rules if rules is not None else default_rules(True, mesh.mesh_dim_names)
    psh = tree_shardings_shaped(mesh, axes_tree, abstract_params, rules)
    return TrainShardings(
        params=psh,
        opt_state=opt_state_shardings(mesh, psh, opt_state),
        batch=batch_sharding(mesh, batch_size, rules),
        rules=rules,
    )


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def mesh_index(mesh, entry) -> tuple[int, int]:
    """(index, count) of this rank's block along the mesh dims of a spec
    entry (None, a name or a tuple of names; the first name outermost)."""
    names = _names(entry)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = _mesh_sizes(mesh)
    index = 0
    for n in names:
        index = index * sizes[n] + coords[n]
    return index, math.prod(sizes[n] for n in names)


def local_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the card ``rank % device_count`` (the
    card ``launch.distributed`` binds the rank to), or the CPU. A function of
    the rank alone, so a loader thread finds the same card as the caller."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    import torch.distributed as dist

    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def device_put(tree, shardings):
    """``jax.device_put(tree, shardings)``: each leaf as a DTensor placed by
    its ``NamedSharding`` (one sharding for every leaf, or a tree of them).
    Every rank holds the same values (parameters drawn from one seed, a
    restored checkpoint): ``distribute_tensor`` keeps each rank's blocks of
    them (and broadcasts rank 0's, which are the same). A replicated leaf
    already on its device is placed without a copy: the DTensor holds the
    given tensor, which a donating step then writes into."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, sh):
        x = torch.as_tensor(x).to(local_device(sh.mesh))
        return distribute_tensor(x, sh.device_mesh, sh.placements)

    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: put(x, shardings), tree)
    return tree_map(put, tree, shardings)


def abstract_put(tree, shardings):
    """``jax.device_put``'s counterpart for abstract leaves (shapes and
    dtypes; ``meta`` tensors): each leaf as a DTensor placed by its
    ``NamedSharding`` (one for every leaf, or a tree of them) whose local
    tensor is this rank's block as a ``meta`` tensor, with the leaf's global
    shape and stride. No copy and no collective; nothing is allocated. Every
    placement must divide its dim (shardings fitted by ``_fit_spec`` do)."""
    from torch.distributed.tensor import DTensor, Shard

    def put(x, sh):
        mesh, placements = sh.device_mesh, sh.placements
        local = list(x.shape)
        for i, pl in enumerate(placements):
            if isinstance(pl, Shard):
                if local[pl.dim] % mesh.size(i):
                    raise ValueError(f"{sh.spec} does not divide shape {tuple(x.shape)} on mesh {mesh}")
                local[pl.dim] //= mesh.size(i)
        block = torch.empty(local, dtype=x.dtype, device="meta")
        return DTensor.from_local(block, mesh, placements, run_check=False, shape=x.shape, stride=x.stride())

    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: put(x, shardings), tree)
    return tree_map(put, tree, shardings)


def split_once(x, dim: int):
    """``x`` with its dim ``dim`` split over one mesh dim at most, the
    largest of those that split it (the first of equals); any other value
    as it is. DTensor's masked lookups (an embedding from a vocab-sharded
    table, the gather of the gold logit from vocab-sharded logits) give
    the result one masked partial per mesh dim that splits the vocab, all
    sharing one mask, and refuse a second mask as conflicting."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    split = [i for i, pl in enumerate(x.placements) if isinstance(pl, Shard) and pl.dim == dim % x.ndim]
    if len(split) < 2:
        return x
    keep = max(split, key=mesh.size)
    return x.redistribute(mesh, [Replicate() if i in split and i != keep else pl for i, pl in enumerate(x.placements)])


class _Carry(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, its partial placements
    reduced there (all-reduced to ``Replicate()``, reduce-scattered to a
    ``Shard``). The gradient of a sum over ranks is the whole gradient on
    every rank: it goes back replicated on those dims (DTensor's own
    backward of the redistribution would turn it into the masked partial,
    which it cannot), and as it comes on the others."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.partial = [pl.is_partial() for pl in x.placements]
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        return g.redistribute(g.device_mesh, [Replicate() if partial else gp
                                              for partial, gp in zip(ctx.partial, g.placements)]), None


def reduce_partials(x):
    """A DTensor with its partial placements reduced (``Replicate()``
    there); any other value as it is. An embedding lookup from a
    vocab-sharded table gives a masked partial sum whose mask every tensor
    computed from it shares, and DTensor releases the mask at the first
    reduction: a second use of the lookup (the residual beside the norm,
    remat's recompute) then has none. Reduced where it is made, it is
    reduced once."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(pl.is_partial() for pl in x.placements):
        return x
    return _Carry.apply(x, tuple(Replicate() if pl.is_partial() else pl for pl in x.placements))


def carry_placements(x):
    """The placements a layer loop carries its residual ``x`` (the
    embedding's output, ``(..., hidden)``) in, from layer to layer, as a
    ``jax.lax.scan``'s carry has one sharding for every iteration: whole on
    the tensor-parallel dims ("model", "tensor"), a layer's partial sum
    all-reduced there; on the others what ``x`` has there (the batch's
    split), whole where ``x`` is partial or split on the hidden dim. None
    for a plain tensor; a dim of one rank is ``Replicate()``. (Split on the
    hidden dim over "model", the residual moved more collective bytes in
    every dry-run decode cell: PERF.md §6.)"""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return None
    mesh, hidden = x.device_mesh, x.ndim - 1
    return tuple(pl if mesh.size(m) > 1 and name not in _MODEL_MESH_NAMES and pl.is_shard() and pl.dim != hidden
                 else Replicate() for m, (name, pl) in enumerate(zip(mesh.mesh_dim_names, x.placements)))


def to_residual(h, x):
    """``h`` (a block's attention, mixer or feed-forward output, a partial
    sum where its last projection contracts a split dim) at the placements
    of the residual ``x`` it is added to (``carry``), so that the residual
    keeps the loop's carry placement through the layer and the add leaves
    DTensor's strategies nothing to choose. ``h`` itself where either is a
    plain tensor or ``x`` is partial."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or any(pl.is_partial() for pl in x.placements):
        return h
    return carry(h, tuple(x.placements))


def carry(x, placements):
    """The layer loop's residual ``x`` at its carry ``placements``
    (``carry_placements``): applied after the embedding and after every
    layer, so each layer's input has one placement, as the JAX package's
    ``lax.scan`` carry has, and a partial sum a layer leaves is reduced
    once, where it is made (all-reduced or reduce-scattered, ``_Carry``).
    ``x`` itself, with no dispatch, where it is a plain tensor,
    ``placements`` is None, or it is at those placements already."""
    from torch.distributed.tensor import DTensor

    if placements is None or not isinstance(x, DTensor) or tuple(x.placements) == placements:
        return x
    return _Carry.apply(x, placements)


def to_global(x):
    """A DTensor's whole value as a plain tensor on every rank (a
    collective where it is sharded or partial); any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def blockwise(fn, labels: str, free: str, *args):
    """``fn(*args)`` where the dims labelled in ``free`` are independent:
    over DTensors, each rank runs ``fn`` on its own block of them, with
    every other dim whole (``local_map``). ``labels`` names each dim of
    each tensor as einsum does (``"bqhgd,bkhd->bqhgd"``; a comma between
    several outputs); every output carries every free label.

    Each mesh dim keeps split the first free label an argument splits over
    it, where the blocks stay even; the arguments are redistributed to
    those placements (a size-1 broadcast dim, and a plain tensor's blocks,
    taken whole), and the outputs come back as DTensors with the same
    placements. An argument's gradient is partial over a mesh dim whose
    kept label it does not carry whole: each rank's block adds its part
    (``A`` of the SSD scan when the batch is split, MLA's shared RoPE key
    when the heads are). Where no argument splits a free label, and on
    plain tensors, ``fn`` runs on its arguments as they are. DTensor lowers
    an einsum to ``bmm`` by viewing its batch-like dims into one, and some
    torch versions (2.11) refuse that view where a dim other than the first
    of them is split; ``fn``'s own arithmetic on each block is that of the
    plain op."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    ins, outs = (side.split(",") for side in labels.split("->"))
    sizes: dict[str, int] = {}
    for a, lab in zip(args, ins):
        for name, n in zip(lab, a.shape):
            sizes[name] = max(sizes.get(name, 1), n)
    keep, blocks = [], {}
    for m in range(mesh.ndim):
        split = [lab[a.placements[m].dim] for a, lab in zip(args, ins)
                 if isinstance(a, DTensor) and a.placements[m].is_shard()]
        name = next((s for s in split if s in free), None)
        if name is not None and sizes[name] % (blocks.get(name, 1) * mesh.size(m)):
            name = None
        if name is not None:
            blocks[name] = blocks.get(name, 1) * mesh.size(m)
        keep.append(name)
    if not blocks:
        return fn(*args)

    args = [a if isinstance(a, DTensor) else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]
    in_pl = [tuple(Shard(lab.index(k)) if k and k in lab and a.shape[lab.index(k)] == sizes[k] else Replicate()
                   for k in keep) for a, lab in zip(args, ins)]
    grad_pl = [tuple(Partial() if k and not p.is_shard() else p for k, p in zip(keep, pl)) for pl in in_pl]
    out_pl = [[Shard(lab.index(k)) if k else Replicate() for k in keep] for lab in outs]
    return local_map(lambda *t: fn(*(RowMajorGrad.apply(x) for x in t)),
                     out_placements=tuple(out_pl) if len(outs) > 1 else out_pl[0], in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh, redistribute_inputs=True)(*args)


def write_at_(x, value, dim: int, index):
    """``value`` (size 1 on ``dim``) written into ``x`` at ``index`` (a 0-d
    integer tensor on ``x``'s device) of ``dim``, in place:
    ``jax.lax.dynamic_update_slice`` at a traced index into a donated
    buffer. Returns ``x``. Nothing reads ``index`` on the host: a plain
    ``x`` takes an ``index_copy_``. Over a DTensor, ``value`` is
    redistributed to ``x``'s placements with ``dim`` whole, and every rank
    writes into its local block at ``index`` less its block's offset (taken
    over every mesh dim that splits ``dim``), clamped into the block:
    ``value`` where the slot is its own, else the slot's current content,
    so only the rank that holds the slot changes its block; a rank whose
    block holds the whole of ``dim`` (no mesh dim splits it) writes
    ``value`` at ``index`` as the plain ``x`` does. The write adds no
    collective. A partial ``x`` has no block to write into: it raises."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(index, DTensor):
        index = index.to_local()
    index = index.reshape(1).long()
    if not isinstance(x, DTensor):
        return x.index_copy_(dim, index, value)
    if any(pl.is_partial() for pl in x.placements):
        raise ValueError(f"cannot write into a partial DTensor ({x.placements})")
    mesh = x.device_mesh
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    value = value.redistribute(mesh, [Replicate() if pl.is_shard(dim) else pl for pl in x.placements])
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
    if shape[dim] == 0:
        return x
    if shape[dim] == x.shape[dim]:
        x.to_local().index_copy_(dim, index, value.to_local())
        return x
    local, here = x.to_local(), index - offset[dim]
    mine = (here >= 0) & (here < shape[dim])
    here = here.clamp(0, shape[dim] - 1)
    local.index_copy_(dim, here, torch.where(mine, value.to_local(), local.index_select(dim, here)))
    return x


def _register(op, strategy, schema_info=None):
    """``strategy`` (``register_sharding``'s form) as the one DTensor uses
    for ``op`` in this torch version: it replaces the version's own,
    whether that is a whole-mesh strategy or a single-mesh-dim one (which
    DTensor would try first), and ``schema_info`` names the non-tensor
    arguments the cached placements depend on (``register_sharding`` keys
    them on the tensors and int arguments alone)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(op)(strategy)
    prop = DTensor._op_dispatcher.sharding_propagator
    getattr(prop, "op_single_dim_strategy_funcs", {}).pop(op, None)
    if schema_info is not None:
        prop.op_to_schema_info[op] = schema_info


def _searchsorted_strategy(sorted_sequence, values, *args, **kwargs):
    """``searchsorted`` (MoE's sort-based dispatch) on whole, replicated
    inputs, which is where GSPMD computes it too."""
    from torch.distributed.tensor import Replicate

    return [([Replicate()], [Replicate(), Replicate()])]


def _var_mean_strategy(x, *args, keepdim=False, **kwargs):
    """``var_mean`` (the norms' statistics): the reduced dims whole, any
    other dim sharded or replicated, the statistics placed as their input
    (renumbered without ``keepdim``)."""
    from torch.distributed.tensor import Replicate, Shard

    ndim = len(x.shape)
    dims = args[0] if args else kwargs.get("dim")
    reduced = set(range(ndim)) if dims is None else {d % ndim for d in dims}
    rest = [None] * len(args)
    out = [([Replicate(), Replicate()], [Replicate(), *rest])]
    for d in sorted(set(range(ndim)) - reduced):
        o = d if keepdim else d - sum(r < d for r in reduced)
        out.append(([Shard(o), Shard(o)], [Shard(d), *rest]))
    return out


def _index_add_strategy(x, dim, index, source, *args, **kwargs):
    """``index_add`` (MoE's combine): the index whole; ``self`` and
    ``source`` replicated, split alike on a dim other than ``dim``, or both
    partial sums (the op is linear in them)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dim %= len(x.shape)
    rest = [None] * len(args)
    out = [([Replicate()], [Replicate(), None, Replicate(), Replicate(), *rest]),
           ([Partial()], [Partial(), None, Replicate(), Partial(), *rest])]
    return out + [([Shard(d)], [Shard(d), None, Replicate(), Shard(d), *rest]) for d in range(len(x.shape)) if d != dim]


def _constant_pad_nd_strategy(x, pad, *args):
    """``constant_pad_nd`` (Mamba2's causal conv): the padded dims whole,
    any other dim sharded or replicated."""
    from torch.distributed.tensor import Replicate, Shard

    ndim = len(x.shape)
    padded = {ndim - 1 - i for i in range(len(pad) // 2) if pad[2 * i] or pad[2 * i + 1]}
    rest = [None] * (1 + len(args))
    return [([Replicate()], [Replicate(), *rest])] + [
        ([Shard(d)], [Shard(d), *rest]) for d in range(ndim) if d not in padded
    ]


def _flip_strategy(x, dims):
    """``flip`` (the backward of the SSD scan's ``cumsum``): the flipped dims
    whole, any other dim sharded or replicated."""
    from torch.distributed.tensor import Replicate, Shard

    ndim = len(x.shape)
    flipped = {d % ndim for d in dims}
    return [([Replicate()], [Replicate(), None])] + [
        ([Shard(d)], [Shard(d), None]) for d in range(ndim) if d not in flipped
    ]


def _index_put_strategy(op_schema):
    """``index_put`` and ``index_put_`` (MoE's dispatch, a VLM's patch
    embeddings written into the sequence): the indices whole; ``self`` and
    ``values`` split alike on the dims after the indexed ones (``values``'
    trailing dims, where they are not broadcast), whole elsewhere. One
    strategy follows ``self``'s placements, one ``values``'; ``self``'s
    first, which an in-place write keeps."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    dst, indices, values = op_schema.args_schema[:3]
    mesh = dst.mesh
    d_spec, v_spec = dst.strategies[0].output_spec, values.strategies[0].output_spec
    d_shape, v_shape = d_spec.tensor_meta.shape, v_spec.tensor_meta.shape
    offset = len(d_shape) - len(v_shape)  # self's dim d is values' dim d - offset
    first = len(indices.children)  # self's dims from here on are not indexed

    def trailing(d):
        return d >= max(first, offset) and d_shape[d] == v_shape[d - offset]

    def spec(strategy, placements):
        return DTensorSpec(mesh, tuple(placements), tensor_meta=strategy.strategies[0].output_spec.tensor_meta)

    whole = [Replicate()] * mesh.ndim
    idx_specs = [spec(c, whole) for c in indices.children]
    out = OpStrategy([])
    for exemplar, shift in ((d_spec, 0), (v_spec, offset)):
        d_pl = [Shard(p.dim + shift) if p.is_shard() and trailing(p.dim + shift) else Replicate()
                for p in exemplar.placements]
        v_pl = [Shard(p.dim - offset) if p.is_shard() else p for p in d_pl]
        d_new, v_new = spec(dst, d_pl), spec(values, v_pl)
        out.strategies.append(OpSpec(
            output_specs=d_new, input_specs=(d_new, *idx_specs, v_new),
            redistribute_cost=[generate_redistribute_costs(dst, d_new),
                               *[generate_redistribute_costs(c, s) for c, s in zip(indices.children, idx_specs)],
                               generate_redistribute_costs(values, v_new)]))
    return out


def _has_strategy(prop, op):
    return op in prop.op_strategy_funcs or op in getattr(prop, "op_single_dim_strategy_funcs", {})


@functools.cache
def _register_strategies():
    """Sharding strategies for the ops the models run where DTensor has none
    or a wrong one in some torch version:
    - ``searchsorted``, ``constant_pad_nd``, ``flip`` and ``index_add``,
      the same in every version (torch 2.11's pad strategy gives one
      placement whatever the mesh's dims, and its redistribution raises
      ``IndexError`` on a mesh of two or more; 2.11 has no ``flip``
      strategy; neither version has one for ``index_add``, and the one
      2.11 derives from its decomposition keeps ``source`` split on the
      indexed dim while the index is whole);
    - ``var_mean`` where the version has none (2.11). A version's own is
      kept: 2.13's follows the strided shards of a 3-D mesh, which this one
      gathers, and with this one whisper-small's ``train_4k`` cell on 2 x
      16 x 16 ran over 15 minutes on the host instead of about one;
    - ``index_put`` and ``index_put_`` where the version has no
      single-dim strategy (2.13's kept): 2.11 has none for ``index_put_``,
      and its ``index_put`` strategy takes ``values``' leading dims for
      the indexed ones, so it splits ``self`` on an indexed dim where
      ``values`` is split there (the gradient of MoE's gather
      ``x_pad[slot_tok]`` with the experts over "model").
    Every other op without a strategy raises."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    prop = DTensor._op_dispatcher.sharding_propagator
    var_mean = torch.ops.aten.var_mean.correction
    _register(torch.ops.aten.searchsorted.Tensor, _searchsorted_strategy)
    if not _has_strategy(prop, var_mean):
        _register(var_mean, _var_mean_strategy, RuntimeSchemaInfo(1, ["keepdim"], needs_pytree=True))
    for op in (torch.ops.aten.index_put.default, torch.ops.aten.index_put_.default):
        if op not in getattr(prop, "op_single_dim_strategy_funcs", {}):
            prop.register_op_strategy(op, _index_put_strategy, RuntimeSchemaInfo(needs_pytree=True))
    _register(torch.ops.aten.constant_pad_nd.default, _constant_pad_nd_strategy, RuntimeSchemaInfo(1))
    _register(torch.ops.aten.index_add.default, _index_add_strategy)
    _register(torch.ops.aten.flip.default, _flip_strategy, RuntimeSchemaInfo(1))


@contextlib.contextmanager
def mesh_ops():
    """The models' ops over DTensors: the plain tensors a model makes for
    itself (positions, rope tables, masks) join the DTensors as replicated
    values (``implicit_replication``), and the ops DTensor lacks have their
    strategies. An op that DTensor has no sharding strategy for raises.
    Inside another ``mesh_ops`` it leaves the outer one's replication on
    when it exits, where ``implicit_replication`` would turn it off (a
    captured decode step enters its own under its caller's)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    _register_strategies()
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with implicit_replication():
        yield


def on_mesh(step):
    """``step`` over DTensor trees (``jax.jit`` with ``in_shardings``), its
    ops under ``mesh_ops``; the returned metrics are whole tensors on every
    rank (outside a captured step's graph). A step's ``graphs`` stay
    readable on the result, and its ``eager`` is put on the mesh too."""

    @functools.wraps(step)
    def run(params, opt_state, batch, *args):
        with mesh_ops():
            params, opt_state, metrics = step(params, opt_state, batch, *args)
            return params, opt_state, tree_map(to_global, metrics)

    if hasattr(step, "eager"):
        run.eager = on_mesh(step.eager)
    return run


def constrain(x, act_spec):
    """``jax.lax.with_sharding_constraint(x, P(tuple(act_spec)))`` for an
    activation: a DTensor's leading (batch) dim redistributed over the
    ``act_spec`` dims its mesh carries, its other dims replicated. The
    identity on a plain tensor, when ``act_spec`` is None, when the mesh
    carries none of those names, and on a one-rank mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if act_spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = set(act_spec) & set(mesh.mesh_dim_names)
    if not names or mesh.size() == 1:
        return x
    return x.redistribute(mesh, tuple(Shard(0) if n in names else Replicate() for n in mesh.mesh_dim_names))
