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
shardings (``jax.device_put``), and ``on_mesh`` runs a step over DTensors
(``jax.jit`` with ``in_shardings``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from ..nn.module import axes_map, tree_def, tree_map

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


def to_global(x):
    """A DTensor's whole value as a plain tensor on every rank (a
    collective where it is sharded or partial); any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


@functools.cache
def _register_strategies():
    """Sharding strategies for the ops the models run that DTensor lacks:
    ``searchsorted`` (MoE's sort-based dispatch) on whole, replicated
    inputs, which is where GSPMD computes it too. Every other op without a
    strategy raises."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def searchsorted(sorted_sequence, values, *args, **kwargs):
        return [([Replicate()], [Replicate(), Replicate()])]


def on_mesh(step):
    """``step`` over DTensor trees (``jax.jit`` with ``in_shardings``): the
    plain tensors the model makes for itself (positions, rope tables, masks)
    join the DTensors as replicated values (``implicit_replication``), and
    the returned metrics are whole tensors on every rank. An op that DTensor
    has no sharding strategy for raises."""
    from torch.distributed.tensor.experimental import implicit_replication

    _register_strategies()

    @functools.wraps(step)
    def run(params, opt_state, batch, *args):
        with implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch, *args)
            return params, opt_state, tree_map(to_global, metrics)

    return run
