"""Minimal functional module system (PyTorch counterpart of ``repro.nn.module``).

- A ``Module`` is a frozen dataclass of hyper-parameters exposing
  ``specs() -> dict[str, ParamSpec | Module | list]``.
- ``init(generator)`` materializes the params tree: nested dicts/lists of
  tensors with the same structure and layouts as the JAX package's
  (conv weights ``(kh, kw, Cin, Cout)``).
- ``abstract(dtype)`` is the same tree of ``meta`` tensors: shapes and
  dtypes without storage, so a full-size model is counted without being
  allocated.
- ``axes()`` is the same tree of logical axis names (``ParamSpec.axes``
  tuples: "embed", "mlp", "heads", "vocab", ...), which ``dist.sharding``
  maps onto the mesh.
- ``Stacked(module, n)`` stacks ``n`` copies on a leading layer axis (the
  JAX package scans over it; the port's models loop over ``unstack`` of
  it).
- ``checkpointed(fn, remat, policy)`` is ``jax.checkpoint``'s counterpart
  for a block call under autograd.
- ``from_jax(tree)`` carries a JAX parameter tree (as numpy arrays) over
  unchanged, because ``jax.random`` and ``torch.Generator`` draw different
  numbers from the same seed.

Modules are pure: ``__call__(params, *args)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.utils.checkpoint

# ---------------------------------------------------------------------------
# Initializers: fn(generator, shape, dtype) -> tensor on the generator's device
# ---------------------------------------------------------------------------

InitFn = Callable[[torch.Generator, tuple[int, ...], torch.dtype], torch.Tensor]


def zeros_init() -> InitFn:
    return lambda g, shape, dtype: torch.zeros(shape, dtype=dtype, device=g.device)


def ones_init() -> InitFn:
    return lambda g, shape, dtype: torch.ones(shape, dtype=dtype, device=g.device)


def _normal(g, shape, std, dtype):
    return (torch.randn(shape, generator=g, dtype=torch.float32, device=g.device) * std).to(dtype)


def normal_init(stddev: float = 0.02) -> InitFn:
    return lambda g, shape, dtype: _normal(g, shape, stddev, dtype)


def lecun_init(fan_in_dims: tuple[int, ...] = (-2,)) -> InitFn:
    """Variance-scaling (fan_in) init. ``fan_in_dims`` index shape dims."""

    def f(g, shape, dtype):
        fan_in = math.prod(shape[d] for d in fan_in_dims)
        return _normal(g, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)

    return f


def conv_init() -> InitFn:
    """Fan-in over (kh, kw, cin) for HWIO conv kernels."""

    def f(g, shape, dtype):
        return _normal(g, shape, math.sqrt(2.0 / max(math.prod(shape[:-1]), 1)), dtype)

    return f


# ---------------------------------------------------------------------------
# Param spec + module base
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: InitFn = dataclasses.field(default_factory=lambda: lecun_init())
    dtype: Any = None  # None -> use the dtype passed to Module.init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


class Module:
    """Base class; subclasses are dataclasses implementing specs()/__call__."""

    def specs(self) -> dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def init(
        self, generator: torch.Generator, dtype: torch.dtype = torch.float32, device=None
    ) -> dict[str, Any]:
        """Draw every parameter from ``generator`` (in ``_init_tree``'s
        sorted-key order) and place it on ``device`` (default: the
        generator's device)."""
        tree = _init_tree(self.specs(), generator, dtype)
        return tree if device is None else tree_map(lambda t: t.to(torch.device(device)), tree)

    def axes(self) -> dict[str, Any]:
        """The parameter tree's logical axis names: a tuple per leaf."""
        return _axes_tree(self.specs())

    def abstract(self, dtype: torch.dtype = torch.float32) -> dict[str, Any]:
        """The parameter tree as ``meta`` tensors (``jax.ShapeDtypeStruct``'s
        counterpart): ``param_count`` of it counts a full-size model."""
        return _abstract_tree(self.specs(), dtype)

    def __call__(self, params, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError


def _init_tree(spec: Any, g: torch.Generator, dtype) -> Any:
    if isinstance(spec, ParamSpec):
        return spec.init(g, spec.shape, spec.dtype or dtype)
    if isinstance(spec, Module):
        return spec.init(g, dtype)
    if isinstance(spec, dict):
        return {k: _init_tree(v, g, dtype) for k, v in sorted(spec.items())}
    if isinstance(spec, (list, tuple)):
        return [_init_tree(v, g, dtype) for v in spec]
    raise TypeError(f"bad spec: {type(spec)}")


def _axes_tree(spec: Any) -> Any:
    if isinstance(spec, ParamSpec):
        return spec.axes
    if isinstance(spec, Module):
        return spec.axes()
    if isinstance(spec, dict):
        return {k: _axes_tree(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [_axes_tree(v) for v in spec]
    raise TypeError(f"bad spec: {type(spec)}")


def axes_map(fn, axes_tree, *rest):
    """``fn`` over the leaves of an ``axes()`` tree (a tuple of names, or
    None, is a leaf) and the trees of its structure in ``rest``."""
    if axes_tree is None or isinstance(axes_tree, tuple):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: axes_map(fn, axes_tree[k], *(r[k] for r in rest)) for k in axes_tree}
    return [axes_map(fn, *xs) for xs in zip(axes_tree, *rest)]


def _abstract_tree(spec: Any, dtype) -> Any:
    if isinstance(spec, ParamSpec):
        return torch.empty(spec.shape, dtype=spec.dtype or dtype, device="meta")
    if isinstance(spec, Module):
        return spec.abstract(dtype)
    if isinstance(spec, dict):
        return {k: _abstract_tree(v, dtype) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return [_abstract_tree(v, dtype) for v in spec]
    raise TypeError(f"bad spec: {type(spec)}")


@dataclasses.dataclass(frozen=True)
class Stacked(Module):
    """``n`` copies of ``inner`` stacked on a leading "layers" axis: params
    come out with shape ``(n, *inner_shape)``, as the JAX package's
    ``Stacked`` gives them, so ``from_jax`` carries them across as they are.
    The parent model loops over the leading axis."""

    inner: Module
    n: int

    def specs(self):
        return {"stack": self}  # sentinel: init and abstract are overridden

    def init(self, generator, dtype=torch.float32, device=None):
        """Draw copy 0, then 1, ... from ``generator`` and stack them."""
        out = tree_stack([self.inner.init(generator, dtype) for _ in range(self.n)])
        return out if device is None else tree_map(lambda t: t.to(torch.device(device)), out)

    def axes(self):
        """The inner axes with "layers" prepended (mapped to no mesh axis)."""
        return axes_map(lambda a: ("layers", *a), self.inner.axes())

    def abstract(self, dtype=torch.float32):
        return tree_map(lambda t: torch.empty((self.n, *t.shape), dtype=t.dtype, device="meta"),
                        self.inner.abstract(dtype))

    def __call__(self, params, *args, **kwargs):
        raise TypeError("Stacked params are consumed layer by layer in the parent model")


def layer(tree, i: int):
    """Layer ``i``'s slice of a ``Stacked`` cache tree: views (a decode
    step writes into them). Parameters go through ``unstack``."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree) -> list:
    """A ``Stacked`` parameter tree as one tree per layer: every leaf split
    once (``unbind``), the per-layer leaves views of it. Under autograd the
    split's backward stacks the layers' gradients into one tensor of the
    leaf's shape, as the JAX package's scan writes layer i's gradient into
    row i; a ``t[i]`` per layer would backpropagate a zero-filled tensor of
    the leaf's full shape for every layer."""
    split = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, list(row)) for row in zip(*split)]


def tree_stack(trees):
    """Trees of one structure -> one tree with a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict/list parameter trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_def(tree):
    """Hashable structure of a tree, leaves elided."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_def(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(tree_def(v) for v in tree))
    return "*"


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    return _fill(tree, iter(leaves))


def _fill(node, it):
    # a module function: a closure that called itself would be a reference
    # cycle holding ``it``, and the leaves (a step's gradients) would live
    # until the garbage collector's next pass
    if isinstance(node, dict):
        filled = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: filled[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, it) for v in node)
    return next(it)


class RowMajorGrad(torch.autograd.Function):
    """The identity, whose gradient is passed back row-major. Over
    DTensors a gradient whose local tensor is laid out otherwise than its
    spec declares (an einsum's backward hands back permuted layouts) makes
    a later view of it fail: the SSD scan's ``dt`` when the sequence is one
    chunk long (the softplus backward keeps the (b, h, s) layout the scan's
    einsums give it), and each block ``dist.blockwise`` hands back. The
    values are unchanged."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def checkpointed(fn: Callable, remat: bool, policy: str = "full") -> Callable:
    """``fn`` under activation checkpointing, as the JAX models wrap a block
    in ``jax.checkpoint`` when their config's ``remat`` is set: its
    activations are dropped after the forward and recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant). Only where autograd
    records (grad mode on and an argument leaf requires grad): otherwise
    ``fn`` runs as it is, so a call under ``torch.no_grad()`` takes the same
    ops and kernels with ``remat`` on or off. ``policy="dots"`` keeps the
    matmul outputs (``aten.mm``/``aten.addmm``) and recomputes the rest, as
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does."""
    if not remat:
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")

    def call(*args, **kwargs):
        leaves = tree_leaves((args, kwargs))
        if not (torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in leaves)):
            return fn(*args, **kwargs)
        extra = {"context_fn": _dots_contexts()} if policy == "dots" else {}
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)

    return call


def _dots_contexts():
    ckpt = torch.utils.checkpoint
    if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
        raise NotImplementedError(
            'remat_policy="dots" needs torch.utils.checkpoint.create_selective_checkpoint_contexts, '
            f"which torch {torch.__version__} lacks"
        )
    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return ckpt.CheckpointPolicy.MUST_SAVE if op in saved else ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(ckpt.create_selective_checkpoint_contexts, policy)


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def cast_tree(params, dtype):
    """The floating leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def from_jax(tree: Any, device=None) -> Any:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) as this package's tree: same
    dict/list structure, same shapes and layouts, same dtypes. bfloat16
    leaves (numpy's ``ml_dtypes`` type) cross through float32, which holds
    every bfloat16 value exactly."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)
