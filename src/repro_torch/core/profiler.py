"""Per-layer dry-run profiler — the trtexec analogue.

Re-derives ``LayerMeta.flops`` / ``bytes_accessed`` by running each compute
layer's ops on meta tensors (shapes and dtypes, no allocation) and counting
what they do: flops from ``torch.utils.flop_counter.FlopCounterMode`` for
convolutions plus this module's own count for elementwise, transcendental
and pool ops (``_ELEMENTWISE_OPS``), bytes as the operand plus result bytes
of every op that moves data (a view moves none; an operand passed twice is
read once). Fused blocks (``_fused_cost``, ``_sppf_cost``) count their
bytes once per block: the block's inputs and its output, what the fused
kernels move. Nothing is timed. The scheduler can then plan against
counted costs instead of the layer graphs' analytic estimates.

The counts follow the JAX package's ``core.profiler``, which reads them
from XLA's ``cost_analysis``; where XLA counts otherwise (constant folding,
f32 upcasts of bf16 on its CPU backend, unfused epilogues) the two differ,
kind by kind, as ``tests/test_torch_cost_model.py`` records.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .graph import LayerGraph

aten = torch.ops.aten

# operations per output element of the elementwise, transcendental and pool
# ops the stand-ins below run (convolutions are FlopCounterMode's); pools
# count window - 1 maxes per output (``_pool_ops``)
_ELEMENTWISE_OPS = {
    aten.add: 1, aten.sub: 1, aten.mul: 1, aten.div: 1, aten.maximum: 1, aten.minimum: 1,
    aten.relu: 1, aten.neg: 1, aten.addcmul: 2,
    aten.leaky_relu: 3,  # compare, multiply, select
    aten.tanh: 1, aten.sigmoid: 1, aten.exp: 1,  # one transcendental each
    aten.silu: 2,  # a sigmoid and a multiply
}
_POOL_OPS = (aten.max_pool2d, aten.max_pool2d_with_indices)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pool_ops(args) -> int:
    k = args[1] if len(args) > 1 else 1
    kh, kw = (k, k) if isinstance(k, int) else (k[0], k[-1])
    return kh * kw - 1


class _Count(TorchDispatchMode):
    """Counts the bytes every data-moving op reads and writes and the
    elementwise and pool operations (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in (aten.detach, aten.alias):
            return out
        ins = {id(t): t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)}
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if func.overloadpacket is aten.max_pool2d_with_indices:
            outs = outs[:1]  # the indices are a by-product the ports never read
        self.bytes += sum(_nbytes(t) for t in ins.values()) + sum(_nbytes(t) for t in outs)
        per = _ELEMENTWISE_OPS.get(func.overloadpacket)
        if func.overloadpacket in _POOL_OPS:
            per = _pool_ops(args)
        if per is not None and outs:
            self.ops += per * outs[0].numel()
        return out


def _count(fn, *operands) -> tuple[float, float]:
    """(flops, bytes) of ``fn(*operands)`` on meta tensors."""
    with FlopCounterMode(display=False) as fc, _Count() as c:
        fn(*operands)
    return float(fc.get_total_flops() + c.ops), float(c.bytes)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtype(dtype_str: str) -> torch.dtype:
    return getattr(torch, dtype_str)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _elementwise_fn(kind: str):
    """Representative op per non-conv layer kind (the JAX package's
    stand-ins, in torch). All of these are memory-bound elementwise/shuffle
    ops, so one op per kind is enough to replace the analytic estimate."""
    if kind == "act":
        return lambda x: F.leaky_relu(x, 0.2)
    if kind == "tanh":
        return torch.tanh
    if kind in ("bn", "norm"):
        # inference-time normalization is a per-channel affine
        def bn(x):
            c = x.shape[-1]
            g = torch.ones((c,), dtype=x.dtype, device=x.device)
            return torch.addcmul(torch.zeros_like(g), x, g)

        return bn
    if kind == "concat":
        # the graph meta's shape is the concatenated result; concat its two
        # halves along the channel axis
        def cat(x):
            h = x.shape[-1] // 2
            return torch.cat([x[..., :h], x[..., h or 1 :]], dim=-1)

        return cat
    if kind in ("crop", "pad"):
        def crop(x):
            if x.dim() >= 3 and x.shape[1] > 2 and x.shape[2] > 2:
                return x[:, 1:-1, 1:-1, ...].contiguous()
            return x * 1.0

        return crop
    if kind == "pool":
        # 2x2 stride-1 "SAME" max pool (one padded row and column after):
        # pad both sides, drop the leading row and column
        return lambda x: _nhwc(F.max_pool2d(_nchw(x), 2, 1, padding=1)[:, :, 1:, 1:])
    if kind == "dropout":
        return lambda x: x * 1.0  # inference passthrough
    if kind == "add":
        return lambda x: x + x  # residual merge
    return None


ELEMENTWISE_KINDS = ("act", "tanh", "bn", "norm", "concat", "crop", "pad", "pool", "dropout", "add")


@functools.lru_cache(maxsize=2048)
def _elementwise_cost(kind, in_shape, dtype_str):
    """Counted (flops, bytes) for one elementwise-ish layer (transcendentals
    count as flops)."""
    fn = _elementwise_fn(kind)
    if fn is None:
        return 0.0, 0.0
    return _count(fn, _meta(in_shape, _dtype(dtype_str)))


def _conv(x, w, kernel, stride, padding, transposed):
    """The port's conv/deconv on NHWC x and HWIO w: a deconv is the VALID
    transposed convolution, then the crop (``nn.ConvTranspose2D``)."""
    if transposed:
        y = _nhwc(F.conv_transpose2d(_nchw(x), w.permute(2, 3, 0, 1), stride=stride))
        if padding:
            y = y[:, padding:-padding, padding:-padding, :].contiguous()
        return y
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=padding))


@functools.lru_cache(maxsize=512)
def _conv_cost(in_shape, kernel, stride, padding, c_out, transposed, dtype_str):
    dtype = _dtype(dtype_str)
    x = _meta(in_shape, dtype)
    w = _meta((kernel, kernel, in_shape[-1], c_out), dtype)
    return _count(lambda x, w: _conv(x, w, kernel, stride, padding, transposed), x, w)


_ACTS = {
    "relu": F.relu,
    "lrelu": lambda y: F.leaky_relu(y, 0.2),
    "silu": F.silu,
    "tanh": torch.tanh,
}


@functools.lru_cache(maxsize=512)
def _fused_cost(in_shape, kernel, stride, padding, c_out, transposed, norm, act, dtype_str):
    """Counted (flops, bytes) for one fused conv/deconv+norm+act block: the
    flops of its conv and epilogue (the inference-time norm as a
    per-channel affine, as for the unfused ``bn`` layer), and its bytes
    once — the block's input, weights, norm parameters and output, what
    the fused CUDA kernel moves. The sum of the per-layer ``_conv_cost`` /
    ``_elementwise_cost`` counts is what the xla implementation pays
    (every intermediate through memory)."""
    dtype = _dtype(dtype_str)
    x = _meta(in_shape, dtype)
    w = _meta((kernel, kernel, in_shape[-1], c_out), dtype)
    v = _meta((c_out,), torch.float32)

    def f(x, w, gamma, beta):
        y = _conv(x, w, kernel, stride, padding, transposed).to(torch.float32)
        if norm != "none":
            y = y * gamma + beta
        if act in _ACTS:
            y = _ACTS[act](y)
        return y.to(dtype)

    flops, _ = _count(f, x, w, v, v)
    out = f(x, w, v, v)
    moved = _nbytes(x) + _nbytes(w) + _nbytes(out) + (2 * _nbytes(v) if norm != "none" else 0)
    return flops, float(moved)


@functools.lru_cache(maxsize=128)
def _sppf_cost(in_shape, window, reps, dtype_str):
    """Counted (flops, bytes) for the SPPF pool pyramid + concat as one
    fused block: ``reps`` cascaded stride-1 max pools whose levels feed the
    next pool and the concat; the input read once and the 4C concat
    written once — what the ``sppf_pyramid`` kernel moves."""
    x = _meta(in_shape, _dtype(dtype_str))
    pad = window // 2

    def f(x):
        outs = [_nchw(x)]
        for _ in range(reps):
            outs.append(F.max_pool2d(outs[-1], window, 1, pad))
        return _nhwc(torch.cat(outs, dim=1))

    flops, _ = _count(f, x)
    return flops, float(_nbytes(x) + _nbytes(f(x)))


def _profile_layer(l, dtype_name: str):
    """Measured clone of one meta. Composites are profiled through their
    primitive decomposition and their totals become the measured sums, so
    profiling a coarse hierarchical graph and profiling its expansion
    agree layer-for-layer."""
    if l.sublayers:
        subs = [_profile_layer(p, dtype_name) for p in l.sublayers]
        return l.clone(
            sublayers=subs,
            flops=sum(p.flops for p in subs),
            bytes_accessed=sum(p.bytes_accessed for p in subs),
        )
    if l.kind in ("conv", "deconv"):
        flops, bytes_ = _conv_cost(
            tuple(l.in_shape),
            l.attrs.get("kernel", 1),
            l.attrs.get("stride", 1),
            l.attrs.get("padding", 0),
            l.out_shape[-1],
            l.kind == "deconv",
            dtype_name,
        )
        return l.clone(flops=flops or l.flops, bytes_accessed=bytes_ or l.bytes_accessed)
    if l.kind in ELEMENTWISE_KINDS:
        flops, bytes_ = _elementwise_cost(l.kind, tuple(l.in_shape), dtype_name)
        return l.clone(flops=flops or l.flops, bytes_accessed=bytes_ or l.bytes_accessed)
    return l.clone()


def profile_graph(graph: LayerGraph, dtype=torch.bfloat16) -> LayerGraph:
    """Return a copy of ``graph`` with counted flops/bytes on conv, deconv
    and elementwise (pointwise/norm/concat/...) layers; composite kinds
    (c2f, sppf, head, ...) are counted through their primitive
    decomposition (undecomposed composites keep analytic estimates). Works
    on coarse and expanded graphs alike."""
    name = str(dtype).removeprefix("torch.")
    out = [_profile_layer(l, name) for l in graph]
    return LayerGraph(graph.model_name + "[profiled]", out).renumber()
