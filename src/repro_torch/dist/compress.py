"""Compressed data-parallel gradients with error feedback (the
counterpart of ``repro.dist.compress``).

Pod-scale all-reduce bandwidth is the scaling wall; the standard remedy
is low-bit gradient exchange with per-tensor scales plus error feedback
so the quantization residual re-enters the next step instead of being
lost (1-bit Adam / PowerSGD lineage). ``make_compressed_dp_grad_fn``
wraps a loss into a grad fn that (1) takes each rank's rows of the batch
over the data-like mesh axes and all-reduces the mean of their gradients
(the global gradient, which GSPMD computes implicitly in the JAX
package), (2) adds the carried residual, (3) fake-quantizes to ``bits``
with a per-tensor max scale (what the wire format would carry), and
(4) returns the dequantized gradient + the new residual, split over
``n_chunks`` carriers (one per pod in the hierarchical reduce).
"""
from __future__ import annotations

import torch

from ..nn.module import tree_leaves, tree_map, tree_unflatten
from .sharding import _names, mesh_index


def zeros_like_error(params, n_chunks: int):
    """Fresh error-feedback state: one residual carrier per chunk/pod."""
    return tree_map(lambda x: torch.zeros((n_chunks, *x.shape), dtype=torch.float32, device=x.device), params)


def make_compressed_dp_grad_fn(loss_fn, mesh, batch_spec, bits: int = 8):
    """Returns ``grad_fn(params, batch, err) -> (grad, new_err)``.

    ``batch_spec``'s first entry names the mesh axes the batch dim shards
    over (e.g. ``P(("pod", "data"))``). ``params`` and ``batch`` are the
    same plain tensors on every rank; each rank differentiates ``loss_fn``
    (a mean over the rows) on its block of rows, and the gradients are
    averaged over those mesh axes. The dequantized gradient stays within
    scale/2 of the true gradient per element (scale = max|g|/
    (2^(bits-1)-1)); the residual is carried in ``new_err``.
    """
    from ..train.steps import _grads, _trainable

    levels = float(2 ** (bits - 1) - 1)
    batch_axes = _names(tuple(batch_spec)[0] if len(tuple(batch_spec)) else None)

    sharded = mesh is not None and bool(batch_axes)

    def local_grad(params, batch):
        if sharded:
            index, count = mesh_index(mesh, batch_axes)

            def own(x):
                if x.shape[0] % count:
                    raise ValueError(f"batch of {x.shape[0]} rows does not split over {count} ranks of {batch_axes}")
                n = x.shape[0] // count
                return x[index * n : (index + 1) * n]

            batch = tree_map(own, batch)
        p = _trainable(params)
        g = _grads(loss_fn(p, batch), p)
        if sharded:
            import torch.distributed as dist

            for leaf in tree_leaves(g):  # mean over the batch axes, one mesh dim at a time
                for a in batch_axes:
                    dist.all_reduce(leaf, group=mesh.get_group(a))
                leaf.div_(count)
        return g

    def grad_fn(params, batch, err):
        g = local_grad(params, batch)
        out_g, out_e = [], []
        for gi, ei in zip(tree_leaves(g), tree_leaves(err)):
            total = gi.float() + ei.sum(dim=0)
            scale = torch.clamp_min(total.abs().max() / levels, 1e-20)
            deq = torch.round(total / scale) * scale  # fake-quantized exchange
            resid = (total - deq) / ei.shape[0]
            out_g.append(deq.to(gi.dtype))
            out_e.append(resid[None].expand(ei.shape).to(ei.dtype).clone())
        return tree_unflatten(g, out_g), tree_unflatten(g, out_e)

    return grad_fn
