"""Optimizers as pure functions over the port's parameter trees.

``init(params) -> state`` and ``update(grads, state, params) -> (params,
state, info)``, as in the JAX package: AdamW with fp32 moments, global-norm
clipping (1.0 by default) and schedule support, Adam, and SGD. States are
plain trees beside the params. ``init`` makes the step count a 0-d int32
CPU tensor, as JAX's count is int32. ``update`` computes the bias
corrections and a schedule's learning rate (0-d float32) where the count
it is given lives. A count on the host keeps them there, and they reach
the card's kernels as scalars, so an eager update on the card never waits
for the host. The captured train steps (``steps._captured_train_step``,
``steps._donated_train_step``) hand ``update`` / ``update_`` the count as
a 0-d int32 buffer on the card, filled at each call, so those scalars are
computed in the CUDA graph from each call's count, not baked into it at
the capture.
Updates run under ``torch.no_grad()`` and
return new tensors; ``AdamW.update_`` is the same update written into the
buffers it is given (the JAX launcher donates them to its jitted step).
``abstract_state`` is ``init``'s tree as ``meta`` tensors (JAX's
``ShapeDtypeStruct``s), for the dry-run cells.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..nn.module import tree_leaves, tree_map, tree_unflatten

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_lr(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0) -> Schedule:
    def f(step):
        step = step.float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return f


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _lr(lr, step):
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float | None = 1.0
    # keep an fp32 master copy in the optimizer state so params can live in
    # bf16 while the update accumulates in fp32
    master_weights: bool = False

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        st = {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32),
        }
        if self.master_weights:
            st["master"] = tree_map(lambda p: p.detach().float().clone(), params)
        return st

    def abstract_state(self, abstract_params):
        """``init``'s tree, shapes and dtypes, as ``meta`` tensors."""
        f32 = lambda p: _meta(p.shape)  # noqa: E731
        st = {"m": tree_map(f32, abstract_params), "v": tree_map(f32, abstract_params),
              "step": _meta((), torch.int32)}
        if self.master_weights:
            st["master"] = tree_map(f32, abstract_params)
        return st

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        gnorm = torch.zeros((), dtype=torch.float32)
        if self.grad_clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.grad_clip_norm)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        lr = _lr(self.lr, step)

        def upd(p, g, m, v, master=None):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            ref = master if master is not None else p.float()
            if self.weight_decay:
                delta = delta + self.weight_decay * ref
            new_ref = ref - lr * delta
            return new_ref.to(p.dtype), m, v, new_ref

        flat_p = tree_leaves(params)
        flat_ma = tree_leaves(state["master"]) if self.master_weights else [None] * len(flat_p)
        out = [
            upd(*args)
            for args in zip(
                flat_p, tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]), flat_ma
            )
        ]
        new_state = {
            "m": tree_unflatten(params, [o[1] for o in out]),
            "v": tree_unflatten(params, [o[2] for o in out]),
            "step": step,
        }
        if self.master_weights:
            new_state["master"] = tree_unflatten(params, [o[3] for o in out])
        new_p = tree_unflatten(params, [o[0] for o in out])
        return new_p, new_state, {"grad_norm": gnorm, "lr": lr}


    @torch.no_grad()
    def update_(self, grads, state, params):
        """``update`` in place, leaf by leaf: the gradients are clipped in
        their buffers, then each parameter, its moments and its master copy
        are written into theirs, so no second copy of the parameters or of
        the optimizer state ever exists (``update`` holds both trees at
        once). The same ops in the same order as ``update``: bit-equal.
        Returns ``(params, state, info)``, the trees passed in, with
        ``state["step"]`` advanced."""
        step = state["step"] + 1
        gnorm = torch.zeros((), dtype=torch.float32)
        flat_g = tree_leaves(grads)
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp_max(self.grad_clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
            for g in flat_g:
                if g.dtype == torch.float32:
                    g.mul_(scale)
                else:
                    g.copy_((g.float() * scale).to(g.dtype))
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        lr = _lr(self.lr, step)
        flat_p = tree_leaves(params)
        flat_ma = tree_leaves(state["master"]) if self.master_weights else [None] * len(flat_p)
        for p, g, m, v, master in zip(flat_p, flat_g, tree_leaves(state["m"]), tree_leaves(state["v"]), flat_ma):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            del g32
            delta = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(self.eps))
            ref = master if master is not None else p.float()
            if self.weight_decay:
                delta.add_(self.weight_decay * ref)
            ref.sub_(delta.mul_(lr))
            del delta
            if ref is not p:
                p.copy_(ref)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}


@dataclasses.dataclass(frozen=True)
class Adam(AdamW):
    """Adam = AdamW with zero decoupled weight decay (pix2pix uses
    Adam(2e-4, b1=0.5) per the paper's reference implementation)."""

    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Schedule | float = 0.01
    momentum: float = 0.9

    def init(self, params):
        return {
            "mom": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32),
        }

    def abstract_state(self, abstract_params):
        """``init``'s tree, shapes and dtypes, as ``meta`` tensors."""
        return {"mom": tree_map(lambda p: _meta(p.shape), abstract_params), "step": _meta((), torch.int32)}

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        lr = _lr(self.lr, step)

        def upd(p, g, m):
            m = self.momentum * m + g.float()
            return (p.float() - lr * m).to(p.dtype), m

        out = [
            upd(p, g, m)
            for p, g, m in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mom"]))
        ]
        new_p = tree_unflatten(params, [o[0] for o in out])
        new_m = tree_unflatten(params, [o[1] for o in out])
        return new_p, {"mom": new_m, "step": step}, {"lr": lr}
