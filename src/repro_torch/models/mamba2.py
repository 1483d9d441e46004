"""Mamba-2 language model (attention-free, SSD blocks; arXiv:2405.21060),
the counterpart of ``repro.models.mamba2``.

A thin wrapper over ``nn.Mamba2Block``: the blocks are stacked on a leading
layer axis as in the JAX package and the port loops over them. On the card
the full-sequence paths (``__call__``, ``prefill``) run each block's scan on
the SSD kernel; the one-token ``decode_step`` runs plain ops, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..dist.sharding import carry, carry_placements, constrain, to_residual
from ..nn import Embedding, Mamba2Block, Module, RMSNorm, Stacked
from ..nn.module import checkpointed, layer, tree_map, tree_stack, unstack


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """The JAX package's ``Mamba2Config``, field for field; ``act_dtype`` is
    a torch dtype, ``remat`` checkpoints each layer under autograd, and
    ``act_spec`` (mesh dims) constrains the activations around each layer,
    over DTensors, to batch-sharded over those dims (``dist.constrain``)."""

    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act_dtype: Any = torch.bfloat16
    remat: bool = True
    act_spec: Any = None

    def block(self) -> Mamba2Block:
        return Mamba2Block(
            self.d_model,
            d_state=self.d_state,
            d_conv=self.d_conv,
            expand=self.expand,
            head_dim=self.head_dim,
            n_groups=self.n_groups,
            chunk=self.chunk,
        )

    def n_params(self) -> int:
        b = self.block()
        d_in_proj = 2 * b.d_inner + 2 * b.n_groups * b.d_state + b.n_heads
        per_layer = (
            self.d_model * d_in_proj
            + b.d_conv * b.conv_dim
            + b.conv_dim
            + 3 * b.n_heads
            + b.d_inner
            + b.d_inner * self.d_model
            + self.d_model
        )
        return self.vocab * self.d_model + self.n_layers * per_layer + self.d_model

    def n_active_params(self) -> int:
        return self.n_params()


@dataclasses.dataclass(frozen=True)
class Mamba2LayerWrapped(Module):
    """Pre-norm residual wrapper around a Mamba2Block."""

    cfg: Mamba2Config

    def specs(self):
        return {"norm": RMSNorm(self.cfg.d_model, self.cfg.norm_eps), "mixer": self.cfg.block()}

    def _norm(self, p, x):
        return RMSNorm(self.cfg.d_model, self.cfg.norm_eps)(p["norm"], x)

    def __call__(self, p, x):
        return x + self.cfg.block()(p["mixer"], self._norm(p, x))

    def prefill(self, p, x, cache_dtype=torch.bfloat16):
        y, cache = self.cfg.block().prefill(p["mixer"], self._norm(p, x), cache_dtype)
        return x + y, cache

    def decode(self, p, x, cache):
        y, cache = self.cfg.block().decode(p["mixer"], self._norm(p, x), cache)
        return x + to_residual(y, x), cache


@dataclasses.dataclass(frozen=True)
class Mamba2LM(Module):
    cfg: Mamba2Config

    def specs(self):
        c = self.cfg
        return {
            "embed": Embedding(c.vocab, c.d_model),
            "blocks": Stacked(Mamba2LayerWrapped(c), c.n_layers),
            "final_norm": RMSNorm(c.d_model, c.norm_eps),
        }

    def _embed(self, p, tokens):
        return Embedding(self.cfg.vocab, self.cfg.d_model)(p["embed"], tokens).to(self.cfg.act_dtype)

    def _final(self, p, x):
        return RMSNorm(self.cfg.d_model, self.cfg.norm_eps)(p["final_norm"], x)

    def _logits(self, p, x):
        return Embedding(self.cfg.vocab, self.cfg.d_model).attend(p["embed"], x)

    def __call__(self, p, tokens, positions=None, return_hidden=False):
        x = self._embed(p, tokens)
        blk = checkpointed(Mamba2LayerWrapped(self.cfg), self.cfg.remat)
        spec = self.cfg.act_spec
        pl = None if spec is not None else carry_placements(x)
        x = carry(x, pl)
        for bp in unstack(p["blocks"]):
            x = carry(constrain(blk(bp, constrain(x, spec)), spec), pl)
        x = self._final(p, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return (x, aux) if return_hidden else (self._logits(p, x), aux)

    def head(self, p, x):
        return self._logits(p, x)

    def init_caches(self, batch, max_len=0, dtype=torch.bfloat16, device=None, abstract=False):
        """The per-layer (conv, ssm) state, stacked; ``max_len`` is taken for
        the other models' signature (the state does not grow). ``abstract``:
        the same tree as ``meta`` tensors."""
        b = self.cfg.block()
        one = b.abstract_cache(batch, dtype) if abstract else b.init_cache(batch, dtype, device)
        return tree_map(lambda a: a.expand(self.cfg.n_layers, *a.shape).clone(), one)

    def prefill(self, p, tokens, positions=None, cache_dtype=torch.bfloat16):
        x = self._embed(p, tokens)
        blk = Mamba2LayerWrapped(self.cfg)
        pl = carry_placements(x)
        x, caches = carry(x, pl), []
        for bp in unstack(p["blocks"]):
            x, cache = blk.prefill(bp, x, cache_dtype)
            x = carry(x, pl)
            caches.append(cache)
        return self._logits(p, self._final(p, x[:, -1:])), tree_stack(caches)

    def decode_step(self, p, token, caches, t=None):
        """Returns (logits, caches): the caches given, written in place.
        ``t`` (an int or a 0-d tensor, as the other families take it) is
        not read: the SSM state carries the position."""
        x = self._embed(p, token)
        blk = Mamba2LayerWrapped(self.cfg)
        pl = carry_placements(x)
        x = carry(x, pl)
        for i, bp in enumerate(unstack(p["blocks"])):
            x, _ = blk.decode(bp, x, layer(caches, i))
            x = carry(x, pl)
        return self._logits(p, self._final(p, x)), caches
