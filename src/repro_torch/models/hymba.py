"""Hymba: hybrid-head architecture — parallel attention + Mamba (SSD) heads
in every layer (arXiv:2411.13676), the counterpart of
``repro.models.hymba``. Most layers use sliding-window attention; a few
(first / middle / last) are global. Attention and SSM branches run in
parallel on the same input and are fused by normalized averaging.

The parameter tree is the JAX package's, with the blocks stacked on a
leading layer axis (``Stacked``); where the JAX model scans over that axis
the port loops over it in Python. Each layer's window is a Python int from
``cfg.windows()``. On the card, the full-sequence paths (``__call__``,
``prefill``) run both branches on the hand-written kernels (flash
attention, the SSD scan) when the model builds the positions itself; the
one-token ``decode_step`` runs plain ops, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..dist.sharding import carry, carry_placements, constrain, to_residual
from ..nn import MLP, Attention, Embedding, Mamba2Block, Module, RMSNorm, Stacked
from ..nn.attention import decode_position
from ..nn.module import checkpointed, layer, tree_map, tree_stack, unstack


@dataclasses.dataclass(frozen=True)
class HymbaConfig:
    name: str
    n_layers: int
    d_model: int
    n_q: int
    n_kv: int
    d_ff: int
    vocab: int
    ssm_state: int = 16
    head_dim: int = 64
    local_window: int = 1024
    global_layers: tuple[int, ...] = (0, 15, 31)
    expand: int = 2
    ssm_head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128
    rope_base: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    remat: bool = True  # checkpoint each block under autograd
    act_spec: Any = None  # mesh dims: the activations around each block, batch-sharded over them

    def windows(self):
        return tuple(0 if i in self.global_layers else self.local_window for i in range(self.n_layers))

    def attn(self):
        return Attention(self.d_model, self.n_q, self.n_kv, self.head_dim,
                         rope_base=self.rope_base, attn_chunk=self.attn_chunk)

    def mamba(self):
        return Mamba2Block(
            self.d_model,
            d_state=self.ssm_state,
            d_conv=self.d_conv,
            expand=self.expand,
            head_dim=self.ssm_head_dim,
            n_groups=self.n_groups,
            chunk=self.chunk,
        )

    def n_params(self):
        d = self.d_model
        attn = d * self.head_dim * (self.n_q + 2 * self.n_kv) + self.n_q * self.head_dim * d
        b = self.mamba()
        d_in_proj = 2 * b.d_inner + 2 * b.n_groups * b.d_state + b.n_heads
        mamba = d * d_in_proj + b.d_conv * b.conv_dim + b.conv_dim + 3 * b.n_heads + b.d_inner + b.d_inner * d
        mlp = 3 * d * self.d_ff
        per_layer = attn + mamba + mlp + 4 * d
        return self.vocab * d + self.n_layers * per_layer + d

    def n_active_params(self):
        return self.n_params()


@dataclasses.dataclass(frozen=True)
class HymbaBlock(Module):
    cfg: HymbaConfig

    def specs(self):
        c = self.cfg
        return {
            "ln_mix": RMSNorm(c.d_model, c.norm_eps),
            "attn": c.attn(),
            "mamba": c.mamba(),
            "ln_attn_out": RMSNorm(c.d_model, c.norm_eps),
            "ln_mamba_out": RMSNorm(c.d_model, c.norm_eps),
            "ln_mlp": RMSNorm(c.d_model, c.norm_eps),
            "mlp": MLP(c.d_model, c.d_ff, act="silu"),
        }

    def _norm(self, p, x):
        return RMSNorm(self.cfg.d_model, self.cfg.norm_eps)(p, x)

    def _fuse_and_mlp(self, p, x, a, m, align=lambda h, x: h):
        """``align(h, x)`` places each branch's output before its add."""
        c = self.cfg
        a, m = align(a, x), align(m, x)
        x = x + 0.5 * (self._norm(p["ln_attn_out"], a) + self._norm(p["ln_mamba_out"], m))
        return x + align(MLP(c.d_model, c.d_ff, act="silu")(p["mlp"], self._norm(p["ln_mlp"], x)), x)

    def __call__(self, p, x, positions, window, index_positions=False):
        c = self.cfg
        h = self._norm(p["ln_mix"], x)
        a = c.attn()(p["attn"], h, positions, window=window, index_positions=index_positions)
        m = c.mamba()(p["mamba"], h)
        return self._fuse_and_mlp(p, x, a, m)

    def prefill(self, p, x, positions, window, cache_dtype=torch.bfloat16, index_positions=False):
        c = self.cfg
        h = self._norm(p["ln_mix"], x)
        a, kv = c.attn().prefill(p["attn"], h, positions, window=window, cache_dtype=cache_dtype,
                                 index_positions=index_positions)
        m, st = c.mamba().prefill(p["mamba"], h, cache_dtype)
        return self._fuse_and_mlp(p, x, a, m), {"kv": kv, "ssm": st}

    def decode(self, p, x, cache, t, window):
        c = self.cfg
        h = self._norm(p["ln_mix"], x)
        a, kv = c.attn().decode(p["attn"], h, cache["kv"], t, window=window)
        m, st = c.mamba().decode(p["mamba"], h, cache["ssm"])
        return self._fuse_and_mlp(p, x, a, m, to_residual), {"kv": kv, "ssm": st}

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None, abstract=False):
        c = self.cfg
        device = "meta" if abstract else device
        return {
            "kv": c.attn().init_cache(batch, max_len, dtype, device),
            "ssm": c.mamba().init_cache(batch, dtype, device),
        }


@dataclasses.dataclass(frozen=True)
class HymbaLM(Module):
    cfg: HymbaConfig

    def specs(self):
        c = self.cfg
        return {
            "embed": Embedding(c.vocab, c.d_model),
            "blocks": Stacked(HymbaBlock(c), c.n_layers),
            "final_norm": RMSNorm(c.d_model, c.norm_eps),
        }

    def _embed(self, p, tokens):
        return Embedding(self.cfg.vocab, self.cfg.d_model)(p["embed"], tokens).to(self.cfg.act_dtype)

    def _positions(self, tokens, positions):
        """The caller's positions, or ``arange(S)`` in every row and the flag
        that says so (the kernels' index-derived mask is then the model's)."""
        if positions is not None:
            return positions, False
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S), True

    def _logits(self, p, x):
        c = self.cfg
        x = RMSNorm(c.d_model, c.norm_eps)(p["final_norm"], x)
        return Embedding(c.vocab, c.d_model).attend(p["embed"], x)

    def __call__(self, p, tokens, positions=None, return_hidden=False):
        c = self.cfg
        positions, index = self._positions(tokens, positions)
        x = self._embed(p, tokens)
        blk = checkpointed(HymbaBlock(c), c.remat)
        pl = None if c.act_spec is not None else carry_placements(x)
        x = carry(x, pl)
        for bp, w in zip(unstack(p["blocks"]), c.windows()):
            x = blk(bp, constrain(x, c.act_spec), positions, w, index_positions=index)
            x = carry(constrain(x, c.act_spec), pl)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return RMSNorm(c.d_model, c.norm_eps)(p["final_norm"], x), aux
        return self._logits(p, x), aux

    def head(self, p, x):
        return Embedding(self.cfg.vocab, self.cfg.d_model).attend(p["embed"], x)

    def init_caches(self, batch, max_len, dtype=torch.bfloat16, device=None, abstract=False):
        """Every layer's cache, stacked; ``abstract``: as ``meta`` tensors."""
        one = HymbaBlock(self.cfg).init_cache(batch, max_len, dtype, device, abstract=abstract)
        return tree_map(lambda a: a.expand(self.cfg.n_layers, *a.shape).clone(), one)

    def prefill(self, p, tokens, positions=None, cache_dtype=torch.bfloat16):
        """Logits of the last token (B, 1, vocab) and the caches, stacked on a
        leading layer axis as the JAX package's scan returns them."""
        c = self.cfg
        positions, index = self._positions(tokens, positions)
        x = self._embed(p, tokens)
        blk = HymbaBlock(c)
        pl = carry_placements(x)
        x, caches = carry(x, pl), []
        for bp, w in zip(unstack(p["blocks"]), c.windows()):
            x, cache = blk.prefill(bp, x, positions, w, cache_dtype, index_positions=index)
            x = carry(x, pl)
            caches.append(cache)
        return self._logits(p, x[:, -1:]), tree_stack(caches)

    def decode_step(self, p, token, caches, t):
        """``t``: an int or a 0-d integer tensor, taken as a 0-d int32
        tensor on the token's device (``decode_position``). Returns
        (logits, caches): the caches given, written in place."""
        c = self.cfg
        t = decode_position(t, token)
        x = self._embed(p, token)
        blk = HymbaBlock(c)
        pl = carry_placements(x)
        x = carry(x, pl)
        for i, (bp, w) in enumerate(zip(unstack(p["blocks"]), c.windows())):
            x, _ = blk.decode(bp, x, layer(caches, i), t, w)
            x = carry(x, pl)
        return self._logits(p, x), caches
