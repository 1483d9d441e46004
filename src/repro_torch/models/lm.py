"""Unified decoder-only transformer LM, the counterpart of ``repro.models.lm``.

One config covers: gemma-2b (MQA, GeGLU, head_dim 256), gemma2-2b/27b
(alternating local/global attention, logit softcaps, post-norms),
phi4-mini (GQA+SwiGLU), deepseek-moe-16b (fine-grained MoE, first layer
dense), deepseek-v2-lite (MLA + MoE), and the qwen2-vl text backbone
(M-RoPE).

The parameter tree is the JAX package's: the first ``first_k_dense``
blocks of an MoE model as a list (``dense_blocks``), the rest stacked on a
leading layer axis (``blocks``); where the JAX model scans over that axis
the port loops in Python over ``unstack``'s per-layer views (one split of
each leaf, whose backward stacks the layers' gradients as the scan's
does), and each layer's window is a Python int from ``cfg.windows()``. On
the card the full-sequence paths (``__call__``,
``prefill``) run GQA attention on the flash-attention kernel when the
model builds the positions itself (``arange(S)``, broadcast to the three
M-RoPE components); a caller's positions, MLA and the one-token
``decode_step`` run plain ops, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..dist.sharding import carry, carry_placements, constrain, to_residual
from ..nn import MLP, Attention, Embedding, Linear, MLAAttention, MoE, Module, RMSNorm, Stacked
from ..nn.attention import decode_position
from ..nn.module import checkpointed, layer, tree_map, tree_stack, unstack


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX package's ``LMConfig``, field for field. ``act_dtype`` is a
    torch dtype. ``remat`` and ``remat_policy`` checkpoint each block's
    activations under autograd (``nn.module.checkpointed``); ``act_spec``
    (mesh dims) constrains the activations around each stacked block, over
    DTensors, to batch-sharded over those dims (``dist.constrain``)."""

    name: str
    n_layers: int
    d_model: int
    n_q: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention
    attn_type: str = "gqa"  # "gqa" | "mla"
    rope_base: float = 10000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    local_window: int = 0  # sliding-window size for "local" layers
    layer_pattern: str = "global"  # "global" | "local_global" | "custom"
    global_layers: tuple[int, ...] = ()  # explicit global layer ids (pattern="custom")
    query_scale: float | None = None
    mrope_sections: tuple[int, ...] | None = None
    # MLA
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mla_absorb: bool = True
    # MLP / MoE
    act: str = "silu"
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0
    first_k_dense: int = 1
    capacity_factor: float = 1.25
    # misc
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    zero_centered_norm: bool = False  # gemma (1 + scale) RMSNorm
    post_norms: bool = False  # gemma2 post-attention/post-ffn norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024  # query-chunked attention block of the plain route (0 = dense)
    remat: bool = True
    act_spec: Any = None
    remat_policy: str = "full"

    # ---- derived -------------------------------------------------------------
    def windows(self) -> tuple[int, ...]:
        """Per-layer window (0 = global/full attention)."""
        if self.layer_pattern == "global":
            return (0,) * self.n_layers
        if self.layer_pattern == "local_global":
            # gemma2: even layers local (sliding window), odd layers global
            return tuple(self.local_window if i % 2 == 0 else 0 for i in range(self.n_layers))
        if self.layer_pattern == "custom":
            return tuple(0 if i in self.global_layers else self.local_window for i in range(self.n_layers))
        raise ValueError(self.layer_pattern)

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, v = self.d_model, self.vocab
        emb = v * d
        if self.attn_type == "mla":
            qd = self.qk_nope_dim + self.qk_rope_dim
            attn = (
                d * self.n_q * qd
                + d * self.kv_lora
                + d * self.qk_rope_dim
                + self.kv_lora * self.n_q * (self.qk_nope_dim + self.v_head_dim)
                + self.n_q * self.v_head_dim * d
            )
        else:
            attn = d * self.head_dim * (self.n_q + 2 * self.n_kv) + self.n_q * self.head_dim * d
        dense_mlp = 3 * d * self.d_ff
        if self.moe:
            expert = 3 * d * self.d_ff_expert
            moe_mlp = self.n_experts * expert + self.n_shared * expert + d * self.n_experts
            n_moe = self.n_layers - self.first_k_dense
            mlps = self.first_k_dense * dense_mlp + n_moe * moe_mlp
        else:
            mlps = self.n_layers * dense_mlp
        norms = self.n_layers * (4 if self.post_norms else 2) * d + d
        head = 0 if self.tie_embeddings else v * d
        return emb + head + self.n_layers * attn + mlps + norms

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.n_params()
        expert = 3 * self.d_model * self.d_ff_expert
        n_moe = self.n_layers - self.first_k_dense
        return self.n_params() - n_moe * (self.n_experts - self.top_k) * expert


@dataclasses.dataclass(frozen=True)
class LMBlock(Module):
    cfg: LMConfig
    use_moe: bool

    def _attn(self):
        c = self.cfg
        if c.attn_type == "mla":
            return MLAAttention(
                c.d_model,
                c.n_q,
                kv_lora=c.kv_lora,
                qk_nope_dim=c.qk_nope_dim,
                qk_rope_dim=c.qk_rope_dim,
                v_head_dim=c.v_head_dim,
                rope_base=c.rope_base,
                absorb=c.mla_absorb,
                attn_chunk=c.attn_chunk,
            )
        return Attention(
            c.d_model,
            c.n_q,
            c.n_kv,
            c.head_dim,
            rope_base=c.rope_base,
            softcap=c.attn_softcap,
            query_scale=c.query_scale,
            mrope_sections=c.mrope_sections,
            attn_chunk=c.attn_chunk,
        )

    def _mlp(self):
        c = self.cfg
        if self.use_moe:
            return MoE(c.d_model, c.d_ff_expert, c.n_experts, c.top_k, n_shared=c.n_shared,
                       capacity_factor=c.capacity_factor, act=c.act)
        return MLP(c.d_model, c.d_ff, act=c.act)

    def specs(self):
        c = self.cfg
        norm = lambda: RMSNorm(c.d_model, c.norm_eps, zero_centered=c.zero_centered_norm)  # noqa: E731
        s = {"ln_attn": norm(), "attn": self._attn(), "ln_mlp": norm(), "mlp": self._mlp()}
        if c.post_norms:
            s["ln_attn_post"] = norm()
            s["ln_mlp_post"] = norm()
        return s

    def _norm(self, p, name, x):
        c = self.cfg
        return RMSNorm(c.d_model, c.norm_eps, zero_centered=c.zero_centered_norm)(p[name], x)

    def _residual_attn(self, p, x, h, align=lambda h, x: h):
        h = align(h, x)
        if self.cfg.post_norms:
            h = self._norm(p, "ln_attn_post", h)
        return x + h

    def _ffn(self, p, x, align=lambda h, x: h):
        """x + the (post-normed) MLP or MoE of x, and the MoE's aux loss;
        ``align(h, x)`` places each output before its add."""
        h = self._norm(p, "ln_mlp", x)
        if self.use_moe:
            h, aux = self._mlp()(p["mlp"], h)
        else:
            h, aux = self._mlp()(p["mlp"], h), None
        h = align(h, x)
        if self.cfg.post_norms:
            h = self._norm(p, "ln_mlp_post", h)
        return x + h, aux

    def __call__(self, p, x, positions, window, index_positions=False):
        h = self._attn()(p["attn"], self._norm(p, "ln_attn", x), positions, window=window,
                         index_positions=index_positions)
        x, aux = self._ffn(p, self._residual_attn(p, x, h))
        return x, aux if aux is not None else torch.zeros((), dtype=torch.float32, device=x.device)

    def prefill(self, p, x, positions, window, cache_dtype=torch.bfloat16, index_positions=False):
        h, cache = self._attn().prefill(p["attn"], self._norm(p, "ln_attn", x), positions, window=window,
                                        cache_dtype=cache_dtype, index_positions=index_positions)
        x, _ = self._ffn(p, self._residual_attn(p, x, h))
        return x, cache

    def decode(self, p, x, cache, t, window):
        h, cache = self._attn().decode(p["attn"], self._norm(p, "ln_attn", x), cache, t, window=window)
        x, _ = self._ffn(p, self._residual_attn(p, x, h, to_residual), to_residual)
        return x, cache

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        return self._attn().init_cache(batch, max_len, dtype, device)

    def abstract_cache(self, batch, max_len, dtype=torch.bfloat16):
        return self._attn().abstract_cache(batch, max_len, dtype)


@dataclasses.dataclass(frozen=True)
class TransformerLM(Module):
    cfg: LMConfig

    @property
    def n_dense(self):
        return self.cfg.first_k_dense if self.cfg.moe else 0

    @property
    def n_scan(self):
        return self.cfg.n_layers - self.n_dense

    def specs(self):
        c = self.cfg
        s: dict[str, Any] = {
            "embed": Embedding(c.vocab, c.d_model, scale_by_sqrt_d=c.embed_scale),
            "blocks": Stacked(LMBlock(c, use_moe=c.moe), self.n_scan),
            "final_norm": RMSNorm(c.d_model, c.norm_eps, zero_centered=c.zero_centered_norm),
        }
        if self.n_dense:
            s["dense_blocks"] = [LMBlock(c, use_moe=False) for _ in range(self.n_dense)]
        if not c.tie_embeddings:
            s["lm_head"] = Linear(c.d_model, c.vocab, in_axis="embed", out_axis="vocab")
        return s

    # ---- helpers ---------------------------------------------------------------
    def _layers(self, p):
        """(block, its params, its window) for every layer, dense ones first."""
        c = self.cfg
        windows = c.windows()
        dense, scan = LMBlock(c, use_moe=False), LMBlock(c, use_moe=c.moe)
        for i in range(self.n_dense):
            yield dense, p["dense_blocks"][i], windows[i]
        for i, bp in enumerate(unstack(p["blocks"])):
            yield scan, bp, windows[self.n_dense + i]

    def _positions(self, tokens, positions):
        """The caller's positions, or ``arange(S)`` in every row (broadcast
        to the three M-RoPE components) and the flag that says so (the
        kernel's index-derived mask is then the model's)."""
        if positions is not None:
            return positions, False
        B, S = tokens.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
        if self.cfg.mrope_sections is not None:
            pos = pos[..., None].expand(B, S, 3)
        return pos, True

    def _final(self, p, x):
        c = self.cfg
        return RMSNorm(c.d_model, c.norm_eps, zero_centered=c.zero_centered_norm)(p["final_norm"], x)

    def _logits(self, p, x):
        c = self.cfg
        if c.tie_embeddings:
            logits = Embedding(c.vocab, c.d_model).attend(p["embed"], x)
        else:
            logits = Linear(c.d_model, c.vocab)(p["lm_head"], x)
        if c.final_softcap:
            logits = (c.final_softcap * torch.tanh(logits.float() / c.final_softcap)).to(logits.dtype)
        return logits

    def _embed(self, p, tokens, extra_embeds=None, embed_positions=None):
        c = self.cfg
        x = Embedding(c.vocab, c.d_model, scale_by_sqrt_d=c.embed_scale)(p["embed"], tokens).to(c.act_dtype)
        if extra_embeds is not None:
            # VLM stub frontend: scatter precomputed patch embeddings into the
            # sequence at the given positions (B, n_img) int; out of place, so
            # DTensor may place the write for whatever split ``x`` has
            bidx = torch.arange(x.shape[0], device=x.device)[:, None]
            x = x.index_put((bidx, embed_positions.long()), extra_embeds.to(c.act_dtype))
        return x

    # ---- forward ---------------------------------------------------------------------
    def __call__(self, p, tokens, positions=None, extra_embeds=None, embed_positions=None, return_hidden=False):
        positions, index = self._positions(tokens, positions)
        x = self._embed(p, tokens, extra_embeds, embed_positions)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        spec = self.cfg.act_spec
        pl = None if spec is not None else carry_placements(x)
        x = carry(x, pl)
        for i, (blk, bp, w) in enumerate(self._layers(p)):
            stacked = i >= self.n_dense  # the JAX model constrains around its scanned blocks
            x = constrain(x, spec) if stacked else x
            x, aux = checkpointed(blk, self.cfg.remat, self.cfg.remat_policy)(bp, x, positions, w,
                                                                              index_positions=index)
            x = carry(constrain(x, spec) if stacked else x, pl)
            aux_total = aux_total + aux
        x = self._final(p, x)
        if return_hidden:
            return x, aux_total
        return self._logits(p, x), aux_total

    def head(self, p, x):
        return self._logits(p, x)

    # ---- caches -------------------------------------------------------------------
    def _cache_len(self, layer_idx, max_len):
        """Ring-buffer caches for pure-local layers: size = window."""
        w = self.cfg.windows()[layer_idx]
        return max_len if w == 0 else min(max_len, w)

    def init_caches(self, batch, max_len, dtype=torch.bfloat16, device=None, abstract=False):
        """``{"dense": [one cache per dense block], "scan": the stacked
        caches}``; the stacked layers share one cache length, the largest
        of theirs, as the JAX package's scan needs. ``abstract``: the same
        tree as ``meta`` tensors."""
        c = self.cfg
        device = "meta" if abstract else device
        dense = [LMBlock(c, use_moe=False).init_cache(batch, self._cache_len(i, max_len), dtype, device)
                 for i in range(self.n_dense)]
        scan_len = max(self._cache_len(i, max_len) for i in range(self.n_dense, c.n_layers))
        one = LMBlock(c, use_moe=c.moe).init_cache(batch, scan_len, dtype, device)
        return {"dense": dense, "scan": tree_map(lambda a: a.expand(self.n_scan, *a.shape).clone(), one)}

    # ---- serving ------------------------------------------------------------------
    def prefill(self, p, tokens, positions=None, cache_dtype=torch.bfloat16):
        """Logits of the last token (B, 1, vocab) and the caches (each of
        the prompt's length), in ``init_caches``' tree."""
        positions, index = self._positions(tokens, positions)
        x = self._embed(p, tokens)
        pl = carry_placements(x)
        x, caches = carry(x, pl), []
        for blk, bp, w in self._layers(p):
            x, cache = blk.prefill(bp, x, positions, w, cache_dtype, index_positions=index)
            x = carry(x, pl)
            caches.append(cache)
        x = self._final(p, x)
        return self._logits(p, x[:, -1:]), {"dense": caches[: self.n_dense],
                                            "scan": tree_stack(caches[self.n_dense :])}

    def decode_step(self, p, token, caches, t):
        """token: (B, 1) int; t: position, an int or a 0-d integer tensor,
        taken as a 0-d int32 tensor on the token's device
        (``decode_position``). Returns (logits, caches): the caches given,
        written in place (each layer's view of the stacked caches)."""
        t = decode_position(t, token)
        x = self._embed(p, token)
        pl = carry_placements(x)
        x = carry(x, pl)
        for i, (blk, bp, w) in enumerate(self._layers(p)):
            cache = caches["dense"][i] if i < self.n_dense else layer(caches["scan"], i - self.n_dense)
            x, _ = blk.decode(bp, x, cache, t, w)
            x = carry(x, pl)
        return self._logits(p, self._final(p, x)), caches
