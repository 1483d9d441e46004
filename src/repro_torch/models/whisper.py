"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the
counterpart of ``repro.models.whisper``.

The conv/audio frontend is a stub: the encoder takes precomputed frame
embeddings (B, n_frames, d). Whisper uses absolute (sinusoidal) positions
and LayerNorm; no RoPE. The blocks are stacked on a leading layer axis as
in the JAX package and the port loops over them. On the card the
full-sequence paths (``encode``, ``__call__``, ``prefill``) run the
encoder's self-attention and the decoder's cross-attention on the
flash-attention kernel's non-causal mode and the decoder's self-attention
on its causal mode; the one-token ``decode_step`` runs plain ops, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..dist.sharding import carry, carry_placements, to_residual
from ..nn import MLP, Attention, Embedding, LayerNorm, Module, ParamSpec, Stacked, normal_init
from ..nn.attention import decode_position
from ..nn.module import checkpointed, layer, tree_map, tree_stack, unstack


def sinusoid_pos(n: int, d: int, device=None):
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    # log(10000) and its quotient in f32, as the JAX package computes them; the
    # constant filled on the device (a copy from the host has no place in a CUDA graph)
    inv = torch.exp(-dim * (torch.log(torch.full((), 10000.0, device=device)) / (d // 2 - 1)))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (n, d)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """The JAX package's ``WhisperConfig``, field for field; ``act_dtype``
    is a torch dtype, and ``remat`` checkpoints each encoder and decoder
    block under autograd."""

    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500
    max_text: int = 448
    norm_eps: float = 1e-5
    act_dtype: Any = torch.bfloat16
    attn_chunk: int = 512
    remat: bool = True

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    def attn(self):
        return Attention(self.d_model, self.n_heads, self.n_heads, self.head_dim,
                         use_rope=False, attn_chunk=self.attn_chunk)

    def norm(self):
        return LayerNorm(self.d_model, self.norm_eps)

    def mlp(self):
        return MLP(self.d_model, self.d_ff, act="gelu", gated=False)

    def n_params(self):
        d = self.d_model
        attn = 4 * d * d
        mlp = 2 * d * self.d_ff
        enc = self.n_enc_layers * (attn + mlp + 4 * d)
        dec = self.n_dec_layers * (2 * attn + mlp + 6 * d)
        return self.vocab * d + self.max_text * d + enc + dec + 4 * d

    def n_active_params(self):
        return self.n_params()


@dataclasses.dataclass(frozen=True)
class EncBlock(Module):
    cfg: WhisperConfig

    def specs(self):
        c = self.cfg
        return {"ln1": c.norm(), "attn": c.attn(), "ln2": c.norm(), "mlp": c.mlp()}

    def __call__(self, p, x):
        c = self.cfg
        x = x + c.attn()(p["attn"], c.norm()(p["ln1"], x), causal=False)
        return x + c.mlp()(p["mlp"], c.norm()(p["ln2"], x))


@dataclasses.dataclass(frozen=True)
class DecBlock(Module):
    cfg: WhisperConfig

    def specs(self):
        c = self.cfg
        return {
            "ln1": c.norm(),
            "self_attn": c.attn(),
            "ln_x": c.norm(),
            "cross_attn": c.attn(),
            "ln2": c.norm(),
            "mlp": c.mlp(),
        }

    def _cross_and_mlp(self, p, x, enc_out):
        c = self.cfg
        x = x + c.attn()(p["cross_attn"], c.norm()(p["ln_x"], x), causal=False, kv_x=enc_out)
        return x + c.mlp()(p["mlp"], c.norm()(p["ln2"], x))

    def __call__(self, p, x, enc_out):
        c = self.cfg
        x = x + c.attn()(p["self_attn"], c.norm()(p["ln1"], x), causal=True)
        return self._cross_and_mlp(p, x, enc_out)

    def prefill(self, p, x, enc_out, cache_dtype=torch.bfloat16):
        c = self.cfg
        y, self_kv = c.attn().prefill(p["self_attn"], c.norm()(p["ln1"], x), cache_dtype=cache_dtype)
        x = self._cross_and_mlp(p, x + y, enc_out)
        ck, cv = c.attn().project_kv(p["cross_attn"], enc_out)
        return x, {"self": self_kv, "cross_k": ck.to(cache_dtype), "cross_v": cv.to(cache_dtype)}

    def decode(self, p, x, cache, t):
        c = self.cfg
        y, self_kv = c.attn().decode(p["self_attn"], c.norm()(p["ln1"], x), cache["self"], t)
        x = x + to_residual(y, x)
        y = c.attn().attend_kv(p["cross_attn"], c.norm()(p["ln_x"], x), cache["cross_k"], cache["cross_v"])
        x = x + to_residual(y, x)
        x = x + to_residual(c.mlp()(p["mlp"], c.norm()(p["ln2"], x)), x)
        return x, {"self": self_kv, "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None, abstract=False):
        """The decoder's self-attention cache and zero cross caches (a
        decode-only run attends to them, as the JAX package's does);
        ``abstract``: as ``meta`` tensors."""
        c = self.cfg
        device = "meta" if abstract else device
        cross_shape = (batch, c.n_frames, c.n_heads, c.head_dim)
        return {
            "self": c.attn().init_cache(batch, max_len, dtype, device),
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device),
        }


@dataclasses.dataclass(frozen=True)
class WhisperModel(Module):
    cfg: WhisperConfig

    def specs(self):
        c = self.cfg
        return {
            "embed": Embedding(c.vocab, c.d_model),
            "pos_embed": ParamSpec((c.max_text, c.d_model), (None, "embed"), normal_init(0.01)),
            "enc_blocks": Stacked(EncBlock(c), c.n_enc_layers),
            "dec_blocks": Stacked(DecBlock(c), c.n_dec_layers),
            "ln_enc": c.norm(),
            "ln_dec": c.norm(),
        }

    def encode(self, p, frames):
        """frames: (B, n_frames, d) precomputed embeddings (conv-stub)."""
        c = self.cfg
        x = frames.to(c.act_dtype) + sinusoid_pos(frames.shape[1], c.d_model, frames.device).to(c.act_dtype)
        blk = checkpointed(EncBlock(c), c.remat)
        pl = carry_placements(x)
        x = carry(x, pl)
        for bp in unstack(p["enc_blocks"]):
            x = carry(blk(bp, x), pl)
        return c.norm()(p["ln_enc"], x)

    def _dec_embed(self, p, tokens):
        c = self.cfg
        x = Embedding(c.vocab, c.d_model)(p["embed"], tokens).to(c.act_dtype)
        S = tokens.shape[1]
        pe_full = p["pos_embed"]
        if S <= c.max_text:
            pe = pe_full[:S]
        else:  # mechanical long-decode cells exceed whisper's 448 positions: tile
            pe = pe_full.repeat(-(-S // c.max_text), 1)[:S]
        return x + pe.to(c.act_dtype)

    def _logits(self, p, x):
        c = self.cfg
        return Embedding(c.vocab, c.d_model).attend(p["embed"], c.norm()(p["ln_dec"], x))

    def __call__(self, p, frames, tokens, return_hidden=False):
        c = self.cfg
        enc_out = self.encode(p, frames)
        x = self._dec_embed(p, tokens)
        blk = checkpointed(DecBlock(c), c.remat)
        pl = carry_placements(x)
        x = carry(x, pl)
        for bp in unstack(p["dec_blocks"]):
            x = carry(blk(bp, x, enc_out), pl)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return c.norm()(p["ln_dec"], x), aux
        return self._logits(p, x), aux

    def head(self, p, x):
        c = self.cfg
        return Embedding(c.vocab, c.d_model).attend(p["embed"], x)

    def init_caches(self, batch, max_len, dtype=torch.bfloat16, device=None, abstract=False):
        one = DecBlock(self.cfg).init_cache(batch, max_len, dtype, device, abstract=abstract)
        return tree_map(lambda a: a.expand(self.cfg.n_dec_layers, *a.shape).clone(), one)

    def prefill(self, p, frames, tokens, cache_dtype=torch.bfloat16):
        c = self.cfg
        enc_out = self.encode(p, frames)
        x = self._dec_embed(p, tokens)
        blk = DecBlock(c)
        pl = carry_placements(x)
        x, caches = carry(x, pl), []
        for bp in unstack(p["dec_blocks"]):
            x, cache = blk.prefill(bp, x, enc_out, cache_dtype)
            x = carry(x, pl)
            caches.append(cache)
        return self._logits(p, x[:, -1:]), tree_stack(caches)

    def decode_step(self, p, token, caches, t):
        """``t``: an int or a 0-d integer tensor, taken as a 0-d int32
        tensor on the token's device (``decode_position``); its position
        embedding is the row ``min(t, max_text - 1)``, read on the device
        (``dynamic_slice_in_dim`` in the JAX package). Returns (logits,
        caches): the caches given, the self-attention caches written in
        place (the cross caches as they are)."""
        c = self.cfg
        t = decode_position(t, token)
        pe_idx = t.clamp(max=c.max_text - 1).reshape(1)
        x = Embedding(c.vocab, c.d_model)(p["embed"], token).to(c.act_dtype)
        x = x + p["pos_embed"].index_select(0, pe_idx).to(c.act_dtype)
        blk = DecBlock(c)
        pl = carry_placements(x)
        x = carry(x, pl)
        for i, bp in enumerate(unstack(p["dec_blocks"])):
            x, _ = blk.decode(bp, x, layer(caches, i), t)
            x = carry(x, pl)
        return self._logits(p, x), caches
