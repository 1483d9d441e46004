"""Attention: MHA/GQA/MQA with causal + sliding-window masks, logit
softcap, RoPE/M-RoPE, KV caches (full and ring buffer), and DeepSeek-V2's
MLA — the counterpart of ``repro.nn.attention``.

On the CPU every path computes what the JAX package computes, op for op
(``_sdpa``, and ``_sdpa_chunked`` above ``attn_chunk``). On a CUDA tensor,
where autograd needs no gradient through it (the kernel has no backward),
the full-sequence paths of ``Attention`` go through the flash-attention
kernel, ``kernels.attention.ops.attention``:
- causal self-attention (``prefill``, ``__call__`` with ``causal=True``
  and no ``kv_x``) when the mask's positions are the kernel's: the token
  indices (``positions=None``, or positions the model built as
  ``arange(S)`` and flagged with ``index_positions=True``; with M-RoPE the
  mask reads the temporal ids). A caller's own positions take the plain
  route;
- non-causal self-attention and cross-attention (``causal=False``, with or
  without ``kv_x``), whose mask is all ones whatever the positions.
A forward that autograd differentiates takes the plain route, on both
devices. The one-token ``decode``, ``attend_kv`` and ``MLAAttention`` (q·k
head dim 192, v head dim 128: the kernel takes one head dim for q, k and
v) run the plain ops on both devices, as the JAX package does. ``window``
is a Python int (0 or None: global).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..dist.sharding import blockwise, write_at_
from ..kernels import grad_route
from ..kernels.attention import ops as attention_ops
from .linear import MultiLinear, OutputLinear
from .module import Module
from .rotary import apply_mrope, apply_rope

NEG_INF = -2.3819763e38  # large negative for masking (fits bf16 after cast via fp32)


def _mask_bias(mask):
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def causal_window_mask(q_pos, k_pos, window=None):
    """Boolean mask (..., Sq, Sk): causal and optionally within a left window.

    q_pos/k_pos: int tensors broadcastable to (..., Sq) / (..., Sk).
    window: None or int; 0 or None means unbounded (global attention).
    """
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = k <= q
    if window is not None and window > 0:
        m = m & ((q - k) < window)
    return m


def _sdpa(q, k, v, mask, scale, softcap=None):
    """q: (B,Sq,Hk,G,D) k: (B,Sk,Hk,D) v: (B,Sk,Hk,Dv) mask: (B|1,1,Sq,Sk).
    Over DTensors, block by block over the batch and the heads
    (``dist.blockwise``)."""
    if mask.dim() != 4:
        raise ValueError(f"mask must be (B|1, 1, Sq, Sk), got {tuple(mask.shape)}")
    return blockwise(lambda *t: _sdpa_block(*t, scale, softcap), "bqhgd,bkhd,bkhv,bxqk->bqhgv", "bhg", q, k, v, mask)


def _scores(q, k):
    """``einsum("bqhgd,bkhd->bhgqk", q, k)`` as one ``bmm`` per batch row
    over views of ``k``: (Hk, G·Sq, D) @ (Hk, D, Sk), whose strides cuBLAS
    takes as they lie. The einsum folds (b, h) into one batch dim, which a
    (B, Sk, Hk, D) cache cannot view for B > 1, and so copies ``k`` whole."""
    B, Sq, Hk, G, D = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, Hk, G * Sq, D)
    return torch.stack([torch.bmm(qb, kb.permute(1, 2, 0)) for qb, kb in zip(qh.unbind(0), k.unbind(0))]).view(
        B, Hk, G, Sq, -1)


def _weighted(probs, v):
    """``einsum("bhgqk,bkhd->bqhgd", probs, v)`` as one ``bmm`` per batch row
    over views of ``v`` (``_scores``' counterpart)."""
    B, Hk, G, Sq, Sk = probs.shape
    ph = probs.reshape(B, Hk, G * Sq, Sk)
    out = torch.stack([torch.bmm(pb, vb.transpose(0, 1)) for pb, vb in zip(ph.unbind(0), v.unbind(0))])
    return out.view(B, Hk, G, Sq, -1).permute(0, 3, 1, 2, 4)


def _sdpa_block(q, k, v, mask, scale, softcap):
    scores = _scores(q, k).float() * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + _mask_bias(mask)[:, :, None, :, :]  # -> (B,1,1,Sq,Sk)
    probs = torch.softmax(scores, dim=-1)
    return _weighted(probs.to(v.dtype), v)


def effective_chunk(chunk: int, Sq: int, Sk: int, budget: int = 1 << 22) -> int:
    """Adapt the query chunk so the transient (chunk, Sk) score block stays
    within ~``budget`` elements per head."""
    ck = min(chunk, max(128, budget // max(Sk, 1)))
    while Sq % ck:
        ck //= 2
    return max(ck, 1)


def _sdpa_chunked(q, k, v, q_pos, k_pos, window, scale, softcap, chunk):
    """Query-chunked SDPA: one (chunk, Sk) score block at a time."""
    outs = []
    for start in range(0, q.shape[1], chunk):
        mask = causal_window_mask(q_pos[..., start : start + chunk], k_pos, window)[:, None]
        outs.append(_sdpa(q[:, start : start + chunk], k, v, mask, scale, softcap))
    return torch.cat(outs, dim=1)


def _write_slot(cache, new, slot):
    """``new`` (B, 1, ...) written into ``cache`` (B, S, ...) at ``slot`` (a
    0-d integer tensor) of its sequence dim, in place
    (``jax.lax.dynamic_update_slice`` at a traced index into the JAX cell's
    donated cache): returns ``cache``. On a DTensor split over the sequence
    only the rank that holds the slot changes its block, with no host read
    of ``slot`` (``dist.write_at_``)."""
    return write_at_(cache, new.to(cache.dtype), 1, slot)


def decode_position(t, like):
    """A decode step's position ``t`` (an int or a 0-d integer tensor) as a
    0-d int32 tensor on ``like``'s device: the JAX cell's replicated
    ``int32`` scalar. The step computes everything else from it on the
    device, with no host read, so one CUDA graph serves every ``t``."""
    if not isinstance(t, torch.Tensor):
        return torch.tensor(t, dtype=torch.int32, device=like.device)
    if t.device != like.device:
        t = t.to(like.device)
    return t if t.dtype == torch.int32 else t.to(torch.int32)


def _arange(S, device):
    return torch.arange(S, device=device)[None, :]


def _temporal(positions):
    """The mask's positions: M-RoPE's (B, S, 3) ids give their temporal ids."""
    return positions[..., 0] if positions is not None and positions.dim() == 3 else positions


@dataclasses.dataclass(frozen=True)
class Attention(Module):
    """GQA attention block (q/k/v/o projections + rotary)."""

    d_model: int
    n_q: int
    n_kv: int
    head_dim: int
    rope_base: float = 10000.0
    softcap: float | None = None
    query_scale: float | None = None  # default 1/sqrt(head_dim)
    mrope_sections: tuple[int, ...] | None = None
    use_rope: bool = True
    # query-chunked attention: bounds the transient (B,H,chunk,S) score
    # tensor of the plain route instead of materializing (B,H,S,S)
    attn_chunk: int = 0

    @property
    def _scale(self):
        return self.query_scale if self.query_scale is not None else 1.0 / math.sqrt(self.head_dim)

    def specs(self):
        return {
            "wq": MultiLinear(self.d_model, self.n_q, self.head_dim),
            "wk": MultiLinear(self.d_model, self.n_kv, self.head_dim),
            "wv": MultiLinear(self.d_model, self.n_kv, self.head_dim),
            "wo": OutputLinear(self.n_q, self.head_dim, self.d_model),
        }

    # -- helpers -------------------------------------------------------------
    def _qkv(self, p, x, positions, kv_x=None):
        kv_x = x if kv_x is None else kv_x
        q = MultiLinear(self.d_model, self.n_q, self.head_dim)(p["wq"], x)
        k, v = self.project_kv(p, kv_x)
        if self.use_rope and positions is not None:
            if self.mrope_sections is not None:
                q = apply_mrope(q, positions, self.mrope_sections, self.rope_base)
                k = apply_mrope(k, positions, self.mrope_sections, self.rope_base)
            else:
                q = apply_rope(q, positions, self.rope_base)
                k = apply_rope(k, positions, self.rope_base)
        return q, k, v

    def _group(self, q):
        b, s, _, d = q.shape
        return q.reshape(b, s, self.n_kv, self.n_q // self.n_kv, d)

    def _out(self, p, out):
        B, S = out.shape[:2]
        return OutputLinear(self.n_q, self.head_dim, self.d_model)(p["wo"], out.reshape(B, S, self.n_q, self.head_dim))

    def _attend(self, q, k, v, positions, window, causal=True, kv_positions=None, cross=False,
                index_positions=False):
        """The kernel on a CUDA tensor where its mask is the model's
        (non-causal attention, or causal self-attention over the token
        indices) and autograd needs no gradient; everything else takes the
        JAX package's path (``_sdpa``, or ``_sdpa_chunked`` above
        ``attn_chunk``)."""
        S, Sk = q.shape[1], k.shape[1]
        kernel_mask = not causal or (not cross and (positions is None or index_positions))
        if kernel_mask and q.device.type == "cuda" and not grad_route("flash_attention", q, k, v):
            return attention_ops.attention(q, k, v, causal=causal, window=max(window or 0, 0) if causal else 0,
                                           softcap=self.softcap, scale=self._scale)
        q_pos = _temporal(positions) if positions is not None else _arange(S, q.device)
        if not cross:
            k_pos = q_pos
        else:
            k_pos = kv_positions if kv_positions is not None else _arange(Sk, q.device)
        qg = self._group(q)
        ck = effective_chunk(self.attn_chunk, S, Sk) if self.attn_chunk else 0
        if causal and ck and S > ck and S % ck == 0:
            return _sdpa_chunked(qg, k, v, q_pos, k_pos, window, self._scale, self.softcap, ck)
        if causal:
            mask = causal_window_mask(q_pos, k_pos, window)[:, None]  # (B,1,Sq,Sk)
        else:
            mask = torch.ones((1, 1, S, Sk), dtype=torch.bool, device=q.device)
        return _sdpa(qg, k, v, mask, self._scale, self.softcap)

    # -- full-sequence (train / prefill) ---------------------------------------
    def prefill(self, p, x, positions=None, window=None, cache_dtype=torch.bfloat16, index_positions=False):
        """Full forward that also returns the KV cache for subsequent decode.
        ``index_positions``: ``positions`` is ``arange(S)`` in every row (the
        model built it), so the kernel's index-derived mask is the same."""
        q, k, v = self._qkv(p, x, positions)
        y = self._out(p, self._attend(q, k, v, positions, window, index_positions=index_positions))
        return y, {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}

    def __call__(self, p, x, positions=None, window=None, causal=True, kv_x=None, kv_positions=None,
                 index_positions=False):
        q, k, v = self._qkv(p, x, positions, kv_x=kv_x)
        return self._out(p, self._attend(q, k, v, positions, window, causal, kv_positions, kv_x is not None,
                                         index_positions))

    def project_kv(self, p, kv_x):
        """Compute (k, v) only — used to precompute cross-attention caches."""
        k = MultiLinear(self.d_model, self.n_kv, self.head_dim)(p["wk"], kv_x)
        v = MultiLinear(self.d_model, self.n_kv, self.head_dim)(p["wv"], kv_x)
        return k, v

    def attend_kv(self, p, x, k, v, mask=None):
        """Attention of queries from ``x`` against precomputed (k, v), no
        rotary; ``mask`` (B|1, 1, Sq, Sk), default all keys."""
        S = x.shape[1]
        q = MultiLinear(self.d_model, self.n_q, self.head_dim)(p["wq"], x)
        if mask is None:
            mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool, device=x.device)
        return self._out(p, _sdpa(self._group(q), k.to(q.dtype), v.to(q.dtype), mask, self._scale, self.softcap))

    # -- decode with cache -----------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        shape = (batch, max_len, self.n_kv, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}

    def abstract_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """``init_cache``'s tree as ``meta`` tensors."""
        return self.init_cache(batch, max_len, dtype, "meta")

    def decode(self, p, x, cache, t, window=None):
        """x: (B,1,d); t: index of the new token, a 0-d int32 tensor
        (``decode_position``). Returns (y, cache): the new token is written
        into the cache given, which is returned (the JAX cell donates its
        cache and updates it in place). The cache is a ring buffer of its
        own length: a decode at t >= its length overwrites slot t % length,
        as the JAX package's does. Nothing reads ``t`` on the host."""
        B = x.shape[0]
        dev = x.device
        t = decode_position(t, x)
        pos = t.expand(B, 1)
        if self.mrope_sections is not None:
            pos = pos[..., None].expand(B, 1, 3)
        q, k_new, v_new = self._qkv(p, x, pos)
        S = cache["k"].shape[1]
        slot = t % S  # full cache: S >= max_len so slot == t
        k, v = _write_slot(cache["k"], k_new, slot), _write_slot(cache["v"], v_new, slot)
        q_pos = t.reshape(1, 1)
        if S == 1:  # degenerate: window-1 cache
            k_pos = q_pos
        else:
            base = torch.arange(S, dtype=torch.int32, device=dev)
            # ring buffer: absolute position of each slot given current t
            k_pos = torch.where(base <= slot, t - (slot - base), t - (S - (base - slot)))[None, :]
        cache = {"k": k, "v": v}
        mask = causal_window_mask(q_pos, k_pos, window) & (k_pos >= 0)[..., None, :]
        out = _sdpa(self._group(q), k.to(q.dtype), v.to(q.dtype), mask[:, None], self._scale, self.softcap)
        return self._out(p, out), cache


def _probs(scores, mask, scale, dtype):
    return torch.softmax(scores.float() * scale + _mask_bias(mask), dim=-1).to(dtype)


def _softmax_out(scores, mask, v, eq, scale):
    return torch.einsum(eq, _probs(scores, mask, scale, v.dtype), v)


def _mla_block(q_nope, q_rope, k_nope, k_r, v, mask, scale):
    """MLA's scores (the no-RoPE and the shared RoPE key parts) and output."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope) + torch.einsum("bqhd,bkd->bhqk", q_rope, k_r)
    return _softmax_out(scores, mask, v, "bhqk,bkhd->bqhd", scale)


@dataclasses.dataclass(frozen=True)
class MLAAttention(Module):
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

    KV is compressed into a rank-``kv_lora`` latent + a shared RoPE key.
    The cache stores only (c_kv, k_rope): 512+64 floats per token instead of
    2 * n_heads * head_dim. ``absorb`` enables the paper's weight-absorption
    decode optimization (attend in latent space; no per-step k/v expansion).
    Plain ops on both devices (see the module docstring).
    """

    d_model: int
    n_q: int
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_base: float = 10000.0
    absorb: bool = False
    attn_chunk: int = 0

    @property
    def _scale(self):
        return 1.0 / math.sqrt(self.qk_nope_dim + self.qk_rope_dim)

    def _wq(self):
        return MultiLinear(self.d_model, self.n_q, self.qk_nope_dim + self.qk_rope_dim)

    def _wuk(self):
        return MultiLinear(self.kv_lora, self.n_q, self.qk_nope_dim, in_axis=None)

    def _wuv(self):
        return MultiLinear(self.kv_lora, self.n_q, self.v_head_dim, in_axis=None)

    def specs(self):
        return {
            "wq": self._wq(),
            "wdkv": MultiLinear(self.d_model, 1, self.kv_lora, head_axis=None),
            "wkr": MultiLinear(self.d_model, 1, self.qk_rope_dim, head_axis=None),
            "wuk": self._wuk(),
            "wuv": self._wuv(),
            "wo": OutputLinear(self.n_q, self.v_head_dim, self.d_model),
        }

    def _latents(self, p, x, positions):
        c_kv = MultiLinear(self.d_model, 1, self.kv_lora, head_axis=None)(p["wdkv"], x)[:, :, 0]
        k_r = MultiLinear(self.d_model, 1, self.qk_rope_dim, head_axis=None)(p["wkr"], x)
        if positions is not None:
            k_r = apply_rope(k_r, positions, self.rope_base)
        return c_kv, k_r[:, :, 0]

    def _q(self, p, x, positions):
        q = self._wq()(p["wq"], x)
        return q[..., : self.qk_nope_dim], apply_rope(q[..., self.qk_nope_dim :], positions, self.rope_base)

    def __call__(self, p, x, positions=None, window=None, causal=True, index_positions=False):
        """``index_positions`` (and ``prefill``'s) is taken for
        ``Attention``'s signature: MLA has no kernel route."""
        B, S, _ = x.shape
        if positions is None:
            positions = _arange(S, x.device)
        q_nope, q_rope = self._q(p, x, positions)
        c_kv, k_r = self._latents(p, x, positions)
        k_nope = self._wuk()(p["wuk"], c_kv)
        v = self._wuv()(p["wuv"], c_kv)

        def attend(q_nope_c, q_rope_c, q_pos_c):
            if causal:
                mask = causal_window_mask(q_pos_c, positions, window)[:, None]
            else:
                mask = torch.ones((1, 1, q_pos_c.shape[-1], S), dtype=torch.bool, device=x.device)
            return blockwise(lambda *t: _mla_block(*t, self._scale), "bqhd,bqhr,bkhd,bkr,bkhv,bxqk->bqhv", "bh",
                             q_nope_c, q_rope_c, k_nope, k_r, v, mask)

        ck = effective_chunk(self.attn_chunk, S, S) if self.attn_chunk else 0
        if ck and S > ck and S % ck == 0:
            out = torch.cat([attend(q_nope[:, st : st + ck], q_rope[:, st : st + ck], positions[..., st : st + ck])
                             for st in range(0, S, ck)], dim=1)
        else:
            out = attend(q_nope, q_rope, positions)
        return OutputLinear(self.n_q, self.v_head_dim, self.d_model)(p["wo"], out)

    def prefill(self, p, x, positions=None, window=None, cache_dtype=torch.bfloat16, index_positions=False):
        if positions is None:
            positions = _arange(x.shape[1], x.device)
        y = self(p, x, positions, window=window)
        c_kv, k_r = self._latents(p, x, positions)
        return y, {"c_kv": c_kv.to(cache_dtype), "k_r": k_r.to(cache_dtype)}

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        return {
            "c_kv": torch.zeros((batch, max_len, self.kv_lora), dtype=dtype, device=device),
            "k_r": torch.zeros((batch, max_len, self.qk_rope_dim), dtype=dtype, device=device),
        }

    def abstract_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        """``init_cache``'s tree as ``meta`` tensors."""
        return self.init_cache(batch, max_len, dtype, "meta")

    def decode(self, p, x, cache, t, window=None):
        """x: (B,1,d); t: a 0-d int32 tensor (``decode_position``). The new
        latents are written into the cache given, at slot min(t, S - 1), as
        ``jax.lax.dynamic_update_slice`` clamps its start index; the cache
        is returned. The scores and output read the expanded keys and
        values as views (``_scores``, ``_weighted``)."""
        B = x.shape[0]
        t = decode_position(t, x)
        pos = t.expand(B, 1)
        q_nope, q_rope = self._q(p, x, pos)
        c_new, kr_new = self._latents(p, x, pos)
        S = cache["c_kv"].shape[1]
        slot = t.clamp(max=S - 1)
        c_all, kr_all = _write_slot(cache["c_kv"], c_new, slot), _write_slot(cache["k_r"], kr_new, slot)
        cache = {"c_kv": c_all, "k_r": kr_all}
        c_kv, k_r = c_all.to(x.dtype), kr_all.to(x.dtype)
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        mask = causal_window_mask(t.reshape(1, 1), k_pos, window)[:, None]  # (1,1,1,S)
        rope_scores = torch.einsum("bqhd,bkd->bhqk", q_rope, k_r)
        if self.absorb:
            # weight absorption: q_nope' = q_nope @ W_uk  -> attend against c_kv
            wuk = p["wuk"]["w"].to(x.dtype)  # (kv_lora, H, nope)
            q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wuk)  # (B,1,H,r)
            scores = torch.einsum("bqhr,bkr->bhqk", q_lat, c_kv) + rope_scores
            out_lat = _softmax_out(scores, mask, c_kv, "bhqk,bkr->bqhr", self._scale)  # (B,1,H,r)
            out = torch.einsum("bqhr,rhd->bqhd", out_lat, p["wuv"]["w"].to(x.dtype))
        else:
            k_nope = self._wuk()(p["wuk"], c_kv)
            v = self._wuv()(p["wuv"], c_kv)
            scores = _scores(q_nope[:, :, :, None], k_nope)[:, :, 0] + rope_scores
            out = _weighted(_probs(scores, mask, self._scale, v.dtype)[:, :, None], v)[:, :, :, 0]
        return OutputLinear(self.n_q, self.v_head_dim, self.d_model)(p["wo"], out), cache
