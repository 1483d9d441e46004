"""GQA attention with causal + sliding-window masks, logit softcap, RoPE
and KV caches (full and ring buffer): the full-sequence and decode paths of
``repro.nn.attention.Attention``.

On the CPU every path computes what the JAX package computes, op for op
(``_sdpa``, and ``_sdpa_chunked`` above ``attn_chunk``). On a CUDA tensor
the full-sequence causal self-attention (``prefill``, and ``__call__``
with ``causal=True`` and no ``kv_x``) goes through the flash-attention
kernel, ``kernels.attention.ops.attention``, when the mask's positions are
the kernel's: the token indices (``positions=None``, or positions the model
built as ``arange(S)`` and flagged with ``index_positions=True``) and
autograd needs no gradient through it (the kernel has no backward). A
caller's own positions, and a forward that autograd differentiates, take
the plain route, on both devices. ``window`` is a Python int
(0 or None: global). MLA and the cross-attention helpers come with the
models that use them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import grad_route
from ..kernels.attention import ops as attention_ops
from .linear import MultiLinear, OutputLinear
from .module import Module
from .rotary import apply_rope

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
    """q: (B,Sq,Hk,G,D) k: (B,Sk,Hk,D) v: (B,Sk,Hk,Dv) mask: (B|1,1,Sq,Sk)."""
    if mask.dim() != 4:
        raise ValueError(f"mask must be (B|1, 1, Sq, Sk), got {tuple(mask.shape)}")
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + _mask_bias(mask)[:, :, None, :, :]  # -> (B,1,1,Sq,Sk)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


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


def _arange(S, device):
    return torch.arange(S, device=device)[None, :]


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
        k = MultiLinear(self.d_model, self.n_kv, self.head_dim)(p["wk"], kv_x)
        v = MultiLinear(self.d_model, self.n_kv, self.head_dim)(p["wv"], kv_x)
        if self.use_rope and positions is not None:
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
        """Causal self-attention over the full sequence goes through the
        kernel on a CUDA tensor whose mask positions are the token indices,
        unless autograd needs its gradient; everything else takes the JAX
        package's path (``_sdpa``, or ``_sdpa_chunked`` above
        ``attn_chunk``)."""
        S, Sk = q.shape[1], k.shape[1]
        if (causal and not cross and q.device.type == "cuda" and (positions is None or index_positions)
                and not grad_route("flash_attention", q, k, v)):
            return attention_ops.attention(q, k, v, causal=True, window=max(window or 0, 0),
                                           softcap=self.softcap, scale=self._scale)
        q_pos = positions if positions is not None else _arange(S, q.device)
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

    # -- decode with cache -----------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        shape = (batch, max_len, self.n_kv, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, p, x, cache, t: int, window=None):
        """x: (B,1,d); t: index of the new token. Returns (y, cache); the
        cache given is not modified (a new one is returned, as in JAX)."""
        B = x.shape[0]
        dev = x.device
        pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
        q, k_new, v_new = self._qkv(p, x, pos)
        S = cache["k"].shape[1]
        if S == 1:  # degenerate: window-1 cache
            k, v = k_new.to(cache["k"].dtype), v_new.to(cache["v"].dtype)
            k_pos = torch.full((1, 1), t, dtype=torch.int32, device=dev)
        else:
            slot = t % S  # full cache: S >= max_len so slot == t
            k, v = cache["k"].clone(), cache["v"].clone()
            k[:, slot] = k_new[:, 0].to(k.dtype)
            v[:, slot] = v_new[:, 0].to(v.dtype)
            base = torch.arange(S, dtype=torch.int32, device=dev)
            # ring buffer: absolute position of each slot given current t
            k_pos = torch.where(base <= slot, t - (slot - base), t - (S - (base - slot)))[None, :]
        cache = {"k": k, "v": v}
        q_pos = torch.full((1, 1), t, dtype=torch.int32, device=dev)
        mask = causal_window_mask(q_pos, k_pos, window) & (k_pos >= 0)[..., None, :]
        out = _sdpa(self._group(q), k.to(q.dtype), v.to(q.dtype), mask[:, None], self._scale, self.softcap)
        return self._out(p, out), cache
