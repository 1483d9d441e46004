"""Plain PyTorch version of flash attention: GQA + causal + sliding window +
logit softcap (the gemma2 / hymba / phi4 attention flavours), a copy of
``repro.kernels.attention.ref.attention_ref``. ``ops.py`` takes it for CPU
tensors; on the card the CUDA kernel is held against it."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def attention_ref(q, k, v, causal=True, window=0, softcap=None, scale=None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hk, D); Hq % Hk == 0.

    window > 0 limits attention to the last ``window`` keys (inclusive of
    self). Query row i sits at key position i + Sk - Sq (ends aligned).
    Returns (B, Sq, Hq, D) in v's dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hk, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= (qpos - kpos) < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)
