"""Flash attention: a CPU tensor goes to the plain version in ``ref.py``, a
CUDA tensor to the hand-written kernel in ``kernel.py`` (or the call
raises: there is no fallback on the card, and the kernel takes every
length, ragged tails included).

The signature follows ``repro.kernels.attention.ops.attention`` without its
TPU knobs (``use_pallas``, ``interpret``). ``launches`` counts the calls
that launched the CUDA kernel — the proof that a run went through it. Like
the other kernel ops, it refuses to run where autograd would need its
gradient (``kernels.refuse_grad``).
"""
from __future__ import annotations

from .. import LM_HINT, refuse_grad
from .kernel import flash_attention_cuda
from .ref import attention_ref

launches = {"flash_attention": 0}


def reset_launches():
    launches["flash_attention"] = 0


def attention(q, k, v, causal=True, window=0, softcap=None, scale=None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hk, D) -> (B, Sq, Hq, D). Query head h
    reads KV head h // (Hq // Hk); window > 0 keeps the last ``window``
    keys; query row i sits at key position i + Sk - Sq."""
    refuse_grad("flash_attention", q, k, v, hint=LM_HINT)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    o = flash_attention_cuda(
        q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous(),
        causal=causal, window=window, softcap=softcap, scale=scale,
    )
    launches["flash_attention"] += 1
    return o
