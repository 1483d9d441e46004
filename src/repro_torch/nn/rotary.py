"""Rotary position embeddings (standard RoPE; Qwen2-VL's M-RoPE comes with
that model)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, base: float = 10000.0, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (base**exponent)  # (head_dim/2,)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], base, x.device)
    angles = positions[..., None].to(torch.float32) * inv  # (B, S, hd/2)
    sin = torch.sin(angles)[..., None, :]  # (B, S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
