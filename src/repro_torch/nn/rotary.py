"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, base: float = 10000.0, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (base**exponent)  # (head_dim/2,)


def _rotate(x, angles):
    """x (B, S, H, hd) rotated by angles (B, S, hd/2), in f32, cast back."""
    sin = torch.sin(angles)[..., None, :]  # (B, S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], base, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * inv)


def apply_mrope(x, positions, sections: tuple[int, ...], base: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).

    x: (B, S, H, hd); positions: (B, S, 3) — (temporal, height, width) ids.
    ``sections`` gives the per-component frequency split (sums to hd/2):
    frequency band j takes its angle from component ``comp[j]``. Text-only
    tokens carry identical t/h/w ids, reducing to standard RoPE.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim / 2 = {hd // 2}")
    inv = rope_freqs(hd, base, x.device)
    comp = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device) for i, s in enumerate(sections)])
    pos = positions.to(torch.float32)[..., comp]  # (B, S, hd/2)
    return _rotate(x, pos * inv)
