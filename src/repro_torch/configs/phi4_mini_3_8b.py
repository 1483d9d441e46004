"""Phi-4-mini 3.8B [arXiv:2412.08905; hf microsoft/Phi-4-mini-instruct]: a copy of
``repro.configs.phi4_mini_3_8b``.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, head_dim=128,
RoPE + SwiGLU + GQA, tied embeddings. Pure full attention -> long_500k
skipped.
"""
from ..models.lm import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_q=24,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    act="silu",
    rope_base=10000.0,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="phi4-mini-smoke",
    n_layers=3,
    d_model=96,
    n_q=6,
    n_kv=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    act="silu",
)

SKIP_SHAPES = ("long_500k",)
SKIP_REASONS = {"long_500k": "pure full-attention arch (quadratic); per assignment skip"}

TRAIN_MICRO = 16
