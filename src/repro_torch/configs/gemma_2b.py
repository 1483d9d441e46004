"""Gemma 2B [arXiv:2403.08295; hf google/gemma-2b]: a copy of
``repro.configs.gemma_2b``.

18L d_model=2048 8H MQA (kv=1) d_ff=16384 vocab=256000, head_dim=256,
GeGLU, sqrt(d) embed scaling, (1+scale) RMSNorm. Pure full attention ->
long_500k skipped.
"""
from ..models.lm import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_q=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="gelu_tanh",
    embed_scale=True,
    zero_centered_norm=True,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="gemma-2b-smoke",
    n_layers=3,
    d_model=64,
    n_q=4,
    n_kv=1,
    head_dim=32,
    d_ff=256,
    vocab=512,
    act="gelu_tanh",
    embed_scale=True,
    zero_centered_norm=True,
)

SKIP_SHAPES = ("long_500k",)
SKIP_REASONS = {"long_500k": "pure full-attention arch (quadratic); per assignment skip"}
