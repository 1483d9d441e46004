"""Qwen2-VL-7B [arXiv:2409.12191; hf Qwen/Qwen2-VL-7B-Instruct]: a copy of
``repro.configs.qwen2_vl_7b``.

Backbone only per the assignment: 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064, head_dim=128, M-RoPE sections (16,24,24).
The vision frontend is a STUB: input_specs provides precomputed patch
embeddings scattered into the token sequence + (t,h,w) position ids.
Pure full attention -> long_500k skipped.
"""
from ..models.lm import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="qwen2-vl-7b",
    n_layers=28,
    d_model=3584,
    n_q=28,
    n_kv=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    act="silu",
    rope_base=1000000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name="qwen2-vl-smoke",
    n_layers=3,
    d_model=64,
    n_q=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    mrope_sections=(2, 3, 3),
    tie_embeddings=False,
)

SKIP_SHAPES = ("long_500k",)
SKIP_REASONS = {"long_500k": "pure full-attention arch (quadratic); per assignment skip"}

TRAIN_MICRO = 16
