"""DeepSeekMoE-16B [arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base]: a copy of
``repro.configs.deepseek_moe_16b``.

28L d_model=2048 16H (GQA kv=16 = MHA) vocab=102400; fine-grained MoE:
64 routed experts top-6 + 2 shared, expert d_ff=1408; first layer dense
(width 8x expert = shared+routed active capacity). Full (quadratic)
attention -> long_500k skipped per assignment rules.
"""
from ..models.lm import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_q=16,
    n_kv=16,
    head_dim=128,
    d_ff=8 * 1408,  # dense first layer (~ the 10944 of the HF config)
    vocab=102400,
    moe=True,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared=2,
    first_k_dense=1,
    act="silu",
    rope_base=10000.0,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name="deepseek-moe-smoke",
    n_layers=3,
    d_model=64,
    n_q=4,
    n_kv=4,
    head_dim=16,
    d_ff=8 * 32,
    vocab=512,
    moe=True,
    n_experts=8,
    top_k=2,
    d_ff_expert=32,
    n_shared=2,
    first_k_dense=1,
    tie_embeddings=False,
)

SKIP_SHAPES = ("long_500k",)
SKIP_REASONS = {"long_500k": "pure full-attention arch (quadratic); per assignment skip"}
