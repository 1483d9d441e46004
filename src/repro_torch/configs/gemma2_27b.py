"""Gemma-2 27B [arXiv:2408.00118; hf google/gemma-2-27b]: a copy of
``repro.configs.gemma2_27b``.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128,
query scale 1/sqrt(d_model/n_q)=1/12 (the 27B's query_pre_attn_scalar),
alternating local(4096)/global, softcaps 50/30. long_500k runs.
"""
from ..models.lm import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_q=32,
    n_kv=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    layer_pattern="local_global",
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=1.0 / 12.0,
    act="gelu_tanh",
    embed_scale=True,
    zero_centered_norm=True,
    post_norms=True,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="gemma2-27b-smoke",
    n_layers=4,
    d_model=96,
    n_q=8,
    n_kv=4,
    head_dim=16,
    d_ff=256,
    vocab=512,
    layer_pattern="local_global",
    local_window=8,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=1.0 / 12.0,
    act="gelu_tanh",
    embed_scale=True,
    zero_centered_norm=True,
    post_norms=True,
)

TRAIN_MICRO = 16
