"""Gemma-2 2B [arXiv:2408.00118; hf google/gemma-2-2b]: a copy of
``repro.configs.gemma2_2b``.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; alternating
local (4096-window) / global attention, attn softcap 50, final softcap 30,
head_dim 256, GeGLU, (1+scale) RMSNorm, post-norms, sqrt(d) embed scale.
Half the layers are sliding-window -> long_500k runs (ring-buffer caches).
"""
from ..models.lm import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_q=8,
    n_kv=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    layer_pattern="local_global",
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=0.0625,  # 1/sqrt(256)
    act="gelu_tanh",
    embed_scale=True,
    zero_centered_norm=True,
    post_norms=True,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="gemma2-2b-smoke",
    n_layers=4,
    d_model=64,
    n_q=4,
    n_kv=2,
    head_dim=32,
    d_ff=128,
    vocab=512,
    layer_pattern="local_global",
    local_window=8,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu_tanh",
    embed_scale=True,
    zero_centered_norm=True,
    post_norms=True,
)
