"""Hymba-1.5B [arXiv:2411.13676; hf nvidia/Hymba-1.5B-Base]: a copy of
``repro.configs.hymba_1_5b``.

32L d_model=1600, 25 attention heads (GQA kv=5, head_dim=64) fused in
parallel with Mamba heads (ssm_state=16), d_ff=5504, vocab=32001.
Sliding-window attention everywhere except 3 global layers (first /
middle / last).
"""
from ..models.hymba import HymbaConfig

FAMILY = "hymba"

CONFIG = HymbaConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_q=25,
    n_kv=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    head_dim=64,
    ssm_head_dim=64,
    local_window=1024,
    global_layers=(0, 15, 31),
    expand=2,
    chunk=256,
)

SMOKE = HymbaConfig(
    name="hymba-smoke",
    n_layers=3,
    d_model=64,
    n_q=4,
    n_kv=2,
    d_ff=128,
    vocab=512,
    ssm_state=16,
    head_dim=16,
    ssm_head_dim=16,
    local_window=8,
    global_layers=(0, 2),
    chunk=8,
)
