"""Mamba-2 2.7B [arXiv:2405.21060; state-spaces/mamba2-2.7b]: a copy of
``repro.configs.mamba2_2_7b``.

64L d_model=2560 (attention-free), ssm_state=128, head_dim=64, expand=2,
vocab=50280. SSD (state-space duality) blocks. Sub-quadratic: all four
shapes run, including long_500k (decode state is O(1) in context).
"""
from ..models.mamba2 import Mamba2Config

FAMILY = "mamba2"

CONFIG = Mamba2Config(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    vocab=50280,
    d_state=128,
    d_conv=4,
    expand=2,
    head_dim=64,
    n_groups=1,
    chunk=256,
)

SMOKE = Mamba2Config(
    name="mamba2-smoke",
    n_layers=3,
    d_model=64,
    vocab=512,
    d_state=16,
    head_dim=16,
    chunk=8,
)

# Perf hillclimb (EXPERIMENTS.md §Perf): TP-only weights cut per-layer
# per-microbatch FSDP gathers 8.3x; 2.7B params fit sharded over model=16.
TRAIN_FSDP = False
