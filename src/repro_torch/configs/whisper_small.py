"""Whisper-small [arXiv:2212.04356; hf openai/whisper-small]: a copy of
``repro.configs.whisper_small``.

12L enc + 12L dec, d_model=768, 12H, d_ff=3072, vocab=51865, enc-dec.
Audio conv frontend is a STUB per the assignment: input_specs provides
precomputed frame embeddings (B, 1500, 768). decode_32k runs mechanically
with a 32k-token decoder self-KV (beyond Whisper's 448-token design —
positions tile; noted in DESIGN.md). long_500k skipped (full attention,
30 s audio window).
"""
from ..models.whisper import WhisperConfig

FAMILY = "whisper"

CONFIG = WhisperConfig(
    name="whisper-small",
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
    vocab=51865,
    n_frames=1500,
    max_text=448,
)

SMOKE = WhisperConfig(
    name="whisper-smoke",
    n_enc_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    d_ff=128,
    vocab=512,
    n_frames=32,
    max_text=64,
)

SKIP_SHAPES = ("long_500k",)
SKIP_REASONS = {"long_500k": "enc-dec with full attention and a 30s audio window; per assignment skip"}
