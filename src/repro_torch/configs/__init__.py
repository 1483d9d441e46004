"""Architecture registry (the counterpart of ``repro.configs``): one module
per ported architecture, each a copy of the JAX package's, exposing
``CONFIG`` (full, assignment-exact) and ``SMOKE`` (reduced same-family
config for CPU tests).

Families not ported yet raise ``NotImplementedError`` naming their
ROADMAP item from ``get_arch``; the port has no config class of theirs, so
``build_model`` (a ``TypeError`` for any config it does not know) cannot
be handed one.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

# the JAX package's assigned architectures and their families
ARCH_IDS = (
    "deepseek_moe_16b",
    "deepseek_v2_lite_16b",
    "gemma2_2b",
    "gemma_2b",
    "gemma2_27b",
    "phi4_mini_3_8b",
    "mamba2_2_7b",
    "whisper_small",
    "hymba_1_5b",
    "qwen2_vl_7b",
)
FAMILIES = {
    "deepseek_moe_16b": "lm",
    "deepseek_v2_lite_16b": "lm",
    "gemma2_2b": "lm",
    "gemma_2b": "lm",
    "gemma2_27b": "lm",
    "phi4_mini_3_8b": "lm",
    "mamba2_2_7b": "mamba2",
    "whisper_small": "whisper",
    "hymba_1_5b": "hymba",
    "qwen2_vl_7b": "lm",
    "pix2pix_mri": "pix2pix",
    "yolov8_stroke": "yolo",
}
PORTED = ("hymba", "pix2pix", "yolo")
# where each family not ported yet is queued
_QUEUED = {
    "lm": "ROADMAP module queue item 3 (TransformerLM: dense, then MoE, MLA, M-RoPE)",
    "mamba2": "ROADMAP module queue item 3 (Mamba2LM)",
    "whisper": "ROADMAP module queue item 3 (WhisperModel)",
}

# assignment shape set (LM transformers): seq_len x global_batch
SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # lm | mamba2 | hymba | whisper | pix2pix | yolo
    config: Any
    smoke: Any


_CACHE: dict[str, ArchSpec] = {}


def get_arch(name: str) -> ArchSpec:
    key = name.replace("-", "_").replace(".", "_")
    if key not in FAMILIES:
        raise KeyError(f"unknown architecture {name!r}")
    family = FAMILIES[key]
    if family not in PORTED:
        raise NotImplementedError(f"{key}: the {family!r} family is not ported yet ({_QUEUED[family]})")
    if key not in _CACHE:
        mod = importlib.import_module(f"{__name__}.{key}")
        _CACHE[key] = ArchSpec(name=key, family=mod.FAMILY, config=mod.CONFIG, smoke=mod.SMOKE)
    return _CACHE[key]


def build_model(cfg):
    from ..models import HymbaConfig, HymbaLM, Pix2Pix, Pix2PixConfig, YOLOv8, YOLOv8Config

    if isinstance(cfg, HymbaConfig):
        return HymbaLM(cfg)
    if isinstance(cfg, Pix2PixConfig):
        return Pix2Pix(cfg)
    if isinstance(cfg, YOLOv8Config):
        return YOLOv8(cfg)
    raise TypeError(type(cfg))
