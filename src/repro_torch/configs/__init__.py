"""Architecture registry (the counterpart of ``repro.configs``): one module
per architecture, each a copy of the JAX package's, exposing ``CONFIG``
(full, assignment-exact), ``SMOKE`` (reduced same-family config for CPU
tests) and, where the JAX package's has them, ``SKIP_SHAPES`` /
``SKIP_REASONS`` (shapes an architecture skips, and why), ``TRAIN_MICRO``
and ``TRAIN_FSDP`` (its training launcher's microbatches and weight
sharding, carried for the training slice).
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
    skip_shapes: tuple[str, ...] = ()
    skip_reasons: dict | None = None
    train_micro: int = 8  # microbatches for the train-shape dry-run/launcher
    train_fsdp: bool = True  # False => TP-only weights (small models: kills FSDP gathers)


_CACHE: dict[str, ArchSpec] = {}


def get_arch(name: str) -> ArchSpec:
    key = name.replace("-", "_").replace(".", "_")
    if key not in FAMILIES:
        raise KeyError(f"unknown architecture {name!r}")
    if key not in _CACHE:
        mod = importlib.import_module(f"{__name__}.{key}")
        _CACHE[key] = ArchSpec(
            name=key,
            family=mod.FAMILY,
            config=mod.CONFIG,
            smoke=mod.SMOKE,
            skip_shapes=tuple(getattr(mod, "SKIP_SHAPES", ())),
            skip_reasons=getattr(mod, "SKIP_REASONS", None),
            train_micro=getattr(mod, "TRAIN_MICRO", 8),
            train_fsdp=getattr(mod, "TRAIN_FSDP", True),
        )
    return _CACHE[key]


def all_archs() -> list[ArchSpec]:
    return [get_arch(a) for a in ARCH_IDS]


def build_model(cfg):
    from ..models import (
        HymbaConfig,
        HymbaLM,
        LMConfig,
        Mamba2Config,
        Mamba2LM,
        Pix2Pix,
        Pix2PixConfig,
        TransformerLM,
        WhisperConfig,
        WhisperModel,
        YOLOv8,
        YOLOv8Config,
    )

    if isinstance(cfg, LMConfig):
        return TransformerLM(cfg)
    if isinstance(cfg, Mamba2Config):
        return Mamba2LM(cfg)
    if isinstance(cfg, HymbaConfig):
        return HymbaLM(cfg)
    if isinstance(cfg, WhisperConfig):
        return WhisperModel(cfg)
    if isinstance(cfg, Pix2PixConfig):
        return Pix2Pix(cfg)
    if isinstance(cfg, YOLOv8Config):
        return YOLOv8(cfg)
    raise TypeError(type(cfg))
