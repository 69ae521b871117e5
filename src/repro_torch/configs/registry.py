"""Architecture registry of the port: arch id -> (full config, smoke config),
the reference's ten architectures in the reference's order
(``repro.configs.registry``)."""

from __future__ import annotations

import importlib

from .base import ModelConfig, SHAPES, ShapeConfig, shape_applicable  # noqa: F401

_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "whisper-tiny": "whisper_tiny",
    "qwen3-32b": "qwen3_32b",
    "qwen3-14b": "qwen3_14b",
    "minicpm3-4b": "minicpm3_4b",
    "internlm2-1.8b": "internlm2_1_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "zamba2-7b": "zamba2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
