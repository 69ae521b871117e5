"""Architecture registry of the port: arch id -> (full config, smoke config).

It lists only the architectures the port can build.  The reference's other
archs (``repro.configs.registry``) raise :class:`KeyError` here until their
modules are ported.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig, SHAPES, ShapeConfig, shape_applicable  # noqa: F401

_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "whisper-tiny": "whisper_tiny",
    "zamba2-7b": "zamba2_7b",
}

#: the reference's archs that the port does not build yet
NOT_PORTED = (
    "qwen3-32b", "qwen3-14b", "minicpm3-4b",
    "internlm2-1.8b", "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b",
    "llava-next-mistral-7b",
)

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported to PyTorch yet; ported: {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE
