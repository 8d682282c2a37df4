"""--arch registry: id -> config (the architectures the port runs)."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "gemma-2b": "gemma_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; options: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
