"""--arch registry: id -> config (the architectures the port runs).

Two tables, one per workload class: autoregressive LMs
(``ModelConfig``: ``get_config`` / ``ARCH_IDS``) and diffusion
transformers (``DiTConfig``: ``get_dit_config`` / ``DIT_ARCH_IDS`` /
``all_dit_configs``)."""
from __future__ import annotations

import importlib

from .base import ModelConfig
from .dit import DiTConfig

_MODULES = {
    "gemma-2b": "gemma_2b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-67b": "deepseek_67b",
    "command-r-plus-104b": "command_r_plus_104b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "xlstm-350m": "xlstm_350m",
}

_DIT_MODULES = {
    "dit-xl-2": "dit_xl_2",
    "dit-test": "dit_test",
}

ARCH_IDS = tuple(_MODULES)
DIT_ARCH_IDS = tuple(_DIT_MODULES)


def _load(table: dict, arch: str, what: str):
    try:
        mod = table[arch]
    except KeyError:
        raise KeyError(f"unknown {what} {arch!r}; options: {list(table)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def get_config(arch: str) -> ModelConfig:
    if arch in _DIT_MODULES:
        raise KeyError(f"{arch!r} is a diffusion config; use "
                       f"get_dit_config({arch!r})")
    return _load(_MODULES, arch, "arch")


def get_dit_config(arch: str) -> DiTConfig:
    return _load(_DIT_MODULES, arch, "dit arch")


def all_dit_configs() -> dict[str, DiTConfig]:
    return {a: get_dit_config(a) for a in DIT_ARCH_IDS}
