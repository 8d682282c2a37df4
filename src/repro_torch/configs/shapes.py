"""Reduced configs for CPU smoke tests (same family, tiny dims)."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink every axis while preserving the family structure (the
    same dims as the reference's ``reduced_config``)."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
    )
    if cfg.local_global_pattern:
        kw["n_layers"] = 4
        kw["local_global_pattern"] = 1       # alternate local/global
        kw["sliding_window"] = 8
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_routed_experts=8, top_k=2, d_expert=32,
            shared_d_ff=32 if cfg.moe.n_shared_experts else 0,
            first_k_dense=min(cfg.moe.first_k_dense, 1))
    return dataclasses.replace(cfg, **kw)
