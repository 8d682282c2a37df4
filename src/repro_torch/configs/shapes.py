"""The assigned input-shape cells, ``input_specs`` and the reduced smoke
configs (port of ``repro/configs/shapes.py``).

Four shapes per architecture (40 cells):
    train_4k     seq 4096,   global_batch 256   (training: train_step)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one token, 32k KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode)

``long_500k`` needs sub-quadratic context handling and is skipped for the
pure full-attention archs (``ModelConfig.long_context_capable`` gates
it).  :func:`input_specs` gives each step's inputs as tensors on torch's
``meta`` device: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str                  # "train" | "prefill" | "decode"
    q_tokens: int = 1          # decode tokens per step (speculative verify)


# The 4 assigned shape cells (x 10 archs = the 40-cell matrix).
ASSIGNED_SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Variants looked up by name, outside the assigned sweep.
PERF_SHAPES: dict[str, ShapeCell] = {
    # speculative-decoding verify step: 4 draft tokens scored per forward
    "decode_32k_spec4": ShapeCell("decode_32k_spec4", 32768, 128, "decode",
                                  q_tokens=4),
}

SHAPES: dict[str, ShapeCell] = {**ASSIGNED_SHAPES, **PERF_SHAPES}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(applicable?, reason if not)."""
    if shape == "long_500k" and not cfg.long_context_capable:
        return False, ("pure full-attention arch: 500k dense KV decode "
                       "skipped per assignment (DESIGN.md "
                       "§Arch-applicability)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Every input of the cell's step as a ``meta`` tensor (no storage):
    int32 tokens and targets, bf16 frame embeddings (audio) and patch
    embeddings (vision)."""
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    def tokens(n):
        return spec((B, n), torch.int32)

    def frames(n):
        return spec((B, n, cfg.d_model), torch.bfloat16)

    def patches():
        return spec((B, cfg.frontend_len, cfg.frontend_dim), torch.bfloat16)

    if cell.step == "train":
        if cfg.frontend == "audio":
            return {"frame_embeddings": frames(S), "targets": tokens(S)}
        if cfg.frontend == "vision":
            st = S - cfg.frontend_len
            return {"patch_embeddings": patches(), "inputs": tokens(st),
                    "targets": tokens(st)}
        return {"inputs": tokens(S), "targets": tokens(S)}
    if cell.step == "prefill":
        if cfg.frontend == "audio":
            return {"frame_embeddings": frames(S)}
        if cfg.frontend == "vision":
            return {"patch_embeddings": patches(),
                    "inputs": tokens(S - cfg.frontend_len)}
        return {"inputs": tokens(S)}
    # decode: q_tokens new tokens against a cache of S
    q = cell.q_tokens
    if cfg.frontend == "audio":
        return {"frame_embeddings": frames(q)}
    return {"inputs": tokens(q)}


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests (same family, tiny dims)
# ---------------------------------------------------------------------------


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
        remat=False,
    )
    if cfg.local_global_pattern:
        kw["n_layers"] = 4
        kw["local_global_pattern"] = 1       # alternate local/global
        kw["sliding_window"] = 8
    if cfg.attn_every:
        kw["attn_every"] = 2
        kw["n_layers"] = 4
    if cfg.mla is not None:
        from repro_torch.models.mla import MLAConfig
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_routed_experts=8, top_k=2, d_expert=32,
            shared_d_ff=32 if cfg.moe.n_shared_experts else 0,
            first_k_dense=min(cfg.moe.first_k_dense, 1))
    if cfg.ssm is not None:
        from repro_torch.models.ssm import SSMConfig
        kw["ssm"] = SSMConfig(state_dim=8, head_dim=16, expand=2,
                              conv_kernel=4, chunk=8)
    if cfg.xlstm is not None:
        from repro_torch.models.xlstm import XLSTMConfig
        kw["xlstm"] = XLSTMConfig(n_heads=4, conv_kernel=4, chunk=8,
                                  slstm_every=cfg.xlstm.slstm_every and 2)
        kw["n_layers"] = 4
    if cfg.frontend == "vision":
        kw["frontend_len"] = 4
        kw["frontend_dim"] = 32
    return dataclasses.replace(cfg, **kw)
