"""Architecture configuration schema (dense attention/MLP stacks).

The port's copy of ``repro.configs.base.ModelConfig`` restricted to the
fields a dense decoder uses: a stack of ``(mixer, ffn)`` blocks with
``mixer`` in {"attn", "attn_local"} and ``ffn == "dense"``.  The MLA,
MoE, SSM and xLSTM families come with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    activation: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # attention layout
    sliding_window: Optional[int] = None
    local_global_pattern: int = 0     # N local layers per 1 global

    param_dtype: str = "bfloat16"
    # KV-cache precision ("bfloat16" | "int8")
    kv_cache_dtype: str = "bfloat16"

    def layer_specs(self) -> tuple[tuple[str, str], ...]:
        """Per-layer (mixer, ffn) kinds."""
        out = []
        for i in range(self.n_layers):
            if self.local_global_pattern:
                p = self.local_global_pattern + 1
                mixer = ("attn" if (i % p) == self.local_global_pattern
                         else "attn_local")
            elif self.sliding_window:
                mixer = "attn_local"
            else:
                mixer = "attn"
            out.append((mixer, "dense"))
        return tuple(out)

    def layer_groups(self) -> list[tuple[tuple[str, str], int]]:
        """Run-length encoded consecutive layer specs: [(spec, count), ...]
        (the grouping of the reference's stacked parameter tree)."""
        groups: list[tuple[tuple[str, str], int]] = []
        for spec in self.layer_specs():
            if groups and groups[-1][0] == spec:
                groups[-1] = (spec, groups[-1][1] + 1)
            else:
                groups.append((spec, 1))
        return groups

    @property
    def gated(self) -> bool:
        return self.activation in ("geglu", "swiglu")

    def param_count(self) -> int:
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = (d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                     + self.n_heads * self.head_dim * d
                     + (3 if self.gated else 2) * d * self.d_ff)
        return int(total + self.n_layers * per_layer)
