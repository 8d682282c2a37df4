"""Architecture configuration schema (attention stacks, dense or MoE).

The port's copy of ``repro.configs.base.ModelConfig`` restricted to the
fields the ported families use: a stack of ``(mixer, ffn)`` blocks with
``mixer`` in {"attn", "attn_local"} and ``ffn`` in {"dense", "moe"}.
The MLA, SSM and xLSTM families come with later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:       # the models package imports this module
    from repro_torch.models.moe import MoEConfig


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

    # family extensions
    moe: Optional["MoEConfig"] = None

    family: str = "dense"             # dense | moe
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
            ffn = ("moe" if self.moe is not None
                   and i >= self.moe.first_k_dense else "dense")
            out.append((mixer, ffn))
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
        mult = 3 if self.gated else 2
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for _mixer, ffn in self.layer_specs():
            total += (d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                      + self.n_heads * self.head_dim * d)
            if ffn == "dense":
                total += mult * d * self.d_ff
            else:
                mo = self.moe
                total += mo.n_routed_experts * (mult * d * mo.d_expert + d)
                total += mult * d * mo.shared_width
        return int(total)
