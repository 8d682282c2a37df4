"""Architecture configuration schema (attention or MLA stacks, dense or
MoE, Mamba-2 hybrids and xLSTM stacks).

The port's copy of ``repro.configs.base.ModelConfig`` restricted to the
fields the ported families use: a stack of ``(mixer, ffn)`` blocks with
``mixer`` in {"attn", "attn_local", "mla", "mamba2", "mlstm", "slstm"}
and ``ffn`` in {"dense", "moe", "none"} (a Mamba-2 or xLSTM block has no
FFN); rmsnorm or layernorm, optional per-head ``qk_norm``, and the
reference's stub frontends (``"vision"``: patch embeddings projected by
``frontend_proj`` into an image prefix that the global layers attend
bidirectionally; ``"audio"``: frame embeddings at ``d_model`` in place
of the token lookup).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:       # the models package imports this module
    from repro_torch.models.mla import MLAConfig
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.ssm import SSMConfig
    from repro_torch.models.xlstm import XLSTMConfig


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
    qk_norm: bool = False
    tie_embeddings: bool = False

    # attention layout
    sliding_window: Optional[int] = None
    local_global_pattern: int = 0     # N local layers per 1 global
    attn_every: int = 0               # hybrid: attention block every k layers

    # family extensions
    mla: Optional["MLAConfig"] = None
    moe: Optional["MoEConfig"] = None
    ssm: Optional["SSMConfig"] = None
    xlstm: Optional["XLSTMConfig"] = None

    # modality frontend (stub): None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_len: int = 0             # e.g. 256 SigLIP patches
    frontend_dim: int = 0             # frontend embedding dim (0 = d_model)

    family: str = "dense"             # dense | moe | ssm | hybrid | vlm | audio
    # the long_500k cell (a 524288-token decode) applies only where this
    # is set: sub-quadratic context (recurrent state, sparse attention)
    long_context_capable: bool = False
    param_dtype: str = "bfloat16"
    # KV-cache precision ("bfloat16" | "int8")
    kv_cache_dtype: str = "bfloat16"

    # training: recompute each layer in the backward (the reference's
    # jax.checkpoint per layer group), and microbatches a train step
    # sums its gradients over
    remat: bool = True
    train_microbatches: int = 1

    def layer_specs(self) -> tuple[tuple[str, str], ...]:
        """Per-layer (mixer, ffn) kinds."""
        out = []
        for i in range(self.n_layers):
            if self.xlstm is not None:
                e = self.xlstm.slstm_every
                out.append(("slstm", "none") if e and i % e == e - 1
                           else ("mlstm", "none"))
                continue
            if self.ssm is not None:
                e = self.attn_every
                out.append(("attn", "dense") if e and i % e == e - 1
                           else ("mamba2", "none"))
                continue
            if self.mla is not None:
                mixer = "mla"
            elif self.local_global_pattern:
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
        """The reference's count: embeddings, head, mixers and FFNs.  Like
        the reference's, it leaves out the norms and ``frontend_proj``
        (paligemma-3b's [1152, 2048], 2.36 M)."""
        d = self.d_model
        mult = 3 if self.gated else 2
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for mixer, ffn in self.layer_specs():
            if mixer == "mla":
                m, H = self.mla, self.n_heads
                total += d * m.q_lora_rank + m.q_lora_rank * H * m.qk_head_dim
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * H * (m.qk_nope_head_dim
                                               + m.v_head_dim)
                total += H * m.v_head_dim * d
            elif mixer == "mamba2":
                s = self.ssm
                total += d * (2 * s.d_inner(d) + 2 * s.n_groups * s.state_dim
                              + s.n_heads(d)) + s.d_inner(d) * d
            elif mixer == "mlstm":
                di = int(self.xlstm.mlstm_proj_factor * d)
                total += d * 2 * di + 3 * di * di + di * d
            elif mixer == "slstm":
                total += (4 * d * d
                          + int(self.xlstm.slstm_ffn_factor * d) * d * 3)
            else:
                total += (d * (self.n_heads + 2 * self.n_kv_heads)
                          * self.head_dim + self.n_heads * self.head_dim * d)
            if ffn == "dense":
                total += mult * d * self.d_ff
            elif ffn == "moe":
                mo = self.moe
                total += mo.n_routed_experts * (mult * d * mo.d_expert + d)
                total += mult * d * mo.shared_width
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token passes through: :meth:`param_count` with
        each MoE layer's routed experts counted ``top_k`` times, not
        ``n_routed_experts`` times (the reference's MoE accounting)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        mult = 3 if self.gated else 2
        n_moe = sum(1 for _, f in self.layer_specs() if f == "moe")
        routed_all = n_moe * mo.n_routed_experts * mult * self.d_model \
            * mo.d_expert
        routed_active = n_moe * mo.top_k * mult * self.d_model * mo.d_expert
        return int(self.param_count() - routed_all + routed_active)
