"""QuantPlan: a whole-model INT8 execution plan (port of
``repro/quant/plan.py``).

Per logical layer kind, whether that layer runs on the fused INT8
pipeline:

    ``mlp``       dense-FFN up/gate/down     (quantize + 2 fused GEMMs,
                                              + 1 row quantize when
                                              d_ff > MAX_FUSED_QUANT_N)
    ``attn_qkv``  q/k/v projections          (ONE wide fused GEMM,
                                              activations quantized
                                              in-kernel)
    ``attn_out``  attention out-projection   (one fused GEMM with the
                                              residual in its epilogue)
    ``attn_kv``   decode KV cache            (KV stored int8 at the
                                              cache-update site; the
                                              flash-decode kernel
                                              dequantizes in-kernel)
    ``moe_experts`` routed experts + shared  (quantize + grouped gated
                  expert of an MoE layer      GEMM with the requant in
                                              its epilogue + grouped down
                                              GEMM for ALL experts, + the
                                              shared expert's 3-launch
                                              MLP; the router stays f32)

With the full plan a decode step of a dense block is 6 launches (7 when
d_ff > MAX_FUSED_QUANT_N, as at gemma-2b) and of an MoE block 9,
whatever the number of experts.  ``adaln`` is kept as a plan field for
parity with the reference; the DiT family it covers is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from .linear import quantize_attention, quantize_mlp, quantize_moe_experts

LAYER_KINDS = ("mlp", "attn_qkv", "attn_out", "attn_kv", "moe_experts",
               "adaln")


def covered_kinds(mixer: str, ffn: str) -> tuple[str, ...]:
    """Which plan layer kinds apply to a (mixer, ffn) block spec."""
    kinds: list[str] = []
    if mixer in ("attn", "attn_local"):
        kinds += ["attn_qkv", "attn_out", "attn_kv"]
    if ffn == "dense":
        kinds += ["mlp"]
    elif ffn == "moe":
        kinds += ["moe_experts"]
    return tuple(kinds)


@dataclass(frozen=True)
class QuantPlan:
    """Per-logical-layer-kind INT8 coverage declaration (default: the
    paper's configuration, everything on the INT8 pipeline)."""

    mlp: bool = True
    attn_qkv: bool = True
    attn_out: bool = True
    attn_kv: bool = True
    moe_experts: bool = True
    adaln: bool = True

    @classmethod
    def full(cls) -> "QuantPlan":
        return cls()

    @classmethod
    def none(cls) -> "QuantPlan":
        return cls(**{k: False for k in LAYER_KINDS})

    def covers(self, kind: str) -> bool:
        if kind not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {kind!r}; "
                             f"options: {LAYER_KINDS}")
        return bool(getattr(self, kind))


FULL_INT8 = QuantPlan.full()


def apply_plan(model, plan: QuantPlan):
    """Rewrite, in place, every plan-covered weight of ``model`` (a
    :class:`~repro_torch.models.model.Model`) into
    :class:`~repro_torch.quant.linear.QuantizedLinear` leaves.  Norms
    and uncovered layers are untouched; idempotent."""
    for block in model.layers:
        kinds = [k for k in covered_kinds(*block.spec) if plan.covers(k)]
        if {"attn_qkv", "attn_out"} & set(kinds):
            quantize_attention(block.attn, qkv="attn_qkv" in kinds,
                               out="attn_out" in kinds)
        if "mlp" in kinds:
            quantize_mlp(block.mlp)
        if "moe_experts" in kinds:
            quantize_moe_experts(block.moe)
    return model
