"""Workload graphs for the simulator (paper §II-A, §IV, Table III).

Builds operator graphs for:
  * LLM Transformer layers — Prefilling and Decoding stages (GPT-3-30B in
    the paper; `transformer_layer_ops` is generic and reused by the bridge
    that lowers every assigned architecture config).
  * DiT blocks (DiT-XL/2, 512x512 -> 32x32 latent /2 patch = 1024 tokens),
    including adaLN conditioning / shift & scale / gates.

Conventions: batched attention matmuls carry ``weights_shared=False``
(their right-hand operand is the per-(batch, kv-head) KV cache); parameter
matmuls fold batch into M with ``weights_shared=True``.
"""
from __future__ import annotations

from dataclasses import dataclass

from .operators import Graph, MatMulOp, OpKind, VectorOp


@dataclass(frozen=True)
class TransformerLayerSpec:
    """Shape of one transformer layer, enough to emit its op graph."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    gated_ffn: bool = False        # GeGLU/SwiGLU double up-projection
    activation: OpKind = OpKind.GELU
    n_shared_experts: int = 0      # MoE
    n_routed_experts: int = 0
    top_k: int = 0
    causal: bool = True

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    layer: TransformerLayerSpec
    vocab: int
    bits: int = 8  # paper evaluates INT8


def gpt3_30b() -> ModelSpec:
    """Paper Table III: GPT3-30B — 48 layers, 56 heads, d_model 7168."""
    d, h = 7168, 56
    layer = TransformerLayerSpec(d_model=d, n_heads=h, n_kv_heads=h,
                                 head_dim=d // h, d_ff=4 * d)
    return ModelSpec("gpt3-30b", 48, layer, vocab=50257)


def dit_xl2() -> ModelSpec:
    """Paper Table III: DiT-XL/2 — 28 layers, 16 heads, d_model 1152."""
    d, h = 1152, 16
    layer = TransformerLayerSpec(d_model=d, n_heads=h, n_kv_heads=h,
                                 head_dim=d // h, d_ff=4 * d, causal=False)
    return ModelSpec("dit-xl2", 28, layer, vocab=0)


def dit_tokens(image_res: int = 512, vae_factor: int = 8, patch: int = 2) -> int:
    """512x512 image -> 64x64 latent -> /2 patchify -> 1024 tokens."""
    latent = image_res // vae_factor
    return (latent // patch) ** 2


# ---------------------------------------------------------------------------
# Layer constructors
# ---------------------------------------------------------------------------
def transformer_layer_ops(
    spec: TransformerLayerSpec,
    batch: int,
    q_len: int,
    kv_len: int,
    bits: int = 8,
    layer_name: str = "layer",
    fuse_attention: bool = True,
) -> list:
    """Ops for one transformer layer processing ``q_len`` new tokens against
    a context of ``kv_len`` (prefill: q_len == kv_len; decode: q_len == 1).
    """
    d, dh = spec.d_model, spec.head_dim
    h, kvh = spec.n_heads, spec.n_kv_heads
    tokens = batch * q_len
    ops: list = []

    def mm(name, kind, M, K, N, *, b=1, shared=True, fused=False):
        ops.append(MatMulOp(name=f"{layer_name}.{name}", kind=kind, M=M, K=K,
                            N=N, batch=b, weights_shared=shared,
                            act_bits=bits, weight_bits=bits, out_bits=bits,
                            layer=layer_name, fused_output=fused))

    def vec(name, kind, elems, **kw):
        ops.append(VectorOp(name=f"{layer_name}.{name}", kind=kind,
                            elems=elems, bits=16, layer=layer_name, **kw))

    # --- attention half --------------------------------------------------
    vec("ln1", OpKind.LAYERNORM, tokens * d)
    mm("qkv", OpKind.QKV, tokens, d, (h + 2 * kvh) * dh)
    vec("rope", OpKind.ROPE, tokens * (h + kvh) * dh)

    # Scores: per (batch, kv-head) problem, the query rows of its group.
    group = max(1, h // kvh)
    score_elems = batch * h * q_len * kv_len
    if spec.causal and q_len == kv_len:
        score_elems = batch * h * q_len * (kv_len + 1) // 2
    mm("attn_qk", OpKind.ATTN_QK, q_len * group, dh, kv_len,
       b=batch * kvh, shared=False, fused=fuse_attention)
    vec("softmax", OpKind.SOFTMAX, score_elems)
    mm("attn_sv", OpKind.ATTN_SV, q_len * group, kv_len, dh,
       b=batch * kvh, shared=False, fused=fuse_attention)
    mm("proj", OpKind.PROJ, tokens, h * dh, d)
    vec("residual1", OpKind.ELEMENTWISE, tokens * d)

    # --- FFN half ---------------------------------------------------------
    vec("ln2", OpKind.LAYERNORM, tokens * d)
    up_mult = 2 if spec.gated_ffn else 1
    if spec.is_moe:
        # Routed experts: each token hits top_k of E experts; per-expert
        # GEMMs see tokens*top_k/E rows on average (dense-dispatch model).
        ff = spec.d_ff
        routed_rows = max(1, tokens * spec.top_k // max(1, spec.n_routed_experts))
        mm("router", OpKind.OTHER_MATMUL, tokens, d, spec.n_routed_experts)
        mm("moe_up", OpKind.MOE_FFN, routed_rows, d, up_mult * ff,
           b=spec.n_routed_experts, shared=True)
        vec("moe_act", spec.activation, routed_rows * ff * spec.n_routed_experts)
        mm("moe_down", OpKind.MOE_FFN, routed_rows, ff, d,
           b=spec.n_routed_experts, shared=True)
        if spec.n_shared_experts:
            sff = ff * spec.n_shared_experts
            mm("shared_up", OpKind.FFN, tokens, d, up_mult * sff)
            vec("shared_act", spec.activation, tokens * sff)
            mm("shared_down", OpKind.FFN, tokens, sff, d)
    else:
        mm("ffn1", OpKind.FFN, tokens, d, up_mult * spec.d_ff)
        vec("act", spec.activation, tokens * spec.d_ff)
        mm("ffn2", OpKind.FFN, tokens, spec.d_ff, d)
    vec("residual2", OpKind.ELEMENTWISE, tokens * d)
    return ops


def dit_block_ops(spec: TransformerLayerSpec, batch: int, tokens: int,
                  bits: int = 8, layer_name: str = "block") -> list:
    """One DiT block: adaLN-Zero conditioning + attention + MLP (Fig 2c)."""
    d = spec.d_model
    ops: list = []

    # Conditioning MLP: c -> 6*d modulation parameters (shift/scale/gate x2).
    ops.append(MatMulOp(name=f"{layer_name}.cond_mlp", kind=OpKind.OTHER_MATMUL,
                        M=batch, K=d, N=6 * d, act_bits=bits, weight_bits=bits,
                        out_bits=bits, layer=layer_name))
    ops.append(VectorOp(name=f"{layer_name}.modulate1", kind=OpKind.CONDITIONING,
                        elems=batch * tokens * d, layer=layer_name))
    body = transformer_layer_ops(spec, batch, tokens, tokens, bits=bits,
                                 layer_name=layer_name)
    ops.extend(body)
    ops.append(VectorOp(name=f"{layer_name}.modulate2", kind=OpKind.CONDITIONING,
                        elems=batch * tokens * d, layer=layer_name))
    ops.append(VectorOp(name=f"{layer_name}.gates", kind=OpKind.ELEMENTWISE,
                        elems=2 * batch * tokens * d, layer=layer_name))
    return ops


# ---------------------------------------------------------------------------
# Model graphs
# ---------------------------------------------------------------------------
def llm_prefill_graph(model: ModelSpec, batch: int, seq: int) -> Graph:
    g = Graph(name=f"{model.name}-prefill-b{batch}-s{seq}",
              repeat=model.n_layers)
    g.extend(transformer_layer_ops(model.layer, batch, seq, seq, model.bits))
    return g


def llm_decode_graph(model: ModelSpec, batch: int, kv_len: int) -> Graph:
    """One decoding iteration with a KV cache of ``kv_len`` tokens."""
    g = Graph(name=f"{model.name}-decode-b{batch}-kv{kv_len}",
              repeat=model.n_layers)
    g.extend(transformer_layer_ops(model.layer, batch, 1, kv_len, model.bits))
    return g


def dit_graph(model: ModelSpec, batch: int, image_res: int = 512) -> Graph:
    tokens = dit_tokens(image_res)
    g = Graph(name=f"{model.name}-b{batch}-r{image_res}", repeat=model.n_layers)
    g.extend(dit_block_ops(model.layer, batch, tokens, model.bits))
    return g


def embed_head_graph(model: ModelSpec, tokens: int) -> Graph:
    """Token embedding (gather) + prediction head; Fig 2(d) shows both are
    <1% of runtime — modeled for the breakdown benchmark (repeat=1)."""
    d = model.layer.d_model
    g = Graph(name=f"{model.name}-embed-head", repeat=1)
    g.add(VectorOp(name="embed", kind=OpKind.ELEMENTWISE,
                   elems=tokens * d, layer="embed"))
    g.add(MatMulOp(name="lm_head", kind=OpKind.LM_HEAD,
                   M=tokens, K=d, N=model.vocab,
                   act_bits=model.bits, weight_bits=model.bits,
                   out_bits=16, layer="head"))
    return g
