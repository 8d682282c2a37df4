"""Bridge: framework ModelConfigs -> simulator operator graphs.

This is what makes the paper's simulator a first-class framework feature:
any assigned architecture (``--arch``) lowers to the operator IR and can
be costed on any simulated TPU variant (baseline TPUv4i, CIM 16x8,
Design A/B, ...), exactly how a production co-design loop consumes such
a model ("what does OUR serving workload gain from this MXU?").

Per-family lowering notes (DESIGN.md §Arch-applicability):
  * attention / MLA / MoE / dense FFN — direct GEMM/GEMV + softmax ops;
  * Mamba2 (SSD) — projections + conv (VPU) + chunked-SSD batched small
    GEMMs (prefill) or GEMV state update (decode);
  * xLSTM — projections + chunk matmuls (mLSTM) / recurrent VPU scan
    (sLSTM);
  * frontends are stubs (embeddings provided), so only the backbone is
    costed — consistent with Fig 2(d) showing frontends are <1%.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

from .operators import Graph, MatMulOp, OpKind, VectorOp
from .workloads import TransformerLayerSpec, dit_block_ops


def _attn_ops(cfg: ModelConfig, batch: int, q_len: int, kv_len: int,
              bits: int, mixer: str, name: str) -> list:
    d, dh, h, kvh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * q_len
    eff_kv = kv_len
    if mixer == "attn_local" and cfg.sliding_window:
        eff_kv = min(kv_len, cfg.sliding_window)
    group = max(1, h // kvh)
    ops = [
        VectorOp(name=f"{name}.ln", kind=OpKind.LAYERNORM, elems=tokens * d),
        MatMulOp(name=f"{name}.qkv", kind=OpKind.QKV, M=tokens, K=d,
                 N=(h + 2 * kvh) * dh, act_bits=bits, weight_bits=bits),
        VectorOp(name=f"{name}.rope", kind=OpKind.ROPE,
                 elems=tokens * (h + kvh) * dh),
        MatMulOp(name=f"{name}.qk", kind=OpKind.ATTN_QK, M=q_len * group,
                 K=dh, N=eff_kv, batch=batch * kvh, weights_shared=False,
                 act_bits=bits, weight_bits=bits, fused_output=True),
        VectorOp(name=f"{name}.softmax", kind=OpKind.SOFTMAX,
                 elems=batch * h * q_len * eff_kv),
        MatMulOp(name=f"{name}.sv", kind=OpKind.ATTN_SV, M=q_len * group,
                 K=eff_kv, N=dh, batch=batch * kvh, weights_shared=False,
                 act_bits=bits, weight_bits=bits, fused_output=True),
        MatMulOp(name=f"{name}.proj", kind=OpKind.PROJ, M=tokens, K=h * dh,
                 N=d, act_bits=bits, weight_bits=bits),
    ]
    return ops


def _mla_ops(cfg: ModelConfig, batch: int, q_len: int, kv_len: int,
             bits: int, name: str) -> list:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    tokens = batch * q_len
    qk = m.qk_head_dim
    ops = [
        VectorOp(name=f"{name}.ln", kind=OpKind.LAYERNORM, elems=tokens * d),
        MatMulOp(name=f"{name}.q_down", kind=OpKind.QKV, M=tokens, K=d,
                 N=m.q_lora_rank, act_bits=bits, weight_bits=bits),
        MatMulOp(name=f"{name}.q_up", kind=OpKind.QKV, M=tokens,
                 K=m.q_lora_rank, N=h * qk, act_bits=bits, weight_bits=bits),
        MatMulOp(name=f"{name}.kv_down", kind=OpKind.QKV, M=tokens, K=d,
                 N=m.kv_lora_rank + m.qk_rope_head_dim, act_bits=bits,
                 weight_bits=bits),
    ]
    if q_len == 1:
        # absorbed decode: latent GEMVs (the ideal CIM case)
        r = m.kv_lora_rank + m.qk_rope_head_dim
        ops += [
            MatMulOp(name=f"{name}.q_absorb", kind=OpKind.QKV, M=tokens,
                     K=h * m.qk_nope_head_dim, N=m.kv_lora_rank,
                     act_bits=bits, weight_bits=bits),
            MatMulOp(name=f"{name}.qk", kind=OpKind.ATTN_QK, M=h, K=r,
                     N=kv_len, batch=batch, weights_shared=False,
                     act_bits=bits, weight_bits=bits, fused_output=True),
            VectorOp(name=f"{name}.softmax", kind=OpKind.SOFTMAX,
                     elems=batch * h * kv_len),
            MatMulOp(name=f"{name}.sv", kind=OpKind.ATTN_SV, M=h, K=kv_len,
                     N=m.kv_lora_rank, batch=batch, weights_shared=False,
                     act_bits=bits, weight_bits=bits, fused_output=True),
            MatMulOp(name=f"{name}.v_up", kind=OpKind.PROJ, M=tokens,
                     K=h * m.kv_lora_rank // max(1, h), N=h * m.v_head_dim,
                     act_bits=bits, weight_bits=bits),
        ]
    else:
        ops += [
            MatMulOp(name=f"{name}.kv_up", kind=OpKind.QKV, M=tokens,
                     K=m.kv_lora_rank,
                     N=h * (m.qk_nope_head_dim + m.v_head_dim),
                     act_bits=bits, weight_bits=bits),
            MatMulOp(name=f"{name}.qk", kind=OpKind.ATTN_QK, M=q_len, K=qk,
                     N=kv_len, batch=batch * h, weights_shared=False,
                     act_bits=bits, weight_bits=bits, fused_output=True),
            VectorOp(name=f"{name}.softmax", kind=OpKind.SOFTMAX,
                     elems=batch * h * q_len * kv_len),
            MatMulOp(name=f"{name}.sv", kind=OpKind.ATTN_SV, M=q_len,
                     K=kv_len, N=m.v_head_dim, batch=batch * h,
                     weights_shared=False, act_bits=bits, weight_bits=bits,
                     fused_output=True),
        ]
    ops.append(MatMulOp(name=f"{name}.o", kind=OpKind.PROJ, M=tokens,
                        K=h * m.v_head_dim, N=d, act_bits=bits,
                        weight_bits=bits))
    return ops


def _ffn_ops(cfg: ModelConfig, batch: int, q_len: int, bits: int,
             ffn: str, name: str) -> list:
    d = cfg.d_model
    tokens = batch * q_len
    gated = cfg.activation in ("geglu", "swiglu")
    mult = 2 if gated else 1
    act_kind = OpKind.GELU if cfg.activation in ("gelu", "geglu") \
        else OpKind.SILU
    ops = [VectorOp(name=f"{name}.ln2", kind=OpKind.LAYERNORM,
                    elems=tokens * d)]
    if ffn == "dense":
        ops += [
            MatMulOp(name=f"{name}.up", kind=OpKind.FFN, M=tokens, K=d,
                     N=mult * cfg.d_ff, act_bits=bits, weight_bits=bits),
            VectorOp(name=f"{name}.act", kind=act_kind,
                     elems=tokens * cfg.d_ff),
            MatMulOp(name=f"{name}.down", kind=OpKind.FFN, M=tokens,
                     K=cfg.d_ff, N=d, act_bits=bits, weight_bits=bits),
        ]
    else:  # moe
        mo = cfg.moe
        rows = max(1, tokens * mo.top_k // mo.n_routed_experts)
        ops += [
            MatMulOp(name=f"{name}.router", kind=OpKind.OTHER_MATMUL,
                     M=tokens, K=d, N=mo.n_routed_experts, act_bits=bits,
                     weight_bits=bits),
            MatMulOp(name=f"{name}.moe_up", kind=OpKind.MOE_FFN, M=rows,
                     K=d, N=mult * mo.d_expert, batch=mo.n_routed_experts,
                     act_bits=bits, weight_bits=bits),
            VectorOp(name=f"{name}.moe_act", kind=act_kind,
                     elems=rows * mo.d_expert * mo.n_routed_experts),
            MatMulOp(name=f"{name}.moe_down", kind=OpKind.MOE_FFN, M=rows,
                     K=mo.d_expert, N=d, batch=mo.n_routed_experts,
                     act_bits=bits, weight_bits=bits),
        ]
        if mo.n_shared_experts:
            sff = mo.shared_d_ff or mo.d_expert * mo.n_shared_experts
            ops += [
                MatMulOp(name=f"{name}.shared_up", kind=OpKind.FFN,
                         M=tokens, K=d, N=mult * sff, act_bits=bits,
                         weight_bits=bits),
                MatMulOp(name=f"{name}.shared_down", kind=OpKind.FFN,
                         M=tokens, K=sff, N=d, act_bits=bits,
                         weight_bits=bits),
            ]
    return ops


def _mamba_ops(cfg: ModelConfig, batch: int, q_len: int, bits: int,
               name: str) -> list:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    P, N = s.head_dim, s.state_dim
    tokens = batch * q_len
    proj = 2 * di + 2 * s.n_groups * N + H
    ops = [
        VectorOp(name=f"{name}.ln", kind=OpKind.LAYERNORM, elems=tokens * d),
        MatMulOp(name=f"{name}.in_proj", kind=OpKind.SSM, M=tokens, K=d,
                 N=proj, act_bits=bits, weight_bits=bits),
        VectorOp(name=f"{name}.conv", kind=OpKind.ELEMENTWISE,
                 elems=tokens * s.conv_dim(d) * s.conv_kernel),
    ]
    if q_len == 1:
        # O(1) state update: per-(batch, head) GEMV against h [P, N]
        ops += [
            MatMulOp(name=f"{name}.state_update", kind=OpKind.SSM, M=P,
                     K=1, N=N, batch=batch * H, weights_shared=False,
                     act_bits=bits, weight_bits=bits, fused_output=True),
            MatMulOp(name=f"{name}.state_read", kind=OpKind.SSM, M=P, K=N,
                     N=1, batch=batch * H, weights_shared=False,
                     act_bits=bits, weight_bits=bits, fused_output=True),
        ]
    else:
        chunk = s.chunk
        n_chunks = max(1, q_len // chunk)
        # intra-chunk quadratic part + state propagation (batched small
        # GEMMs — the mapping-flexibility case for CIM)
        ops += [
            MatMulOp(name=f"{name}.ssd_cb", kind=OpKind.SSM, M=chunk, K=N,
                     N=chunk, batch=batch * H * n_chunks,
                     weights_shared=False, act_bits=bits, weight_bits=bits,
                     fused_output=True),
            MatMulOp(name=f"{name}.ssd_y", kind=OpKind.SSM, M=chunk,
                     K=chunk, N=P, batch=batch * H * n_chunks,
                     weights_shared=False, act_bits=bits, weight_bits=bits,
                     fused_output=True),
            MatMulOp(name=f"{name}.ssd_state", kind=OpKind.SSM, M=N,
                     K=chunk, N=P, batch=batch * H * n_chunks,
                     weights_shared=False, act_bits=bits, weight_bits=bits,
                     fused_output=True),
            VectorOp(name=f"{name}.ssd_decay", kind=OpKind.SCAN,
                     elems=batch * H * q_len),
        ]
    ops += [
        VectorOp(name=f"{name}.gate", kind=OpKind.SILU, elems=tokens * di),
        MatMulOp(name=f"{name}.out_proj", kind=OpKind.SSM, M=tokens, K=di,
                 N=d, act_bits=bits, weight_bits=bits),
    ]
    return ops


def _xlstm_ops(cfg: ModelConfig, batch: int, q_len: int, bits: int,
               mixer: str, name: str) -> list:
    xc = cfg.xlstm
    d = cfg.d_model
    tokens = batch * q_len
    if mixer == "mlstm":
        di = int(xc.mlstm_proj_factor * d)
        H = xc.n_heads
        dh = di // H
        ops = [
            VectorOp(name=f"{name}.ln", kind=OpKind.LAYERNORM,
                     elems=tokens * d),
            MatMulOp(name=f"{name}.up", kind=OpKind.SSM, M=tokens, K=d,
                     N=2 * di, act_bits=bits, weight_bits=bits),
            MatMulOp(name=f"{name}.qkv", kind=OpKind.SSM, M=tokens, K=di,
                     N=3 * di, act_bits=bits, weight_bits=bits),
        ]
        if q_len == 1:
            ops += [
                MatMulOp(name=f"{name}.Cq", kind=OpKind.SSM, M=dh, K=1,
                         N=dh, batch=batch * H, weights_shared=False,
                         act_bits=bits, weight_bits=bits, fused_output=True),
                MatMulOp(name=f"{name}.Cread", kind=OpKind.SSM, M=1, K=dh,
                         N=dh, batch=batch * H, weights_shared=False,
                         act_bits=bits, weight_bits=bits, fused_output=True),
            ]
        else:
            chunk = xc.chunk
            n_chunks = max(1, q_len // chunk)
            ops += [
                MatMulOp(name=f"{name}.intra", kind=OpKind.SSM, M=chunk,
                         K=dh, N=chunk, batch=batch * H * n_chunks,
                         weights_shared=False, act_bits=bits,
                         weight_bits=bits, fused_output=True),
                MatMulOp(name=f"{name}.intra_v", kind=OpKind.SSM, M=chunk,
                         K=chunk, N=dh, batch=batch * H * n_chunks,
                         weights_shared=False, act_bits=bits,
                         weight_bits=bits, fused_output=True),
                VectorOp(name=f"{name}.gates", kind=OpKind.SCAN,
                         elems=batch * H * q_len * 4),
            ]
        ops.append(MatMulOp(name=f"{name}.down", kind=OpKind.SSM, M=tokens,
                            K=di, N=d, act_bits=bits, weight_bits=bits))
        return ops
    # sLSTM: sequential VPU recurrence + small recurrent matmuls
    H = xc.n_heads
    dh = d // H
    return [
        VectorOp(name=f"{name}.ln", kind=OpKind.LAYERNORM, elems=tokens * d),
        MatMulOp(name=f"{name}.w", kind=OpKind.SSM, M=tokens, K=d, N=4 * d,
                 act_bits=bits, weight_bits=bits),
        MatMulOp(name=f"{name}.recur", kind=OpKind.SSM, M=1, K=dh, N=4 * dh,
                 batch=batch * H * q_len, weights_shared=False,
                 act_bits=bits, weight_bits=bits, fused_output=True),
        VectorOp(name=f"{name}.cell", kind=OpKind.SCAN,
                 elems=tokens * d * 4),
        MatMulOp(name=f"{name}.ffn_up", kind=OpKind.FFN, M=tokens, K=d,
                 N=int(2 * xc.slstm_ffn_factor * d), act_bits=bits,
                 weight_bits=bits),
        MatMulOp(name=f"{name}.ffn_down", kind=OpKind.FFN, M=tokens,
                 K=int(xc.slstm_ffn_factor * d), N=d, act_bits=bits,
                 weight_bits=bits),
    ]


def _plan_layer_coverage(mixer: str, ffn: str) -> dict:
    """OpKind -> plan layer-kind map for ONE layer, derived from
    ``repro_torch.quant.plan.covered_kinds`` (the single source of truth) so
    the simulator costs exactly what apply_plan quantizes: only
    attn/attn_local mixers get quantized projections (MLA stays bf16),
    and a MoE layer's shared expert (OpKind.FFN) follows
    ``moe_experts`` with the routed experts.  Attention QK/SV (the
    KV-cache GEMVs) follow ``attn_kv``: with the int8 KV cache the
    flash-decode kernel streams int8 K/V and dequantizes in-kernel, so
    those GEMVs run at the 8-bit operand width too.  Softmax, the
    router, and the LM head are not plan-covered — they stay bf16."""
    # local import: quant pulls torch and the kernel wrappers, which the
    # simulator core otherwise never needs (callers passing a QuantPlan
    # have already imported repro_torch.quant anyway)
    from repro_torch.quant.plan import covered_kinds

    kinds = covered_kinds(mixer, ffn)
    cov: dict = {}
    if "attn_qkv" in kinds:
        cov[OpKind.QKV] = "attn_qkv"
    if "attn_out" in kinds:
        cov[OpKind.PROJ] = "attn_out"
    if "attn_kv" in kinds:
        cov[OpKind.ATTN_QK] = "attn_kv"
        cov[OpKind.ATTN_SV] = "attn_kv"
    if "mlp" in kinds:
        cov[OpKind.FFN] = "mlp"
    if "moe_experts" in kinds:
        cov[OpKind.MOE_FFN] = "moe_experts"
        cov[OpKind.FFN] = "moe_experts"      # shared expert
    return cov


def _plan_op_bits(op, plan, coverage: dict):
    """Covered weight matmuls run the INT8 CIM pipeline (8-bit MACs at
    the paper's INT8 energy point); everything else stays bf16."""
    if not isinstance(op, MatMulOp):
        return op
    kind = coverage.get(op.kind)
    bits = 8 if (kind is not None and plan.covers(kind)) else 16
    return op.scaled(act_bits=bits, weight_bits=bits)


def graph_from_config(cfg: ModelConfig, batch: int, q_len: int,
                      kv_len: int, bits: int = 8,
                      quant_plan=None) -> Graph:
    """Operator graph for one model step (q_len==1 -> decode).

    ``quant_plan`` (a :class:`repro_torch.quant.plan.QuantPlan`, duck-typed)
    overrides ``bits`` per op: plan-covered weight matmuls execute at
    INT8 (the fused CIM pipeline the kernels actually run), uncovered
    ops at bf16 — so the simulator costs exactly the mixed-precision
    execution the QuantPlan declares.
    """
    stage = "decode" if q_len == 1 else "prefill"
    g = Graph(name=f"{cfg.name}-{stage}-b{batch}-kv{kv_len}", repeat=1)
    for i, (mixer, ffn) in enumerate(cfg.layer_specs()):
        name = f"L{i}.{mixer}"
        start = len(g.ops)
        if mixer in ("attn", "attn_local"):
            g.extend(_attn_ops(cfg, batch, q_len, kv_len, bits, mixer, name))
        elif mixer == "mla":
            g.extend(_mla_ops(cfg, batch, q_len, kv_len, bits, name))
        elif mixer == "mamba2":
            g.extend(_mamba_ops(cfg, batch, q_len, bits, name))
        elif mixer in ("mlstm", "slstm"):
            g.extend(_xlstm_ops(cfg, batch, q_len, bits, mixer, name))
        if ffn != "none":
            g.extend(_ffn_ops(cfg, batch, q_len, bits, ffn, name))
        g.add(VectorOp(name=f"{name}.residual", kind=OpKind.ELEMENTWISE,
                       elems=batch * q_len * cfg.d_model * 2))
        if quant_plan is not None:
            cov = _plan_layer_coverage(mixer, ffn)
            g.ops[start:] = [_plan_op_bits(op, quant_plan, cov)
                             for op in g.ops[start:]]
    # head
    g.add(MatMulOp(name="lm_head", kind=OpKind.LM_HEAD, M=batch * q_len,
                   K=cfg.d_model, N=cfg.vocab, act_bits=bits,
                   weight_bits=bits, out_bits=16))
    if quant_plan is not None:
        g.ops[-1] = g.ops[-1].scaled(act_bits=16, weight_bits=16)
    return g


# ---------------------------------------------------------------------------
# Diffusion transformers (DiT)
# ---------------------------------------------------------------------------
# OpKind -> plan layer kind for one DiT block: the adaLN modulation GEMM
# is the only OTHER_MATMUL in the block graph (there is no router), and
# the non-gated MLP rides the "mlp" kind.  Attention QK/SV and softmax
# are not weight matmuls the plan covers — they stay bf16, same as the
# LLM lowering.
_DIT_COVERAGE = {
    OpKind.QKV: "attn_qkv",
    OpKind.PROJ: "attn_out",
    OpKind.FFN: "mlp",
    OpKind.OTHER_MATMUL: "adaln",
}


def dit_spec(cfg) -> TransformerLayerSpec:
    """A :class:`repro_torch.configs.dit.DiTConfig` -> the analytic layer spec
    its blocks lower to (non-causal, non-gated GELU MLP, MHA)."""
    return TransformerLayerSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, gated_ffn=False,
        activation=OpKind.GELU, causal=False)


def dit_graph_from_config(cfg, batch: int, bits: int = 8,
                          quant_plan=None) -> Graph:
    """Operator graph for one DiT denoise evaluation of ``cfg`` (a
    :class:`repro_torch.configs.dit.DiTConfig`), one repeat per block.

    ``quant_plan`` costs exactly the mixed-precision execution the
    runnable model dispatches: plan-covered weight matmuls (adaLN
    modulation, QKV, out-projection, MLP) at the INT8-CIM energy point,
    attention score matmuls/softmax at bf16 — and the
    ``OpKind.CONDITIONING`` shift/scale/gate VectorOps at the *plan's*
    element width (8-bit I/O when ``adaln`` is covered: the modulation
    parameters stream out of the fused epilogue as INT8-pipeline
    products) instead of always at the fp path.
    """
    g = Graph(name=f"{cfg.name}-denoise-b{batch}", repeat=cfg.n_layers)
    ops = dit_block_ops(dit_spec(cfg), batch, cfg.tokens, bits)
    if quant_plan is None:
        g.extend(ops)
        return g
    for op in ops:
        if isinstance(op, VectorOp) and op.kind == OpKind.CONDITIONING:
            op = dataclasses.replace(
                op, bits=8 if quant_plan.covers("adaln") else 16)
        else:
            op = _plan_op_bits(op, quant_plan, _DIT_COVERAGE)
        g.add(op)
    return g
