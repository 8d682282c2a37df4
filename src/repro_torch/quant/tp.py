"""Tensor-parallel execution of the fused INT8 pipeline (port of
``repro/quant/tp.py``).

The reference runs each function under ``shard_map`` on a mesh; here
each rank is a process holding its shards of the weights (placed by
:func:`repro_torch.parallel.sharding.shard_model`) and calling the
collectives of its :class:`~repro_torch.parallel.context.TPGroup`
itself.  Every rank runs the same kernels on its slice, with the fewest
collectives the partition allows:

    column-parallel (QKV, MLP up/gate)
        Weights sharded on the output-channel axis; activations are
        replicated, so each rank's per-column math (the in-kernel row
        quantization included) is the unsharded pipeline's.  No
        collective; the output is this rank's columns.

    row-parallel (attention out-projection, MLP down)
        Weights sharded on the input-channel axis.  Three rules keep the
        result bit-identical to the unsharded pipeline: (1) the row
        absmax of the activations is max-reduced over the ranks before
        quantizing, so every rank uses the global row scale; (2) the
        int32 partial accumulators (kernel 6, ``cim_gemm_int8``) are
        sum-reduced, and integer addition is exact; (3) the
        dequant/residual epilogue runs once, on the summed accumulator,
        in the kernels' order of rounded multiplies and adds.

    expert-parallel (grouped MoE pipeline)
        The expert stacks are sharded on the expert axis; each rank runs
        the grouped pipeline on its E/p experts and its slice of the
        skip list, and one all-gather in x's dtype returns every
        expert's output to every rank.

    head-parallel decode
        Each rank attends its own q heads over the KV heads it holds (its
        shard, or all of them for an MQA head).  Every head's softmax is
        independent: no collective.

Per layer and forward a dense block makes 2 MAX and 2 SUM reductions, an
MoE block one gather more.  ``use_kernel`` picks the kernels or their
plain versions, as elsewhere in ``quant``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.parallel.context import TPGroup, tp_group

__all__ = ["tp_group", "matmul_column", "matmul_row", "mlp", "grouped_moe",
           "decode_attn", "decode_attn_paged"]


def _global_rowquant(group: TPGroup, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row absmax int8 quantization with the absmax max-reduced over the
    ranks: every rank quantizes its input-channel slice with the global
    row scale, so ``q`` is the unsharded quantization's slice bit for bit
    (max is exact; the scalar chain is ``quantize_rows_int8``'s)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    amax = group.all_reduce_max(amax) + 1e-12
    scale = kref.div(amax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def matmul_column(group: TPGroup, x2: torch.Tensor, w_q: torch.Tensor,
                  w_scale: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Column-parallel fused matmul: x2 [M, K] replicated, w_q [K, N/p]
    this rank's columns -> f32 [M, N/p].  No collective."""
    if use_kernel:
        return kops.cim_quantized_matmul_fused(x2, w_q, w_scale)
    return kref.fused_matmul_ref(x2, w_q, w_scale)


def _row_epilogue(group, x_q, x_s, w_q, w_scale, use_kernel, residual):
    acc = (kops.cim_int8_gemm_acc(x_q, w_q) if use_kernel
           else kref.cim_gemm_int8_ref(x_q, w_q))
    acc = group.all_reduce_sum(acc)
    out = acc.float() * x_s * w_scale[None, :]
    if residual is not None:
        out = out + residual.float()
    return out


def matmul_row(group: TPGroup, x2: torch.Tensor, w_q: torch.Tensor,
               w_scale: torch.Tensor, use_kernel: bool,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """Row-parallel fused matmul: x2 [M, K/p] and w_q [K/p, N] this
    rank's input channels -> f32 [M, N] on every rank; the int32 sum
    folds in before the dequant/residual epilogue."""
    x_q, x_s = _global_rowquant(group, x2)
    return _row_epilogue(group, x_q, x_s, w_q, w_scale, use_kernel,
                         residual)


def mlp(group: TPGroup, x2: torch.Tensor, mlp_mod, activation: str,
        use_kernel: bool, residual: torch.Tensor | None = None
        ) -> torch.Tensor:
    """The INT8 MLP over the ranks: up/gate column-parallel (f32 hidden
    columns, no requant), the hidden requant with the max-reduced global
    row scale, down row-parallel with the int32 sum before the residual
    epilogue.  x2 [M, d] replicated -> f32 [M, d] on every rank.
    ``mlp_mod`` holds this rank's shards (``up``, ``down``[, ``gate``])."""
    up, down = mlp_mod.up, mlp_mod.down
    gate = getattr(mlp_mod, "gate", None)
    if use_kernel:
        x_q, x_s = kops.quantize_rows_int8(x2.contiguous())
        h = kops.cim_hidden_int8(
            x_q, x_s, up.q, up.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            activation=activation)
    elif gate is not None:
        h = kref.gated_mlp_hidden_ref(x2, gate.q, gate.scale, up.q, up.scale,
                                      activation)
    else:
        h = kref.fused_matmul_ref(x2, up.q, up.scale, activation=activation)
    h_q, h_s = _global_rowquant(group, h)
    return _row_epilogue(group, h_q, h_s, down.q, down.scale, use_kernel,
                         residual)


def grouped_moe(group: TPGroup, x: torch.Tensor, moe, activation: str,
                use_kernel: bool,
                expert_counts: torch.Tensor | None = None) -> torch.Tensor:
    """Expert-parallel grouped MoE pipeline: x [E, T, d] (every expert's
    capacity rows, replicated) -> [E, T, d] in x's dtype on every rank.
    ``moe`` holds this rank's E/p expert stacks; the rank runs them on
    its slice of x and of the skip list ``expert_counts``, and one
    all-gather of the outputs in x's dtype follows."""
    n = moe.up.q.shape[0]
    mine = slice(group.rank * n, (group.rank + 1) * n)
    xl = x[mine]
    counts = None if expert_counts is None else expert_counts[mine]
    gate = getattr(moe, "gate", None)
    if use_kernel:
        out = kops.cim_quantized_grouped_mlp(
            xl, moe.up.q, moe.up.scale, moe.down.q, moe.down.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            expert_counts=counts, activation=activation)
    else:
        qtree = {k: (getattr(moe, k).q, getattr(moe, k).scale)
                 for k in ("up", "gate", "down")
                 if getattr(moe, k, None) is not None}
        out = kref.grouped_quantized_mlp_ref(xl, qtree, activation)
    return group.all_gather(out.to(x.dtype))


def decode_attn(q, k, v, pos, q_pos, k_scale=None, v_scale=None, *,
                window=None, use_kernel: bool = True) -> torch.Tensor:
    """Head-parallel flash-decode over the ring cache: q [B, KH_r, G_r, D]
    holds this rank's q heads grouped over the KV heads it holds, and
    k/v [B, S, KH_r, D] (+ [B, S, KH_r] scales on the int8 path) are its
    cache: 1/p of the KV cache when KH divides p, else all of it.  No
    collective."""
    if use_kernel:
        return kops.decode_attention(q, k, v, pos, q_pos, k_scale=k_scale,
                                     v_scale=v_scale, window=window)
    return kref.decode_attention_ref(q, k, v, pos, q_pos, window=window,
                                     k_scale=k_scale, v_scale=v_scale)


def decode_attn_paged(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                      k_scale_pages=None, v_scale_pages=None, *,
                      window=None, use_kernel: bool = True) -> torch.Tensor:
    """Head-parallel paged flash-decode: :func:`decode_attn` over block
    pools [NB, bs, KH_r, D] holding this rank's KV heads; the block
    tables and positions are the same on every rank.  No collective."""
    if use_kernel:
        return kops.decode_attention_paged(
            q, k_pages, v_pages, pos_pages, block_tables, q_pos,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
            window=window)
    return kref.decode_attention_paged_ref(
        q, k_pages, v_pages, pos_pages, block_tables, q_pos, window=window,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
