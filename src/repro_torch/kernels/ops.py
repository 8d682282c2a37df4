"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Dispatch is by tensor device: CPU tensors run the plain versions, CUDA
tensors launch the hand-written kernels or raise.  The reference's
dispatch rules are kept: activations are quantized inside the GEMM when
``K <= MAX_FUSED_QUANT_K``, and the MLP's hidden state (dense or per
expert) is re-quantized in the up/gated GEMM's epilogue
(``quantize_out``) only when ``d_ff <= MAX_FUSED_QUANT_N``, else by a
separate row-quantize launch; decode attention takes the split-KV walk
above ``SPLIT_MIN_SLOTS`` slots.  The reference's padding to 256-row /
32-row / CORE_K / CORE_N multiples is TPU tiling and has no counterpart
here: the kernels mask ragged edges.
"""
from __future__ import annotations

import torch

from . import decode_attention as _da
from . import ref
from .cim_gemm import (MAX_FUSED_QUANT_K, MAX_FUSED_QUANT_N,
                       cim_gated_gemm_int8, cim_gemm_int8_fused,
                       cim_gemm_int8_fused_qin, cim_grouped_gated_gemm_int8,
                       cim_grouped_gemm_int8, quantize_rows_int8)
from .decode_attention import SPLIT_STEP

__all__ = ["quantize_weights_int8", "quantize_rows_int8",
           "cim_quantized_matmul_fused", "cim_quantized_mlp",
           "cim_quantized_grouped_mlp",
           "decode_attention", "decode_attention_splitkv",
           "decode_attention_paged", "n_splits_for", "ref",
           "MAX_FUSED_QUANT_K", "MAX_FUSED_QUANT_N"]

# Above this many cache slots decode attention takes the split walk.
SPLIT_MIN_SLOTS = 2048
MAX_SPLITS = 8


def quantize_weights_int8(w: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-output-channel symmetric int8: w [K, N] -> (w_q, scale [N]);
    a stack [E, K, N] quantizes per expert -> scale [E, N]."""
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=-2) + 1e-12
    scale = ref.div(amax, 127.0)
    w_q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127,
                      127).to(torch.int8)
    return w_q, scale


def _contig(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.contiguous()


def cim_quantized_matmul_fused(x: torch.Tensor, w_q: torch.Tensor,
                               w_scale: torch.Tensor,
                               residual: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Quantized linear: x [M, K] bf16/f32; w_q [K, N] int8; w_scale [N];
    optional residual [M, N] added in the epilogue -> f32 [M, N].  One
    launch when K fits ``MAX_FUSED_QUANT_K``, else quantize + GEMM (two
    launches)."""
    x, residual = x.contiguous(), _contig(residual)
    if x.shape[1] <= MAX_FUSED_QUANT_K:
        return cim_gemm_int8_fused_qin(x, w_q, w_scale, residual=residual)
    x_q, x_s = quantize_rows_int8(x)
    return cim_gemm_int8_fused(x_q, w_q, x_s, w_scale, residual=residual)


def cim_quantized_mlp(x: torch.Tensor, up_q: torch.Tensor,
                      up_scale: torch.Tensor, down_q: torch.Tensor,
                      down_scale: torch.Tensor,
                      gate_q: torch.Tensor | None = None,
                      gate_scale: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None,
                      activation: str = "gelu") -> torch.Tensor:
    """INT8 MLP: quantize + (gated) up GEMM + down GEMM with the residual
    in the down GEMM's epilogue.  The hidden state is re-quantized by
    the up/gated GEMM when ``d_ff <= MAX_FUSED_QUANT_N``, else by one
    more row-quantize launch (gemma-2b's d_ff of 16384 takes this
    branch: 4 launches per MLP; narrower ones take 3).  Returns f32
    [M, N]."""
    x, residual = x.contiguous(), _contig(residual)
    fuse_requant = up_q.shape[1] <= MAX_FUSED_QUANT_N
    x_q, x_s = quantize_rows_int8(x)
    if gate_q is not None:
        h = cim_gated_gemm_int8(x_q, gate_q, up_q, x_s, gate_scale, up_scale,
                                activation=activation,
                                quantize_out=fuse_requant)
    else:
        h = cim_gemm_int8_fused(x_q, up_q, x_s, up_scale,
                                activation=activation,
                                quantize_out=fuse_requant)
    h_q, h_s = h if fuse_requant else quantize_rows_int8(h)
    return cim_gemm_int8_fused(h_q, down_q, h_s, down_scale,
                               residual=residual)


def cim_quantized_grouped_mlp(x: torch.Tensor, up_q: torch.Tensor,
                              up_scale: torch.Tensor, down_q: torch.Tensor,
                              down_scale: torch.Tensor,
                              gate_q: torch.Tensor | None = None,
                              gate_scale: torch.Tensor | None = None,
                              expert_counts: torch.Tensor | None = None,
                              activation: str = "gelu") -> torch.Tensor:
    """INT8 MLPs of all E experts in a number of launches independent of
    E: one row quantize over the stacked [E * T, d] rows, one grouped
    (gated) GEMM that re-quantizes the hidden state in its epilogue when
    ``d_ff <= MAX_FUSED_QUANT_N`` (else one more row quantize), one
    grouped down GEMM.

    x [E, T, d] f32/bf16; up/gate [E, d, F] int8 with scales [E, F];
    down [E, F, d'] int8 with scale [E, d'] -> f32 [E, T, d'].
    ``expert_counts`` (int32 [E]) is the skip list: an expert with no
    tokens streams no weights in either grouped GEMM (same bits, its
    rows being zero)."""
    E, T, d = x.shape
    F = up_q.shape[2]
    fuse_requant = F <= MAX_FUSED_QUANT_N
    x_q, x_s = quantize_rows_int8(x.contiguous().reshape(E * T, d))
    x_q, x_s = x_q.reshape(E, T, d), x_s.reshape(E, T, 1)
    if gate_q is not None:
        h = cim_grouped_gated_gemm_int8(x_q, gate_q, up_q, x_s, gate_scale,
                                        up_scale, counts=expert_counts,
                                        activation=activation,
                                        quantize_out=fuse_requant)
    else:
        h = cim_grouped_gemm_int8(x_q, up_q, x_s, up_scale,
                                  counts=expert_counts,
                                  activation=activation,
                                  quantize_out=fuse_requant)
    if fuse_requant:
        h_q, h_s = h
    else:
        h_q, h_s = quantize_rows_int8(h.reshape(E * T, F))
        h_q, h_s = h_q.reshape(E, T, F), h_s.reshape(E, T, 1)
    return cim_grouped_gemm_int8(h_q, down_q, h_s, down_scale,
                                 counts=expert_counts)


def n_splits_for(S: int) -> int:
    """The reference's split rule: one walk up to ``SPLIT_MIN_SLOTS``
    slots, then one split per 2048 slots, at most ``MAX_SPLITS``."""
    return 1 if S <= SPLIT_MIN_SLOTS else min(MAX_SPLITS, S // 2048)


def decode_attention(q, k, v, pos, q_pos, k_scale=None, v_scale=None,
                     window=None, n_splits: int | None = None):
    """Flash-decode over a (possibly int8) ring-buffer KV cache.

    ``k_scale``/``v_scale`` [B, S, KH] f32 turn on the int8-KV path
    (dequantized inside the kernel).  ``n_splits`` picks the split-KV
    walk: None applies :func:`n_splits_for` (one launch up to 2048
    slots, else the partial and combine launches); 1 forces the single
    walk.  The reference then lowers the count until it divides its
    512-slot blocks; here splits end on the kernel's 64-slot steps, so
    the count is only capped at the number of steps.  An unquantized
    cache must have q's dtype."""
    S = k.shape[1]
    if n_splits is None:
        n_splits = n_splits_for(S)
    n_splits = min(n_splits, -(-S // SPLIT_STEP))
    if n_splits > 1:
        return decode_attention_splitkv(q, k, v, pos, q_pos, k_scale,
                                        v_scale, window, n_splits)
    return _da.decode_attention(q.contiguous(), k, v, pos, q_pos,
                                k_scale=k_scale, v_scale=v_scale,
                                window=window)


def decode_attention_splitkv(q, k, v, pos, q_pos, k_scale=None,
                             v_scale=None, window=None, n_splits: int = 2):
    """Explicit split-KV entry: the partial and the combine launch even
    at ``n_splits=1``, where the result equals the single walk's bit for
    bit (the combine's weights are exactly 1)."""
    o, m, l = _da.decode_attention_partial(q.contiguous(), k, v, pos, q_pos,
                                           k_scale=k_scale, v_scale=v_scale,
                                           window=window, n_splits=n_splits)
    return _da.decode_attention_combine(o, m, l, q.dtype)


def decode_attention_paged(q, k_pages, v_pages, pos_pages, block_tables,
                           q_pos, k_scale_pages=None, v_scale_pages=None,
                           window=None):
    """Flash-decode over a paged (block-table) KV cache.

    Pools [NB, bs, KH, D] hold fixed-size KV blocks shared by all
    sequences; ``block_tables`` [B, nb] int32 maps each row's logical
    blocks to pool blocks (0 = the all-empty null block).
    ``k_scale_pages``/``v_scale_pages`` [NB, bs, KH] f32 turn on the
    int8-KV path.  Bitwise equal to the single ring walk on the
    equivalent layout."""
    return _da.decode_attention_paged(
        q.contiguous(), k_pages, v_pages, pos_pages, block_tables, q_pos,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
        window=window)
