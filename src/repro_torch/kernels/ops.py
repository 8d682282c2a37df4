"""Public kernel entry points (port of ``repro/kernels/ops.py``).

Dispatch is by tensor device: CPU tensors run the plain versions, CUDA
tensors launch the hand-written kernels or raise.  The reference's
dispatch rules are kept: activations are quantized inside the GEMM when
``K <= MAX_FUSED_QUANT_K``, and the MLP's hidden state is re-quantized
by the gated GEMM (``quantize_out``) only when ``d_ff <=
MAX_FUSED_QUANT_N``, else by a separate row-quantize launch.  The
reference's padding to 256-row / CORE_K / CORE_N multiples is TPU
tiling and has no counterpart here: the kernels mask ragged edges.
"""
from __future__ import annotations

import torch

from . import ref
from .cim_gemm import (MAX_FUSED_QUANT_K, MAX_FUSED_QUANT_N,
                       cim_gated_gemm_int8, cim_gemm_int8_fused,
                       cim_gemm_int8_fused_qin, quantize_rows_int8)
from .decode_attention import decode_attention as _decode_kernel

__all__ = ["quantize_weights_int8", "quantize_rows_int8",
           "cim_quantized_matmul_fused", "cim_quantized_mlp",
           "decode_attention", "ref", "MAX_FUSED_QUANT_K",
           "MAX_FUSED_QUANT_N"]


def quantize_weights_int8(w: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-output-channel symmetric int8: w [K, N] -> (w_q, scale [N])."""
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=0) + 1e-12
    scale = ref.div(amax, 127.0)
    w_q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
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
    branch: 4 launches per MLP).  Returns f32 [M, N]."""
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


def decode_attention(q, k, v, pos, q_pos, k_scale=None, v_scale=None,
                     window=None):
    """Flash-decode over a (possibly int8) ring-buffer KV cache.

    ``k_scale``/``v_scale`` [B, S, KH] f32 turn on the int8-KV path
    (dequantized inside the kernel).  One launch whatever S: the
    split-KV walk the reference takes above 2048 slots is not ported
    yet, and the single walk is exact at any S.  An unquantized cache
    must have q's dtype."""
    return _decode_kernel(q.contiguous(), k, v, pos, q_pos,
                          k_scale=k_scale, v_scale=v_scale, window=window)
