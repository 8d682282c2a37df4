"""INT8 GEMM pipeline: row quantizer + fused-epilogue GEMMs.

The port of ``repro/kernels/cim_gemm.py``.  The CUDA kernels live in
``csrc/cim_gemm.cu`` (one GEMM template whose instantiations differ in
the prologue and the epilogue; see the note at the top of that file for
what bounds them and how).  Every wrapper here:

* takes its plain version (``*_plain``) when its tensors lie on the CPU;
* on CUDA tensors checks dtype, shape, contiguity and alignment,
  allocates the outputs, launches on the current stream, raises if the
  launch failed, and adds one to its ``launches`` counter.

``quantize_out=True`` on the card launches the GEMM and then the row
quantizer; the reference's fused and unfused forms give the same bits.
"""
from __future__ import annotations

import torch

from . import ref
from ._launch import (ACTIVATIONS, DTYPE_CODE, I, P, bind, check, on_cpu,
                      ptr, require, stream)

# Above this many output columns the reference runs the hidden requant
# as a separate quantize dispatch (``quantize_out=False``).
MAX_FUSED_QUANT_N = 8192
# Above this many input columns the reference quantizes activations in a
# separate dispatch instead of inside the GEMM.
MAX_FUSED_QUANT_K = 4096

_LIB = "cim_gemm"
_FLOAT = (torch.float32, torch.bfloat16)


def _epilogue_plain(acc, x_scale, w_scale, bias, residual, activation):
    out = acc.float() * x_scale * w_scale[None, :]
    if bias is not None:
        out = out + bias.float()[None, :]
    out = ref.activate_ref(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out


def _residual_code(residual, M, N) -> int:
    if residual is None:
        return 0
    require(residual, "residual", _FLOAT, (M, N))
    return DTYPE_CODE[residual.dtype]


def _check_weight(w, w_scale, K, name="w"):
    require(w, name, torch.int8)
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"{name}: shape {tuple(w.shape)}, expected [{K}, N]")
    N = w.shape[1]
    if N % 4:
        raise ValueError(f"{name}: N={N} must be a multiple of 4")
    if w.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")
    require(w_scale, f"{name}_scale", torch.float32, (N,))
    return N


# ---------------------------------------------------------------------------
# Row quantizer (kernel 1)
# ---------------------------------------------------------------------------
def quantize_rows_int8_plain(x):
    return ref.quantize_rows_int8_ref(x)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: x [M, K] f32/bf16 ->
    (q int8 [M, K], scale f32 [M, 1])."""
    if on_cpu(x):
        return quantize_rows_int8_plain(x)
    require(x, "x", _FLOAT)
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    fn = bind(_LIB, "cim_quantize_rows_int8", [P, I, P, P, I, I, P])
    check(_LIB, fn(ptr(x), DTYPE_CODE[x.dtype], ptr(q), ptr(s), M, K,
                   stream(x)), "quantize_rows_int8")
    quantize_rows_int8.launches += 1
    return q, s


quantize_rows_int8.launches = 0


# ---------------------------------------------------------------------------
# Quantize-in GEMM (kernel 2)
# ---------------------------------------------------------------------------
def cim_gemm_int8_fused_qin_plain(x, w, w_scale, bias=None, residual=None,
                                  activation=None):
    return ref.fused_matmul_ref(x, w, w_scale, bias=bias, residual=residual,
                                activation=activation)


def cim_gemm_int8_fused_qin(x: torch.Tensor, w: torch.Tensor,
                            w_scale: torch.Tensor,
                            bias: torch.Tensor | None = None,
                            residual: torch.Tensor | None = None,
                            activation: str | None = None) -> torch.Tensor:
    """Quantized linear as one launch: x [M, K] f32/bf16 is row-quantized
    inside the kernel, multiplied by w [K, N] int8 and rescaled by
    ``w_scale [N]`` (+ bias [N]) (+ activation) (+ residual [M, N])
    -> f32 [M, N]."""
    if on_cpu(x, w, w_scale, bias, residual):
        return cim_gemm_int8_fused_qin_plain(x, w, w_scale, bias, residual,
                                             activation)
    require(x, "x", _FLOAT)
    M, K = x.shape
    N = _check_weight(w, w_scale, K)
    if bias is not None:
        require(bias, "bias", torch.float32, (N,))
    rc = _residual_code(residual, M, N)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    fn = bind(_LIB, "cim_gemm_int8_fused_qin",
              [P, I, P, P, P, P, I, I, P, I, I, I, P])
    check(_LIB, fn(ptr(x), DTYPE_CODE[x.dtype], ptr(w), ptr(w_scale),
                   ptr(bias), ptr(residual), rc, ACTIVATIONS[activation],
                   ptr(out), M, K, N, stream(x)), "cim_gemm_int8_fused_qin")
    cim_gemm_int8_fused_qin.launches += 1
    return out


cim_gemm_int8_fused_qin.launches = 0


# ---------------------------------------------------------------------------
# Pre-quantized GEMM (kernel 3)
# ---------------------------------------------------------------------------
def cim_gemm_int8_fused_plain(x_q, w, x_scale, w_scale, bias=None,
                              residual=None, activation=None):
    return _epilogue_plain(ref.cim_gemm_int8_ref(x_q, w), x_scale, w_scale,
                           bias, residual, activation)


def cim_gemm_int8_fused(x_q: torch.Tensor, w: torch.Tensor,
                        x_scale: torch.Tensor, w_scale: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        activation: str | None = None,
                        quantize_out: bool = False):
    """INT8 GEMM with the fused dequant/bias/activation/residual epilogue:
    x_q [M, K] int8 @ w [K, N] int8, rescaled by ``x_scale [M, 1]`` and
    ``w_scale [N]`` -> f32 [M, N]; with ``quantize_out`` -> (q int8
    [M, N], scale f32 [M, 1]) for the next GEMM."""
    if quantize_out and residual is not None:
        raise ValueError("residual is for the block output, not a "
                         "requantized hidden state")
    if on_cpu(x_q, w, x_scale, w_scale, bias, residual):
        out = cim_gemm_int8_fused_plain(x_q, w, x_scale, w_scale, bias,
                                        residual, activation)
        return quantize_rows_int8_plain(out) if quantize_out else out
    require(x_q, "x_q", torch.int8)
    M, K = x_q.shape
    require(x_scale, "x_scale", torch.float32, (M, 1))
    N = _check_weight(w, w_scale, K)
    if bias is not None:
        require(bias, "bias", torch.float32, (N,))
    rc = _residual_code(residual, M, N)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    fn = bind(_LIB, "cim_gemm_int8_fused",
              [P, P, P, P, P, P, I, I, P, I, I, I, P])
    check(_LIB, fn(ptr(x_q), ptr(x_scale), ptr(w), ptr(w_scale), ptr(bias),
                   ptr(residual), rc, ACTIVATIONS[activation], ptr(out),
                   M, K, N, stream(x_q)), "cim_gemm_int8_fused")
    cim_gemm_int8_fused.launches += 1
    return quantize_rows_int8(out) if quantize_out else out


cim_gemm_int8_fused.launches = 0


# ---------------------------------------------------------------------------
# Gated GEMM (kernel 4)
# ---------------------------------------------------------------------------
def cim_gated_gemm_int8_plain(x_q, w_gate, w_up, x_scale, gate_scale,
                              up_scale, activation="gelu"):
    g = ref.cim_gemm_int8_ref(x_q, w_gate).float() * x_scale \
        * gate_scale[None, :]
    u = ref.cim_gemm_int8_ref(x_q, w_up).float() * x_scale \
        * up_scale[None, :]
    return ref.activate_ref(g, activation) * u


def cim_gated_gemm_int8(x_q: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, x_scale: torch.Tensor,
                        gate_scale: torch.Tensor, up_scale: torch.Tensor,
                        activation: str = "gelu",
                        quantize_out: bool = False):
    """Gated MLP front half ``act(x@Wg) * (x@Wu)`` in one launch: both
    int32 accumulators share one x stream -> f32 [M, N], or with
    ``quantize_out`` (q int8 [M, N], scale f32 [M, 1])."""
    if on_cpu(x_q, w_gate, w_up, x_scale, gate_scale, up_scale):
        h = cim_gated_gemm_int8_plain(x_q, w_gate, w_up, x_scale,
                                      gate_scale, up_scale, activation)
        return quantize_rows_int8_plain(h) if quantize_out else h
    require(x_q, "x_q", torch.int8)
    M, K = x_q.shape
    require(x_scale, "x_scale", torch.float32, (M, 1))
    N = _check_weight(w_gate, gate_scale, K, "w_gate")
    if _check_weight(w_up, up_scale, K, "w_up") != N:
        raise ValueError("gate and up widths differ")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    fn = bind(_LIB, "cim_gated_gemm_int8",
              [P, P, P, P, P, P, I, P, I, I, I, P])
    check(_LIB, fn(ptr(x_q), ptr(x_scale), ptr(w_gate), ptr(gate_scale),
                   ptr(w_up), ptr(up_scale), ACTIVATIONS[activation],
                   ptr(out), M, K, N, stream(x_q)), "cim_gated_gemm_int8")
    cim_gated_gemm_int8.launches += 1
    return quantize_rows_int8(out) if quantize_out else out


cim_gated_gemm_int8.launches = 0
