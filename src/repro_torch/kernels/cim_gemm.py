"""INT8 GEMM pipeline: row quantizer + fused-epilogue GEMMs, dense and
grouped over experts.

The port of ``repro/kernels/cim_gemm.py``.  The CUDA kernels live in
``csrc/cim_gemm.cu`` (one GEMM template whose instantiations differ in
the prologue and the epilogue; see the note at the top of that file for
what bounds them and how).  Every wrapper here:

* takes its plain version (``*_plain``) when its tensors lie on the CPU;
* on CUDA tensors checks dtype, shape, contiguity and alignment,
  allocates the outputs, launches on the current stream, raises if the
  launch failed, and adds one to its ``launches`` counter.

``quantize_out=True`` re-quantizes the output rows inside the same
launch (bitwise ``quantize_rows_int8`` of the f32 output); the
reference's ``[E, 1, N]`` scale layout is TPU tiling, so the grouped
wrappers take ``[E, N]``.
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
_GEMM_ARGS = [P, P, P, P, P, P, P, P, I, P, I, P, P, P, P, P, I, I, I, I, P]


def _epilogue_plain(acc, x_scale, w_scale, bias, residual, activation):
    """Dequant/bias/activation/residual; ``w_scale``/``bias`` are [N] or
    per expert [E, N]."""
    out = acc.float() * x_scale * w_scale.unsqueeze(-2)
    if bias is not None:
        out = out + bias.float().unsqueeze(-2)
    out = ref.activate_ref(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out


def _skip_plain(acc, counts):
    """Zero the accumulators of experts whose count is 0 (the kernels'
    skip list: such an expert runs no K sweep)."""
    if counts is None:
        return acc
    return torch.where(counts[:, None, None] > 0, acc, torch.zeros_like(acc))


def _residual_code(residual, M, N) -> int:
    if residual is None:
        return 0
    require(residual, "residual", _FLOAT, (M, N))
    return DTYPE_CODE[residual.dtype]


def _check_weight(w, w_scale, K, name="w", E=None):
    """w [K, N] (or [E, K, N]) int8 with scale [N] (or [E, N]); returns N."""
    require(w, name, torch.int8)
    lead = () if E is None else (E,)
    if w.dim() != len(lead) + 2 or tuple(w.shape[:-1]) != lead + (K,):
        want = ", ".join(str(d) for d in lead + (K,))
        raise ValueError(f"{name}: shape {tuple(w.shape)}, expected "
                         f"[{want}, N]")
    N = w.shape[-1]
    if N % 4:
        raise ValueError(f"{name}: N={N} must be a multiple of 4")
    if w.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")
    require(w_scale, f"{name}_scale", torch.float32, lead + (N,))
    return N


# The requant epilogue's row maxima and row-band arrival counters, one
# pair per device: zeros that every quantize_out launch leaves zeroed.
_REQUANT_WS: dict[torch.device, torch.Tensor] = {}


def _requant_workspace(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 words on ``device``, kept across
    launches.  Grown outside CUDA-graph capture only: memory allocated
    during a capture belongs to the graph."""
    ws = _REQUANT_WS.get(device)
    if ws is None or ws.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantize_out: the requant workspace must be "
                               "grown before CUDA-graph capture; launch once "
                               "outside the capture first")
        size = max(n, 1 << 16, 0 if ws is None else 2 * ws.numel())
        ws = torch.zeros(size, dtype=torch.int32, device=device)
        _REQUANT_WS[device] = ws
    return ws


def _gemm_int8(what, x_q, x_scale, w, w_scale, w2=None, w2_scale=None,
               bias=None, residual=None, counts=None, activation=None,
               quantize_out=False):
    """Launch the pre-quantized GEMM template on x_q [E, M, K] int8 and
    w (w2) [E, K, N], checked by the caller; returns f32 [E, M, N] or
    (q int8 [E, M, N], scale f32 [E, M, 1])."""
    E, M, K = x_q.shape
    N = w.shape[-1]
    dev = x_q.device
    rc = _residual_code(residual, M, N)
    out = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    q = qs = amax = arrive = None
    if quantize_out:
        q = torch.empty((E, M, N), dtype=torch.int8, device=dev)
        qs = torch.empty((E, M, 1), dtype=torch.float32, device=dev)
        bands = E * -(-M // 8)
        ws = _requant_workspace(dev, E * M + bands)
        amax, arrive = ws[:E * M], ws[E * M:E * M + bands]
    fn = bind(_LIB, "cim_gemm_int8_launch", _GEMM_ARGS)
    check(_LIB, fn(ptr(x_q), ptr(x_scale), ptr(w), ptr(w_scale), ptr(w2),
                   ptr(w2_scale), ptr(bias), ptr(residual), rc, ptr(counts),
                   ACTIVATIONS[activation], ptr(out), ptr(q), ptr(qs),
                   ptr(amax), ptr(arrive), E, M, K, N, stream(x_q)), what)
    return (q, qs) if quantize_out else out


def _check_counts(counts, E):
    if counts is not None:
        require(counts, "counts", torch.int32, (E,))


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
# INT8 GEMM to int32, no epilogue (kernel 6)
# ---------------------------------------------------------------------------
def cim_gemm_int8_plain(x_q, w):
    return ref.cim_gemm_int8_ref(x_q, w)


def cim_gemm_int8(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 GEMM: x_q [M, K] int8 @ w [K, N] int8 -> int32 [M, N],
    with no scale and no epilogue: the row-parallel partial accumulator
    of tensor parallelism, summed over the ranks before the one
    dequant/residual epilogue."""
    if on_cpu(x_q, w):
        return cim_gemm_int8_plain(x_q, w)
    require(x_q, "x_q", torch.int8)
    M, K = x_q.shape
    require(w, "w", torch.int8)
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w: shape {tuple(w.shape)}, expected [{K}, N]")
    N = w.shape[1]
    if N % 4 or w.data_ptr() % 4:
        raise ValueError(f"w: N={N} must be a multiple of 4 and w 4-byte "
                         f"aligned")
    out = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    fn = bind(_LIB, "cim_gemm_int8_acc", [P, P, P, I, I, I, P])
    check(_LIB, fn(ptr(x_q), ptr(w), ptr(out), M, K, N, stream(x_q)),
          "cim_gemm_int8")
    cim_gemm_int8.launches += 1
    return out


cim_gemm_int8.launches = 0


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
    [M, N], scale f32 [M, 1]) for the next GEMM, in the same launch."""
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
    out = _gemm_int8("cim_gemm_int8_fused", x_q[None], x_scale[None], w[None],
                     w_scale[None], bias=bias, residual=residual,
                     activation=activation, quantize_out=quantize_out)
    cim_gemm_int8_fused.launches += 1
    return (out[0][0], out[1][0]) if quantize_out else out[0]


cim_gemm_int8_fused.launches = 0


# ---------------------------------------------------------------------------
# Gated GEMM (kernel 4)
# ---------------------------------------------------------------------------
def cim_gated_gemm_int8_plain(x_q, w_gate, w_up, x_scale, gate_scale,
                              up_scale, activation="gelu"):
    g = ref.cim_gemm_int8_ref(x_q, w_gate).float() * x_scale \
        * gate_scale.unsqueeze(-2)
    u = ref.cim_gemm_int8_ref(x_q, w_up).float() * x_scale \
        * up_scale.unsqueeze(-2)
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
    out = _gemm_int8("cim_gated_gemm_int8", x_q[None], x_scale[None],
                     w_gate[None], gate_scale[None], w_up[None],
                     up_scale[None], activation=activation,
                     quantize_out=quantize_out)
    cim_gated_gemm_int8.launches += 1
    return (out[0][0], out[1][0]) if quantize_out else out[0]


cim_gated_gemm_int8.launches = 0


# ---------------------------------------------------------------------------
# Grouped-expert GEMM (kernel 7)
# ---------------------------------------------------------------------------
def cim_grouped_gemm_int8_plain(x_q, w, x_scale, w_scale, bias=None,
                                counts=None, activation=None):
    acc = _skip_plain(ref.cim_gemm_int8_ref(x_q, w), counts)
    return _epilogue_plain(acc, x_scale, w_scale, bias, None, activation)


def cim_grouped_gemm_int8(x: torch.Tensor, w: torch.Tensor,
                          x_scale: torch.Tensor, w_scale: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          counts: torch.Tensor | None = None,
                          activation: str | None = None,
                          quantize_out: bool = False):
    """All experts' INT8 GEMMs in one launch: per expert e, x [E, M, K]
    int8 @ w [E, K, N] int8, rescaled by ``x_scale [E, M, 1]`` and
    ``w_scale [E, N]`` (+ bias [E, N]) (+ activation) -> f32 [E, M, N];
    with ``quantize_out`` -> (q int8 [E, M, N], scale f32 [E, M, 1]).
    ``counts`` (int32 [E]) is the skip list: an expert whose count is 0
    streams no weights and gets the epilogue of zero accumulators."""
    if on_cpu(x, w, x_scale, w_scale, bias, counts):
        out = cim_grouped_gemm_int8_plain(x, w, x_scale, w_scale, bias,
                                          counts, activation)
        return quantize_rows_int8_plain(out) if quantize_out else out
    require(x, "x", torch.int8)
    E, M, K = x.shape
    require(x_scale, "x_scale", torch.float32, (E, M, 1))
    N = _check_weight(w, w_scale, K, E=E)
    if bias is not None:
        require(bias, "bias", torch.float32, (E, N))
    _check_counts(counts, E)
    out = _gemm_int8("cim_grouped_gemm_int8", x, x_scale, w, w_scale,
                     bias=bias, counts=counts, activation=activation,
                     quantize_out=quantize_out)
    cim_grouped_gemm_int8.launches += 1
    return out


cim_grouped_gemm_int8.launches = 0


# ---------------------------------------------------------------------------
# Grouped-expert gated GEMM (kernel 8)
# ---------------------------------------------------------------------------
def cim_grouped_gated_gemm_int8_plain(x, w_gate, w_up, x_scale, gate_scale,
                                      up_scale, counts=None,
                                      activation="gelu"):
    g = _skip_plain(ref.cim_gemm_int8_ref(x, w_gate), counts).float() \
        * x_scale * gate_scale.unsqueeze(-2)
    u = _skip_plain(ref.cim_gemm_int8_ref(x, w_up), counts).float() \
        * x_scale * up_scale.unsqueeze(-2)
    return ref.activate_ref(g, activation) * u


def cim_grouped_gated_gemm_int8(x: torch.Tensor, w_gate: torch.Tensor,
                                w_up: torch.Tensor, x_scale: torch.Tensor,
                                gate_scale: torch.Tensor,
                                up_scale: torch.Tensor,
                                counts: torch.Tensor | None = None,
                                activation: str = "gelu",
                                quantize_out: bool = False):
    """All experts' gated front halves ``act(x@Wg) * (x@Wu)`` in one
    launch: x [E, M, K] int8, w_gate/w_up [E, K, N] int8, scales
    ``x_scale [E, M, 1]``, ``gate_scale``/``up_scale [E, N]`` -> f32
    [E, M, N], or with ``quantize_out`` (q int8 [E, M, N], scale f32
    [E, M, 1]) for the grouped down GEMM.  ``counts`` as in
    :func:`cim_grouped_gemm_int8`."""
    if on_cpu(x, w_gate, w_up, x_scale, gate_scale, up_scale, counts):
        h = cim_grouped_gated_gemm_int8_plain(x, w_gate, w_up, x_scale,
                                              gate_scale, up_scale, counts,
                                              activation)
        return quantize_rows_int8_plain(h) if quantize_out else h
    require(x, "x", torch.int8)
    E, M, K = x.shape
    require(x_scale, "x_scale", torch.float32, (E, M, 1))
    N = _check_weight(w_gate, gate_scale, K, "w_gate", E=E)
    if _check_weight(w_up, up_scale, K, "w_up", E=E) != N:
        raise ValueError("gate and up widths differ")
    _check_counts(counts, E)
    out = _gemm_int8("cim_grouped_gated_gemm_int8", x, x_scale, w_gate,
                     gate_scale, w_up, up_scale, counts=counts,
                     activation=activation, quantize_out=quantize_out)
    cim_grouped_gated_gemm_int8.launches += 1
    return out


cim_grouped_gated_gemm_int8.launches = 0
