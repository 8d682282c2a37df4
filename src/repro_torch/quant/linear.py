"""INT8 weight quantization for serving (port of ``repro/quant/linear.py``).

Per-output-channel int8 weights, dynamic per-row activation
quantization and an f32 rescale/activation/residual epilogue, run
on the fused INT8 pipeline of ``kernels.ops`` (``use_kernel`` True or
None) or on the identical-math plain oracle (``use_kernel=False``).
The pipeline itself dispatches by tensor device: CUDA tensors launch
the hand-written kernels, CPU tensors run their plain versions.

:func:`kernel_mode` forces call sites that pass ``use_kernel=None``
(the model's layers) to the pipeline (True) or the oracle (False): an
explicit choice of the caller, never a fallback.  Tensor parallelism
and degraded mode come with later slices of the port.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


class QuantizedLinear(nn.Module):
    """Per-output-channel symmetric int8 weight.

    ``q`` may carry extra structure axes ([in, heads, head_dim] for the
    fused QKV projection, [heads, head_dim, out] for the attention
    out-projection); ``scale`` matches the output-channel axes.  Apply
    sites flatten to 2D.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)            # int8
        self.register_buffer("scale", scale)    # f32


# ---------------------------------------------------------------------------
# Kernel-dispatch resolution
# ---------------------------------------------------------------------------
_KERNEL_MODE: bool | None = None


@contextlib.contextmanager
def kernel_mode(force: bool | None):
    """Force ``use_kernel=None`` call sites to the fused pipeline (True)
    or the plain oracle (False) for the enclosed scope."""
    global _KERNEL_MODE
    prev = _KERNEL_MODE
    _KERNEL_MODE = force
    try:
        yield
    finally:
        _KERNEL_MODE = prev


def _resolve_use_kernel(use_kernel: bool | None) -> bool:
    if use_kernel is None:
        return True if _KERNEL_MODE is None else _KERNEL_MODE
    return use_kernel


def _canon_activation(activation: str | None) -> str | None:
    if activation in ("gelu", "geglu"):
        return "gelu"
    if activation in ("silu", "swiglu"):
        return "silu"
    return activation


def quantize_linear(w: torch.Tensor) -> QuantizedLinear:
    q, s = kops.quantize_weights_int8(w.float())
    return QuantizedLinear(q, s)


def _matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            use_kernel: bool | None,
            residual: torch.Tensor | None) -> torch.Tensor:
    """x [..., K] @ int8 q [K, N] * scale [N] (+ residual) -> f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    r2 = None if residual is None else residual.reshape(-1,
                                                        residual.shape[-1])
    if _resolve_use_kernel(use_kernel):
        out = kops.cim_quantized_matmul_fused(x2, q, scale, residual=r2)
    else:
        out = kref.fused_matmul_ref(x2, q, scale, residual=r2)
    return out.reshape(*lead, -1)


def quantized_matmul(x: torch.Tensor, w: QuantizedLinear,
                     use_kernel: bool | None = False,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] @ int8 W (+ residual, added in the epilogue) -> f32."""
    return _matmul(x, w.q, w.scale, use_kernel, residual)


# ---------------------------------------------------------------------------
# MLP-block quantization
# ---------------------------------------------------------------------------
_MLP_LEAVES = ("up", "down", "gate")


def quantize_mlp(mlp: nn.Module) -> nn.Module:
    """Replace the module's ``up``/``down``/``gate`` weights by
    :class:`QuantizedLinear` leaves, in place (the bf16 weights are
    released).  Idempotent."""
    for name in _MLP_LEAVES:
        w = getattr(mlp, name, None)
        if w is not None and not isinstance(w, QuantizedLinear):
            delattr(mlp, name)
            setattr(mlp, name, quantize_linear(w))
    return mlp


def quantized_mlp_apply(mlp: nn.Module, x: torch.Tensor, activation: str,
                        use_kernel: bool | None = False,
                        residual: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Quantized MLP block on the fused INT8 pipeline; ``residual`` is
    added in the down GEMM's epilogue.  Returns x's dtype."""
    use_kernel = _resolve_use_kernel(use_kernel)
    act = _canon_activation(activation)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    r2 = None if residual is None else residual.reshape(-1,
                                                        residual.shape[-1])
    gate = getattr(mlp, "gate", None)
    if use_kernel:
        out = kops.cim_quantized_mlp(
            x2, mlp.up.q, mlp.up.scale, mlp.down.q, mlp.down.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            residual=r2, activation=act)
    else:
        qtree = {k: (getattr(mlp, k).q, getattr(mlp, k).scale)
                 for k in _MLP_LEAVES if getattr(mlp, k, None) is not None}
        out = kref.quantized_mlp_ref(x2, qtree, act, residual=r2)
    return out.reshape(*lead, -1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections (fused QKV + out-projection w/ residual epilogue)
# ---------------------------------------------------------------------------
def quantize_attention(attn: nn.Module, qkv: bool = True,
                       out: bool = True) -> nn.Module:
    """Quantize one attention layer's projections, in place.

    ``q [d, H, Dh]``, ``k``/``v [d, KH, Dh]`` fuse into one ``qkv``
    :class:`QuantizedLinear` with ``q`` int8 [d, H + 2*KH, Dh] and
    ``scale`` [H + 2*KH, Dh]; ``o [H, Dh, d]`` keeps its head structure
    (scale [d]).
    """
    if qkv and not isinstance(getattr(attn, "qkv", None), QuantizedLinear):
        wide = torch.cat([attn.q, attn.k, attn.v], dim=-2)  # [d, HK, Dh]
        for name in ("q", "k", "v"):
            delattr(attn, name)
        d = wide.shape[0]
        flat = quantize_linear(wide.reshape(d, -1))
        attn.qkv = QuantizedLinear(flat.q.reshape(wide.shape),
                                   flat.scale.reshape(wide.shape[1:]))
    if out and not isinstance(attn.o, QuantizedLinear):
        wo = attn.o                                       # [H, Dh, d]
        flat = quantize_linear(wo.reshape(-1, wo.shape[-1]))
        delattr(attn, "o")
        attn.o = QuantizedLinear(flat.q.reshape(wo.shape), flat.scale)
    return attn


def quantized_qkv_proj(qkv: QuantizedLinear, x: torch.Tensor,
                       use_kernel: bool | None = None) -> torch.Tensor:
    """One wide fused GEMM for q/k/v: x [..., d] -> [..., HK, Dh] f32."""
    d, HK, Dh = qkv.q.shape
    wide = _matmul(x, qkv.q.reshape(d, HK * Dh), qkv.scale.reshape(HK * Dh),
                   use_kernel, None)
    return wide.reshape(*x.shape[:-1], HK, Dh)


def quantized_out_proj(o: QuantizedLinear, attn_out: torch.Tensor,
                       residual: torch.Tensor | None = None,
                       use_kernel: bool | None = None) -> torch.Tensor:
    """Attention out-projection with the residual add fused into the
    GEMM epilogue: attn_out [..., H, Dh] -> [..., d] f32."""
    H, Dh, d = o.q.shape
    x2 = attn_out.reshape(*attn_out.shape[:-2], H * Dh)
    return _matmul(x2, o.q.reshape(H * Dh, d), o.scale, use_kernel, residual)


# ---------------------------------------------------------------------------
# MoE expert MLPs (grouped-expert pipeline, launches independent of E)
# ---------------------------------------------------------------------------
def quantize_moe_experts(moe: nn.Module) -> nn.Module:
    """Quantize one MoE layer in place: the routed expert stacks
    ``up``/``gate`` [E, d, F] and ``down`` [E, F, d] become per-expert
    per-output-channel :class:`QuantizedLinear` stacks (q int8 [E, K, N],
    scale [E, N]); the shared-expert MLP is quantized as a dense MLP.
    The router stays f32 (routing is precision-sensitive).  Idempotent."""
    quantize_mlp(moe)
    shared = getattr(moe, "shared", None)
    if shared is not None:
        quantize_mlp(shared)
    return moe


def _expert_qtree(moe: nn.Module) -> dict:
    return {k: (getattr(moe, k).q, getattr(moe, k).scale)
            for k in _MLP_LEAVES if getattr(moe, k, None) is not None}


def quantized_moe_apply(moe: nn.Module, x: torch.Tensor, activation: str,
                        use_kernel: bool | None = False,
                        expert_counts: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Grouped-expert INT8 MLPs: x [E, T, d] -> [E, T, d] in x's dtype.

    All experts' capacity buffers run one pipeline
    (:func:`~repro_torch.kernels.ops.cim_quantized_grouped_mlp`): a row
    quantize, a grouped (gated) GEMM with the requant in its epilogue, a
    grouped down GEMM, with the expert index as a grid dimension, so the
    launch count does not depend on E.  ``expert_counts`` (int32 [E],
    the router's tally) is the skip list: experts that received no tokens
    stream no weights, with the same bits.  ``use_kernel=False`` runs
    the plain grouped oracle."""
    act = _canon_activation(activation)
    if _resolve_use_kernel(use_kernel):
        gate = getattr(moe, "gate", None)
        out = kops.cim_quantized_grouped_mlp(
            x, moe.up.q, moe.up.scale, moe.down.q, moe.down.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            expert_counts=expert_counts, activation=act)
    else:
        out = kref.grouped_quantized_mlp_ref(x, _expert_qtree(moe), act)
    return out.to(x.dtype)


def quantized_moe_apply_looped(moe: nn.Module, x: torch.Tensor,
                               activation: str,
                               use_kernel: bool | None = False
                               ) -> torch.Tensor:
    """One dense MLP pipeline per expert (3 launches each): the bitwise
    comparator of :func:`quantized_moe_apply` in the tests, as in the
    reference.  Not used on any model path."""
    outs = []
    for e in range(x.shape[0]):
        one = nn.Module()
        for k, (q, s) in _expert_qtree(moe).items():
            setattr(one, k, QuantizedLinear(q[e], s[e]))
        outs.append(quantized_mlp_apply(one, x[e], activation,
                                        use_kernel=use_kernel))
    return torch.stack(outs)
