"""INT8 weight quantization for serving (port of ``repro/quant/linear.py``).

Per-output-channel int8 weights, dynamic per-row activation
quantization and an f32 rescale/activation/residual epilogue, run
on the fused INT8 pipeline of ``kernels.ops`` (``use_kernel`` True or
None) or on the identical-math plain oracle (``use_kernel=False``).
The pipeline itself dispatches by tensor device: CUDA tensors launch
the hand-written kernels, CPU tensors run their plain versions.

:func:`kernel_mode` forces call sites that pass ``use_kernel=None``
(the model's layers) to the pipeline (True) or the oracle (False): an
explicit choice of the caller, never a fallback.

Tensor parallelism: a leaf that
:func:`~repro_torch.parallel.sharding.shard_model` cut to a rank's shard
runs through :mod:`repro_torch.quant.tp` under the current group
(:func:`~repro_torch.parallel.context.tp_context`); a whole leaf runs
the unsharded path, as the reference does for a dimension the group
size does not divide.

Degraded mode (:func:`degraded_mode`, the reliability layer): every
quantized apply site screens its fused output for non-finite values and,
when the screen trips, re-runs the layer on operands sanitized by
``nan_to_num(·, 0, 0, 0)`` (x, scales, bias, residual; never the int8
weights), as the reference does with ``lax.cond``.  On the pipeline the
screen is one launch that writes a flag on the device and the fallback
is the same pipeline on gated launches that leave at once when the flag
says the screen passed, writing the output in place only when it
tripped: a healthy step pays the screen and the gated launches, never a
second GEMM and never a host sync.  The plain oracle
(``use_kernel=False``) screens on the host.  Under tensor parallelism
degraded mode raises (ROADMAP A.3).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from . import tp as _tp


class QuantizedLinear(nn.Module):
    """Per-output-channel symmetric int8 weight.

    ``q`` may carry extra structure axes ([in, heads, head_dim] for the
    fused QKV projection, [heads, head_dim, out] for the attention
    out-projection); ``scale`` matches the output-channel axes.  Apply
    sites flatten to 2D.  ``tp_size`` is the number of ranks the leaf
    was sharded over (:func:`~repro_torch.parallel.sharding.shard_model`),
    None for a whole leaf.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)            # int8
        self.register_buffer("scale", scale)    # f32
        self.tp_size: int | None = None


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


def kernels_enabled() -> bool:
    """Whether a ``use_kernel=None`` call site runs the kernels here (the
    Mamba-2 scan reads it too)."""
    return _resolve_use_kernel(None)


def _tp_group_for(w: QuantizedLinear):
    """The current TP group if ``w`` is a rank's shard, None for a whole
    leaf.  A shard outside a group of its size raises: its layer cannot
    run alone."""
    if w.tp_size is None:
        return None
    group = _tp.tp_group()
    if group is None or group.size != w.tp_size:
        raise RuntimeError(
            f"a weight sharded {w.tp_size} ways needs a tensor-parallel "
            f"group of that size current (tp_context), got "
            f"{None if group is None else group.size}")
    return group


# ---------------------------------------------------------------------------
# Degraded-mode execution (reliability layer)
# ---------------------------------------------------------------------------
_DEGRADED_MODE: bool = False


@contextlib.contextmanager
def degraded_mode(enable: bool = True):
    """Per-layer degraded-mode fallback for the enclosed scope.

    When enabled, every quantized apply site screens its fused-pipeline
    output (:func:`~repro_torch.kernels.ops.finite_screen`, one launch,
    a flag on the device) and runs the layer's gated fallback chain,
    which recomputes the layer on sanitized operands and writes its
    output in place only when the screen tripped.  The contract, as the
    reference's: with the mode off the code path, the bits and every
    launch pin are unchanged; with it on and the screen passing the
    output is bitwise the unscreened output; a tripped layer's output is
    the same pipeline on operands sanitized by ``nan_to_num(·, 0, 0,
    0)``, so corrupted channels contribute zero instead of poisoning the
    residual stream."""
    global _DEGRADED_MODE
    prev = _DEGRADED_MODE
    _DEGRADED_MODE = enable
    try:
        yield
    finally:
        _DEGRADED_MODE = prev


def _san(a: torch.Tensor | None) -> torch.Tensor | None:
    """Sanitize a float operand for the plain fallback (int8 weights are
    always finite; scales/activations/bias/residual may not be)."""
    return None if a is None else torch.nan_to_num(a, nan=0.0, posinf=0.0,
                                                   neginf=0.0)


def _screen(out: torch.Tensor, use_kernel: bool, gated, plain
            ) -> torch.Tensor:
    """Finite screen + fallback when degraded mode is active.  On the
    pipeline ``gated(flag, out)`` runs the layer's gated launches into
    ``out`` (they do nothing when the screen passed); the plain oracle
    checks on the host and returns ``plain()`` when the screen trips."""
    if not _DEGRADED_MODE:
        return out
    if use_kernel:
        gated(kops.finite_screen(out), out)
        return out
    return out if bool(torch.isfinite(out).all()) else plain()


def _no_tp_degraded(group) -> None:
    if group is not None and _DEGRADED_MODE:
        raise NotImplementedError("degraded mode under tensor parallelism "
                                  "is not ported yet (ROADMAP A.3)")


def _canon_activation(activation: str | None) -> str | None:
    if activation in ("gelu", "geglu"):
        return "gelu"
    if activation in ("silu", "swiglu"):
        return "silu"
    return activation


def quantize_linear(w: torch.Tensor) -> QuantizedLinear:
    q, s = kops.quantize_weights_int8(w)
    return QuantizedLinear(q, s)


def _matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            use_kernel: bool | None, residual: torch.Tensor | None,
            bias: torch.Tensor | None = None,
            activation: str | None = None) -> torch.Tensor:
    """x [..., K] @ int8 q [K, N] * scale [N] (+ bias, + activation,
    + residual) -> f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    r2 = None if residual is None else residual.reshape(-1,
                                                        residual.shape[-1])
    activation = _canon_activation(activation)
    use_kernel = _resolve_use_kernel(use_kernel)
    if use_kernel:
        out = kops.cim_quantized_matmul_fused(x2, q, scale, bias=bias,
                                              residual=r2,
                                              activation=activation)
    else:
        out = kref.fused_matmul_ref(x2, q, scale, bias=bias, residual=r2,
                                    activation=activation)
    out = _screen(out, use_kernel, lambda flag, o:
                  kops.cim_quantized_matmul_fused(
                      x2, q, scale, bias=bias, residual=r2,
                      activation=activation, gate=flag, out=o),
                  lambda: kref.fused_matmul_ref(
                      _san(x2), q, _san(scale), bias=_san(bias),
                      residual=_san(r2), activation=activation))
    return out.reshape(*lead, -1)


def quantized_matmul(x: torch.Tensor, w: QuantizedLinear,
                     use_kernel: bool | None = False,
                     bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     activation: str | None = None) -> torch.Tensor:
    """x [..., K] @ int8 W (+ bias [N], + activation, + residual [..., N])
    -> f32; bias, activation and residual run in the GEMM's epilogue, in
    that order."""
    return _matmul(x, w.q, w.scale, use_kernel, residual, bias, activation)


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
    group = _tp_group_for(mlp.up)
    _no_tp_degraded(group)

    def pipeline(**kw):
        return kops.cim_quantized_mlp(
            x2, mlp.up.q, mlp.up.scale, mlp.down.q, mlp.down.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            residual=r2, activation=act, **kw)
    if group is not None:
        # up/gate column-parallel, down row-parallel with the int32 sum
        # before the residual epilogue (quant/tp.py)
        out = _tp.mlp(group, x2, mlp, act, use_kernel, residual=r2)
    elif use_kernel:
        out = pipeline()
    else:
        out = kref.quantized_mlp_ref(x2, _expert_qtree(mlp), act,
                                     residual=r2)
    out = _screen(out, use_kernel,
                  lambda flag, o: pipeline(gate=flag, out=o),
                  lambda: kref.quantized_mlp_ref(
                      _san(x2), {k: (q, _san(s)) for k, (q, s)
                                 in _expert_qtree(mlp).items()}, act,
                      residual=_san(r2)))
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
    """One wide fused GEMM for q/k/v: x [..., d] -> [..., HK, Dh] f32.

    A rank's shard holds [its q heads | its k heads | its v heads] and
    runs column-parallel: the same per-column math, no collective."""
    d, HK, Dh = qkv.q.shape
    w_q, w_s = qkv.q.reshape(d, HK * Dh), qkv.scale.reshape(HK * Dh)
    group = _tp_group_for(qkv)
    _no_tp_degraded(group)
    if group is not None:
        wide = _tp.matmul_column(group, x.reshape(-1, d), w_q, w_s,
                                 _resolve_use_kernel(use_kernel))
    else:
        wide = _matmul(x, w_q, w_s, use_kernel, None)
    return wide.reshape(*x.shape[:-1], HK, Dh)


def quantized_out_proj(o: QuantizedLinear, attn_out: torch.Tensor,
                       residual: torch.Tensor | None = None,
                       use_kernel: bool | None = None) -> torch.Tensor:
    """Attention out-projection with the residual add fused into the
    GEMM epilogue: attn_out [..., H, Dh] -> [..., d] f32.

    A rank's shard (its H/p heads' input channels) runs row-parallel:
    the global row scale, the int32 sum over the ranks, then the one
    dequant/residual epilogue, bitwise the unsharded pipeline."""
    H, Dh, d = o.q.shape
    x2 = attn_out.reshape(*attn_out.shape[:-2], H * Dh)
    group = _tp_group_for(o)
    _no_tp_degraded(group)
    if group is None:
        return _matmul(x2, o.q.reshape(H * Dh, d), o.scale, use_kernel,
                       residual)
    lead = x2.shape[:-1]
    out = _tp.matmul_row(group, x2.reshape(-1, H * Dh),
                         o.q.reshape(H * Dh, d), o.scale,
                         _resolve_use_kernel(use_kernel),
                         residual=None if residual is None
                         else residual.reshape(-1, d))
    return out.reshape(*lead, d)


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
    the plain grouped oracle.  A rank's shard of the expert stacks runs
    expert-parallel (:func:`repro_torch.quant.tp.grouped_moe`)."""
    act = _canon_activation(activation)
    group = _tp_group_for(moe.up)
    _no_tp_degraded(group)
    use_kernel = _resolve_use_kernel(use_kernel)
    if group is not None:
        return _tp.grouped_moe(group, x, moe, act, use_kernel,
                               expert_counts=expert_counts)
    gate = getattr(moe, "gate", None)

    def pipeline(**kw):
        return kops.cim_quantized_grouped_mlp(
            x, moe.up.q, moe.up.scale, moe.down.q, moe.down.scale,
            gate_q=None if gate is None else gate.q,
            gate_scale=None if gate is None else gate.scale,
            expert_counts=expert_counts, activation=act, **kw)
    if use_kernel:
        out = pipeline()
    else:
        out = kref.grouped_quantized_mlp_ref(x, _expert_qtree(moe), act)
    # the fallback keeps the skip list: an idle expert's rows are zero,
    # so it gives the reference's bits, which ignore it
    out = _screen(out, use_kernel,
                  lambda flag, o: pipeline(gate=flag, out=o),
                  lambda: kref.grouped_quantized_mlp_ref(
                      _san(x), {k: (q, _san(s)) for k, (q, s)
                                in _expert_qtree(moe).items()}, act))
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
