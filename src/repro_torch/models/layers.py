"""Core layer primitives (port of ``repro/models/layers.py``): init,
rmsnorm and layernorm, embedding + tied logits, the untied LM head,
RoPE, the dense MLP."""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from repro_torch.kernels.ref import gelu_tanh, silu
from repro_torch.quant.linear import QuantizedLinear, quantized_mlp_apply


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
_LEAF_SINK = None


@contextlib.contextmanager
def leaf_sink(sink):
    """For the enclosed scope, a draw into a leaf on the meta device goes
    to ``sink(p, generator, scale)`` instead (the tensor-parallel draw,
    :func:`repro_torch.parallel.sharding.draw_sharded`, places each leaf
    itself)."""
    global _LEAF_SINK
    prev, _LEAF_SINK = _LEAF_SINK, sink
    try:
        yield
    finally:
        _LEAF_SINK = prev


def truncated_normal_(p: torch.Tensor, generator: torch.Generator,
                      scale: float) -> torch.Tensor:
    """Fill ``p`` with ``scale * N(0, 1)`` truncated to [-2, 2], drawn in
    f32 with torch's own generator, then cast to ``p``'s dtype (see
    :func:`leaf_sink` for a leaf on the meta device)."""
    if _LEAF_SINK is not None and p.is_meta:
        _LEAF_SINK(p, generator, scale)
        return p
    tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        p.copy_(tmp.mul_(scale))
    return p


def weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale).to(dtype)


def layernorm_apply(scale: torch.Tensor, x: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (the population variance, as ``jnp.var``), times
    ``scale``, plus ``bias`` when given, in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        x = x + bias
    return x.to(dtype)


def norm_apply(kind: str, scale: torch.Tensor, x: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The block and final norms of a config: ``"rmsnorm"`` (no bias) or
    ``"layernorm"``."""
    if kind == "rmsnorm":
        if bias is not None:
            raise ValueError("rmsnorm takes no bias")
        return rmsnorm_apply(scale, x)
    if kind == "layernorm":
        return layernorm_apply(scale, x, bias)
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# Embedding + tied head
# ---------------------------------------------------------------------------
def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as int32 (a 16-bit dtype widened)."""
    if t.element_size() == 4:
        return t.view(torch.int32)
    return t.view(torch.int16).to(torch.int32)


def embedding_apply(emb: torch.Tensor, tokens: torch.Tensor,
                    group=None) -> torch.Tensor:
    """The rows of ``emb`` at ``tokens``.  With ``group`` ``emb`` holds a
    tensor-parallel rank's rows ``[r V / p, (r + 1) V / p)`` of the
    vocabulary: an id outside them reads zero, and one SUM over the ranks
    (of the rows' bits as int32, so any float dtype goes through any
    backend) gives every rank the whole lookup, bit for bit: each row
    comes from one rank, and an integer added to zeros is itself."""
    if group is None:
        return emb[tokens]
    n = emb.shape[0]
    local = tokens - group.rank * n
    mine = (local >= 0) & (local < n)
    rows = emb[torch.where(mine, local, torch.zeros_like(local))]
    bits = torch.where(mine[..., None], _as_int32(rows),
                       torch.zeros((), dtype=torch.int32,
                                   device=rows.device))
    bits = group.all_reduce_sum(bits.contiguous())
    if emb.element_size() == 4:
        return bits.view(emb.dtype)
    return bits.to(torch.int16).view(emb.dtype)


def gather_vocab(group, logits: torch.Tensor) -> torch.Tensor:
    """The ranks' vocabulary columns of ``logits`` [..., V/p]
    concatenated in rank order (one all-gather): the whole row on every
    rank, for the host sampler, the health check and degraded mode."""
    if group is None:
        return logits
    whole = group.all_gather(logits.movedim(-1, 0).contiguous())
    return whole.movedim(0, -1).contiguous()


def embedding_attend(emb: torch.Tensor, x: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Tied-weight logits: x @ E^T / sqrt(d), in the weights' dtype, then
    f32.  A plain product outside any kernel, so it stays
    ``torch.matmul``.  With ``group`` ``emb`` is a rank's rows: its
    columns of the logits, gathered (:func:`gather_vocab`)."""
    scale = 1.0 / math.sqrt(emb.shape[-1])
    return gather_vocab(group, (torch.matmul(x, emb.t()) * scale).float())


def lm_head_apply(kernel: torch.Tensor, x: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Untied logits: x @ W with W [d, vocab] in the weights' dtype, then
    f32.  A plain product outside any kernel, so it stays
    ``torch.matmul``.  With ``group`` ``kernel`` is a rank's columns,
    gathered (:func:`gather_vocab`)."""
    return gather_vocab(group, torch.matmul(x, kernel).float())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN; gated variants)
# ---------------------------------------------------------------------------
def _activate(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu", "geglu"):
        return gelu_tanh(x)
    if name in ("silu", "swiglu"):
        return silu(x)
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


class MLP(nn.Module):
    """Dense FFN weights: ``up``/``gate`` [d, d_ff], ``down`` [d_ff, d]
    (bf16 parameters, or :class:`QuantizedLinear` leaves once a plan
    covering ``mlp`` is applied)."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, dtype,
                 device):
        super().__init__()
        self.up = weight((d_model, d_ff), dtype, device)
        self.down = weight((d_ff, d_model), dtype, device)
        if gated:
            self.gate = weight((d_model, d_ff), dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        truncated_normal_(self.up, generator, 1.0 / math.sqrt(
            self.up.shape[0]))
        truncated_normal_(self.down, generator, 1.0 / math.sqrt(
            self.down.shape[0]))
        if hasattr(self, "gate"):
            truncated_normal_(self.gate, generator, 1.0 / math.sqrt(
                self.gate.shape[0]))


def mlp_apply(mlp: MLP, x: torch.Tensor, activation: str = "gelu",
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """Dense FFN; ``residual`` is added to the output (inside the down
    GEMM's epilogue on the quantized path)."""
    if isinstance(mlp.up, QuantizedLinear):
        return quantized_mlp_apply(mlp, x, activation, use_kernel=None,
                                   residual=residual)
    up = torch.matmul(x, mlp.up)
    gate = getattr(mlp, "gate", None)
    if gate is not None:
        h = _activate(activation, torch.matmul(x, gate)) * up
    else:
        h = _activate(activation, up)
    out = torch.matmul(h, mlp.down)
    return out if residual is None else residual + out
