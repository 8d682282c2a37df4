"""Core layer primitives (port of ``repro/models/layers.py``): init,
rmsnorm, embedding + tied logits, the untied LM head, RoPE, the dense
MLP."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.ref import gelu_tanh, silu
from repro_torch.quant.linear import QuantizedLinear, quantized_mlp_apply


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def truncated_normal_(p: torch.Tensor, generator: torch.Generator,
                      scale: float) -> torch.Tensor:
    """Fill ``p`` with ``scale * N(0, 1)`` truncated to [-2, 2], drawn in
    f32 with torch's own generator, then cast to ``p``'s dtype."""
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


# ---------------------------------------------------------------------------
# Embedding + tied head
# ---------------------------------------------------------------------------
def embedding_apply(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens]


def embedding_attend(emb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied-weight logits: x @ E^T / sqrt(d), in the weights' dtype, then
    f32.  A plain product outside any kernel, so it stays
    ``torch.matmul``."""
    scale = 1.0 / math.sqrt(emb.shape[-1])
    return (torch.matmul(x, emb.t()) * scale).float()


def lm_head_apply(kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Untied logits: x @ W with W [d, vocab] in the weights' dtype, then
    f32.  A plain product outside any kernel, so it stays
    ``torch.matmul``."""
    return torch.matmul(x, kernel).float()


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
