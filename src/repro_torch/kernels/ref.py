"""Plain PyTorch versions of the kernels on the serving path.

Each function mirrors its namesake in the reference's ``kernels/ref.py``
operation for operation: rows quantize with ``scale = (amax + 1e-12) /
127`` and a true division, rounding is half-to-even (``torch.round``),
GELU is the tanh approximation written out as the reference writes it,
and masked scores are ``-1e30``.  The CPU path runs these; on the card
they are what ``chip_smoke.py`` holds each CUDA kernel against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def cim_gemm_int8_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32, exactly.

    CUDA has no integer matrix product, so on the card the sum runs in
    float64, which is exact while |sum| < 2**53 (127 * 127 * K is far
    below that for any K here); float32 would not be exact at K = 16384.
    """
    if x.is_cuda:
        return torch.matmul(x.double(), w.double()).to(torch.int32)
    return torch.matmul(x.to(torch.int32), w.to(torch.int32))


def div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` as an IEEE division.  On CUDA, torch turns division by
    a Python scalar into a multiplication by its reciprocal, which can
    differ in the last bit; dividing by a tensor of ``d`` does not."""
    return t / torch.full_like(t, d)


def quantize_rows_int8_ref(x: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Dynamic per-row symmetric int8: x [M, K] -> (q, scale [M, 1])."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True) + 1e-12
    scale = div(amax, 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU in the reference's operation order."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def activate_ref(x: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation is None:
        return x
    if activation == "gelu":
        return gelu_tanh(x)
    if activation == "silu":
        return x * torch.sigmoid(x)
    if activation == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown epilogue activation {activation!r}")


def fused_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     activation: str | None = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Oracle for the fused epilogue: quant -> GEMM -> dequant/bias/act
    (+ residual add)."""
    x_q, x_scale = quantize_rows_int8_ref(x)
    out = cim_gemm_int8_ref(x_q, w_q).float()
    out = out * x_scale * w_scale[None, :]
    if bias is not None:
        out = out + bias.float()[None, :]
    out = activate_ref(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def gated_mlp_hidden_ref(x: torch.Tensor, g_q: torch.Tensor,
                         g_scale: torch.Tensor, u_q: torch.Tensor,
                         u_scale: torch.Tensor,
                         activation: str = "gelu") -> torch.Tensor:
    """Oracle for the gated front half: act(x@Wg) * (x@Wu), f32."""
    x_q, x_scale = quantize_rows_int8_ref(x)
    g = cim_gemm_int8_ref(x_q, g_q).float() * x_scale * g_scale[None, :]
    u = cim_gemm_int8_ref(x_q, u_q).float() * x_scale * u_scale[None, :]
    return activate_ref(g, activation) * u


def quantized_mlp_ref(x: torch.Tensor, qtree: dict, activation: str,
                      residual: torch.Tensor | None = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """End-to-end oracle for the int8 MLP pipeline.

    ``qtree``: {'up': (q, scale)[, 'gate': ...], 'down': (q, scale)},
    including the int8 requant of the hidden state between the GEMMs.
    """
    if "gate" in qtree:
        h = gated_mlp_hidden_ref(x, qtree["gate"][0], qtree["gate"][1],
                                 qtree["up"][0], qtree["up"][1], activation)
    else:
        h = fused_matmul_ref(x, qtree["up"][0], qtree["up"][1],
                             activation=activation)
    h_q, h_scale = quantize_rows_int8_ref(h)
    out = cim_gemm_int8_ref(h_q, qtree["down"][0]).float()
    out = out * h_scale * qtree["down"][1][None, :]
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def decode_attention_ref(q, k, v, pos, q_pos, window=None,
                         k_scale=None, v_scale=None):
    """q [B,KH,G,D]; k/v [B,S,KH,D]; pos [B,S]; q_pos [B].

    ``k_scale``/``v_scale`` [B,S,KH] f32 dequantize an int8 KV cache."""
    D = q.shape[-1]
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
        q = q.float()
    s = torch.einsum("bhgd,bshd->bhgs", q, k).float()
    s = s / math.sqrt(D)
    ok = pos[:, None, None, :] <= q_pos[:, None, None, None]
    if window is not None:
        ok &= pos[:, None, None, :] > (q_pos[:, None, None, None] - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype), v)
