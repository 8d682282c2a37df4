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
    """int8 [..., M, K] @ int8 [..., K, N] -> int32, exactly (a leading
    expert axis batches).

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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))``, one rounding per step in x's dtype:
    the order XLA expands ``jax.nn.silu`` into (and the kernels'
    epilogue computes)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def activate_ref(x: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation is None:
        return x
    if activation == "gelu":
        return gelu_tanh(x)
    if activation == "silu":
        return silu(x)
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
    out = out * x_scale * w_scale.unsqueeze(-2)
    if bias is not None:
        out = out + bias.float().unsqueeze(-2)
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
    g = cim_gemm_int8_ref(x_q, g_q).float() * x_scale * g_scale.unsqueeze(-2)
    u = cim_gemm_int8_ref(x_q, u_q).float() * x_scale * u_scale.unsqueeze(-2)
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
    out = out * h_scale * qtree["down"][1].unsqueeze(-2)
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def grouped_quantized_mlp_ref(x: torch.Tensor, qtree: dict, activation: str,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Oracle for the grouped-expert int8 MLP pipeline: x [E, T, d] and
    stacked leaves {'up': (q [E, d, F], scale [E, F])[, 'gate': ...],
    'down': (q [E, F, d'], scale [E, d'])} -> [E, T, d'].  The
    reference's per-expert vmap of :func:`quantized_mlp_ref`, written as
    its leading batch axis: every step is per row or per expert."""
    return quantized_mlp_ref(x, qtree, activation, out_dtype=out_dtype)


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


def decode_attention_paged_ref(q, k_pages, v_pages, pos_pages, block_tables,
                               q_pos, window=None, k_scale_pages=None,
                               v_scale_pages=None):
    """Oracle for the paged walk: gather the pools into the linear
    [B, nb*bs, KH, D] layout and run :func:`decode_attention_ref`.
    pools [NB, bs, KH, D]; pos_pages [NB, bs]; block_tables [B, nb]
    (0 = the all-empty null block, so unallocated entries self-mask)."""
    B, nb = block_tables.shape
    bs = pos_pages.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, nb * bs, *k_pages.shape[2:])
    v = v_pages[bt].reshape(B, nb * bs, *v_pages.shape[2:])
    pos = pos_pages[bt].reshape(B, nb * bs)
    ks = vs = None
    if k_scale_pages is not None:
        ks = k_scale_pages[bt].reshape(B, nb * bs, -1)
        vs = v_scale_pages[bt].reshape(B, nb * bs, -1)
    return decode_attention_ref(q, k, v, pos, q_pos, window=window,
                                k_scale=ks, v_scale=vs)


def decode_attention_partial_ref(q, k, v, pos, q_pos, n_splits, split_len,
                                 window=None, k_scale=None, v_scale=None):
    """Oracle for the split walk: split ``s`` covers slots
    ``[s * split_len, (s + 1) * split_len)`` and emits its raw state
    o f32 [B, KH, NS, G, D] (not divided), m, l f32 [B, KH, NS, G, 1].

    As in the reference, the all-empty-row exception is decided over the
    whole row (such a row attends uniformly, m = -1e30 in every split);
    a split with no visible slot in a row that has some emits m = -1e30,
    l = 0, o = 0."""
    D = q.shape[-1]
    S = k.shape[1]
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
        q = q.float()
    # scores and the PV sum in f32, as the reference's kernel computes
    # them (p is rounded to the cache dtype first)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float())
    s = s / math.sqrt(D)
    ok = pos[:, None, None, :] <= q_pos[:, None, None, None]
    if window is not None:
        ok &= pos[:, None, None, :] > (q_pos[:, None, None, None] - window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    row_any = ok.any(-1, keepdim=True)                       # [B, 1, 1, 1]
    B, KH, G, _ = s.shape
    os, ms, ls = [], [], []
    for i in range(n_splits):
        lo, hi = min(i * split_len, S), min((i + 1) * split_len, S)
        si = s[..., lo:hi]
        if hi == lo:
            m = torch.full((B, KH, G, 1), NEG_INF, device=s.device)
            l = torch.zeros_like(m)
            o = torch.zeros((B, KH, G, D), device=s.device)
        else:
            m = si.amax(-1, keepdim=True)
            p = torch.exp(si - m)
            l = p.sum(-1, keepdim=True)
            o = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(),
                             v[:, lo:hi].float())
            dead = row_any & ~ok[..., lo:hi].any(-1, keepdim=True)
            m = torch.where(dead, torch.full_like(m, NEG_INF), m)
            l = torch.where(dead, torch.zeros_like(l), l)
            o = torch.where(dead, torch.zeros_like(o), o)
        os.append(o)
        ms.append(m)
        ls.append(l)
    return (torch.stack(os, 2), torch.stack(ms, 2), torch.stack(ls, 2))


def combine_partials_ref(o, m, l):
    """Oracle for the combine, as the reference's ``_combine_kernel``:
    o [B, KH, NS, G, D], m/l [B, KH, NS, G, 1] -> f32 [B, KH, G, D]."""
    m_g = m.amax(2, keepdim=True)
    w = torch.exp(m - m_g)
    l_g = (l * w).sum(2)
    acc = (o * w).sum(2)
    return acc / torch.clamp_min(l_g, 1e-30)


def decode_attention_splitkv_ref(q, k, v, pos, q_pos, n_splits, split_len,
                                 window=None, k_scale=None, v_scale=None):
    """The split walk and its combine, in q's dtype."""
    o, m, l = decode_attention_partial_ref(q, k, v, pos, q_pos, n_splits,
                                           split_len, window=window,
                                           k_scale=k_scale, v_scale=v_scale)
    return combine_partials_ref(o, m, l).to(q.dtype)
