"""xLSTM blocks (port of ``repro/models/xlstm.py``; arXiv:2405.04517):
the mLSTM (matrix memory, chunkwise-parallel over the prompt) and the
sLSTM (scalar memory, a sequential scan with exponential gating).

The reference computes both with plain ``jnp`` outside any Pallas kernel
and no plan kind covers them (their ``ffn`` is ``"none"``), so here they
are plain ``torch``: bf16 projections, f32 gates, states and
recurrences, the reference's casts.  Decode is the O(1)-state step.  A
cache dict is updated in place, so a slot's view of the engine's batched
cache takes the new values:

* mLSTM: {"conv" [B, K-1, di] (the raw ``u`` tail), "C" [B, H, Dk, Dv],
  "n" [B, H, Dk], "m" [B, H] (f32), "index" [B] int32};
* sLSTM: {"c", "n", "h", "m" [B, H, dh] (f32), "index" [B] int32}.

``init_*_cache`` starts ``m`` at -1e30 as the reference's does; the ring
engine's slot reset zeroes every leaf, ``m`` included, as the
reference's engine does (ROADMAP C.14).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn.functional import logsigmoid

from repro_torch.kernels.ref import silu
from repro_torch.quant import tp as _tp
from .layers import MLP, mlp_apply, rmsnorm_apply, truncated_normal_, weight
from .ssm import _causal_conv

M_FLOOR = -1e30      # the stabilizer's start and floor


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    conv_kernel: int = 4
    chunk: int = 64
    mlstm_proj_factor: float = 2.0
    slstm_ffn_factor: float = 4.0 / 3.0
    slstm_every: int = 8      # one sLSTM block per this many layers (0 = none)

    def mlstm_inner(self, d_model: int) -> int:
        return int(self.mlstm_proj_factor * d_model)

    def slstm_ffn(self, d_model: int) -> int:
        return int(self.slstm_ffn_factor * d_model)


# ---------------------------------------------------------------------------
# mLSTM: chunkwise-parallel matrix-memory cell
# ---------------------------------------------------------------------------
def _mlstm_chunk_step(state, q, k, v, ig, lf, scale):
    """One chunk.  state: (C [B,H,Dk,Dv], n [B,H,Dk], m [B,H]); q, k, v
    [B,L,H,D]; ig, lf [B,L,H].  Returns (new state, h [B,L,H,D])."""
    C, n, m = state
    L = q.shape[1]
    q = q * scale                 # one global 1/sqrt(D); intra+inter terms

    cum = torch.cumsum(lf, dim=1)                                # [B,L,H]
    # decay from step s to step t (t >= s): cum[t] - cum[s]
    d_mat = cum[:, :, None] - cum[:, None, :] + ig[:, None, :, :]  # [B,t,s,H]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    d_mat = torch.where(tri[None, :, :, None], d_mat,
                        torch.full_like(d_mat, -math.inf))
    b_vec = cum + m[:, None]                     # carried-state weight
    m_new = torch.maximum(d_mat.amax(dim=2), b_vec)
    m_new = torch.clamp_min(m_new, M_FLOOR)

    intra = torch.einsum("blhd,bshd->blsh", q, k)
    intra = intra * torch.exp(d_mat - m_new[:, :, None])
    inter_w = torch.exp(b_vec - m_new)                           # [B,L,H]

    num = (torch.einsum("blsh,bshd->blhd", intra, v)
           + torch.einsum("blhd,bhdv->blhv", q, C) * inter_w[..., None])
    den = intra.sum(dim=2) + torch.einsum("blhd,bhd->blh", q, n) * inter_w
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]

    # chunk-final state update
    last = cum[:, -1]                                            # [B,H]
    m_next = torch.maximum(m + last, (last[:, None] - cum + ig).amax(dim=1))
    decay = torch.exp(m + last - m_next)                         # [B,H]
    w_s = torch.exp(last[:, None] - cum + ig - m_next[:, None])  # [B,L,H]
    C_next = C * decay[..., None, None] + torch.einsum(
        "bshd,bshv->bhdv", k * w_s[..., None], v)
    n_next = n * decay[..., None] + torch.einsum("bshd,bsh->bhd", k, w_s)
    return (C_next, n_next, m_next), h


def mlstm_scan(q, k, v, ig, fg, chunk: int,
               state: Optional[tuple] = None):
    """q, k, v [B, S, H, D] f32; ig / fg preactivations [B, S, H].  A
    ragged last chunk is padded with ``ig = -1e30`` and a forget log of 0,
    which leave the state as it was.  Returns (h [B, S, H, D], final
    state)."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    lf = logsigmoid(fg)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
        ig = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=M_FLOOR)
        lf = torch.nn.functional.pad(lf, (0, 0, 0, pad))
    if state is None:
        state = (q.new_zeros((B, H, D, D)), q.new_zeros((B, H, D)),
                 q.new_full((B, H), M_FLOOR))
    hs = []
    for c0 in range(0, q.shape[1], chunk):
        c = slice(c0, c0 + chunk)
        state, h = _mlstm_chunk_step(state, q[:, c], k[:, c], v[:, c],
                                     ig[:, c], lf[:, c], scale)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S], state


def mlstm_decode_step(q, k, v, ig, fg, state):
    """One token.  q, k, v [B, 1, H, D]; gates [B, 1, H]."""
    C, n, m = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    lf = logsigmoid(fg)[:, 0]
    ig = ig[:, 0]
    m_new = torch.maximum(lf + m, ig)
    f_p = torch.exp(lf + m - m_new)
    i_p = torch.exp(ig - m_new)
    k0, v0, q0 = k[:, 0], v[:, 0], q[:, 0] * scale
    C = C * f_p[..., None, None] + torch.einsum(
        "bhd,bhv->bhdv", k0 * i_p[..., None], v0)
    n = n * f_p[..., None] + k0 * i_p[..., None]
    num = torch.einsum("bhd,bhdv->bhv", q0, C)
    den = torch.einsum("bhd,bhd->bh", q0, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h[:, None], (C, n, m_new)


class MLSTMBlock(nn.Module):
    """The reference's ``mlstm_block_init`` leaves: ``up`` [d, 2·di],
    ``conv_w`` [K, di], ``conv_b`` [di], ``q``/``k``/``v`` [di, H, dh],
    ``igate`` and ``fgate`` [di, H] and ``fgate_b`` [H] (f32),
    ``norm.scale`` [di] (f32) and ``down`` [di, d]."""

    def __init__(self, d_model: int, cfg: XLSTMConfig, dtype, device):
        super().__init__()
        di, H = cfg.mlstm_inner(d_model), cfg.n_heads
        f32 = torch.float32
        self.up = weight((d_model, 2 * di), dtype, device)
        self.conv_w = weight((cfg.conv_kernel, di), dtype, device)
        self.conv_b = weight((di,), dtype, device)
        for name in ("q", "k", "v"):
            setattr(self, name, weight((di, H, di // H), dtype, device))
        self.igate = weight((di, H), f32, device)
        self.fgate = weight((di, H), f32, device)
        self.fgate_b = weight((H,), f32, device)
        self.norm = nn.Module()
        self.norm.scale = weight((di,), f32, device)
        self.down = weight((di, d_model), dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        """``mlstm_block_init``: the projections and ``igate`` over
        sqrt(fan_in), ``conv_w`` times 0.1; ``fgate`` and ``conv_b``
        zeros, ``fgate_b`` 3, the norm ones."""
        for p in (self.up, self.q, self.k, self.v, self.igate, self.down):
            truncated_normal_(p, generator, 1.0 / math.sqrt(p.shape[0]))
        truncated_normal_(self.conv_w, generator, 0.1)
        with torch.no_grad():
            self.conv_b.zero_()
            self.fgate.zero_()
            self.fgate_b.fill_(3.0)
            self.norm.scale.fill_(1.0)


def _among_heads(t: torch.Tensor, axis: int, heads: slice, H: int,
                 fill: float = 0.0) -> torch.Tensor:
    """``t``'s heads (on ``axis``) placed at ``heads`` among H, ``fill``
    at the others."""
    shape = list(t.shape)
    shape[axis] = H
    out = t.new_full(shape, fill)
    out.narrow(axis, heads.start, heads.stop - heads.start).copy_(t)
    return out


def mlstm_block_apply(blk: MLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig,
                      cache: Optional[dict] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d].  With a cache: one token takes the decode
    step, more the chunked scan from the cache's state; the conv tail,
    state and index are updated in place.

    A tensor-parallel rank's block holds its heads' q, k and v and their
    state (:func:`repro_torch.parallel.sharding.mlstm_cuts`; ``up``, the
    conv and the gates' weights whole).  Its recurrence runs among all H
    heads, the others' q, k, v and state zero: the batched products then
    have the unsharded block's shapes, and cuBLAS rounds the rank's heads
    as it rounds them there (over fewer heads it takes other algorithms).
    The heads' outputs are gathered (one all-gather) before the norm and
    the whole ``down``."""
    B, S, D = x.shape
    di, K = cfg.mlstm_inner(D), cfg.conv_kernel
    group = _tp.group_of(blk)

    up = torch.einsum("bsd,dk->bsk", x, blk.up)
    u, z = up[..., :di], up[..., di:]
    tail_in = cache["conv"] if cache is not None else None
    conv = _causal_conv(u, blk.conv_w, blk.conv_b, tail_in)

    q = torch.einsum("bsk,khd->bshd", conv, blk.q).float()
    k = torch.einsum("bsk,khd->bshd", conv, blk.k).float()
    v = torch.einsum("bsk,khd->bshd", u, blk.v).float()
    ig = torch.einsum("bsk,kh->bsh", conv.float(), blk.igate)
    fg = torch.einsum("bsk,kh->bsh", conv.float(), blk.fgate) + blk.fgate_b
    state = None if cache is None else (cache["C"], cache["n"], cache["m"])
    if group is not None:
        H, Hr = cfg.n_heads, q.shape[2]
        heads = slice(group.rank * Hr, (group.rank + 1) * Hr)
        q, k, v = (_among_heads(t, 2, heads, H) for t in (q, k, v))
        if state is not None:
            state = (_among_heads(state[0], 1, heads, H),
                     _among_heads(state[1], 1, heads, H),
                     _among_heads(state[2], 1, heads, H, M_FLOOR))

    if cache is not None:
        if S == 1:
            h, state = mlstm_decode_step(q, k, v, ig, fg, state)
        else:
            h, state = mlstm_scan(q, k, v, ig, fg, cfg.chunk, state)
        new_tail = torch.cat([tail_in, u.to(tail_in.dtype)],
                             dim=1)[:, -(K - 1):]
        cache["conv"].copy_(new_tail)
        for name, value in zip(("C", "n", "m"), state):
            cache[name].copy_(value if group is None else value[:, heads])
        cache["index"] += S
    else:
        h, _ = mlstm_scan(q, k, v, ig, fg, cfg.chunk)

    if group is not None:
        h = _tp.gather_heads(group, h[:, :, heads].to(x.dtype), 2)
    h = h.reshape(B, S, di).to(x.dtype)
    h = rmsnorm_apply(blk.norm.scale, h) * silu(z)
    return torch.einsum("bsk,kd->bsd", h, blk.down)


# ---------------------------------------------------------------------------
# sLSTM: scalar-memory recurrent cell (sequential scan)
# ---------------------------------------------------------------------------
class SLSTMBlock(nn.Module):
    """The reference's ``slstm_block_init`` leaves: ``w`` [d, 4, H, dh],
    ``r`` [4, H, dh, dh] and ``b`` [4, H, dh] (all f32; gates z, i, f, o),
    ``norm.scale`` [d] (f32) and the geglu ``ffn`` (bf16 ``up``/``gate``
    [d, ffn], ``down`` [ffn, d])."""

    def __init__(self, d_model: int, cfg: XLSTMConfig, dtype, device):
        super().__init__()
        H = cfg.n_heads
        dh = d_model // H
        f32 = torch.float32
        self.w = weight((d_model, 4, H, dh), f32, device)
        self.r = weight((4, H, dh, dh), f32, device)
        self.b = weight((4, H, dh), f32, device)
        self.norm = nn.Module()
        self.norm.scale = weight((d_model,), f32, device)
        self.ffn = MLP(d_model, cfg.slstm_ffn(d_model), True, dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        """``slstm_block_init``: ``w`` over sqrt(d), ``r`` over sqrt(dh),
        ``b`` zeros, the norm ones, the FFN as ``mlp_init``."""
        truncated_normal_(self.w, generator,
                          1.0 / math.sqrt(self.w.shape[0]))
        truncated_normal_(self.r, generator,
                          1.0 / math.sqrt(self.r.shape[-1]))
        with torch.no_grad():
            self.b.zero_()
            self.norm.scale.fill_(1.0)
        self.ffn.init_(generator)


def _slstm_step(blk: SLSTMBlock, carry, wx_t):
    """carry: (c, n, h, m) each [B, H, dh]; wx_t [B, 4, H, dh]."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,ghde->bghe", h, blk.r) + blk.b
    pre = wx_t + rec
    z_t = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = pre[:, 2]
    o_t = torch.sigmoid(pre[:, 3])
    lf = logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(lf + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


def slstm_scan(blk: SLSTMBlock, wx: torch.Tensor, carry: tuple):
    """The sequential scan over wx [B, S, 4, H, dh] from ``carry``;
    returns (h [B, S, H, dh], final carry)."""
    hs = []
    for s in range(wx.shape[1]):
        carry = _slstm_step(blk, carry, wx[:, s])
        hs.append(carry[2])
    return torch.stack(hs, dim=1), carry


def slstm_block_apply(blk: SLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig,
                      cache: Optional[dict] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: the scan, rmsnorm, and the geglu FFN
    added as a residual.  The cache's carry and index are updated in
    place.  A tensor-parallel rank's block holds its heads' ``r``, ``b``
    and carry (:func:`repro_torch.parallel.sharding.slstm_cuts`: the
    recurrence is block-diagonal by head) and takes its heads of the
    whole input projection; the heads' outputs are gathered (one
    all-gather) before the norm and the whole FFN."""
    B, S, D = x.shape
    H = blk.r.shape[1]                       # the heads this block holds
    dh = D // cfg.n_heads
    group = _tp.group_of(blk)
    wx = torch.einsum("bsd,dghe->bsghe", x.float(), blk.w)
    if group is not None:
        wx = wx[:, :, :, group.rank * H:(group.rank + 1) * H]
    if cache is not None:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zero = x.new_zeros((B, H, dh), dtype=torch.float32)
        carry = (zero, zero, zero, torch.full_like(zero, M_FLOOR))
    hs, carry = slstm_scan(blk, wx, carry)
    if cache is not None:
        for name, value in zip(("c", "n", "h", "m"), carry):
            cache[name].copy_(value)
        cache["index"] += S
    h = hs.reshape(B, S, H * dh).to(x.dtype)
    if group is not None:
        h = _tp.gather_heads(group, h, -1)
    h = rmsnorm_apply(blk.norm.scale, h)
    return h + mlp_apply(blk.ffn, h, "geglu")


def init_mlstm_cache(batch: int, d_model: int, cfg: XLSTMConfig,
                     dtype=torch.bfloat16, device=None,
                     n_heads: Optional[int] = None) -> dict:
    """An mLSTM layer's cache over ``n_heads`` heads (default the
    config's; a tensor-parallel rank's block holds fewer)."""
    di = cfg.mlstm_inner(d_model)
    dh = di // cfg.n_heads
    H = n_heads or cfg.n_heads
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di), dtype=dtype,
                            device=device),
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), M_FLOOR, dtype=f32, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_slstm_cache(batch: int, d_model: int, cfg: XLSTMConfig,
                     device=None, n_heads: Optional[int] = None) -> dict:
    """An sLSTM layer's carry over ``n_heads`` heads (default the
    config's)."""
    shape = (batch, n_heads or cfg.n_heads, d_model // cfg.n_heads)
    f32 = torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, M_FLOOR, dtype=f32, device=device),
            "index": torch.zeros((batch,), dtype=torch.int32,
                                 device=device)}
