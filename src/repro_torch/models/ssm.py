"""Mamba-2 (SSD) blocks for zamba2-style hybrids (port of
``repro/models/ssm.py``).

A prefill (S > 1, or no cache) runs the chunked SSD scan, kernel 13 on
CUDA tensors (``kernels/ssd_scan.py``), from the cache's state when there
is a cache; a ragged last chunk is exact, so nothing is padded.  A scan
that autograd differentiates (training) goes through
``kernels.ssd_scan.SSDScan``: the kernel's forward, the reference's
gradient of the chunked form in plain torch.  The
S == 1 decode is the O(1) recurrence ``h = exp(dt·A) h + (dt·b) xᵀ, y =
c·h`` in plain torch, as the reference computes it outside any Pallas
kernel.  The projections stay bf16 ``torch.matmul``: no plan kind covers
a Mamba-2 block.  A cache dict ({"conv", "ssm", "index"}: the conv tail,
the state, the write index) is updated in place, so a slot's view of the
engine's batched cache takes the new values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import silu
from repro_torch.quant import tp as _tp
from repro_torch.quant.linear import kernels_enabled
from .layers import rmsnorm_apply, truncated_normal_, weight


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.state_dim


class Mamba2(nn.Module):
    """The reference's ``mamba2_init`` leaves: ``in_proj`` [d, 2·di +
    2·G·N + H], ``conv_w`` [K, conv_dim], ``conv_b``, ``a_log``,
    ``d_skip``, ``dt_bias`` [H] (f32), ``norm.scale`` [di] (f32) and
    ``out_proj`` [di, d]."""

    def __init__(self, d_model: int, cfg: SSMConfig, dtype, device):
        super().__init__()
        di, H = cfg.d_inner(d_model), cfg.n_heads(d_model)
        cd = cfg.conv_dim(d_model)
        f32 = torch.float32
        self.in_proj = weight((d_model, 2 * di + 2 * cfg.n_groups
                               * cfg.state_dim + H), dtype, device)
        self.conv_w = weight((cfg.conv_kernel, cd), dtype, device)
        self.conv_b = weight((cd,), dtype, device)
        self.a_log = weight((H,), f32, device)
        self.d_skip = weight((H,), f32, device)
        self.dt_bias = weight((H,), f32, device)
        self.norm = nn.Module()
        self.norm.scale = weight((di,), f32, device)
        self.out_proj = weight((di, d_model), dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        """``mamba2_init``: the projections ``N(0, 1)`` truncated to [-2,
        2] over sqrt(fan_in), ``conv_w`` times 0.1; ``a_log = log(1..H)``,
        ``d_skip`` and the norm ones, ``dt_bias`` and ``conv_b`` zeros."""
        truncated_normal_(self.in_proj, generator,
                          1.0 / math.sqrt(self.in_proj.shape[0]))
        truncated_normal_(self.conv_w, generator, 0.1)
        truncated_normal_(self.out_proj, generator,
                          1.0 / math.sqrt(self.out_proj.shape[0]))
        H = self.a_log.shape[0]
        with torch.no_grad():
            self.a_log.copy_(torch.log(torch.arange(
                1, H + 1, dtype=torch.float32, device=self.a_log.device)))
            self.d_skip.fill_(1.0)
            self.dt_bias.zero_()
            self.conv_b.zero_()
            self.norm.scale.fill_(1.0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, x [B, S, C], w [K, C], tail [B, K-1, C]:
    the K products summed one by one onto 0, then ``+ b``, then silu, each
    step rounded in x's dtype as the reference's ``sum`` does."""
    K, S = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return silu(out + b)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, without
    torch's linear cut-off above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_apply(m: Mamba2, x: torch.Tensor, cfg: SSMConfig,
                 cache: Optional[dict] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d].  ``cache`` ({"conv" [B, K-1, conv_dim],
    "ssm" [B, H, P, N] f32, "index" [B] int32}) is read and updated in
    place: the conv tail, the state, and the index advanced by S.

    A tensor-parallel rank's block holds its SSM heads (their z, x and dt
    columns, conv channels, ``a_log``, ``d_skip``, ``dt_bias``, state;
    :func:`repro_torch.parallel.sharding.mamba_cuts`): the heads run as
    the unsharded block's, and their gated outputs are gathered (one
    all-gather) before the norm and the whole ``out_proj``."""
    B, S, D = x.shape
    P, N, K = cfg.head_dim, cfg.state_dim, cfg.conv_kernel
    H = m.a_log.shape[0]                     # the heads this block holds
    di = H * P
    G = (m.conv_w.shape[1] - di) // (2 * N)
    group = _tp.group_of(m)

    zxbcdt = torch.matmul(x, m.in_proj)
    z = zxbcdt[..., :di]
    xbc_raw = zxbcdt[..., di:di + di + 2 * G * N]
    dt = zxbcdt[..., -H:]

    tail_in = cache["conv"] if cache is not None else None
    xbc = _causal_conv(xbc_raw, m.conv_w, m.conv_b, tail_in)
    if cache is not None:
        new_tail = torch.cat([tail_in, xbc_raw.to(tail_in.dtype)],
                             dim=1)[:, -(K - 1):]

    xs = xbc[..., :di].reshape(B, S, H, P)
    b = xbc[..., di:di + G * N].reshape(B, S, G, N).float().contiguous()
    c = xbc[..., di + G * N:].reshape(B, S, G, N).float().contiguous()

    a = -torch.exp(m.a_log)                                      # [H]
    dt = softplus(dt.float() + m.dt_bias)                        # [B, S, H]
    log_a = dt * a
    x_scaled = xs.float() * dt[..., None]                        # [B,S,H,P]

    if cache is None or S > 1:
        h0 = cache["ssm"].float() if cache is not None else None
        scan = (_ssd.ssd_scan_trainable if kernels_enabled()
                else _ssd.ssd_scan_plain)
        y, final = scan(x_scaled, log_a, b, c, cfg.chunk, h0)
    else:
        # O(1) decode: h = exp(dt*a) h + (dt*b) x ; y = c . h
        h = cache["ssm"].float()                                 # [B,H,P,N]
        da = torch.exp(log_a[:, 0])                              # [B, H]
        bh = b[:, 0].repeat_interleave(H // G, dim=1)            # [B, H, N]
        ch = c[:, 0].repeat_interleave(H // G, dim=1)
        final = h * da[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x_scaled[:, 0], bh)
        y = torch.einsum("bhpn,bhn->bhp", final, ch)[:, None]
    if cache is not None:
        cache["conv"].copy_(new_tail)
        cache["ssm"].copy_(final)
        cache["index"] += S

    y = y + xs.float() * m.d_skip[:, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * silu(z)
    if group is not None:
        y = _tp.gather_heads(group, y, -1)
    y = rmsnorm_apply(m.norm.scale, y)
    return torch.matmul(y, m.out_proj)


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig,
                   dtype=torch.bfloat16, device=None,
                   n_heads: Optional[int] = None,
                   conv_dim: Optional[int] = None) -> dict:
    """A Mamba-2 layer's cache; ``n_heads`` and ``conv_dim`` (default the
    config's) are the heads and conv channels a tensor-parallel rank's
    block holds."""
    H = n_heads or cfg.n_heads(d_model)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                             conv_dim or cfg.conv_dim(d_model)), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, cfg.head_dim, cfg.state_dim),
                           dtype=torch.float32, device=device),
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
