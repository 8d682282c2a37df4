"""Chunked SSD (Mamba-2) scan (port of ``repro/kernels/ssd_scan.py``).

The state-space dual form, one chunk at a time: inside a chunk the
output is ``(C·Bᵀ ∘ L)·X`` plus the carried state's ``exp(cum) · C·hᵀ``;
the state ``h [P, N]`` then decays by the chunk's total and takes
``(X ∘ decay)ᵀ·B``.  The state starts at zero.  The CUDA body is
``csrc/ssd_scan.cu``: one block per (head, slice of P) carries its rows
of ``h`` across the chunks in a loop; its note says what bounds it.  The
wrapper takes its plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises, and counts the launch.

x:     [BH, S, P]   (dt-scaled inputs; f32)
log_a: [BH, S]      (per-step log decay, <= 0; f32)
b, c:  [BH, S, N]   (f32)
out:   y [BH, S, P] (x's dtype), final state [BH, P, N] (f32)

``chunk`` is the reference's chunk length; a ragged last chunk is
shorter (the reference requires S % chunk == 0, which ``ops`` keeps).
"""
from __future__ import annotations

import torch

from ._launch import I, bind, check, on_cpu, ptr, require, stream
from ._launch import P as PTR

# the kernel holds one chunk of b, c and C·Bᵀ in shared memory: at most
# 128 positions, and what a block may hold on the card (227 KiB)
MAX_CHUNK = 128
SMEM_LIMIT = 232448

_LIB = "ssd_scan"


def ssd_scan_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's body, chunk by chunk, in f32: the decay
    matrix ``L[t, s] = exp(cum_t - cum_s)`` is evaluated only for
    ``s <= t`` (above the diagonal the exponent is positive and can
    overflow)."""
    BH, S, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xs = x[:, c0:c0 + chunk].float()
        la = log_a[:, c0:c0 + chunk].float()
        bs = b[:, c0:c0 + chunk].float()
        cs = c[:, c0:c0 + chunk].float()
        L = xs.shape[1]
        cum = torch.cumsum(la, -1)                              # [BH, L]
        tri = torch.ones((L, L), dtype=torch.bool,
                         device=x.device).tril()
        seg = cum[:, :, None] - cum[:, None, :]
        decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
        cb = torch.matmul(cs, bs.transpose(1, 2))               # [BH, t, s]
        y = torch.matmul(cb * decay, xs)
        y = y + torch.exp(cum)[..., None] * torch.matmul(cs,
                                                         h.transpose(1, 2))
        ys.append(y)
        decay_out = torch.exp(cum[:, -1:] - cum)                # [BH, L]
        h = torch.exp(cum[:, -1])[:, None, None] * h + torch.matmul(
            (xs * decay_out[..., None]).transpose(1, 2), bs)
    return torch.cat(ys, 1).to(x.dtype), h


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [BH, S, P], final state [BH, P, N]) of the chunked scan.  One
    launch on CUDA tensors, which must be f32, with ``chunk`` at most
    128 and a chunk's b, c and C·Bᵀ within the block's shared memory
    (N 128 at chunk 128 is not)."""
    if x.dim() != 3:
        raise ValueError(f"x: expected [BH, S, P], got shape "
                         f"{tuple(x.shape)}")
    BH, S, P = x.shape
    if chunk < 1:
        raise ValueError("chunk must be positive")
    if on_cpu(x, log_a, b, c):
        return ssd_scan_plain(x, log_a, b, c, chunk)
    N = b.shape[-1] if b.dim() == 3 else -1
    require(x, "x", torch.float32)
    require(log_a, "log_a", torch.float32, (BH, S))
    require(b, "b", torch.float32, (BH, S, N))
    require(c, "c", torch.float32, (BH, S, N))
    chunk = min(chunk, S)
    if chunk > MAX_CHUNK or N < 1 or S == 0 or P == 0:
        raise ValueError(f"ssd_scan takes 0 < S, chunk <= {MAX_CHUNK} and "
                         f"0 < N; got S={S}, P={P}, chunk={chunk}, N={N}")
    smem = bind(_LIB, "ssd_scan_smem_bytes", [I, I])(chunk, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {chunk} with N={N} needs {smem} "
                         f"bytes of shared memory, above {SMEM_LIMIT}")
    y = torch.empty_like(x)
    final = torch.empty((BH, P, N), dtype=torch.float32, device=x.device)
    fn = bind(_LIB, "ssd_scan_launch",
              [PTR, PTR, PTR, PTR, PTR, PTR, I, I, I, I, I, PTR])
    check(_LIB, fn(ptr(x), ptr(log_a), ptr(b), ptr(c), ptr(y), ptr(final),
                   BH, S, P, N, chunk, stream(x)), "ssd_scan")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
