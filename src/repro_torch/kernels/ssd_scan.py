"""Chunked SSD (Mamba-2) scan (port of ``repro/kernels/ssd_scan.py``,
with the initial state of ``repro/models/ssm.py::ssd_chunked``).

The state-space dual form, one chunk at a time: inside a chunk the
output is ``(C·Bᵀ ∘ L)·X`` plus the entering state's ``exp(cum) · C·hᵀ``;
the state ``h [P, N]`` then decays by the chunk's total and takes
``(X ∘ decay)ᵀ·B``.  The state starts at ``h0`` (zeros when None).  The
CUDA body is ``csrc/ssd_scan.cu``: one block per (head, chunk), the
chunk states passed on by a look-back inside the one launch; its note
says how.  The wrapper takes its plain version for CPU tensors; for
CUDA tensors it launches the kernel or raises, and counts the launch.

Two layouts, f32 throughout:

* flattened heads (the ops surface, the reference kernel's):
  x [BH, S, P], log_a [BH, S], b and c [BH, S, N], h0 [BH, P, N];
* the model's (``ssd_chunked``'s): x [B, S, H, P], log_a [B, S, H], b
  and c [B, S, G, N] per group (head h reads group h // (H // G), as
  ``jnp.repeat`` broadcasts them), h0 [B, H, P, N].

y comes back in x's layout and dtype, the final state as h0's layout.
``chunk`` is the reference's chunk length; a ragged last chunk is
shorter and exact (the reference pads S to a multiple of it, with zeros
that change nothing).
"""
from __future__ import annotations

from typing import Optional

import torch

from ._launch import I, bind, check, on_cpu, ptr, require, stream
from ._launch import P as PTR

# the kernel holds one chunk of b, c and C·Bᵀ in shared memory: at most
# 128 positions, and what a block may hold on the card (227 KiB)
MAX_CHUNK = 128
SMEM_LIMIT = 232448

_LIB = "ssd_scan"


def _dims(x, log_a, b, c, h0) -> tuple[int, int, int, int, int, int]:
    """(B, S, H, G, P, N) of either layout; raises on a shape that does
    not fit it."""
    if x.dim() == 3:
        B, S, P = x.shape
        H = G = 1
        N = b.shape[-1] if b.dim() == 3 else -1
        shapes = {"log_a": (B, S), "b": (B, S, N), "c": (B, S, N),
                  "h0": (B, P, N)}
    elif x.dim() == 4:
        B, S, H, P = x.shape
        G, N = (b.shape[2], b.shape[3]) if b.dim() == 4 else (1, -1)
        shapes = {"log_a": (B, S, H), "b": (B, S, G, N),
                  "c": (B, S, G, N), "h0": (B, H, P, N)}
    else:
        raise ValueError(f"x: expected [BH, S, P] or [B, S, H, P], got "
                         f"shape {tuple(x.shape)}")
    for name, t in (("log_a", log_a), ("b", b), ("c", c), ("h0", h0)):
        if t is not None and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{shapes[name]}")
    if N < 1 or G < 1 or H % G:
        raise ValueError(f"ssd_scan: N={N} and G={G} must be positive "
                         f"and G must divide H={H}")
    return B, S, H, G, P, N


def _plain_flat(x, log_a, b, c, chunk, h0):
    """The reference kernel's body on flattened heads, chunk by chunk,
    in f32: the decay matrix ``L[t, s] = exp(cum_t - cum_s)`` is
    evaluated only for ``s <= t`` (above the diagonal the exponent is
    positive and can overflow)."""
    BH, S, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, S)
    h = (torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
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


def ssd_scan_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in either layout: the model's layout is
    flattened to one row per (batch, head), b and c repeated per head."""
    B, S, H, G, P, N = _dims(x, log_a, b, c, h0)
    if x.dim() == 3:
        return _plain_flat(x, log_a, b, c, chunk, h0)

    def flat(t):                     # [B, S, H, K] -> [B * H, S, K]
        return t.transpose(1, 2).reshape(B * H, S, -1)
    rep = H // G
    y, h = _plain_flat(
        flat(x), log_a.transpose(1, 2).reshape(B * H, S),
        flat(b.repeat_interleave(rep, 2)), flat(c.repeat_interleave(rep, 2)),
        chunk, None if h0 is None else h0.reshape(B * H, P, N))
    return (y.reshape(B, H, S, P).transpose(1, 2).contiguous(),
            h.reshape(B, H, P, N))


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the chunked scan from ``h0`` (None: zeros),
    in either layout.  One launch on CUDA tensors, which must be f32 and
    contiguous, with ``chunk`` at most 128 and the block's shared memory
    within the card's (N 256 at chunk 128 is not)."""
    if chunk < 1:
        raise ValueError("chunk must be positive")
    B, S, H, G, P, N = _dims(x, log_a, b, c, h0)
    if on_cpu(x, log_a, b, c, h0):
        return ssd_scan_plain(x, log_a, b, c, chunk, h0)
    for name, t in (("x", x), ("log_a", log_a), ("b", b), ("c", c),
                    ("h0", h0)):
        if t is not None:
            require(t, name, torch.float32)
    chunk = min(chunk, S)
    if chunk > MAX_CHUNK or S == 0 or P == 0:
        raise ValueError(f"ssd_scan takes 0 < S, 0 < P and chunk <= "
                         f"{MAX_CHUNK}; got S={S}, P={P}, chunk={chunk}")
    smem = bind(_LIB, "ssd_scan_smem_bytes", [I, I, I])(chunk, P, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {chunk} with P={P}, N={N} needs "
                         f"{smem} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    nc = -(-S // chunk)
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N) if x.dim() == 4 else (B, P, N),
                        dtype=torch.float32, device=x.device)
    ws = torch.empty(((nc - 1) * B * H * P * N,), dtype=torch.float32,
                     device=x.device)
    flags = torch.zeros((nc * B * H + 1,), dtype=torch.int32,
                        device=x.device)
    vec = int(P % 4 == 0 and N % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, b, c)))
    fn = bind(_LIB, "ssd_scan_launch",
              [PTR] * 9 + [I] * 8 + [PTR])
    check(_LIB, fn(ptr(x), ptr(log_a), ptr(b), ptr(c), ptr(h0), ptr(y),
                   ptr(final), ptr(ws), ptr(flags), B, S, H, G, P, N, chunk,
                   vec, stream(x)), "ssd_scan")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
