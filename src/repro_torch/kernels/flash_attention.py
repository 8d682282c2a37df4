"""Flash-attention prefill (port of ``repro/kernels/flash_attention.py``).

Causal, sliding-window, prefix or full attention of a whole prompt with an
online softmax over KV tiles; the CUDA bodies are ``csrc/flash_attention.cu``,
whose note says what bounds them and how they follow the reference (GQA
by reading KV head ``h // G``, never repeating KV; f32 scores; ``p``
rounded to v's dtype before PV; masked scores ``-1e30``; KV tiles that
no query row of a tile can see are skipped, which computes the same
function).  bf16 with ``D % 8 == 0`` runs on the tensor cores
(``mma.sync``; D 72, DiT-XL/2's head size, in the tile 128 wide), f32
and any other bf16 head size on the CUDA cores.  The
wrapper takes its plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises, and counts the launch.

q:   [B, Sq, H, D]    (f32 or bf16; D <= 256)
k,v: [B, Skv, KH, D]  (q's dtype; H % KH == 0)
out: [B, Sq, H, D]    (q's dtype)
lse: [B, H, Sq] f32   (with ``return_lse``: each row's log-sum-exp of its
                       scaled scores, 1e30 for a row with no visible key)

The causal mask is aligned top-left: query and key positions both start
at 0, also when Sq != Skv.  ``window`` hides keys at or before
``q_pos - window``.  ``prefix_len`` p > 0 (causal, no window) also shows
every query the keys before p: the reference's ``"prefix"`` mask, the
image prefix of a vision config attended bidirectionally.
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._launch import (DTYPE_CODE, F, I, P, bind, check, on_cpu, ptr,
                      require, stream)

NEG_INF = ref.NEG_INF
MAX_HEAD_DIM = 256
BODIES = ("mma", "fma")
# the tensor-core body's 16-byte copies: q, k, v rows start 16-byte
# aligned (a head of D % 8 == 0 bf16 values is whole 16-byte chunks)
_ALIGN = 16

_LIB = "flash_attention"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          prefix_len: int = 0, return_lse: bool = False):
    """The kernel's arithmetic, densely: f32 scores times 1/sqrt(D),
    masked with -1e30; p = exp(s - max) rounded to v's dtype for PV,
    l = sum of the unrounded p; out = (p . v) / max(l, 1e-30) in q's
    dtype.  ``return_lse`` also returns max + log(l) [B, H, Sq] f32
    (1e30 where the max is -1e30: no visible key)."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.float().reshape(B, Sq, KH, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    ok = ref.prefill_visible(Sq, Skv, causal, window, q.device, prefix_len)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / torch.clamp_min(l, 1e-30)
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    return out, row_lse(s.amax(-1), l[..., 0]).reshape(B, H, Sq)


def row_lse(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """m + log(l) where the row saw a key (its max above -1e30), 1e30
    where it saw none: the kernel's rule."""
    return torch.where(m > NEG_INF, m + torch.log(l),
                       torch.full_like(m, 1e30))


def body_for(dtype: torch.dtype, D: int) -> str:
    """The body a call takes by default: the tensor cores' ("mma") for
    bf16 with ``D % 8 == 0``, else the CUDA cores' f32 one ("fma")."""
    return "mma" if dtype == torch.bfloat16 and D % 8 == 0 else "fma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None, *,
                    body: str | None = None, prefix_len: int = 0,
                    return_lse: bool = False):
    """Prefill attention of q over k/v (see the module note for shapes
    and masks).  One launch on CUDA tensors.  ``body`` ("mma" or "fma")
    overrides :func:`body_for`; "mma" needs bf16 and ``D % 8 == 0``.
    ``return_lse`` returns ``(out, lse)``: the rows' log-sum-exp, written
    by the same launch."""
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    prefix_len = int(prefix_len or 0)
    if prefix_len < 0 or (prefix_len and (not causal
                                          or window is not None)):
        raise ValueError(f"prefix_len takes an int >= 0 with a causal "
                         f"mask and no window; got {prefix_len}, "
                         f"causal={causal}, window={window}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected [B, S, H, D], got shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, D) or H % KH:
        raise ValueError(f"k: shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (H % KH must be 0)")
    if body is not None and body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, window, prefix_len,
                                     return_lse)
    require(q, "q", (torch.float32, torch.bfloat16))
    require(k, "k", q.dtype)
    require(v, "v", q.dtype, tuple(k.shape))
    if D > MAX_HEAD_DIM or Sq == 0 or Skv == 0:
        raise ValueError(f"flash_attention takes 0 < S and D <= "
                         f"{MAX_HEAD_DIM}; got Sq={Sq}, Skv={Skv}, D={D}")
    body = body or body_for(q.dtype, D)
    if body == "mma":
        if body_for(q.dtype, D) != "mma":
            raise ValueError(f"the tensor-core body takes bf16 with "
                             f"D % 8 == 0; got {q.dtype}, D={D}")
        for name, a in (("q", q), ("k", k), ("v", v)):
            if a.data_ptr() % _ALIGN:
                raise ValueError(f"{name} must start {_ALIGN}-byte aligned "
                                 f"for the tensor-core body")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = bind(_LIB, "flash_attention_launch",
              [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, P])
    check(_LIB, fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse),
                   DTYPE_CODE[q.dtype], int(body == "mma"), B, Sq, Skv, H,
                   KH, D, int(causal), window or 0, prefix_len,
                   1.0 / math.sqrt(D), stream(q)),
          "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
