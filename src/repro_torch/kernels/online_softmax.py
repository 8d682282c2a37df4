"""Online-softmax kernel (port of ``repro/kernels/online_softmax.py``).

Softmax over the last axis of x [R, C] (f32 or bf16), computed in f32
and returned in x's dtype.  Two regimes, as in the reference, switched
by what fits in the kernel's shared memory (not by the reference's
``block_c``):

* a row of at most ``ROWS_MAX_C`` columns is held on chip by one block:
  max, ``exp(x - max)``, sum, divide (``_softmax_rows_kernel``), one
  launch;
* a longer row is cut into column slices over many blocks.  A stats
  launch writes each slice's running ``(m, l)``; a normalize launch
  merges a row's slices (``l`` clamped at 1e-30) and writes
  ``exp(x - m) / l`` (``_softmax_online_kernel``'s two sweeps).  Two
  launches per call, and the counter counts both.

The CUDA bodies are ``csrc/online_softmax.cu``; its note says what
bounds them.  The wrapper takes its plain version for CPU tensors; for
CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import torch

from ._launch import (DTYPE_CODE, I, P, bind, check, on_cpu, ptr, require,
                      stream)

# the longest row the rows kernel stages in 48 KiB of shared memory (f32)
ROWS_MAX_C = 12288
# columns per block of the long-row path
SLICE_C = 4096

_LIB = "online_softmax"


def online_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic: in f32, ``exp(x - max) / max(sum,
    1e-30)``, in x's dtype."""
    x32 = x.float()
    p = torch.exp(x32 - x32.amax(-1, keepdim=True))
    return (p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)).to(x.dtype)


def n_slices(C: int) -> int:
    """Column slices per row of the long-row path (1 for the rows
    path)."""
    return 1 if C <= ROWS_MAX_C else -(-C // SLICE_C)


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of x [R, C].  One launch on CUDA
    tensors when C <= ``ROWS_MAX_C``, else two."""
    if x.dim() != 2:
        raise ValueError(f"x: expected [R, C], got shape {tuple(x.shape)}")
    if on_cpu(x):
        return online_softmax_plain(x)
    require(x, "x", (torch.float32, torch.bfloat16))
    R, C = x.shape
    if R == 0 or C == 0:
        raise ValueError(f"online_softmax takes a non-empty x, got shape "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    kind = DTYPE_CODE[x.dtype]
    ns = n_slices(C)
    if ns == 1:
        fn = bind(_LIB, "online_softmax_rows_launch", [P, P, I, I, I, P])
        check(_LIB, fn(ptr(x), ptr(out), kind, R, C, stream(x)),
              "online_softmax (rows)")
        online_softmax.launches += 1
        return out
    m = torch.empty((R, ns), dtype=torch.float32, device=x.device)
    l = torch.empty_like(m)
    fn = bind(_LIB, "online_softmax_stats_launch", [P, P, P, I, I, I, I, P])
    check(_LIB, fn(ptr(x), ptr(m), ptr(l), kind, R, C, SLICE_C, stream(x)),
          "online_softmax (stats)")
    online_softmax.launches += 1
    fn = bind(_LIB, "online_softmax_normalize_launch",
              [P, P, P, P, I, I, I, I, P])
    check(_LIB, fn(ptr(x), ptr(m), ptr(l), ptr(out), kind, R, C, SLICE_C,
                   stream(x)), "online_softmax (normalize)")
    online_softmax.launches += 1
    return out


online_softmax.launches = 0
