"""Online-softmax kernel (port of ``repro/kernels/online_softmax.py``).

Softmax over the last axis of x [R, C] (f32 or bf16), computed in f32
and returned in x's dtype.  :func:`softmax_plan` picks the launch from
(R, C, dtype, x's alignment) alone, not from the reference's
``block_c``; every regime holds a thread's values in registers:

* ``"warp"`` (C <= 1024): a warp takes a row, a block 8 rows; one launch,
  x read once (``_softmax_rows_kernel``);
* ``"block"``: a block takes a row; one launch, x read once;
* ``"cluster"``: a thread-block cluster of up to 16 blocks takes a row
  (8 where it fills idle SMs), each block a slice; the blocks exchange
  their slices' ``(m, l)`` through distributed shared memory and merge
  them as the reference's online recurrence does
  (``_softmax_online_kernel``'s running state); one launch, x read
  once;
* ``"split"`` (C > 524288): a stats launch writes each 4096-value
  slice's ``(m, l)``, a normalize launch merges a row's slices (``l``
  clamped at 1e-30) and writes ``exp(x - m) / l``.  Two launches, and the
  counter counts both.

The CUDA bodies are ``csrc/online_softmax.cu``; its note says what
bounds them.  The wrapper takes its plain version for CPU tensors; for
CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ._launch import (DTYPE_CODE, I, P, bind, check, on_cpu, ptr, require,
                      stream)
from .cim_gemm import SMS
VALUES = 32               # f32 values a thread holds (warp, block, cluster)
WARP_ROWS = 8             # rows a block of the warp regime
MAX_THREADS = 1024        # threads a block
MAX_CLUSTER = 16          # blocks a row (the non-portable size above 8)
SPREAD_CLUSTER = 8        # the most blocks a row takes to fill idle SMs
MIN_SLICE = 2048          # values of a cluster block's slice, at least
SPLIT_THREADS = 256       # threads a block of the split regime
SPLIT_VALUES = 16         # values a thread of the split regime
WARP_MAX_C = 32 * VALUES                                # 1024
CLUSTER_MAX_C = MAX_CLUSTER * MAX_THREADS * VALUES      # 524288
SPLIT_SLICE = SPLIT_THREADS * SPLIT_VALUES              # 4096 values

_LIB = "online_softmax"
_X_ITEM = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class SoftmaxPlan:
    regime: str    # "warp", "block", "cluster" or "split"
    threads: int   # threads a block
    units: int     # units a thread holds (16 bytes when vec, else a value)
    cluster: int   # blocks of a cluster that take a row (1 outside it)
    vec: bool      # 16-byte units; else single values
    launches: int  # 1, or 2 for "split"


_FORCED: dict = {}


@contextlib.contextmanager
def forced_softmax_plan(threads: int, cluster: int):
    """Force the threads and the cluster of the block and cluster
    regimes inside the block (timings of other plans); the launch raises
    if they do not hold a row."""
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 from 32 to "
                         f"{MAX_THREADS}")
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be from 1 to {MAX_CLUSTER}")
    saved = dict(_FORCED)
    _FORCED.update(threads=threads, cluster=cluster)
    try:
        yield
    finally:
        _FORCED.clear()
        _FORCED.update(saved)


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def softmax_plan(R: int, C: int, dtype: torch.dtype,
                 aligned: bool = True) -> SoftmaxPlan:
    """The launch plan of kernel 14 on x [R, C] of ``dtype`` (float32 or
    bfloat16), a function of its arguments alone (``aligned``: x's first
    byte is 16-byte aligned).  Rows whose bytes divide into 16 (and are
    aligned) take 16-byte units, else single values; a thread holds
    ``VALUES`` values (``units`` units).

    * C <= ``WARP_MAX_C`` (1024): ``"warp"``, a warp a row.
    * C > ``CLUSTER_MAX_C`` (524288): ``"split"``, two launches.
    * Else the cluster is the fewest blocks (a power of two) whose
      ``MAX_THREADS`` x ``VALUES`` hold the row, doubled up to
      ``SPREAD_CLUSTER`` while R x cluster < ``SMS`` and a slice keeps at
      least ``MIN_SLICE`` values; a block has the fewest threads (a power
      of two from 32) that hold its slice.  Cluster 1 is ``"block"``.
      gemma-2b's logits ([8, 256000]) take 8 clusters of 8 blocks of 1024
      threads: 16 blocks of 512 were slower on the card (``PERF.md``)."""
    if dtype not in _X_ITEM:
        raise ValueError(f"dtype must be one of {tuple(_X_ITEM)}")
    if R < 1 or C < 1:
        raise ValueError(f"x [{R}, {C}] is empty")
    xb = _X_ITEM[dtype]
    vec = aligned and C * xb % 16 == 0
    per = 16 // xb if vec else 1
    if C <= WARP_MAX_C:
        return SoftmaxPlan("warp", 32 * WARP_ROWS, VALUES // per, 1, vec, 1)
    if C > CLUSTER_MAX_C:
        return SoftmaxPlan("split", SPLIT_THREADS, SPLIT_VALUES // per, 1,
                           vec, 2)
    cs = _pow2_at_least(-(-C // (MAX_THREADS * VALUES)))
    while (cs < SPREAD_CLUSTER and R * cs < SMS
           and C // (2 * cs) >= MIN_SLICE):
        cs *= 2
    units = VALUES // per
    slice_units = -(-(C // per) // cs)
    threads = max(32, _pow2_at_least(-(-slice_units // units)))
    if _FORCED:
        threads, cs = _FORCED["threads"], _FORCED["cluster"]
    return SoftmaxPlan("block" if cs == 1 else "cluster", threads, units, cs,
                       vec, 1)


def online_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic: in f32, ``exp(x - max) / max(sum,
    1e-30)``, in x's dtype."""
    x32 = x.float()
    p = torch.exp(x32 - x32.amax(-1, keepdim=True))
    return (p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)).to(x.dtype)


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of x [R, C].  On CUDA tensors the
    launches :func:`softmax_plan` gives: one, or two above 524288
    columns."""
    if x.dim() != 2:
        raise ValueError(f"x: expected [R, C], got shape {tuple(x.shape)}")
    if on_cpu(x):
        return online_softmax_plain(x)
    require(x, "x", (torch.float32, torch.bfloat16))
    R, C = x.shape
    if R == 0 or C == 0:
        raise ValueError(f"online_softmax takes a non-empty x, got shape "
                         f"{tuple(x.shape)}")
    plan = softmax_plan(R, C, x.dtype, x.data_ptr() % 16 == 0)
    out = torch.empty_like(x)
    kind = DTYPE_CODE[x.dtype]
    if plan.regime != "split":
        fn = bind(_LIB, "online_softmax_rows_launch",
                  [P, P, I, I, I, I, I, I, I, I, P])
        check(_LIB, fn(ptr(x), ptr(out), kind, int(plan.vec), R, C,
                       int(plan.regime == "warp"), plan.threads,
                       plan.cluster, plan.units, stream(x)),
              f"online_softmax ({plan.regime})")
        online_softmax.launches += 1
        return out
    slices = -(-C // SPLIT_SLICE)
    m = torch.empty((R, slices), dtype=torch.float32, device=x.device)
    l = torch.empty_like(m)
    fn = bind(_LIB, "online_softmax_split_launch",
              [P, P, P, P, I, I, I, I, I, I, I, P])
    for phase, what in enumerate(("stats", "normalize")):
        check(_LIB, fn(ptr(x), ptr(m), ptr(l), ptr(out), kind,
                       int(plan.vec), R, C, slices, plan.units, phase,
                       stream(x)), f"online_softmax (split, {what})")
        online_softmax.launches += 1
    return out


online_softmax.launches = 0
