"""INT8 GEMM pipeline: row quantizer + fused-epilogue GEMMs, dense and
grouped over experts.

The port of ``repro/kernels/cim_gemm.py``.  The CUDA kernels live in
``csrc/cim_gemm.cu``: the dense GEMMs (kernels 2, 3, 4 and 6) run on one
tensor-core body in one of two tile shapes, with thread-block clusters
splitting K, as :func:`gemm_plan` decides from (M, K, N) and the body's
variant (int8 x, the gated pair of weights, or f32/bf16 x quantized in
the kernel); the grouped GEMMs (kernel 7 on the int8 body, kernel 8 on
the gated one) run the body once per expert under :func:`grouped_plan`;
the row quantizer (kernel 1) holds each row in the registers of one
block, as many threads as :func:`rowquant_plan` decides (see the note at
the top of that file for what bounds them and how).  Every wrapper
here:

* takes its plain version (``*_plain``) when its tensors lie on the CPU;
* on CUDA tensors checks dtype, shape, contiguity and alignment,
  allocates the outputs, launches on the current stream, raises if the
  launch failed, and adds one to its ``launches`` counter.

``quantize_out=True`` re-quantizes the output rows inside the same
launch (bitwise ``quantize_rows_int8`` of the f32 output); the
reference's ``[E, 1, N]`` scale layout is TPU tiling, so the grouped
wrappers take ``[E, N]``.

The degraded mode (``quant/linear.py``): :func:`finite_screen` reduces a
layer's f32 output to an int32 flag on the device (1: it holds a NaN or
an inf), and kernels 1, 2, 3, 4, 7 and 8 take that flag as ``gate=``: a
gated launch does nothing when the flag is 0 and otherwise runs on its
float operands read through ``nan_to_num(·, 0, 0, 0)`` (x, the scales,
the bias and the residual; never the int8 weights), writing into
``out=`` where given (the layer's output, in place).  Kernel 6 takes it
too: the int32 partial of a tensor-parallel row-parallel site's
fallback (its operands are int8, so it only gates).  The plain versions
take the same flag: they compute on the sanitized operands and write
``out`` only when the flag is set.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from . import ref
from ._launch import (ACTIVATIONS, DTYPE_CODE, I, P, bind, check, on_cpu,
                      ptr, require, stream)

# Above this many output columns the reference runs the hidden requant
# as a separate quantize dispatch (``quantize_out=False``).
MAX_FUSED_QUANT_N = 8192
# Above this many input columns the reference quantizes activations in a
# separate dispatch instead of inside the GEMM.
MAX_FUSED_QUANT_K = 4096

_LIB = "cim_gemm"
# the degraded fallback's gated instantiations (csrc/cim_gemm_fallback.cu)
_FALLBACK_LIB = "cim_gemm_fallback"
_FLOAT = (torch.float32, torch.bfloat16)
_GROUPED_I8_ARGS = [P] * 8 + [I] + [P] * 5 + [I] * 8 + [P, P]
_I8_ARGS = [P] * 8 + [I] * 3 + [P] * 5 + [I] * 7 + [P, P]
_ROWQUANT_ARGS = [P, I, P, P] + [I] * 4 + [P, P]
_SCREEN_ARGS = [P, ctypes.c_int64, P, P, P]


def _san(t):
    """``nan_to_num(t, 0, 0, 0)``: the degraded fallback's read of a float
    operand (None stays None)."""
    return None if t is None else torch.nan_to_num(t, nan=0.0, posinf=0.0,
                                                   neginf=0.0)


def _tripped(gate) -> bool:
    """The plain versions' read of the screen's flag (a host read: the
    CPU path only)."""
    return bool(gate.reshape(-1)[0])


def _gated_out(gate, out, result):
    """A gated plain version's result: written into ``out`` (a tensor, or
    a tuple for a tuple result; when given) only if the screen tripped,
    as the kernel writes it."""
    if out is None:
        return result
    if _tripped(gate):
        for o, r in zip(*((out, result) if isinstance(out, tuple)
                          else ((out,), (result,)))):
            o.copy_(r)
    return out


def _out_needs_gate(gate, out) -> None:
    if out is not None and gate is None:
        raise ValueError("out= is the degraded fallback's in-place output: "
                         "it needs gate=")


def _check_gate(gate, out, shape) -> None:
    require(gate, "gate", torch.int32, (1,))
    if out is not None:
        require(out, "out", torch.float32, shape)


def _epilogue_plain(acc, x_scale, w_scale, bias, residual, activation):
    """Dequant/bias/activation/residual; ``w_scale``/``bias`` are [N] or
    per expert [E, N]."""
    out = acc.float() * x_scale * w_scale.unsqueeze(-2)
    if bias is not None:
        out = out + bias.float().unsqueeze(-2)
    out = ref.activate_ref(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out


def _skip_plain(acc, counts):
    """Zero the accumulators of experts whose count is 0 (the kernels'
    skip list: such an expert runs no K sweep)."""
    if counts is None:
        return acc
    return torch.where(counts[:, None, None] > 0, acc, torch.zeros_like(acc))


def _residual_code(residual, M, N) -> int:
    if residual is None:
        return 0
    require(residual, "residual", _FLOAT, (M, N))
    return DTYPE_CODE[residual.dtype]


def _check_weight(w, w_scale, K, name="w", E=None):
    """w [K, N] (or [E, K, N]) int8 with scale [N] (or [E, N]); returns N."""
    require(w, name, torch.int8)
    lead = () if E is None else (E,)
    if w.dim() != len(lead) + 2 or tuple(w.shape[:-1]) != lead + (K,):
        want = ", ".join(str(d) for d in lead + (K,))
        raise ValueError(f"{name}: shape {tuple(w.shape)}, expected "
                         f"[{want}, N]")
    N = w.shape[-1]
    if N % 4:
        raise ValueError(f"{name}: N={N} must be a multiple of 4")
    if w.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")
    require(w_scale, f"{name}_scale", torch.float32, lead + (N,))
    return N


# The requant epilogue's row maxima and row-band arrival counters, one
# pair per device: zeros that every quantize_out launch leaves zeroed.
_REQUANT_WS: dict[torch.device, torch.Tensor] = {}


def _requant_workspace(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 words on ``device``, kept across
    launches.  Grown outside CUDA-graph capture only: memory allocated
    during a capture belongs to the graph."""
    ws = _REQUANT_WS.get(device)
    if ws is None or ws.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quantize_out: the requant workspace must be "
                               "grown before CUDA-graph capture; launch once "
                               "outside the capture first")
        size = max(n, 1 << 16, 0 if ws is None else 2 * ws.numel())
        ws = torch.zeros(size, dtype=torch.int32, device=device)
        _REQUANT_WS[device] = ws
    return ws


# ---------------------------------------------------------------------------
# Launch plan of the tensor-core GEMM (kernels 2, 3, 4 and 6; 7 and 8)
# ---------------------------------------------------------------------------
SMS = 132              # streaming multiprocessors of an H100
MAX_SMEM = 232448      # dynamic shared memory a block may use on sm_90
CLUSTERS = (1, 2, 3, 4, 5, 6, 7, 8)   # 8: the portable maximum
# rows the decode tile takes (two n-tiles of 8); more take the prefill
# tile
DECODE_MAX_M = 16
# decode: columns of a tile, K rows a step, stages of the cp.async ring
DEC_BN, DEC_BK, DEC_STAGES = 64, 128, 4
# prefill: rows of a tile, weight bytes of a stage row (the output columns
# of a tile, half of them with the gated pair), K rows a step, stages
PRE_BM, PRE_BN, PRE_BK, PRE_STAGES = 128, 128, 64, 4
# a prefill rank keeps at least this many K steps (of 64 rows)
PRE_MIN_STEPS = 4
# the rule's largest cluster: clusters of 8 timed slower than clusters of
# 5 to 7 at every decode shape swept and than 6 at the prefill ones
# (``chip_smoke.py``'s forced-plan ``[times]`` lines; PERF.md)
RULE_MAX_CLUSTER = 6
_TAIL = 128 * 4 + 128 * 4 + 16   # row maxima, row scales, flag
_KINDS = ("decode", "prefill")
# the body's variants (``Var`` in the source): int8 x (kernels 3 and 6),
# int8 x with the gated pair of weights (kernel 4), f32 or bf16 x
# quantized in the kernel (kernel 2)
VARIANTS = ("int8", "gated", "qin_f32", "qin_bf16")
# bytes of an x element of each variant
_X_BYTES = {"int8": 1, "gated": 1, "qin_f32": 4, "qin_bf16": 2}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    kind: str     # "decode": W^T as the tensor cores' A side; "prefill"
    bm: int       # rows of a tile: 8 or 16 (decode), 128 (prefill)
    bn: int       # output columns of a tile
    bk: int       # K rows of one step of the cp.async ring
    cluster: int  # blocks of a cluster, splitting the K steps
    smem: int     # dynamic shared-memory bytes of a block
    variant: str = "int8"   # one of VARIANTS

    @property
    def shape(self) -> int:
        """The kernel's code of the tile shape (``Shape`` in the source)."""
        return 2 if self.kind == "prefill" else self.bm // 8 - 1

    @property
    def var(self) -> int:
        """The kernel's code of the variant (``Var`` in the source)."""
        return VARIANTS.index(self.variant)

    def grid(self, M: int, N: int) -> int:
        """Blocks of the launch."""
        rows = -(-M // self.bm) if self.kind == "prefill" else 1
        return rows * -(-N // self.bn) * self.cluster


def k_steps(K: int, bk: int, cluster: int) -> tuple[int, int]:
    """(K steps of ``bk`` rows, the most steps a rank takes): rank r
    takes steps [r steps // C, (r + 1) steps // C), a whole number; the
    last step is ragged (masked) when bk does not divide K."""
    steps = -(-K // bk)
    return steps, -(-steps // cluster)


def smem_bytes(kind: str, bm: int, K: int, cluster: int,
               variant: str = "int8") -> int:
    """Dynamic shared memory of one block, as the kernel lays it out
    (``i8_layout`` in ``csrc/cim_gemm.cu``, whose
    ``cim_gemm_i8_smem_bytes`` a card test holds this against).  Decode:
    the stage ring (DEC_BK x DEC_BN bytes a stage and weight) and the
    rank's x slice (bm rows of its K extent, padded by 16 bytes).
    Prefill: the ring of x (its f32 or bf16 values with quantize-in) and
    w stages, then with quantize-in the int8 x tile of the step, or with
    a cluster the int32 partial tile merged by rank 0, whichever is
    larger."""
    nw = 2 if variant == "gated" else 1
    if kind == "prefill":
        ring = PRE_STAGES * (PRE_BM * PRE_BK * _X_BYTES[variant]
                             + PRE_BK * PRE_BN)
        body = ring + (PRE_BM * PRE_BK if variant.startswith("qin") else 0)
        part = PRE_BM * (PRE_BN + 4) * 4 if cluster > 1 else 0
        return max(body, part) + _TAIL
    _, spr = k_steps(K, DEC_BK, cluster)
    return (DEC_STAGES * DEC_BK * DEC_BN * nw + bm * (spr * DEC_BK + 16)
            + _TAIL)


def _plan_of(kind: str, cluster: int, M: int, K: int,
             variant: str = "int8") -> GemmPlan:
    if kind == "decode":
        bm = 8 if M <= 8 else 16
        return GemmPlan(kind, bm, DEC_BN, DEC_BK, cluster,
                        smem_bytes(kind, bm, K, cluster, variant), variant)
    bn = PRE_BN // 2 if variant == "gated" else PRE_BN
    return GemmPlan(kind, PRE_BM, bn, PRE_BK, cluster,
                    smem_bytes(kind, PRE_BM, K, cluster, variant), variant)


def _refusal(plan: GemmPlan, M: int, K: int) -> str | None:
    """Why the kernel cannot take ``plan`` at (M, K), or None."""
    if plan.kind == "decode" and M > DECODE_MAX_M:
        return f"the decode tile takes at most {DECODE_MAX_M} rows, not {M}"
    if plan.cluster not in CLUSTERS:
        return f"cluster {plan.cluster} not in {CLUSTERS}"
    steps, _ = k_steps(K, plan.bk, plan.cluster)
    if plan.cluster > steps:
        return (f"a cluster of {plan.cluster} leaves a rank without a K "
                f"step ({steps} steps of {plan.bk})")
    if plan.smem > MAX_SMEM:
        return f"{plan.smem} bytes of shared memory, over {MAX_SMEM}"
    return None


def _cluster_rule(kind: str, M: int, K: int, N: int, variant: str,
                  experts: int = 1) -> int:
    """The fewest blocks per cluster that give each SM (``SMS``) a weight
    stream (a block of the gated pair streams two; the grouped GEMM has
    ``experts`` times the blocks), at most ``RULE_MAX_CLUSTER``, while
    every rank keeps a K step (``PRE_MIN_STEPS`` of them on the prefill
    tile); more if the decode tile's x slice needs it to fit."""
    one = _plan_of(kind, 1, M, K, variant)
    least = 1 if kind == "decode" else PRE_MIN_STEPS
    streams = 2 if variant == "gated" else 1
    steps = -(-K // one.bk)
    blocks = one.grid(M, N) * streams * experts
    c = max(1, min(-(-SMS // blocks), RULE_MAX_CLUSTER, steps // least))
    while c < CLUSTERS[-1] and _plan_of(kind, c, M, K, variant).smem \
            > MAX_SMEM:
        c += 1
    return c


_FORCED: dict = {}


@contextlib.contextmanager
def forced_gemm_plan(kind: str | None = None, cluster: int | None = None):
    """Force the tile shape and/or the cluster size of the plan for the
    GEMMs launched inside the block (tests and timings of every plan);
    a forced plan the kernel cannot take raises in :func:`gemm_plan`."""
    if kind is not None and kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}")
    saved = dict(_FORCED)
    _FORCED.update({k: v for k, v in (("kind", kind), ("cluster", cluster))
                    if v is not None})
    try:
        yield
    finally:
        _FORCED.clear()
        _FORCED.update(saved)


def _planned(M: int, K: int, N: int, variant: str, experts: int) -> GemmPlan:
    kind = _FORCED.get("kind")
    if kind is None:
        kind = "decode" if M <= DECODE_MAX_M and _plan_of(
            "decode", CLUSTERS[-1], M, K, variant).smem <= MAX_SMEM \
            else "prefill"
    cluster = _FORCED.get("cluster") or _cluster_rule(kind, M, K, N, variant,
                                                      experts)
    plan = _plan_of(kind, cluster, M, K, variant)
    why = _refusal(plan, M, K)
    if why is not None:
        raise ValueError(f"GEMM plan {plan.kind} x{plan.cluster} at M={M} "
                         f"K={K} N={N} ({variant}, E={experts}): {why}")
    return plan


def gemm_plan(M: int, K: int, N: int, variant: str = "int8") -> GemmPlan:
    """The launch plan of ``x [M, K] @ w [K, N]`` on the tensor-core
    GEMM, a function of (M, K, N) and the body's variant alone: the
    decode tile up to ``DECODE_MAX_M`` rows (while its x slice fits),
    else the prefill tile; the cluster size from :func:`_cluster_rule`.
    Raises if a forced plan cannot be taken."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    return _planned(M, K, N, variant, 1)


# the grid's z extent: the grouped GEMM's experts
MAX_EXPERTS = 65535


def grouped_plan(E: int, M: int, K: int, N: int,
                 variant: str = "gated") -> GemmPlan:
    """The launch plan of a grouped GEMM over E experts of ``x [M, K] @
    w [K, N]`` each: ``variant`` "gated" for kernel 8 (the gate and up
    weights), "int8" for kernel 7 (one weight).  The body's tile rule
    (:func:`gemm_plan`), and a cluster rule that counts the blocks of all
    E experts, since a function of the shapes alone cannot see which
    experts hold tokens (at qwen2-moe's E 60: cluster 1 for both).  The
    launch has ``plan.grid(M, N) * E`` blocks.  Raises if E is out of
    range, the variant is not a grouped one or a forced plan cannot be
    taken."""
    if variant not in ("int8", "gated"):
        raise ValueError("a grouped GEMM's variant is 'int8' or 'gated'")
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"E={E} experts: the grid takes 1 to {MAX_EXPERTS}")
    return _planned(M, K, N, variant, E)


def gemm_plans(M: int, K: int, N: int,
               variant: str = "int8") -> list[GemmPlan]:
    """Every plan the kernel can take at (M, K, N) for ``variant``."""
    plans = [_plan_of(kind, c, M, K, variant) for kind in _KINDS
             for c in CLUSTERS]
    return [p for p in plans if _refusal(p, M, K) is None]


def _gemm_i8(what, x, x_scale, w, w_scale, w2=None, w2_scale=None,
             bias=None, residual=None, activation=None, quantize_out=False,
             acc=False, gate=None, out=None):
    """Launch the tensor-core GEMM on x [M, K] (int8, or f32/bf16 to be
    quantized in the kernel) and w [K, N] int8 (with w2, the gated pair),
    checked by the caller, under :func:`gemm_plan`; returns f32 [M, N],
    (q int8 [M, N], scale f32 [M, 1]) or, with ``acc``, int32 [M, N].
    ``gate`` launches the degraded fallback (f32 out, or int32 with
    ``acc``), into ``out`` when given."""
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    if x.dtype == torch.int8:
        variant = "int8" if w2 is None else "gated"
    else:
        variant = "qin_f32" if x.dtype == torch.float32 else "qin_bf16"
    plan = gemm_plan(M, K, N, variant)
    rc = _residual_code(residual, M, N)
    if out is None:
        out = torch.empty((M, N), dtype=torch.int32 if acc else torch.float32,
                          device=dev)
    q = qs = amax = arrive = None
    if quantize_out:
        q = torch.empty((M, N), dtype=torch.int8, device=dev)
        qs = torch.empty((M, 1), dtype=torch.float32, device=dev)
        bands = -(-M // plan.bm)
        ws = _requant_workspace(dev, M + bands)
        amax, arrive = ws[:M], ws[M:M + bands]
    lib, entry = ((_LIB, "cim_gemm_i8_launch") if gate is None else
                  (_FALLBACK_LIB, "cim_gemm_i8_launch_fallback"))
    fn = bind(lib, entry, _I8_ARGS)
    check(lib, fn(ptr(x), ptr(x_scale), ptr(w), ptr(w_scale), ptr(w2),
                  ptr(w2_scale), ptr(bias), ptr(residual), rc,
                  ACTIVATIONS[activation], int(acc), ptr(out), ptr(q),
                  ptr(qs), ptr(amax), ptr(arrive), M, K, N, plan.var,
                  plan.shape, plan.cluster, plan.smem, ptr(gate),
                  stream(x)), what)
    return (q, qs) if quantize_out else out


def _grouped_i8(what, x, x_scale, w, w_scale, w2=None, w2_scale=None,
                bias=None, counts=None, activation=None, quantize_out=False,
                gate=None, out=None):
    """Launch the grouped body on x [E, M, K] int8 and w [E, K, N] (with
    w2, the gated pair: kernel 8; else kernel 7), checked by the caller,
    under :func:`grouped_plan`; returns f32 [E, M, N] or (q int8
    [E, M, N], scale f32 [E, M, 1])."""
    E, M, K = x.shape
    N = w.shape[-1]
    dev = x.device
    plan = grouped_plan(E, M, K, N, "int8" if w2 is None else "gated")
    if out is None:
        out = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    q = qs = amax = arrive = None
    if quantize_out:
        q = torch.empty((E, M, N), dtype=torch.int8, device=dev)
        qs = torch.empty((E, M, 1), dtype=torch.float32, device=dev)
        bands = E * -(-M // plan.bm)
        ws = _requant_workspace(dev, E * M + bands)
        amax, arrive = ws[:E * M], ws[E * M:E * M + bands]
    lib, entry = ((_LIB, "cim_grouped_i8_launch") if gate is None else
                  (_FALLBACK_LIB, "cim_grouped_i8_launch_fallback"))
    fn = bind(lib, entry, _GROUPED_I8_ARGS)
    check(lib, fn(ptr(x), ptr(x_scale), ptr(w), ptr(w_scale), ptr(w2),
                  ptr(w2_scale), ptr(bias), ptr(counts),
                  ACTIVATIONS[activation], ptr(out), ptr(q), ptr(qs),
                  ptr(amax), ptr(arrive), E, M, K, N, plan.var, plan.shape,
                  plan.cluster, plan.smem, ptr(gate), stream(x)), what)
    return (q, qs) if quantize_out else out


def kernel_smem_bytes(plan: GemmPlan, K: int) -> int:
    """The kernel's own count of :func:`smem_bytes`
    (``cim_gemm_i8_smem_bytes``); needs the built library."""
    fn = bind(_LIB, "cim_gemm_i8_smem_bytes", [I, I, I, I])
    return fn(plan.shape, plan.var, K, plan.cluster)


def _check_counts(counts, E):
    if counts is not None:
        require(counts, "counts", torch.int32, (E,))


# ---------------------------------------------------------------------------
# Launch plan of the row quantizer (kernel 1)
# ---------------------------------------------------------------------------
RQ_UNITS = 8              # units a thread holds at a time (RQ_V)
RQ_MAX_THREADS = 1024     # threads of a block (RQ_MAX_NT)
# threads a row takes unless it needs more to stay in registers
RQ_THREADS = 512
_X_ITEM = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class RowQuantPlan:
    threads: int   # threads of the block that takes a row
    vec: bool      # 16-byte units; else one value a unit
    units: int     # units of a row

    @property
    def chunks(self) -> int:
        """Passes of RQ_UNITS units a thread makes over its row: at 1 x is
        read once; at more, all but the last chunk twice."""
        return max(1, -(-self.units // (self.threads * RQ_UNITS)))


_FORCED_RQ: dict = {}


@contextlib.contextmanager
def forced_rowquant_plan(threads: int):
    """Force the threads of the row quantizer's block inside the block
    (tests and timings of other plans)."""
    if threads % 32 or not 32 <= threads <= RQ_MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 from 32 to "
                         f"{RQ_MAX_THREADS}")
    saved = dict(_FORCED_RQ)
    _FORCED_RQ["threads"] = threads
    try:
        yield
    finally:
        _FORCED_RQ.clear()
        _FORCED_RQ.update(saved)


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def rowquant_plan(M: int, K: int, dtype: torch.dtype,
                  aligned: bool = True) -> RowQuantPlan:
    """The launch plan of the row quantizer on x [M, K] of ``dtype``
    (float32 or bfloat16), a function of its arguments alone
    (``aligned``: x's first byte is 16-byte aligned).  Rows whose bytes
    divide into 16 (and are aligned) take 16-byte units, else single
    values.  A row takes one block with the fewest threads (whole warps,
    a power of two, at most RQ_THREADS unless the row needs more to stay
    in registers, RQ_UNITS units a thread) that give each two units when
    the rows are fewer than 4 SMS, four when they are more."""
    if dtype not in _X_ITEM:
        raise ValueError(f"dtype must be one of {tuple(_X_ITEM)}")
    if M < 1 or K < 1:
        raise ValueError(f"x [{M}, {K}] is empty")
    xb = _X_ITEM[dtype]
    vec = aligned and K * xb % 16 == 0
    units = K * xb // 16 if vec else K
    threads = _FORCED_RQ.get("threads")
    if threads is None:
        lane = 2 if M < 4 * SMS else 4
        threads = min(RQ_THREADS,
                      max(32, _pow2_at_least(-(-units // lane))))
        if threads * RQ_UNITS < units:
            threads = min(RQ_MAX_THREADS,
                          _pow2_at_least(-(-units // RQ_UNITS)))
    return RowQuantPlan(threads, vec, units)


# ---------------------------------------------------------------------------
# Row quantizer (kernel 1)
# ---------------------------------------------------------------------------
def quantize_rows_int8_plain(x, gate=None, out=None):
    if gate is None:
        return ref.quantize_rows_int8_ref(x)
    return _gated_out(gate, out, ref.quantize_rows_int8_ref(_san(x)))


def quantize_rows_int8(x: torch.Tensor, gate: torch.Tensor | None = None,
                       out: tuple | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: x [M, K] f32/bf16 ->
    (q int8 [M, K], scale f32 [M, 1]), in one launch under
    :func:`rowquant_plan`.  ``gate`` (the screen's flag) makes it the
    degraded fallback: nothing is written when the flag is 0, else the
    rows of ``nan_to_num(x)``, into ``out`` ((q, scale)) when given."""
    _out_needs_gate(gate, out)
    if on_cpu(x, gate, *(out or ())):
        return quantize_rows_int8_plain(x, gate, out)
    require(x, "x", _FLOAT)
    M, K = x.shape
    if gate is not None:
        require(gate, "gate", torch.int32, (1,))
        if out is not None:
            require(out[0], "out q", torch.int8, (M, K))
            require(out[1], "out scale", torch.float32, (M, 1))
    plan = rowquant_plan(M, K, x.dtype, x.data_ptr() % 16 == 0)
    if gate is not None and out is not None:
        q, s = out
    else:
        q = torch.empty((M, K), dtype=torch.int8, device=x.device)
        s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    lib, entry = ((_LIB, "cim_quantize_rows_int8") if gate is None else
                  (_FALLBACK_LIB, "cim_quantize_rows_int8_fallback"))
    fn = bind(lib, entry, _ROWQUANT_ARGS)
    check(lib, fn(ptr(x), DTYPE_CODE[x.dtype], ptr(q), ptr(s), M, K,
                  plan.threads, int(plan.vec), ptr(gate), stream(x)),
          "quantize_rows_int8")
    quantize_rows_int8.launches += 1
    return q, s


quantize_rows_int8.launches = 0


# ---------------------------------------------------------------------------
# INT8 GEMM to int32, no epilogue (kernel 6)
# ---------------------------------------------------------------------------
def cim_gemm_int8_plain(x_q, w, gate=None, out=None):
    res = ref.cim_gemm_int8_ref(x_q, w)
    return res if gate is None else _gated_out(gate, out, res)


def cim_gemm_int8(x_q: torch.Tensor, w: torch.Tensor,
                  gate: torch.Tensor | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Exact int8 GEMM: x_q [M, K] int8 @ w [K, N] int8 -> int32 [M, N],
    with no scale and no epilogue: the row-parallel partial accumulator
    of tensor parallelism, summed over the ranks before the one
    dequant/residual epilogue.  ``gate`` (the screen's flag): the
    degraded fallback of a row-parallel site, whose ranks sum the
    partials of their sanitized inputs: nothing is written when the flag
    is 0, else the same exact sum, into ``out`` (int32 [M, N]) when
    given."""
    _out_needs_gate(gate, out)
    if on_cpu(x_q, w, gate, out):
        return cim_gemm_int8_plain(x_q, w, gate, out)
    require(x_q, "x_q", torch.int8)
    M, K = x_q.shape
    require(w, "w", torch.int8)
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w: shape {tuple(w.shape)}, expected [{K}, N]")
    N = w.shape[1]
    if N % 4 or w.data_ptr() % 4:
        raise ValueError(f"w: N={N} must be a multiple of 4 and w 4-byte "
                         f"aligned")
    if gate is not None:
        require(gate, "gate", torch.int32, (1,))
        if out is not None:
            require(out, "out", torch.int32, (M, N))
    out = _gemm_i8("cim_gemm_int8", x_q, None, w, None, acc=True, gate=gate,
                   out=out)
    cim_gemm_int8.launches += 1
    if gate is not None:
        cim_gemm_int8.gated_launches += 1
    return out


cim_gemm_int8.launches = 0
# the gated form's launches alone (each is counted in ``launches`` too)
cim_gemm_int8.gated_launches = 0


# ---------------------------------------------------------------------------
# Quantize-in GEMM (kernel 2)
# ---------------------------------------------------------------------------
def cim_gemm_int8_fused_qin_plain(x, w, w_scale, bias=None, residual=None,
                                  activation=None, gate=None, out=None):
    if gate is not None:
        x, w_scale, bias, residual = map(_san, (x, w_scale, bias, residual))
    res = ref.fused_matmul_ref(x, w, w_scale, bias=bias, residual=residual,
                               activation=activation)
    return res if gate is None else _gated_out(gate, out, res)


def cim_gemm_int8_fused_qin(x: torch.Tensor, w: torch.Tensor,
                            w_scale: torch.Tensor,
                            bias: torch.Tensor | None = None,
                            residual: torch.Tensor | None = None,
                            activation: str | None = None,
                            gate: torch.Tensor | None = None,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """Quantized linear as one launch: x [M, K] f32/bf16 is row-quantized
    inside the kernel, multiplied by w [K, N] int8 and rescaled by
    ``w_scale [N]`` (+ bias [N]) (+ activation) (+ residual [M, N])
    -> f32 [M, N].  ``gate``: the degraded fallback, into ``out`` (f32
    [M, N]) when given."""
    _out_needs_gate(gate, out)
    if on_cpu(x, w, w_scale, bias, residual, gate, out):
        return cim_gemm_int8_fused_qin_plain(x, w, w_scale, bias, residual,
                                             activation, gate, out)
    require(x, "x", _FLOAT)
    M, K = x.shape
    N = _check_weight(w, w_scale, K)
    if bias is not None:
        require(bias, "bias", torch.float32, (N,))
    if gate is not None:
        _check_gate(gate, out, (M, N))
    out = _gemm_i8("cim_gemm_int8_fused_qin", x, None, w, w_scale,
                   bias=bias, residual=residual, activation=activation,
                   gate=gate, out=out)
    cim_gemm_int8_fused_qin.launches += 1
    return out


cim_gemm_int8_fused_qin.launches = 0


# ---------------------------------------------------------------------------
# Pre-quantized GEMM (kernel 3)
# ---------------------------------------------------------------------------
def cim_gemm_int8_fused_plain(x_q, w, x_scale, w_scale, bias=None,
                              residual=None, activation=None, gate=None,
                              out=None):
    if gate is not None:
        x_scale, w_scale, bias, residual = map(
            _san, (x_scale, w_scale, bias, residual))
    res = _epilogue_plain(ref.cim_gemm_int8_ref(x_q, w), x_scale, w_scale,
                          bias, residual, activation)
    return res if gate is None else _gated_out(gate, out, res)


def cim_gemm_int8_fused(x_q: torch.Tensor, w: torch.Tensor,
                        x_scale: torch.Tensor, w_scale: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        activation: str | None = None,
                        quantize_out: bool = False,
                        gate: torch.Tensor | None = None,
                        out: torch.Tensor | None = None):
    """INT8 GEMM with the fused dequant/bias/activation/residual epilogue:
    x_q [M, K] int8 @ w [K, N] int8, rescaled by ``x_scale [M, 1]`` and
    ``w_scale [N]`` -> f32 [M, N]; with ``quantize_out`` -> (q int8
    [M, N], scale f32 [M, 1]) for the next GEMM, in the same launch.
    ``gate``: the degraded fallback (no ``quantize_out``), into ``out``
    (f32 [M, N]) when given."""
    _out_needs_gate(gate, out)
    if quantize_out and residual is not None:
        raise ValueError("residual is for the block output, not a "
                         "requantized hidden state")
    if quantize_out and gate is not None:
        raise ValueError("the degraded fallback requantizes with the gated "
                         "row quantizer, not in the epilogue")
    if on_cpu(x_q, w, x_scale, w_scale, bias, residual, gate, out):
        res = cim_gemm_int8_fused_plain(x_q, w, x_scale, w_scale, bias,
                                        residual, activation, gate, out)
        return quantize_rows_int8_plain(res) if quantize_out else res
    require(x_q, "x_q", torch.int8)
    M, K = x_q.shape
    require(x_scale, "x_scale", torch.float32, (M, 1))
    N = _check_weight(w, w_scale, K)
    if bias is not None:
        require(bias, "bias", torch.float32, (N,))
    if gate is not None:
        _check_gate(gate, out, (M, N))
    out = _gemm_i8("cim_gemm_int8_fused", x_q, x_scale, w, w_scale,
                   bias=bias, residual=residual, activation=activation,
                   quantize_out=quantize_out, gate=gate, out=out)
    cim_gemm_int8_fused.launches += 1
    return out


cim_gemm_int8_fused.launches = 0


# ---------------------------------------------------------------------------
# Gated GEMM (kernel 4)
# ---------------------------------------------------------------------------
def cim_gated_gemm_int8_plain(x_q, w_gate, w_up, x_scale, gate_scale,
                              up_scale, activation="gelu", gate=None,
                              out=None):
    if gate is not None:
        x_scale, gate_scale, up_scale = map(_san, (x_scale, gate_scale,
                                                   up_scale))
    g = ref.cim_gemm_int8_ref(x_q, w_gate).float() * x_scale \
        * gate_scale.unsqueeze(-2)
    u = ref.cim_gemm_int8_ref(x_q, w_up).float() * x_scale \
        * up_scale.unsqueeze(-2)
    res = ref.activate_ref(g, activation) * u
    return res if gate is None else _gated_out(gate, out, res)


def cim_gated_gemm_int8(x_q: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, x_scale: torch.Tensor,
                        gate_scale: torch.Tensor, up_scale: torch.Tensor,
                        activation: str = "gelu",
                        quantize_out: bool = False,
                        gate: torch.Tensor | None = None,
                        out: torch.Tensor | None = None):
    """Gated MLP front half ``act(x@Wg) * (x@Wu)`` in one launch: both
    int32 accumulators share one x stream -> f32 [M, N], or with
    ``quantize_out`` (q int8 [M, N], scale f32 [M, 1]).  ``gate``: the
    degraded fallback (no ``quantize_out``), into ``out`` when given."""
    _out_needs_gate(gate, out)
    if quantize_out and gate is not None:
        raise ValueError("the degraded fallback requantizes with the gated "
                         "row quantizer, not in the epilogue")
    if on_cpu(x_q, w_gate, w_up, x_scale, gate_scale, up_scale, gate, out):
        h = cim_gated_gemm_int8_plain(x_q, w_gate, w_up, x_scale,
                                      gate_scale, up_scale, activation, gate,
                                      out)
        return quantize_rows_int8_plain(h) if quantize_out else h
    require(x_q, "x_q", torch.int8)
    M, K = x_q.shape
    require(x_scale, "x_scale", torch.float32, (M, 1))
    N = _check_weight(w_gate, gate_scale, K, "w_gate")
    if _check_weight(w_up, up_scale, K, "w_up") != N:
        raise ValueError("gate and up widths differ")
    if gate is not None:
        _check_gate(gate, out, (M, N))
    out = _gemm_i8("cim_gated_gemm_int8", x_q, x_scale, w_gate, gate_scale,
                   w_up, up_scale, activation=activation,
                   quantize_out=quantize_out, gate=gate, out=out)
    cim_gated_gemm_int8.launches += 1
    return out


cim_gated_gemm_int8.launches = 0


# ---------------------------------------------------------------------------
# Grouped-expert GEMM (kernel 7)
# ---------------------------------------------------------------------------
def cim_grouped_gemm_int8_plain(x_q, w, x_scale, w_scale, bias=None,
                                counts=None, activation=None, gate=None,
                                out=None):
    if gate is not None:
        x_scale, w_scale, bias = map(_san, (x_scale, w_scale, bias))
    acc = _skip_plain(ref.cim_gemm_int8_ref(x_q, w), counts)
    res = _epilogue_plain(acc, x_scale, w_scale, bias, None, activation)
    return res if gate is None else _gated_out(gate, out, res)


def cim_grouped_gemm_int8(x: torch.Tensor, w: torch.Tensor,
                          x_scale: torch.Tensor, w_scale: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          counts: torch.Tensor | None = None,
                          activation: str | None = None,
                          quantize_out: bool = False,
                          gate: torch.Tensor | None = None,
                          out: torch.Tensor | None = None):
    """All experts' INT8 GEMMs in one launch on the int8 tensor-core body
    under :func:`grouped_plan`: per expert e, x [E, M, K] int8 @ w [E, K,
    N] int8, rescaled by ``x_scale [E, M, 1]`` and ``w_scale [E, N]`` (+
    bias [E, N]) (+ activation) -> f32 [E, M, N]; with ``quantize_out``
    -> (q int8 [E, M, N], scale f32 [E, M, 1]).  ``counts`` (int32 [E])
    is the skip list: an expert whose count is 0 streams no weights and
    gets the epilogue of zero accumulators (act(bias) with a bias).
    ``gate``: the degraded fallback (no ``quantize_out``), into ``out``
    (f32 [E, M, N]) when given."""
    _out_needs_gate(gate, out)
    if quantize_out and gate is not None:
        raise ValueError("the degraded fallback requantizes with the gated "
                         "row quantizer, not in the epilogue")
    if on_cpu(x, w, x_scale, w_scale, bias, counts, gate, out):
        res = cim_grouped_gemm_int8_plain(x, w, x_scale, w_scale, bias,
                                          counts, activation, gate, out)
        return quantize_rows_int8_plain(res) if quantize_out else res
    require(x, "x", torch.int8)
    E, M, K = x.shape
    require(x_scale, "x_scale", torch.float32, (E, M, 1))
    N = _check_weight(w, w_scale, K, E=E)
    if bias is not None:
        require(bias, "bias", torch.float32, (E, N))
    _check_counts(counts, E)
    if gate is not None:
        _check_gate(gate, out, (E, M, w.shape[-1]))
    out = _grouped_i8("cim_grouped_gemm_int8", x, x_scale, w, w_scale,
                      bias=bias, counts=counts, activation=activation,
                      quantize_out=quantize_out, gate=gate, out=out)
    cim_grouped_gemm_int8.launches += 1
    return out


cim_grouped_gemm_int8.launches = 0


# ---------------------------------------------------------------------------
# Grouped-expert gated GEMM (kernel 8)
# ---------------------------------------------------------------------------
def cim_grouped_gated_gemm_int8_plain(x, w_gate, w_up, x_scale, gate_scale,
                                      up_scale, counts=None,
                                      activation="gelu", gate=None,
                                      out=None):
    if gate is not None:
        x_scale, gate_scale, up_scale = map(_san, (x_scale, gate_scale,
                                                   up_scale))
    g = _skip_plain(ref.cim_gemm_int8_ref(x, w_gate), counts).float() \
        * x_scale * gate_scale.unsqueeze(-2)
    u = _skip_plain(ref.cim_gemm_int8_ref(x, w_up), counts).float() \
        * x_scale * up_scale.unsqueeze(-2)
    res = ref.activate_ref(g, activation) * u
    return res if gate is None else _gated_out(gate, out, res)


def cim_grouped_gated_gemm_int8(x: torch.Tensor, w_gate: torch.Tensor,
                                w_up: torch.Tensor, x_scale: torch.Tensor,
                                gate_scale: torch.Tensor,
                                up_scale: torch.Tensor,
                                counts: torch.Tensor | None = None,
                                activation: str = "gelu",
                                quantize_out: bool = False,
                                gate: torch.Tensor | None = None,
                                out: torch.Tensor | None = None):
    """All experts' gated front halves ``act(x@Wg) * (x@Wu)`` in one
    launch on the gated tensor-core body under :func:`grouped_plan`: x
    [E, M, K] int8, w_gate/w_up [E, K, N] int8, scales ``x_scale [E, M,
    1]``, ``gate_scale``/``up_scale [E, N]`` -> f32 [E, M, N], or with
    ``quantize_out`` (q int8 [E, M, N], scale f32 [E, M, 1]) for the
    grouped down GEMM.  ``counts`` as in :func:`cim_grouped_gemm_int8`:
    an idle expert's tiles store the zero accumulators' output and
    stream nothing.  ``gate``: the degraded fallback (no
    ``quantize_out``), into ``out`` when given."""
    _out_needs_gate(gate, out)
    if quantize_out and gate is not None:
        raise ValueError("the degraded fallback requantizes with the gated "
                         "row quantizer, not in the epilogue")
    if on_cpu(x, w_gate, w_up, x_scale, gate_scale, up_scale, counts, gate,
              out):
        h = cim_grouped_gated_gemm_int8_plain(x, w_gate, w_up, x_scale,
                                              gate_scale, up_scale, counts,
                                              activation, gate, out)
        return quantize_rows_int8_plain(h) if quantize_out else h
    require(x, "x", torch.int8)
    E, M, K = x.shape
    require(x_scale, "x_scale", torch.float32, (E, M, 1))
    N = _check_weight(w_gate, gate_scale, K, "w_gate", E=E)
    if _check_weight(w_up, up_scale, K, "w_up", E=E) != N:
        raise ValueError("gate and up widths differ")
    _check_counts(counts, E)
    if gate is not None:
        _check_gate(gate, out, (E, M, N))
    out = _grouped_i8("cim_grouped_gated_gemm_int8", x, x_scale, w_gate,
                      gate_scale, w_up, up_scale, counts=counts,
                      activation=activation, quantize_out=quantize_out,
                      gate=gate, out=out)
    cim_grouped_gated_gemm_int8.launches += 1
    return out


cim_grouped_gated_gemm_int8.launches = 0


# ---------------------------------------------------------------------------
# The degraded mode's finite screen
# ---------------------------------------------------------------------------
# Per device: the screen's scratch words (zero between launches) and, in
# word 2, the count of screens that tripped.
_SCREEN_WS: dict[torch.device, torch.Tensor] = {}


def _screen_workspace(device) -> torch.Tensor:
    """The screen's 4 int32 words on ``device`` (``"cuda"`` is the current
    card), made zero at first use, outside CUDA-graph capture (memory
    allocated inside a capture belongs to the graph)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ws = _SCREEN_WS.get(device)
    if ws is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("finite_screen: launch once outside CUDA-graph "
                               "capture first (its workspace is made then)")
        ws = torch.zeros(4, dtype=torch.int32, device=device)
        _SCREEN_WS[device] = ws
    return ws


def screen_trips(device) -> int:
    """How many screens on ``device`` tripped so far (a host read: call
    it after a run)."""
    return int(_screen_workspace(device)[2])


def finite_screen_plain(x):
    flag = torch.isfinite(x).all().logical_not().to(torch.int32).reshape(1)
    _screen_workspace(x.device)[2] += flag[0]
    return flag


def finite_screen(x: torch.Tensor) -> torch.Tensor:
    """The degraded mode's screen: x (f32, any shape, contiguous, not
    empty) -> flag int32 [1] on x's device, 1 when x holds a NaN or an
    inf, else 0, in one launch with no host sync; a tripped screen adds
    one to :func:`screen_trips`."""
    if on_cpu(x):
        return finite_screen_plain(x)
    require(x, "x", torch.float32)
    if x.numel() < 1:
        raise ValueError("finite_screen: x is empty")
    ws = _screen_workspace(x.device)
    flag = torch.empty(1, dtype=torch.int32, device=x.device)
    fn = bind(_LIB, "cim_finite_screen", _SCREEN_ARGS)
    check(_LIB, fn(ptr(x), x.numel(), ptr(flag), ptr(ws), stream(x)),
          "finite_screen")
    finite_screen.launches += 1
    return flag


finite_screen.launches = 0
