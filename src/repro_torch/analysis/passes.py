"""The audit passes over a recorded model step (port of
``repro/analysis/passes.py``).

Each pass takes facts of one run (:mod:`.record`) plus the expectation
from :mod:`.manifest` and returns a list of :class:`Violation` — empty
means the contract holds.  Passes never raise on a violation (the
callers decide severity).

The reference's ``vmem_audit`` (VMEM footprint and block geometry of
each Pallas call) and ``retrace_audit`` (one jit trace per engine step)
have no counterpart: VMEM is TPU memory — on the card the kernels'
registers and shared memory are pinned by ``tests/test_torch_cuda.py``
— and the port compiles no program per shape (each CUDA source builds
once, ``kernels/_build.py``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from . import manifest

# aten ops that multiply matrices: an int8 or int32 operand of one of
# them, outside the kernel wrappers, is a GEMM off the fused pipeline
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "_int_mm", "baddbmm", "addbmm",
                        "mv", "addmv", "dot", "matmul", "linear",
                        "_scaled_mm"})
_INT_OPERANDS = (torch.int8, torch.int32)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract breach, precise enough to act on: which pass, a
    stable machine-readable code, the launch counter or op it anchors
    to, and a human sentence."""
    pass_name: str     # dispatch | dtype_flow | collective
    code: str
    site: str          # launch counter, "file:line", or collective kind
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Pass 1: dispatch audit
# ---------------------------------------------------------------------------
def classify(launches) -> Counter:
    """Site-class histogram of a step's launches (a mapping launch
    counter -> launches); counters no class covers
    (``manifest.UNCONTRACTED``) are left out, unknown ones are
    ``"unknown"``."""
    out: Counter = Counter()
    for name, n in launches.items():
        if n and name not in manifest.UNCONTRACTED:
            out[manifest.KERNEL_SITES.get(name, "unknown")] += n
    return out


def dispatch_audit(launches, expected: Counter,
                   expected_launches: Counter | None = None) -> list:
    """Every launch belongs to a known counter, and the per-class counts
    match the manifest exactly; with ``expected_launches`` (by counter)
    each counter's count too."""
    out = []
    actual: Counter = Counter()
    for name, n in launches.items():
        if not n or name in manifest.UNCONTRACTED:
            continue
        cls = manifest.KERNEL_SITES.get(name)
        if cls is None:
            out.append(Violation(
                "dispatch", "unknown_kernel", name,
                f"kernel {name!r} is not in the manifest's site-class "
                f"table"))
            continue
        actual[cls] += n
    for cls in sorted(set(expected) | set(actual)):
        if actual.get(cls, 0) != expected.get(cls, 0):
            out.append(Violation(
                "dispatch", "count_mismatch", cls,
                f"site class {cls!r}: {actual.get(cls, 0)} launches, "
                f"manifest expects {expected.get(cls, 0)}"))
    if expected_launches is not None:
        for name in sorted(set(expected_launches) | set(launches)):
            if name in manifest.UNCONTRACTED:
                continue
            a, e = launches.get(name, 0), expected_launches.get(name, 0)
            if a != e:
                out.append(Violation(
                    "dispatch", "launch_mismatch", name,
                    f"{name}: {a} launches, manifest expects {e}"))
    return out


# ---------------------------------------------------------------------------
# Pass 2: dtype-flow audit
# ---------------------------------------------------------------------------
def int8_matmuls(ops) -> list:
    """Matmul-family ops outside the wrappers with an int8 or int32
    operand (the reference's ``int8_xla_dots``)."""
    return [op for op in ops if op.scope == "outside"
            and op.op in MATMUL_OPS
            and any(t.dtype in _INT_OPERANDS for t in op.inputs)]


def int8_dequant_leaks(ops) -> list:
    """Ops outside the wrappers that take an int8 tensor and give a
    floating one: an int8 buffer (a weight, the KV cache) dequantized at
    the torch level."""
    return [op for op in ops if op.scope == "outside"
            and op.op not in MATMUL_OPS
            and any(t.dtype == torch.int8 for t in op.inputs)
            and any(t.dtype.is_floating_point for t in op.outputs)]


def int32_escapes(ops) -> list:
    """(op, kernel) pairs: an op outside the wrappers that reads an int32
    accumulator of an ``acc_gemm`` launch before any collective took it
    (the exact cross-rank sum must come first)."""
    pending: dict[int, str] = {}
    found = []
    for op in ops:
        if op.scope == "kernel" \
                and manifest.KERNEL_SITES.get(op.kernel) == "acc_gemm":
            for t in op.outputs:
                if t.dtype == torch.int32:
                    pending[t.ref] = op.kernel
        elif op.scope == "collective":
            for t in op.inputs:
                pending.pop(t.ref, None)
        elif op.scope == "outside":
            for t in op.inputs:
                if t.ref in pending:
                    found.append((op, pending.pop(t.ref)))
    return found


def dtype_flow_audit(ops, phase: str = "decode", kv_dtypes=None) -> list:
    """No int32 accumulator escapes a kernel without its cross-rank sum,
    no matmul outside the wrappers takes int8 or int32 operands, no int8
    tensor is dequantized outside the wrappers in a decode step, and
    (when ``kv_dtypes`` — (path, dtype) pairs of the step's KV storage —
    is given) KV storage stays int8.

    ``phase="prefill"`` relaxes the dequant rule, as in the reference:
    prefill attention runs outside the kernels and dequantizes the int8
    cache it attends over.
    """
    out = []
    for op, kernel in int32_escapes(ops):
        out.append(Violation(
            "dtype_flow", "int32_escape", op.src,
            f"{op.op} reads the int32 accumulator of {kernel!r} before "
            f"its all_reduce — accumulators are summed across ranks "
            f"before anything reads them"))
    for op in int8_matmuls(ops):
        shapes = [t.shape for t in op.inputs]
        out.append(Violation(
            "dtype_flow", "int8_matmul", op.src,
            f"{op.op} multiplies integer operands {shapes} outside the "
            f"kernel wrappers — a GEMM off the fused pipeline"))
    if phase != "prefill":
        for op in int8_dequant_leaks(ops):
            src = next(t for t in op.inputs if t.dtype == torch.int8)
            dst = next(t for t in op.outputs if t.dtype.is_floating_point)
            out.append(Violation(
                "dtype_flow", "dequant_leak", op.src,
                f"{op.op}: int8 tensor {src.shape} dequantized to "
                f"{dst.dtype} outside the kernels — a quantize->dequantize "
                f"round trip off the pipeline"))
    for path, dtype in (kv_dtypes or ()):
        if dtype != torch.int8:
            out.append(Violation(
                "dtype_flow", "kv_not_int8", path,
                f"KV cache leaf {path} holds {dtype} though the plan "
                f"covers attn_kv — int8 storage contract broken"))
    return out


# ---------------------------------------------------------------------------
# Pass 3: collective audit
# ---------------------------------------------------------------------------
def collective_audit(ops, sharded: bool,
                     expected: Counter | None = None) -> list:
    """An unsharded step makes no collective at all.  A tensor-parallel
    rank's step makes exactly the manifest's collectives by kind, only of
    the allowed kinds, and every SUM adds integers (the exactness
    contract)."""
    out = []
    colls = [op for op in ops if op.op.startswith("collective:")]
    if not sharded:
        for c in colls:
            out.append(Violation(
                "collective", "unexpected_collective", c.op,
                f"{c.op} in an unsharded step"))
        return out
    actual: Counter = Counter()
    for c in colls:
        kind = c.op.split(":", 1)[1]
        actual[kind] += 1
        if kind not in manifest.ALLOWED_COLLECTIVES:
            out.append(Violation(
                "collective", "forbidden_collective", kind,
                f"{kind}: only {sorted(manifest.ALLOWED_COLLECTIVES)} are "
                f"part of the TP contract"))
        if kind == "sum" and any(t.dtype != manifest.SUM_DTYPE
                                 for t in c.inputs):
            out.append(Violation(
                "collective", "sum_not_int", kind,
                f"all_reduce SUM over {[str(t.dtype) for t in c.inputs]} "
                f"— cross-rank accumulator sums must be int32 to stay "
                f"exact"))
    if expected is not None:
        for kind in sorted(set(expected) | set(actual)):
            if actual.get(kind, 0) != expected.get(kind, 0):
                out.append(Violation(
                    "collective", "count_mismatch", kind,
                    f"{kind}: {actual.get(kind, 0)} collectives, manifest "
                    f"expects {expected.get(kind, 0)}"))
    return out
