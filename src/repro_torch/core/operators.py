"""Operator IR for the CIM-TPU simulator (paper §III-C "Workload Evaluations").

A workload is a list of ``Op``s.  Two op classes cover everything the paper
evaluates:

* ``MatMulOp`` — GEMM/GEMV on the MXUs.  ``batch`` independent
  ``M x K @ K x N`` problems; ``weights_shared`` distinguishes
  parameter matmuls (QKV/Proj/FFN: one weight matrix reused by every
  batch element — systolic-friendly) from attention matmuls
  (Q@K^T, S@V: per-(batch, head) "weights" streamed from the KV cache —
  the GEMV-shaped case where the CIM-MXU wins).
* ``VectorOp`` — VPU work (Softmax/LayerNorm/GeLU/residual/...).

Ops carry enough byte-accounting metadata for the mapping engine to place
their tensors in the HBM->CMEM->VMEM hierarchy.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional


class OpKind(enum.Enum):
    QKV = "qkv"
    ATTN_QK = "attn_qk"
    ATTN_SV = "attn_sv"
    PROJ = "proj"
    FFN = "ffn"
    MOE_FFN = "moe_ffn"
    LM_HEAD = "lm_head"
    SSM = "ssm"
    OTHER_MATMUL = "other_matmul"

    SOFTMAX = "softmax"
    LAYERNORM = "layernorm"
    GELU = "gelu"
    SILU = "silu"
    ELEMENTWISE = "elementwise"
    ROPE = "rope"
    CONDITIONING = "conditioning"  # DiT adaLN shift/scale/gate
    SCAN = "scan"                  # recurrent state update (SSM/xLSTM)


MATMUL_KINDS = {
    OpKind.QKV, OpKind.ATTN_QK, OpKind.ATTN_SV, OpKind.PROJ, OpKind.FFN,
    OpKind.MOE_FFN, OpKind.LM_HEAD, OpKind.SSM, OpKind.OTHER_MATMUL,
}

# Buckets used for the paper's breakdown figures (Fig 6).
GEMM_BUCKET = {OpKind.QKV, OpKind.PROJ, OpKind.FFN, OpKind.MOE_FFN,
               OpKind.LM_HEAD, OpKind.SSM, OpKind.OTHER_MATMUL}
ATTENTION_BUCKET = {OpKind.ATTN_QK, OpKind.ATTN_SV, OpKind.SOFTMAX}


@dataclass(frozen=True)
class Op:
    name: str
    kind: OpKind
    layer: str = ""  # human-readable group, e.g. "layer0", for breakdowns

    @property
    def is_matmul(self) -> bool:
        return self.kind in MATMUL_KINDS


@dataclass(frozen=True)
class MatMulOp(Op):
    """``batch`` independent (M, K) @ (K, N) problems.

    weights_shared: True when the same K x N operand serves every batch
      element (model parameters).  False for attention-style matmuls where
      each batch element has its own right-hand operand (KV cache).
    weights_resident: True if the right-hand operand can stay pinned on
      chip across invocations (never for TPU-scale models; exposed for
      small-workload studies).
    act_bits/weight_bits/out_bits: element widths (INT8 = 8, BF16 = 16).
    fused_output: output consumed in-place by the next op (skips HBM
      write-back when the mapping engine keeps it resident).
    """

    M: int = 1
    K: int = 1
    N: int = 1
    batch: int = 1
    weights_shared: bool = True
    weights_resident: bool = False
    act_bits: int = 8
    weight_bits: int = 8
    out_bits: int = 8
    fused_output: bool = False

    # -- byte/flop accounting -------------------------------------------
    @property
    def macs(self) -> int:
        return self.batch * self.M * self.K * self.N

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def input_bytes(self) -> int:
        return self.batch * self.M * self.K * self.act_bits // 8

    @property
    def weight_bytes(self) -> int:
        unique = 1 if self.weights_shared else self.batch
        return unique * self.K * self.N * self.weight_bits // 8

    @property
    def output_bytes(self) -> int:
        return self.batch * self.M * self.N * self.out_bits // 8

    @property
    def total_bytes(self) -> int:
        return self.input_bytes + self.weight_bytes + self.output_bytes

    @property
    def is_gemv(self) -> bool:
        return self.M == 1

    @property
    def arithmetic_intensity(self) -> float:
        return self.macs / max(1, self.total_bytes)

    def scaled(self, **kw) -> "MatMulOp":
        return replace(self, **kw)


@dataclass(frozen=True)
class VectorOp(Op):
    """Elementwise / reduction work executed on the VPU.

    elems: number of output elements processed.
    ops_per_elem: VPU ops per element (resolved against VPUConfig when 0).
    bytes_read/bytes_written: explicit traffic (defaults: elems * width).
    """

    elems: int = 0
    ops_per_elem: float = 0.0
    bits: int = 16
    bytes_read: Optional[int] = None
    bytes_written: Optional[int] = None

    @property
    def io_bytes(self) -> int:
        r = self.bytes_read if self.bytes_read is not None else self.elems * self.bits // 8
        w = self.bytes_written if self.bytes_written is not None else self.elems * self.bits // 8
        return r + w


@dataclass
class Graph:
    """An operator graph with aggregate helpers."""

    name: str
    ops: list[Op] = field(default_factory=list)
    repeat: int = 1  # e.g. number of identical transformer layers

    def add(self, op: Op) -> None:
        self.ops.append(op)

    def extend(self, ops: Iterable[Op]) -> None:
        self.ops.extend(ops)

    @property
    def matmuls(self) -> list[MatMulOp]:
        return [o for o in self.ops if isinstance(o, MatMulOp)]

    @property
    def total_macs(self) -> int:
        return self.repeat * sum(o.macs for o in self.matmuls)

    @property
    def total_flops(self) -> int:
        return 2 * self.total_macs

    def __iter__(self):
        return iter(self.ops)

    def __len__(self) -> int:
        return len(self.ops)
