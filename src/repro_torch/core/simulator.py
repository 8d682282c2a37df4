"""Operator/layer/model-level performance + energy simulation (paper §III).

Per op:  latency = max(MXU-or-VPU compute, HBM transfer, OCI transfer)
(double buffering, §III-C) plus the un-hidden startup; MXU energy follows
the active/idle/stall decomposition of :mod:`repro_torch.core.energy`; memory
energy is tracked separately so "MXU energy" comparisons match the paper's
accounting.
"""
from __future__ import annotations

import enum
from collections import defaultdict
from dataclasses import dataclass, field

from .energy import DEFAULT_ENERGY_MODEL, EnergyModel
from .hardware import TPUConfig
from .mapping import Mapping, map_matmul
from .mxu_model import MXUCost, matmul_cost
from .operators import (ATTENTION_BUCKET, GEMM_BUCKET, Graph, MatMulOp, Op,
                        OpKind, VectorOp)


class Bottleneck(enum.Enum):
    COMPUTE = "compute"
    HBM = "hbm"
    OCI = "oci"
    VPU = "vpu"


@dataclass
class OpCost:
    op: Op
    latency_s: float
    compute_s: float
    hbm_s: float
    oci_s: float
    bottleneck: Bottleneck
    mxu_energy_j: float
    vpu_energy_j: float
    memory_energy_j: float
    util: float
    hbm_bytes: float
    macs: float

    @property
    def total_energy_j(self) -> float:
        return self.mxu_energy_j + self.vpu_energy_j + self.memory_energy_j


@dataclass
class GraphCost:
    graph_name: str
    op_costs: list[OpCost] = field(default_factory=list)
    repeat: int = 1
    # Peak throughput of the TPUConfig this cost was simulated on; MFU is
    # relative to *this* config (not a module-global keyed by graph name,
    # which silently mixed configs when two hardware points simulated
    # graphs of the same name, as run_exploration does).
    peak_macs_per_second: float = 0.0

    # ---- aggregates (single repetition x repeat) -----------------------
    @property
    def latency_s(self) -> float:
        return self.repeat * sum(c.latency_s for c in self.op_costs)

    @property
    def mxu_energy_j(self) -> float:
        return self.repeat * sum(c.mxu_energy_j for c in self.op_costs)

    @property
    def vpu_energy_j(self) -> float:
        return self.repeat * sum(c.vpu_energy_j for c in self.op_costs)

    @property
    def memory_energy_j(self) -> float:
        return self.repeat * sum(c.memory_energy_j for c in self.op_costs)

    @property
    def total_energy_j(self) -> float:
        return self.mxu_energy_j + self.vpu_energy_j + self.memory_energy_j

    @property
    def total_macs(self) -> float:
        return self.repeat * sum(c.macs for c in self.op_costs)

    @property
    def hbm_bytes(self) -> float:
        return self.repeat * sum(c.hbm_bytes for c in self.op_costs)

    def latency_by(self, keyfn) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for c in self.op_costs:
            out[keyfn(c.op)] += self.repeat * c.latency_s
        return dict(out)

    def breakdown(self) -> dict[str, float]:
        """Paper Fig 6-style latency buckets."""
        def bucket(op: Op) -> str:
            if op.kind in GEMM_BUCKET:
                return "gemm"
            if op.kind == OpKind.SOFTMAX:
                return "softmax"
            if op.kind in ATTENTION_BUCKET:
                return "attention_mm"
            return "other"
        return self.latency_by(bucket)

    def breakdown_fractions(self) -> dict[str, float]:
        b = self.breakdown()
        tot = sum(b.values()) or 1.0
        return {k: v / tot for k, v in b.items()}

    def attention_latency_s(self) -> float:
        """QK^T + S@V + Softmax (the paper's 'Attention layers')."""
        return self.repeat * sum(
            c.latency_s for c in self.op_costs if c.op.kind in ATTENTION_BUCKET
        )

    def summary(self) -> dict[str, float]:
        return {
            "latency_s": self.latency_s,
            "mxu_energy_j": self.mxu_energy_j,
            "total_energy_j": self.total_energy_j,
            "macs": self.total_macs,
            "hbm_bytes": self.hbm_bytes,
            "mfu": self.total_macs / max(1e-30, self.latency_s)
                   / max(1.0, self.peak_macs_per_second),
        }


# ---------------------------------------------------------------------------
def _vector_ops_per_elem(vpu, op: VectorOp) -> float:
    if op.ops_per_elem:
        return op.ops_per_elem
    table = {
        OpKind.SOFTMAX: vpu.softmax_online_ops,
        OpKind.LAYERNORM: vpu.layernorm_ops,
        OpKind.GELU: vpu.gelu_tanh_ops,
        OpKind.SILU: vpu.silu_ops,
        OpKind.ELEMENTWISE: vpu.elementwise_ops,
        OpKind.ROPE: 4,
        OpKind.CONDITIONING: 2,
        OpKind.SCAN: 6,
    }
    return float(table.get(op.kind, vpu.elementwise_ops))


def simulate_matmul(tpu: TPUConfig, op: MatMulOp,
                    em: EnergyModel = DEFAULT_ENERGY_MODEL) -> OpCost:
    mxu: MXUCost = matmul_cost(tpu, op)
    compute_s = mxu.cycles / tpu.frequency
    mapping: Mapping = map_matmul(tpu, op, compute_s)

    hbm_s = mapping.hbm_bytes / tpu.hbm_bandwidth
    oci_s = mapping.oci_bytes / tpu.oci_bandwidth
    latency = max(compute_s, hbm_s, oci_s) + mapping.startup_s

    times = {Bottleneck.COMPUTE: compute_s, Bottleneck.HBM: hbm_s,
             Bottleneck.OCI: oci_s}
    bottleneck = max(times, key=times.get)

    stall_cycles = max(0.0, (latency - compute_s)) * tpu.frequency
    mxu_e = em.mxu_energy(tpu, mxu.active_macs, mxu.cycles, stall_cycles,
                          mxu.weight_bytes,
                          mac_bits=max(op.act_bits, op.weight_bits))
    mem_e = em.memory_energy(mapping.hbm_bytes, mapping.oci_bytes,
                             mapping.vmem_bytes)
    return OpCost(op=op, latency_s=latency, compute_s=compute_s, hbm_s=hbm_s,
                  oci_s=oci_s, bottleneck=bottleneck, mxu_energy_j=mxu_e,
                  vpu_energy_j=0.0, memory_energy_j=mem_e, util=mxu.util,
                  hbm_bytes=mapping.hbm_bytes, macs=float(op.macs))


def simulate_vector(tpu: TPUConfig, op: VectorOp,
                    em: EnergyModel = DEFAULT_ENERGY_MODEL) -> OpCost:
    ops_per_elem = _vector_ops_per_elem(tpu.vpu, op)
    total_ops = op.elems * ops_per_elem
    vpu_s = total_ops / (tpu.vpu.ops_per_cycle * tpu.frequency)

    io = op.io_bytes
    # Tensors too large for CMEM spill to HBM (e.g. unfused giant score
    # matrices); fused/on-chip tensors move over the OCI only.
    spills = io / 2 > 0.5 * tpu.cmem_bytes
    hbm_bytes = float(io) if spills else 0.0
    hbm_s = hbm_bytes / tpu.hbm_bandwidth
    oci_s = io / tpu.oci_bandwidth
    latency = max(vpu_s, hbm_s, oci_s)

    bottleneck = Bottleneck.VPU if latency == vpu_s else (
        Bottleneck.HBM if latency == hbm_s else Bottleneck.OCI)
    return OpCost(op=op, latency_s=latency, compute_s=vpu_s, hbm_s=hbm_s,
                  oci_s=oci_s, bottleneck=bottleneck, mxu_energy_j=0.0,
                  vpu_energy_j=em.vpu_energy(total_ops),
                  memory_energy_j=em.memory_energy(hbm_bytes, io, io),
                  util=0.0, hbm_bytes=hbm_bytes, macs=0.0)


def simulate_op(tpu: TPUConfig, op: Op,
                em: EnergyModel = DEFAULT_ENERGY_MODEL) -> OpCost:
    if isinstance(op, MatMulOp):
        return simulate_matmul(tpu, op, em)
    if isinstance(op, VectorOp):
        return simulate_vector(tpu, op, em)
    raise TypeError(f"cannot simulate {type(op)}")  # pragma: no cover


def simulate_graph(tpu: TPUConfig, graph: Graph,
                   em: EnergyModel = DEFAULT_ENERGY_MODEL) -> GraphCost:
    gc = GraphCost(graph_name=graph.name, repeat=graph.repeat,
                   peak_macs_per_second=tpu.peak_macs_per_second)
    for op in graph:
        gc.op_costs.append(simulate_op(tpu, op, em))
    return gc
