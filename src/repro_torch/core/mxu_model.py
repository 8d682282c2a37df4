"""Analytical MXU timing models (paper §III-B, §IV-A).

Two models with one interface:

* ``systolic_cost`` — SCALE-Sim-style weight-stationary systolic array
  (the TPUv4i baseline MXU).  Shared-weight GEMMs enjoy double-buffered
  weight loads (per-fold floor of ``max(M, R)``); attention-style matmuls
  (per-batch "weights" = KV cache) pay the full non-overlapped
  ``R + M + C - 2`` per fold — the "frequent weight update" penalty the
  paper calls out in §III-B.

* ``cim_cost`` — the CIM-MXU: a ``grid_rows x grid_cols`` systolic grid of
  weight-stationary CIM cores.  Per core one input row takes
  ``n_dim * bits / 8`` cycles (bit-serial broadcast), i.e. 128 MACs/cycle
  at INT8 — peak matches the digital MXU (Table II).  Two mapping
  freedoms give CIM its wins:
    1. *packing*: independent (batch, head) problems occupy disjoint core
       sub-grids (no fill/drain per problem) — the decode-GEMV and DiT
       attention speedups of §IV-B;
    2. *replication*: when a shared weight tile underfills the grid, it is
       replicated and M split across replicas.
  Weight updates stream through each core's dedicated port and overlap
  with compute (simultaneous MAC + write, [24]); only the non-overlapped
  remainder is exposed.
"""
from __future__ import annotations

from dataclasses import dataclass

from .hardware import CIMMXUConfig, SystolicMXUConfig, TPUConfig
from .operators import MatMulOp


@dataclass(frozen=True)
class MXUCost:
    """Compute-side cost of one MatMulOp on the full MXU ensemble."""

    cycles: float          # active cycles (critical path across MXUs)
    active_macs: float     # useful MACs
    weight_bytes: float    # bytes written into array weight storage
    util: float            # active_macs / (cycles * ensemble peak)

    @staticmethod
    def zero() -> "MXUCost":
        return MXUCost(0.0, 0.0, 0.0, 1.0)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# SCALE-Sim-style weight-stationary fold accounting for *unshared* weights
# (attention): weight fill + stream + drain with partial fill/drain overlap.
# 2.0 would be the fully non-overlapped SCALE-Sim formula (2R + M + C - 2);
# 1.0 a perfectly double-buffered fill.  1.75 calibrates the baseline's
# decode attention share to the paper's Fig 6 (§IV-B).
UNSHARED_WEIGHT_FILL_FACTOR = 1.75


# ---------------------------------------------------------------------------
# Digital systolic baseline
# ---------------------------------------------------------------------------
def systolic_cost(mxu: SystolicMXUConfig, num_mxus: int, op: MatMulOp) -> MXUCost:
    R, C = mxu.rows, mxu.cols
    folds = _ceil_div(op.K, R) * _ceil_div(op.N, C)

    if op.weights_shared:
        # One weight matrix, all batch rows streamed together.
        m_eff = op.batch * op.M
        per_fold = max(m_eff, R)  # double-buffered weight fill
        fold_share = _ceil_div(folds, num_mxus)
        cycles = fold_share * per_fold + (R + C + min(m_eff, R))
        weight_bytes = op.weight_bytes
    else:
        # Per-batch weights (attention): weight fill + stream + drain per
        # fold; fills cannot be hidden because every fold is new weights
        # ("frequent weight update" penalty, §III-B).
        per_fold = int(UNSHARED_WEIGHT_FILL_FACTOR * R) + op.M + C - 2
        total_folds = op.batch * folds
        cycles = _ceil_div(total_folds, num_mxus) * per_fold
        weight_bytes = op.weight_bytes  # already batch-scaled

    peak = num_mxus * mxu.macs_per_cycle
    util = op.macs / max(1.0, cycles * peak)
    return MXUCost(cycles=float(cycles), active_macs=float(op.macs),
                   weight_bytes=float(weight_bytes), util=min(1.0, util))


# ---------------------------------------------------------------------------
# CIM-MXU
# ---------------------------------------------------------------------------
def cim_cost(mxu: CIMMXUConfig, num_mxus: int, op: MatMulOp) -> MXUCost:
    """Work-conserving CIM-MXU model.

    Per core and input row, the output-channel sequencer sweeps one
    channel per cycle (128 MACs/cycle at INT8) and *early-terminates*
    after the channels actually mapped to that core — so an op with
    N < n_dim does not pay for unused channels.  The mapping engine packs
    K-strips of (possibly different) problems across the core grid, so
    ensemble throughput is work-conserving:

        total core-cycles = ceil(K / k_dim) * M_total * N * bits/8

    floored by one problem's critical path (a single row through its
    strip).  Weight updates stream through per-core dedicated ports,
    overlapped with compute when ``simultaneous_weight_io``
    (max(compute, stream)); one un-hidden initial block load remains.
    """
    core = mxu.core
    cpc = max(1, min(op.act_bits, 8)) / 8.0  # cycles per output channel
    fill = mxu.grid_rows + mxu.grid_cols     # systolic hop latency
    write_core = _ceil_div(core.k_dim * core.n_dim * op.weight_bits // 8,
                           core.weight_io_bytes_per_cycle)

    k_tiles = _ceil_div(op.K, core.k_dim)
    ensemble_cores = num_mxus * mxu.n_cores
    ensemble_io = ensemble_cores * core.weight_io_bytes_per_cycle

    m_total = op.batch * op.M if op.weights_shared else op.batch * op.M
    # (identical expressions — unshared problems contribute batch*M rows of
    #  independent work; kept explicit for readability)
    total_core_cycles = k_tiles * m_total * op.N * cpc
    if not mxu.allow_packing:
        # Without packing every problem/fold runs serially at full sweeps.
        n_strip = _ceil_div(op.N, core.n_dim)
        waves = (op.batch if not op.weights_shared else 1) * \
            _ceil_div(k_tiles * n_strip, ensemble_cores)
        total_core_cycles = waves * ensemble_cores * op.M * core.n_dim * cpc

    compute = total_core_cycles / ensemble_cores
    # Critical-path floor: for unshared problems, one problem's M rows
    # stream through its strip (II = per-core channel sweep).  The mapping
    # engine may replicate a problem's tile onto idle cores and split M
    # across the replicas (same packing freedom the paper credits for the
    # DiT win), so the serial row count shrinks by the free-core factor.
    if op.weights_shared:
        serial_rows = 1
    else:
        n_strip = _ceil_div(op.N, core.n_dim)
        tiles_all = k_tiles * n_strip * op.batch
        rep1 = max(1, ensemble_cores // max(1, tiles_all))
        serial_rows = _ceil_div(op.M, rep1)
    floor = serial_rows * min(op.N, core.n_dim) * cpc
    compute = max(compute, floor) + fill

    # Weight streaming (overlapped): KV/parameter blocks written into the
    # arrays through the dedicated ports.
    weight_bytes = float(op.weight_bytes)
    stream = weight_bytes / ensemble_io
    if core.simultaneous_weight_io:
        cycles = max(compute, stream) + write_core
    else:
        cycles = compute + stream + write_core

    peak = num_mxus * mxu.macs_per_cycle
    util = op.macs / max(1.0, cycles * peak)
    return MXUCost(cycles=float(cycles), active_macs=float(op.macs),
                   weight_bytes=weight_bytes, util=min(1.0, util))


def matmul_cost(tpu: TPUConfig, op: MatMulOp) -> MXUCost:
    if isinstance(tpu.mxu, CIMMXUConfig):
        return cim_cost(tpu.mxu, tpu.num_mxus, op)
    if isinstance(tpu.mxu, SystolicMXUConfig):
        return systolic_cost(tpu.mxu, tpu.num_mxus, op)
    raise TypeError(f"unknown MXU type: {type(tpu.mxu)}")  # pragma: no cover
