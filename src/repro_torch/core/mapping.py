"""Mapping engine: tiling + scheduling of operators onto the CIM-based TPU
(paper §III-C, Fig 5).

A ``[B, M, K] x [K, N]`` operator is partitioned into CMEM-resident
subtiles ``[M_t, K_t] x [K_t, N_t]`` and further into VMEM tiles before
hitting the MXUs/VPU.  The mapspace (tile sizes x loop orders) is pruned
with the heuristics of LLMCompass/Timeloop (power-of-two tile candidates,
residency-driven loop orders, no partial-sum spilling unless forced) and
searched exhaustively over the pruned set — vectorized with NumPy so the
search is O(100) candidate evaluations per op.  Double buffering is
modeled by overlapping transfer and compute (latency = max(...) instead of
sum), with the un-hidden first-tile startup added.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from .hardware import TPUConfig
from .operators import MatMulOp


@dataclass(frozen=True)
class Mapping:
    """Result of the mapping search for one MatMulOp."""

    schedule: str                 # loop-order/residency choice
    cmem_tile: tuple[int, int, int]   # (M_t, K_t, N_t)
    vmem_tile: tuple[int, int, int]
    hbm_bytes: float              # HBM <-> CMEM traffic
    oci_bytes: float              # CMEM <-> VMEM traffic
    vmem_bytes: float             # VMEM <-> compute traffic
    startup_s: float              # un-hidden first-tile transfer


def _pow2_tiles(dim: int, lo: int = 64) -> list[int]:
    """Candidate tile sizes: powers of two up to dim, plus dim itself."""
    out = []
    t = lo
    while t < dim:
        out.append(t)
        t *= 2
    out.append(dim)
    return out


def _traffic(schedule: str, B: int, M: int, K: int, N: int,
             mt: np.ndarray, kt: np.ndarray, nt: np.ndarray,
             ab: int, wb: int, ob: int, shared: bool) -> np.ndarray:
    """HBM traffic (bytes) for a tiling under a residency schedule.

    A: [B*M, K] activations (shared case folds batch into M);
    W: [K, N] weights (unique per batch element when not shared).
    """
    m_eff = B * M if shared else M
    w_mult = 1 if shared else B
    a_bytes = m_eff * K * ab // 8
    w_bytes = w_mult * K * N * wb // 8
    o_bytes = (B * M * N * ob) // 8

    n_tiles = np.ceil(N / nt)
    m_tiles = np.ceil(m_eff / mt)

    if schedule == "a_resident":
        # A tile stays in CMEM while all N tiles stream past it.
        traffic = a_bytes * 1.0 + w_bytes * m_tiles + o_bytes
    elif schedule == "w_resident":
        # W tile stays while all M tiles stream past it.
        traffic = a_bytes * n_tiles + w_bytes * 1.0 + o_bytes
    else:  # "streaming": both stream, outputs accumulate in CMEM (K inner)
        traffic = a_bytes * n_tiles + w_bytes * m_tiles + o_bytes
    return traffic


@functools.lru_cache(maxsize=4096)
def map_matmul(tpu: TPUConfig, op: MatMulOp, compute_s: float) -> Mapping:
    """Search the pruned mapspace for the latency-optimal tiling of ``op``.

    ``compute_s`` (from the MXU model) lets the search trade transfer time
    against compute under double buffering.
    """
    B, M, K, N = op.batch, op.M, op.K, op.N
    shared = op.weights_shared
    ab, wb, ob = op.act_bits, op.weight_bits, op.out_bits
    m_eff = B * M if shared else M

    if not shared:
        # Attention-style: KV streamed exactly once (no reuse across batch);
        # residency games buy nothing.  Compulsory traffic.
        hbm = op.input_bytes + op.weight_bytes + op.output_bytes
        if op.fused_output:
            hbm -= op.output_bytes
        oci = float(hbm)
        vmem = float(hbm) + op.weight_bytes
        startup = min(op.weight_bytes, tpu.vmem_bytes / 2) / tpu.hbm_bandwidth
        return Mapping("streaming", (m_eff, K, N), (m_eff, K, N),
                       float(max(hbm, 0)), oci, vmem, startup)

    # -- pruned candidate grid ------------------------------------------
    mts = np.array(_pow2_tiles(max(1, m_eff)), dtype=np.float64)
    nts = np.array(_pow2_tiles(max(1, N)), dtype=np.float64)
    kt = float(K)  # heuristic: never spill partial sums at CMEM level
    mt_g, nt_g = np.meshgrid(mts, nts, indexing="ij")

    usable = 0.85 * tpu.cmem_bytes / 2  # double buffered
    fits = (mt_g * kt * ab / 8 + kt * nt_g * wb / 8 + mt_g * nt_g * 4) <= usable
    # Always keep the smallest candidate feasible even if cramped.
    if not fits.any():
        fits = np.zeros_like(fits, dtype=bool)
        fits[0, 0] = True

    best = None
    for schedule in ("a_resident", "w_resident", "streaming"):
        traffic = _traffic(schedule, B, M, K, N, mt_g, kt, nt_g, ab, wb, ob, shared)
        traffic = np.where(fits, traffic, np.inf)
        if op.weights_resident:
            traffic = traffic - (K * N * wb // 8)
        if op.fused_output:
            traffic = traffic - (B * M * N * ob // 8)
        hbm_s = traffic / tpu.hbm_bandwidth
        lat = np.maximum(hbm_s, compute_s)
        idx = np.unravel_index(int(np.argmin(lat)), lat.shape)
        cand = (float(lat[idx]), schedule, int(mt_g[idx]), int(nt_g[idx]),
                float(traffic[idx]))
        if best is None or cand[0] < best[0]:
            best = cand

    _, schedule, mt, nt, hbm = best
    hbm = max(hbm, 0.0)

    # -- VMEM level: same structure, one level down ----------------------
    v_usable = 0.8 * tpu.vmem_bytes / 2
    # heuristic: MXU-aligned VMEM tiles, K kept whole per pass when it fits.
    kv = min(K, max(128, int(v_usable // max(1, (mt + nt) * max(ab, wb) // 8))))
    kv = max(128, min(K, kv))
    mv = min(mt, 512)
    nv = min(nt, 2048)
    # CMEM->VMEM traffic: stream each CMEM tile once per use (w_resident at
    # this level; weights go straight to the MXU weight port).
    oci = (m_eff * K * ab / 8) * math.ceil(nt / nv) + (K * N * wb / 8) \
        + (m_eff * N * ob / 8)
    vmem = oci + K * N * wb / 8  # weights pass through VMEM to the arrays

    startup = (mv * kv * ab / 8 + kv * nv * wb / 8) / tpu.hbm_bandwidth
    return Mapping(schedule, (int(mt), int(kt), int(nt)), (mv, kv, nv),
                   float(hbm), float(oci), float(vmem), float(startup))
