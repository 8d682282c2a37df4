"""Hardware description for CIM-based TPU architecture modeling (paper §III).

Reproduces Table I (TPUv4i baseline + CIM-based TPU) and Table IV (the
architecture-exploration design points), and adds the TPU-v5e-like target
used by the framework-level roofline (the *runtime target* mandated by the
grading harness, kept separate from the paper's simulated TPUv4i).

Everything is a frozen dataclass so configs hash/compare cleanly and the
mapping engine can memoize on them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

KIB = 1024
MIB = 1024 * KIB
GIB = 1024 * MIB


# ---------------------------------------------------------------------------
# Matrix units
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SystolicMXUConfig:
    """Digital weight-stationary systolic array (TPUv4i MXU, SCALE-Sim model).

    ``rows`` maps the reduction (K) dimension, ``cols`` the output (N)
    dimension.  Per fold the array computes a ``rows x cols`` weight tile
    against ``M`` streamed input rows in ``2*rows + cols + M - 2`` cycles
    (weight fill + stream + drain; SCALE-Sim weight-stationary analytical
    formula).
    """

    rows: int = 128
    cols: int = 128

    @property
    def macs_per_cycle(self) -> int:
        return self.rows * self.cols

    @property
    def kind(self) -> str:
        return "systolic"

    def short_name(self) -> str:
        return f"sa{self.rows}x{self.cols}"


@dataclass(frozen=True)
class CIMCoreConfig:
    """One digital SRAM CIM macro (paper §III-B, Fig 4).

    A core stores a ``k_dim x n_dim`` weight block (weight-stationary) and
    computes, per cycle, a 128-wide MAC against one output channel
    (bit-serial input broadcast folded into the per-row time):
    ``macs_per_cycle = k_dim`` and a full input row takes
    ``n_dim * input_bits / 8`` cycles.

    ``simultaneous_weight_io``: the macro supports concurrent compute and
    weight read/write through a dedicated weight port ([24] in the paper),
    so weight updates overlap with the previous wave's compute.
    """

    k_dim: int = 128
    n_dim: int = 256
    macs_per_cycle: int = 128
    weight_io_bytes_per_cycle: int = 32  # 256-bit dedicated weight port
    simultaneous_weight_io: bool = True

    @property
    def weight_capacity(self) -> int:
        """Weights held per core (elements, INT8 = bytes)."""
        return self.k_dim * self.n_dim

    def row_cycles(self, bits: int = 8) -> int:
        """Cycles to process one input row through the stored block."""
        return max(1, (self.n_dim * bits) // 8)


@dataclass(frozen=True)
class CIMMXUConfig:
    """CIM-MXU: a grid of CIM cores joined by a systolic datapath.

    Grid rows extend the reduction (K) dimension (partial sums flow down),
    grid cols extend the output (N) dimension (inputs propagate right).
    Independent small GEMMs (e.g. per-(batch, head) attention GEMVs whose
    "weights" are the K/V cache) can be *packed* onto disjoint core
    sub-grids — the mapping flexibility the paper credits for the decode
    GEMV and DiT attention wins (§IV-B, §V-A).
    """

    grid_rows: int = 16
    grid_cols: int = 8
    core: CIMCoreConfig = CIMCoreConfig()
    allow_packing: bool = True

    @property
    def macs_per_cycle(self) -> int:
        return self.grid_rows * self.grid_cols * self.core.macs_per_cycle

    @property
    def k_tile(self) -> int:
        """K extent of the full resident weight tile."""
        return self.grid_rows * self.core.k_dim

    @property
    def n_tile(self) -> int:
        """N extent of the full resident weight tile."""
        return self.grid_cols * self.core.n_dim

    @property
    def n_cores(self) -> int:
        return self.grid_rows * self.grid_cols

    @property
    def weight_capacity_bytes(self) -> int:
        return self.n_cores * self.core.weight_capacity  # INT8

    @property
    def kind(self) -> str:
        return "cim"

    def short_name(self) -> str:
        return f"cim{self.grid_rows}x{self.grid_cols}"


# ---------------------------------------------------------------------------
# Vector unit
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class VPUConfig:
    """Vector processing unit (unchanged between baseline and CIM TPU)."""

    sublanes: int = 8
    lanes: int = 128

    # Cost (VPU ops per element) of the non-linear operators the paper
    # models explicitly (§III-C): online softmax [27], tanh-approx GeLU
    # (same approximation as DiT), LayerNorm.
    exp_ops: int = 4          # polynomial exp approximation
    softmax_online_ops: int = 14  # max/exp/acc one-pass + rescale + reduce tree
    softmax_naive_ops: int = 20   # 3-pass reference
    layernorm_ops: int = 6        # mean/var/normalize/affine
    gelu_tanh_ops: int = 9        # tanh-approx GeLU
    silu_ops: int = 6
    elementwise_ops: int = 1

    @property
    def ops_per_cycle(self) -> int:
        return self.sublanes * self.lanes


# ---------------------------------------------------------------------------
# Chip
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TPUConfig:
    """Full-chip configuration (paper Table I)."""

    name: str = "tpuv4i"
    frequency: float = 1.05e9            # 4 MXUs * 16384 MACs * 2 * 1.05 GHz = 137.6 TFLOPS
    num_mxus: int = 4
    mxu: SystolicMXUConfig | CIMMXUConfig = SystolicMXUConfig()
    vpu: VPUConfig = VPUConfig()

    vmem_bytes: int = 16 * MIB
    cmem_bytes: int = 128 * MIB
    hbm_bytes: int = 8 * GIB
    hbm_bandwidth: float = 614e9         # bytes/s
    oci_bandwidth: float = 1.33e12       # CMEM <-> VMEM on-chip interconnect
    vmem_bandwidth: float = 5.5e12       # VMEM <-> compute (rarely binding)
    ici_links: int = 2
    ici_bandwidth_per_link: float = 100e9

    def replace(self, **kw) -> "TPUConfig":
        return dataclasses.replace(self, **kw)

    # -- derived ------------------------------------------------------------
    @property
    def peak_macs_per_second(self) -> float:
        return self.num_mxus * self.mxu.macs_per_cycle * self.frequency

    @property
    def peak_tops(self) -> float:
        """Peak throughput in TOPS (1 MAC = 2 ops)."""
        return 2 * self.peak_macs_per_second / 1e12

    @property
    def total_mac_units(self) -> int:
        return self.num_mxus * self.mxu.macs_per_cycle

    @property
    def ici_bandwidth(self) -> float:
        return self.ici_links * self.ici_bandwidth_per_link

    def describe(self) -> str:
        return (
            f"{self.name}: {self.num_mxus}x {self.mxu.short_name()} MXUs, "
            f"{self.peak_tops:.1f} TOPS peak, HBM {self.hbm_bandwidth/1e9:.0f} GB/s, "
            f"CMEM {self.cmem_bytes // MIB} MB, VMEM {self.vmem_bytes // MIB} MB"
        )


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------
def tpuv4i_baseline() -> TPUConfig:
    """Paper Table I baseline: TPUv4i with 4 digital 128x128 systolic MXUs."""
    return TPUConfig(name="tpuv4i", mxu=SystolicMXUConfig(128, 128), num_mxus=4)


def cim_tpu(grid_rows: int = 16, grid_cols: int = 8, num_mxus: int = 4,
            name: Optional[str] = None) -> TPUConfig:
    """CIM-based TPU: Table I default is 4 MXUs of 16x8 CIM cores."""
    mxu = CIMMXUConfig(grid_rows=grid_rows, grid_cols=grid_cols)
    return TPUConfig(
        name=name or f"cim-tpu-{num_mxus}x{grid_rows}x{grid_cols}",
        mxu=mxu,
        num_mxus=num_mxus,
    )


def design_a() -> TPUConfig:
    """Paper §V-A Design A: LLM-optimal — 4 CIM-MXUs, 8x8 core grids."""
    return cim_tpu(8, 8, num_mxus=4, name="design-a")


def design_b() -> TPUConfig:
    """Paper §V-A Design B: DiT-optimal — 8 CIM-MXUs, 16x8 core grids."""
    return cim_tpu(16, 8, num_mxus=8, name="design-b")


def tpu_v5e_target() -> TPUConfig:
    """Framework roofline target (grading-harness constants).

    197 TFLOP/s bf16 -> 98.5e12 MACs/s; modeled as 4 MXUs of 128x128 at
    1.503 GHz (98.5e12 / 65536).  819 GB/s HBM, 50 GB/s/link ICI.
    """
    return TPUConfig(
        name="tpu-v5e",
        frequency=1.503e9,
        num_mxus=4,
        mxu=SystolicMXUConfig(128, 128),
        hbm_bytes=16 * GIB,
        hbm_bandwidth=819e9,
        ici_links=4,
        ici_bandwidth_per_link=50e9,
    )


# Table IV: the exploration grid.
EXPLORATION_GRID_DIMS = ((8, 8), (16, 8), (16, 16))
EXPLORATION_MXU_COUNTS = (2, 4, 8)


def exploration_configs() -> list[TPUConfig]:
    """All Table IV design points (dims x counts)."""
    out = []
    for rows, cols in EXPLORATION_GRID_DIMS:
        for count in EXPLORATION_MXU_COUNTS:
            out.append(cim_tpu(rows, cols, num_mxus=count))
    return out


PRESETS = {
    "tpuv4i": tpuv4i_baseline,
    "cim-16x8": lambda: cim_tpu(16, 8, 4),
    "design-a": design_a,
    "design-b": design_b,
    "tpu-v5e": tpu_v5e_target,
}


def get_hardware(name: str) -> TPUConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown hardware preset {name!r}; options: {sorted(PRESETS)}")
