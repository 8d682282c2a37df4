"""Inference scenarios + architecture design-space exploration (paper §V).

Scenarios (paper §IV-B / §V-A):
  * LLM: GPT-3-30B, batch 8, INT8; prompt 1024, 512 output tokens
    (decoding dominates — §V-A).  Decode cost integrated over the growing
    KV cache with an 8-point midpoint quadrature.
  * DiT: DiT-XL/2 @ 512x512 (1024 latent tokens), batch 8, 28 blocks.

Exploration grid (Table IV): CIM core-array dims {8x8, 16x8, 16x16} x
CIM-MXU counts {2, 4, 8}, against the TPUv4i digital baseline.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from .energy import DEFAULT_ENERGY_MODEL, EnergyModel
from .hardware import TPUConfig, exploration_configs, tpuv4i_baseline
from .simulator import GraphCost, simulate_graph
from .workloads import (ModelSpec, dit_graph, gpt3_30b, dit_xl2,
                        llm_decode_graph, llm_prefill_graph)


# ---------------------------------------------------------------------------
# Workload-graph memoization: the op list for a given (model, batch,
# q_len/kv_len) point is identical across every hardware config and every
# quadrature sweep — ``run_exploration`` alone would otherwise rebuild
# each decode graph once per design point.  ModelSpec is a frozen
# (hashable) dataclass, so the graph constructors memoize cleanly;
# simulate_graph only reads the Graph, so sharing one instance is safe.
# ---------------------------------------------------------------------------
_prefill_graph = functools.lru_cache(maxsize=512)(llm_prefill_graph)
_decode_graph = functools.lru_cache(maxsize=512)(llm_decode_graph)
_dit_graph = functools.lru_cache(maxsize=512)(dit_graph)


def clear_graph_cache() -> None:
    """Drop memoized workload graphs (benchmarking / memory pressure)."""
    _prefill_graph.cache_clear()
    _decode_graph.cache_clear()
    _dit_graph.cache_clear()


@dataclass
class ScenarioCost:
    name: str
    hw: str
    latency_s: float
    mxu_energy_j: float
    total_energy_j: float
    phases: dict[str, float]          # phase -> latency
    attention_latency_s: float = 0.0
    breakdown: dict[str, float] | None = None

    @property
    def mxu_power_w(self) -> float:
        return self.mxu_energy_j / max(1e-30, self.latency_s)


def llm_inference_cost(
    tpu: TPUConfig,
    model: ModelSpec | None = None,
    batch: int = 8,
    prompt: int = 1024,
    output: int = 512,
    em: EnergyModel = DEFAULT_ENERGY_MODEL,
    quadrature: int = 8,
) -> ScenarioCost:
    model = model or gpt3_30b()
    prefill = simulate_graph(tpu, _prefill_graph(model, batch, prompt), em)

    # Midpoint quadrature over the decode trajectory kv in (prompt, prompt+output].
    seg = output / quadrature
    dec_lat = dec_mxu = dec_tot = dec_attn = 0.0
    for i in range(quadrature):
        kv = int(prompt + (i + 0.5) * seg)
        step = simulate_graph(tpu, _decode_graph(model, batch, kv), em)
        dec_lat += step.latency_s * seg
        dec_mxu += step.mxu_energy_j * seg
        dec_tot += step.total_energy_j * seg
        dec_attn += step.attention_latency_s() * seg

    return ScenarioCost(
        name=f"{model.name}-in{prompt}-out{output}-b{batch}",
        hw=tpu.name,
        latency_s=prefill.latency_s + dec_lat,
        mxu_energy_j=prefill.mxu_energy_j + dec_mxu,
        total_energy_j=prefill.total_energy_j + dec_tot,
        phases={"prefill": prefill.latency_s, "decode": dec_lat},
        attention_latency_s=prefill.attention_latency_s() + dec_attn,
    )


def llm_prefill_cost(tpu: TPUConfig, model: ModelSpec | None = None,
                     batch: int = 8, prompt: int = 1024,
                     em: EnergyModel = DEFAULT_ENERGY_MODEL) -> GraphCost:
    model = model or gpt3_30b()
    return simulate_graph(tpu, _prefill_graph(model, batch, prompt), em)


def llm_decode_cost(tpu: TPUConfig, model: ModelSpec | None = None,
                    batch: int = 8, kv_len: int = 1280,
                    em: EnergyModel = DEFAULT_ENERGY_MODEL) -> GraphCost:
    """Paper §IV-B decode point: the 256th output token after a 1024
    prompt -> kv cache of 1280."""
    model = model or gpt3_30b()
    return simulate_graph(tpu, _decode_graph(model, batch, kv_len), em)


def dit_inference_cost(tpu: TPUConfig, model: ModelSpec | None = None,
                       batch: int = 8, image_res: int = 512,
                       em: EnergyModel = DEFAULT_ENERGY_MODEL) -> ScenarioCost:
    model = model or dit_xl2()
    g = simulate_graph(tpu, _dit_graph(model, batch, image_res), em)
    return ScenarioCost(
        name=f"{model.name}-r{image_res}-b{batch}",
        hw=tpu.name,
        latency_s=g.latency_s,
        mxu_energy_j=g.mxu_energy_j,
        total_energy_j=g.total_energy_j,
        phases={"dit": g.latency_s},
        attention_latency_s=g.attention_latency_s(),
        breakdown=g.breakdown_fractions(),
    )


# ---------------------------------------------------------------------------
# Table IV exploration
# ---------------------------------------------------------------------------
@dataclass
class ExplorationRecord:
    hw: TPUConfig
    llm: ScenarioCost
    dit: ScenarioCost

    def row(self, base: "ExplorationRecord") -> dict:
        return {
            "hw": self.hw.name,
            "peak_tops": round(self.hw.peak_tops, 1),
            "llm_latency_s": self.llm.latency_s,
            "llm_speedup": base.llm.latency_s / self.llm.latency_s,
            "llm_mxu_energy_j": self.llm.mxu_energy_j,
            "llm_energy_saving": base.llm.mxu_energy_j / self.llm.mxu_energy_j,
            "dit_latency_s": self.dit.latency_s,
            "dit_speedup": base.dit.latency_s / self.dit.latency_s,
            "dit_mxu_energy_j": self.dit.mxu_energy_j,
            "dit_energy_saving": base.dit.mxu_energy_j / self.dit.mxu_energy_j,
        }


def run_exploration(em: EnergyModel = DEFAULT_ENERGY_MODEL,
                    quadrature: int = 4) -> list[ExplorationRecord]:
    """Evaluate the baseline + all Table IV design points on both scenarios."""
    records = []
    for hw in [tpuv4i_baseline()] + exploration_configs():
        llm = llm_inference_cost(hw, em=em, quadrature=quadrature)
        dit = dit_inference_cost(hw, em=em)
        records.append(ExplorationRecord(hw=hw, llm=llm, dit=dit))
    return records


def pick_designs(records: list[ExplorationRecord]) -> dict[str, ExplorationRecord]:
    """Re-derive the paper's Design A (LLM) / Design B (DiT) trade-off picks.

    §V-A states the criteria qualitatively ("considering latency, energy
    and area trade-offs").  We operationalize them as minimum
    energy-delay-area product (EDAP) among configs that do not regress
    latency vs the TPUv4i baseline.  The paper lands on 4x(8x8) for LLM
    and 8x(16x8) for DiT; our mapping engine finds decode more firmly
    HBM-bound than theirs, so the LLM pick can shift one notch smaller —
    the benchmark reports both our pick and the paper's designs
    (hardware.design_a / design_b keep the paper's exact configs).
    """
    from .energy import mxu_area_mm2

    base, cims = records[0], records[1:]

    def edap(r: ExplorationRecord, which: str) -> float:
        s = getattr(r, which)
        return s.latency_s * s.mxu_energy_j * mxu_area_mm2(r.hw)

    def pool(which: str) -> list[ExplorationRecord]:
        # within 20% of the best latency achieved by any CIM config, and
        # never slower than the baseline
        best = min(getattr(r, which).latency_s for r in cims)
        basel = getattr(base, which).latency_s
        out = [r for r in cims
               if getattr(r, which).latency_s <= min(1.20 * best, basel)]
        return out or cims

    design_a = min(pool("llm"), key=lambda r: edap(r, "llm"))
    design_b = min(pool("dit"), key=lambda r: edap(r, "dit"))
    return {"baseline": base, "design_a": design_a, "design_b": design_b}
