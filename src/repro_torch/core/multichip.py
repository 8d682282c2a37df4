"""Multi-device inference modeling (paper §V-B, Fig 8).

The paper scales to 4 TPUs in a ring (2 ICI links/chip, 100 GB/s each)
with pipeline parallelism for throughput, and cites Megatron-LM [28] for
tensor parallelism.  Both are modeled:

* ``tensor_parallel_cost`` — Megatron-style sharding: heads/FFN split
  across chips, two ring all-reduces of the activations per layer.
* ``pipeline_parallel_cost`` — layers split into stages; microbatches
  stream through the ring; steady-state throughput set by the slowest
  stage + boundary activation transfer, with the standard (stages-1)
  bubble charged against the fill/drain.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from .energy import DEFAULT_ENERGY_MODEL, EnergyModel
from .hardware import TPUConfig
from .simulator import simulate_graph
from .workloads import (ModelSpec, dit_graph, llm_decode_graph,
                        llm_prefill_graph)


@dataclass
class MultiChipCost:
    name: str
    hw: str
    n_chips: int
    strategy: str
    throughput_per_s: float       # sequences/s (LLM) or images/s (DiT)
    latency_s: float              # per batch
    mxu_energy_j: float           # summed over chips
    comm_s: float


def _ring_allreduce_s(tpu: TPUConfig, bytes_: float, n: int) -> float:
    if n <= 1:
        return 0.0
    return 2 * (n - 1) / n * bytes_ / tpu.ici_bandwidth


def _tp_shard_model(model: ModelSpec, n: int) -> ModelSpec:
    lyr = model.layer
    shard = dataclasses.replace(
        lyr,
        n_heads=max(1, lyr.n_heads // n),
        n_kv_heads=max(1, lyr.n_kv_heads // n),
        d_ff=max(1, lyr.d_ff // n),
        n_routed_experts=max(1, lyr.n_routed_experts // n)
        if lyr.n_routed_experts else 0,
    )
    return dataclasses.replace(model, layer=shard)


def tensor_parallel_llm_cost(
    tpu: TPUConfig, model: ModelSpec, n: int, batch: int = 8,
    prompt: int = 1024, output: int = 512,
    em: EnergyModel = DEFAULT_ENERGY_MODEL, quadrature: int = 4,
) -> MultiChipCost:
    sharded = _tp_shard_model(model, n)
    d = model.layer.d_model

    pre = simulate_graph(tpu, llm_prefill_graph(sharded, batch, prompt), em)
    ar_prefill = 2 * _ring_allreduce_s(tpu, batch * prompt * d * 2, n)
    prefill_s = pre.latency_s + model.n_layers * ar_prefill

    seg = output / quadrature
    dec_s = dec_e = 0.0
    ar_decode = 2 * _ring_allreduce_s(tpu, batch * 1 * d * 2, n)
    for i in range(quadrature):
        kv = int(prompt + (i + 0.5) * seg)
        step = simulate_graph(tpu, llm_decode_graph(sharded, batch, kv), em)
        dec_s += (step.latency_s + model.n_layers * ar_decode) * seg
        dec_e += step.mxu_energy_j * seg

    total = prefill_s + dec_s
    comm = model.n_layers * (ar_prefill + ar_decode * output)
    return MultiChipCost(
        name=f"{model.name}-tp{n}", hw=tpu.name, n_chips=n, strategy="tp",
        throughput_per_s=batch / total, latency_s=total,
        mxu_energy_j=n * (pre.mxu_energy_j + dec_e), comm_s=comm,
    )


def pipeline_parallel_llm_cost(
    tpu: TPUConfig, model: ModelSpec, n: int, batch: int = 8,
    prompt: int = 1024, output: int = 512,
    em: EnergyModel = DEFAULT_ENERGY_MODEL, quadrature: int = 4,
    microbatches: int | None = None,
) -> MultiChipCost:
    """n-stage pipeline over a ring (the paper's §V-B configuration).

    Each stage holds n_layers/n layers; ``microbatches`` concurrent
    requests keep the ring busy (default 4n).  Sequence throughput =
    microbatches / makespan.
    """
    m = microbatches or 4 * n
    stage_model = dataclasses.replace(
        model, n_layers=max(1, int(math.ceil(model.n_layers / n))))
    d = model.layer.d_model

    pre = simulate_graph(tpu, llm_prefill_graph(stage_model, batch, prompt), em)
    hop_prefill = batch * prompt * d * 2 / tpu.ici_bandwidth
    stage_prefill = pre.latency_s + hop_prefill

    seg = output / quadrature
    stage_dec = dec_e = 0.0
    hop_dec = batch * d * 2 / tpu.ici_bandwidth
    for i in range(quadrature):
        kv = int(prompt + (i + 0.5) * seg)
        step = simulate_graph(tpu, llm_decode_graph(stage_model, batch, kv), em)
        stage_dec += (step.latency_s + hop_dec) * seg
        dec_e += step.mxu_energy_j * seg

    # One request's stage time (prefill amortized + all decode steps).
    stage_s = stage_prefill + stage_dec
    makespan = (m + n - 1) * stage_s / max(1, 1)  # m waves + (n-1) bubble
    throughput = (m * batch) / makespan
    per_chip_energy = pre.mxu_energy_j + dec_e  # each chip runs 1/n of layers
    return MultiChipCost(
        name=f"{model.name}-pp{n}", hw=tpu.name, n_chips=n, strategy="pp",
        throughput_per_s=throughput, latency_s=n * stage_s,
        mxu_energy_j=n * per_chip_energy, comm_s=n * (hop_prefill + hop_dec * output),
    )


def pipeline_parallel_dit_cost(
    tpu: TPUConfig, model: ModelSpec, n: int, batch: int = 8,
    image_res: int = 512, em: EnergyModel = DEFAULT_ENERGY_MODEL,
    microbatches: int | None = None,
) -> MultiChipCost:
    m = microbatches or 4 * n
    stage_model = dataclasses.replace(
        model, n_layers=max(1, int(math.ceil(model.n_layers / n))))
    g = simulate_graph(tpu, dit_graph(stage_model, batch, image_res), em)
    d = model.layer.d_model
    tokens = (image_res // 8 // 2) ** 2
    hop = batch * tokens * d * 2 / tpu.ici_bandwidth
    stage_s = g.latency_s + hop
    makespan = (m + n - 1) * stage_s
    return MultiChipCost(
        name=f"{model.name}-pp{n}", hw=tpu.name, n_chips=n, strategy="pp",
        throughput_per_s=m * batch / makespan, latency_s=n * stage_s,
        mxu_energy_j=n * g.mxu_energy_j, comm_s=n * hop,
    )
