"""Live dispatch/energy attribution for instrumented engines (port of
``repro/obs/attribution.py``).

Two modeled quantities ride along with every engine step:

  * **Dispatch counts by site class** — derived from the declarative
    manifest the launch audit checks (:mod:`repro_torch.analysis.manifest`),
    never hand-pinned here.  A full-plan decode step books
    ``model_sites(model, "decode")``'s counter once per batched forward:
    the reference's depth-free counts (one block per layer group; a
    group of ``n`` layers launches ``n`` times as many on the port, see
    ``manifest.step_launches``).  Engines whose plan does not cover
    every site of every layer group (or whose arch has no full-plan
    contract yet) book nothing — a zero is honest, a guessed number is
    not.
  * **Energy per request row** — each request's share of a step is
    priced as a batch=1 analytic step on the simulator
    (:func:`repro_torch.core.bridge.graph_from_config` at the request's
    actual q_len/kv_len, plan-covered ops at the INT8-CIM energy point,
    everything else bf16), on the paper's 27.3x hardware point by
    default (2x(8x8) CIM-TPU).  Prices are memoized per (phase, q_len,
    kv_len) — a traffic run revisits the same few hundred keys — and
    the sum over a request's steps is exactly the analytic simulator's
    cost of the same step sequence.  These joules and MACs model the
    paper's CIM-TPU; they are not the card's energy.

Per-row batch=1 pricing attributes each sequence the cost of *its own*
computation; batch-sharing effects (idle decode rows in a fixed-shape
batch, pad rows) are deliberately not smeared across requests — the
occupancy/utilization gauges report those.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class StepPrice(NamedTuple):
    """Modeled cost of one engine-step row (batch=1)."""
    mxu_j: float
    vpu_j: float
    memory_j: float
    macs: float

    @property
    def joules(self) -> float:
        return self.mxu_j + self.vpu_j + self.memory_j


def default_hardware():
    """The paper's 27.3x MXU-energy design point: 2x(8x8) CIM-TPU."""
    from repro_torch.core import cim_tpu
    return cim_tpu(8, 8, num_mxus=2)


def plan_covers_model(model, quant_plan) -> bool:
    """True when ``quant_plan`` puts every contract site of every layer
    group of ``model`` on the fused pipeline — the precondition for
    counting dispatches off the manifest."""
    if quant_plan is None:
        return False
    from repro_torch.analysis.manifest import supports_full_plan
    from repro_torch.quant.plan import covered_kinds
    if not supports_full_plan(model):
        return False
    for (mixer, ffn), _count in model.cfg.layer_groups():
        for kind in covered_kinds(mixer, ffn):
            if not quant_plan.covers(kind):
                return False
    return True


def plan_covers_dit(quant_plan) -> bool:
    if quant_plan is None:
        return False
    from repro_torch.quant.plan import DIT_LAYER_KINDS
    return all(quant_plan.covers(k) for k in DIT_LAYER_KINDS)


class EnergyAttribution:
    """Per-step pricer + dispatch counter for one engine.

    Bind exactly one of ``bind_llm`` / ``bind_dit`` (the engines do it
    in ``__init__`` when built with ``obs=``).  All pricing happens on
    the host against the analytic simulator; nothing here touches a
    tensor.
    """

    def __init__(self, hardware=None, energy_model=None):
        self._tpu = hardware
        self._em = energy_model
        self.model = None
        self.quant_plan = None
        self.kv_slots = 0        # cache slots a decode kernel streams
        self.kind: Optional[str] = None    # "llm" | "dit"
        self.dispatches_modeled = False
        self._price_memo: dict = {}
        self._decode_memo: dict = {}   # kv_len -> StepPrice (hot path)
        self._dispatch_memo: dict = {}

    # -- lazy heavy imports --------------------------------------------
    @property
    def tpu(self):
        if self._tpu is None:
            self._tpu = default_hardware()
        return self._tpu

    @property
    def em(self):
        if self._em is None:
            from repro_torch.core.energy import DEFAULT_ENERGY_MODEL
            self._em = DEFAULT_ENERGY_MODEL
        return self._em

    # -- binding -------------------------------------------------------
    def bind_llm(self, model, quant_plan, kv_slots: int) -> None:
        self.model = model
        self.quant_plan = quant_plan
        self.kv_slots = int(kv_slots)
        self.kind = "llm"
        self.dispatches_modeled = plan_covers_model(model, quant_plan)

    def bind_dit(self, model, quant_plan) -> None:
        self.model = model
        self.quant_plan = quant_plan
        self.kind = "dit"
        self.dispatches_modeled = plan_covers_dit(quant_plan)

    # -- pricing -------------------------------------------------------
    def _simulate(self, graph) -> StepPrice:
        from repro_torch.core.simulator import simulate_graph
        gc = simulate_graph(self.tpu, graph, self.em)
        return StepPrice(gc.mxu_energy_j, gc.vpu_energy_j,
                         gc.memory_energy_j, gc.total_macs)

    def _price_llm(self, q_len: int, kv_len: int) -> StepPrice:
        from repro_torch.core.bridge import graph_from_config
        bits = 8 if self.quant_plan is not None else 16
        g = graph_from_config(self.model.cfg, 1, q_len, kv_len, bits=bits,
                              quant_plan=self.quant_plan)
        return self._simulate(g)

    def _decode_anchor(self, kv_len: int) -> StepPrice:
        key = ("decode_anchor", kv_len)
        p = self._price_memo.get(key)
        if p is None:
            p = self._price_memo[key] = self._price_llm(1, kv_len)
        return p

    def price_decode(self, kv_len: int) -> StepPrice:
        """One decode-step row attending ``kv_len`` cache positions.

        Under the analytic model every energy component is exactly
        affine in ``kv_len`` (MAC counts and HBM bytes of the
        attention ops grow linearly, everything else is constant), so
        two anchor simulations at kv 1 and ``kv_slots`` price every
        intermediate cache length to machine precision — a traffic run
        costs two graph simulations, not one per distinct length
        (exactness pinned against direct simulation in
        tests/test_torch_obs.py).
        """
        p = self._decode_memo.get(kv_len)
        if p is None:
            kv = int(kv_len)
            hi = max(2, self.kv_slots)
            if 1 <= kv <= hi:
                lo_p = self._decode_anchor(1)
                hi_p = self._decode_anchor(hi)
                f = (kv - 1) / (hi - 1)
                p = StepPrice(*(a + f * (b - a)
                                for a, b in zip(lo_p, hi_p)))
            else:
                p = self._price_llm(1, kv)
            self._decode_memo[kv_len] = p
        return p

    def price_prefill(self, q_len: int, kv_len: int) -> StepPrice:
        """One prefill (chunk) row: ``q_len`` tokens computed, attending
        a cache of ``kv_len`` positions (chunk offset + chunk)."""
        key = ("prefill", int(q_len), int(kv_len))
        p = self._price_memo.get(key)
        if p is None:
            p = self._price_memo[key] = self._price_llm(int(q_len),
                                                        int(kv_len))
        return p

    def price_dit_eval(self) -> StepPrice:
        """One denoise model evaluation of one latent (batch=1)."""
        p = self._price_memo.get("dit")
        if p is None:
            from repro_torch.core.bridge import dit_graph_from_config
            bits = 8 if self.quant_plan is not None else 16
            g = dit_graph_from_config(self.model.cfg, 1, bits=bits,
                                      quant_plan=self.quant_plan)
            p = self._price_memo["dit"] = self._simulate(g)
        return p

    # -- manifest-derived dispatch counts ------------------------------
    def dispatch_counts(self, phase: str) -> dict:
        """Site-class -> dispatch count for one whole-model step of
        ``phase`` ("prefill" / "decode" / "dit_step"); {} when the
        engine's plan/arch is outside the manifest contract."""
        if not self.dispatches_modeled:
            return {}
        counts = self._dispatch_memo.get(phase)
        if counts is None:
            from repro_torch.analysis import manifest
            if phase == "dit_step":
                c = manifest.dit_sites(self.model.cfg)
            else:
                c = manifest.model_sites(self.model, phase,
                                         kv_len=self.kv_slots
                                         if phase == "decode" else 0)
            counts = self._dispatch_memo[phase] = dict(c)
        return counts
