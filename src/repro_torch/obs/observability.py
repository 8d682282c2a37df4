"""The Observability facade the engines call into (port of
``repro/obs/observability.py``).

One :class:`Observability` instance pairs a :class:`MetricsRegistry`
(counters/gauges/histograms), an :class:`EventLog` + per-request
:class:`RequestTrace` map, and an :class:`EnergyAttribution` pricer.
Engines built with ``obs=Observability()`` call the ``on_*`` hooks at
their scheduling points; engines built without one skip every hook
behind a single ``if self.obs is not None`` — the disabled path touches
no obs code at all, so engine outputs stay bitwise-identical and the
launch counts are untouched (pinned in tests/test_torch_obs.py).  The
hooks read host values only (ints, floats, the request objects): they
add no device-to-host sync.

All hooks take ``now`` from the engine's injectable clock, never
``time.monotonic`` directly — a step-clocked engine produces fully
deterministic logs and histograms.
"""
from __future__ import annotations

from typing import Optional

from .attribution import EnergyAttribution, StepPrice
from .metrics import MetricsRegistry, STEP_BUCKETS, linear_buckets
from .tracing import EventLog, RequestTrace

TOKEN_BUCKETS = linear_buckets(4, 4, 16) + (96.0, 128.0, 192.0, 256.0)


class Observability:
    """Shared instrumentation substrate for one engine (or one
    engine-per-phase reuse via :meth:`reset`)."""

    def __init__(self, hardware=None, energy_model=None,
                 max_events: Optional[int] = None):
        self.registry = MetricsRegistry()
        self.events = EventLog(max_events=max_events)
        self.traces: dict[int, RequestTrace] = {}
        self.attribution = EnergyAttribution(hardware, energy_model)
        r = self.registry
        # the metric names and help strings are the reference's, so that
        # the two packages' snapshots compare equal; "dispatches" are the
        # manifest's launches by site class and the energy is the paper's
        # CIM-TPU model (attribution.py), not the card's
        # counters
        self.requests_total = r.counter(
            "requests_total", "requests by terminal status")
        self.tokens_total = r.counter(
            "tokens_total", "generated tokens delivered")
        self.prefills_total = r.counter(
            "prefills_total", "completed request prefills")
        self.prefill_chunks_total = r.counter(
            "prefill_chunks_total", "chunked-prefill dispatches")
        self.decode_steps_total = r.counter(
            "decode_steps_total", "batched decode dispatches")
        self.preemptions_total = r.counter(
            "preemptions_total", "sequences evicted under pool pressure")
        self.evicted_blocks_total = r.counter(
            "evicted_blocks_total", "KV blocks freed by preemption")
        self.pool_exhaustions_total = r.counter(
            "pool_exhaustions_total", "KV pool allocation failures")
        self.chaos_total = r.counter(
            "chaos_injections_total", "chaos faults injected, by kind")
        self.dispatches_total = r.counter(
            "dispatches_total",
            "modeled Pallas dispatches by manifest site class")
        self.energy_joules_total = r.counter(
            "energy_joules_total",
            "modeled energy by component (mxu/vpu/memory)")
        self.macs_total = r.counter("macs_total", "modeled MACs")
        self.images_total = r.counter(
            "images_total", "diffusion images delivered")
        self.denoise_evals_total = r.counter(
            "denoise_evals_total", "DiT denoise model evaluations")
        # gauges
        self.queue_depth = r.gauge("queue_depth", "requests waiting")
        self.slots_active = r.gauge(
            "slots_active", "slots decoding this step")
        self.kv_occupancy = r.gauge(
            "kv_occupancy", "fraction of the allocatable KV pool in use")
        self.kv_fragmentation = r.gauge(
            "kv_fragmentation",
            "1 - used positions / allocated positions (block padding)")
        self.energy_mxu_fraction = r.gauge(
            "energy_mxu_fraction", "MXU share of total modeled energy")
        # histograms (engine-clock units: steps under a step clock)
        self.queue_wait_hist = r.histogram(
            "queue_wait_steps", "submit -> first admission", STEP_BUCKETS)
        self.ttft_hist = r.histogram(
            "ttft_steps", "submit -> first token", STEP_BUCKETS)
        self.itl_hist = r.histogram(
            "itl_steps", "mean inter-token latency per request",
            STEP_BUCKETS)
        self.tokens_hist = r.histogram(
            "tokens_per_request", "generated tokens per finished request",
            TOKEN_BUCKETS)
        # hot-path state: energy accumulates in plain floats and is
        # flushed to the counter series once per engine hook, not once
        # per batch row (the hooks run host-side inside the serve loop,
        # so per-row label-key hashing would dominate obs overhead)
        self._e_mxu = self._e_vpu = self._e_mem = self._e_macs = 0.0
        self._mxu_key = (("component", "mxu"),)
        self._vpu_key = (("component", "vpu"),)
        self._mem_key = (("component", "memory"),)
        self._dispatch_keys: dict = {}

    # -- engine binding -------------------------------------------------
    def bind_llm_engine(self, engine) -> None:
        self.attribution.bind_llm(engine.model, engine.quant_plan,
                                  engine._obs_kv_slots())

    def bind_dit_engine(self, engine) -> None:
        self.attribution.bind_dit(engine.model, engine.quant_plan)

    # -- internals ------------------------------------------------------
    def _trace(self, req) -> RequestTrace:
        t = self.traces.get(req.uid)
        if t is None:
            t = self.traces[req.uid] = RequestTrace(
                uid=req.uid, submitted_at=float(req.submitted_at))
        return t

    def _book_price(self, trace: RequestTrace, p: StepPrice) -> None:
        trace.add_energy(p.mxu_j, p.vpu_j, p.memory_j, p.macs)
        self._e_mxu += p.mxu_j
        self._e_vpu += p.vpu_j
        self._e_mem += p.memory_j
        self._e_macs += p.macs

    def _flush_energy(self) -> None:
        s = self.energy_joules_total.series
        s[self._mxu_key] = self._e_mxu
        s[self._vpu_key] = self._e_vpu
        s[self._mem_key] = self._e_mem
        self.macs_total.series[()] = self._e_macs
        total = self._e_mxu + self._e_vpu + self._e_mem
        if total > 0:
            self.energy_mxu_fraction.series[()] = self._e_mxu / total

    def _book_dispatches(self, phase: str, n: int = 1) -> None:
        pairs = self._dispatch_keys.get(phase)
        if pairs is None:
            pairs = self._dispatch_keys[phase] = [
                ((("site", site),), count) for site, count in
                self.attribution.dispatch_counts(phase).items()]
        s = self.dispatches_total.series
        for key, count in pairs:
            s[key] = s.get(key, 0.0) + count * n

    # -- lifecycle hooks ------------------------------------------------
    def on_submit(self, req, now: float, queue_depth: int) -> None:
        t = self._trace(req)
        t.submitted_at = float(now)
        self.queue_depth.set(queue_depth)
        self.events.emit("submit", now, uid=req.uid,
                         queue_depth=queue_depth)

    def on_admit(self, req, slot: int, now: float,
                 resumed: bool = False) -> None:
        t = self._trace(req)
        if t.admitted_at is None:
            t.admitted_at = float(now)
            self.queue_wait_hist.observe(t.queue_wait)
        self.events.emit("admit", now, uid=req.uid, slot=slot,
                         resumed=resumed)

    def on_prefill(self, req, q_len: int, kv_len: int, now: float,
                   chunk: bool = False, offset: int = 0) -> None:
        t = self._trace(req)
        t.prefill_chunks += 1
        if chunk:
            self.prefill_chunks_total.add()
        self._book_price(t, self.attribution.price_prefill(q_len, kv_len))
        self._book_dispatches("prefill")
        self._flush_energy()
        self.events.emit("prefill", now, uid=req.uid, q_len=q_len,
                         kv_len=kv_len, chunk=chunk, offset=offset)

    def on_prefill_done(self, req, now: float) -> None:
        self.prefills_total.add()

    def on_first_token(self, req, now: float) -> None:
        t = self._trace(req)
        t.first_token_at = float(now)
        self.ttft_hist.observe(t.ttft)
        self.events.emit("first_token", now, uid=req.uid,
                         ttft_steps=t.ttft)

    def on_decode_rows(self, rows, now: float) -> None:
        """One batched decode dispatch; ``rows`` is [(req, kv_len)] for
        every row the step actually computed."""
        self.decode_steps_total.add()
        self._book_dispatches("decode")
        self.slots_active.series[()] = float(len(rows))
        emit = self.events.emit
        traces = self.traces
        price = self.attribution.price_decode
        for req, kv_len in rows:
            t = traces.get(req.uid)
            if t is None:
                t = self._trace(req)
            t.decode_steps += 1
            self._book_price(t, price(kv_len))
            emit("decode", now, uid=req.uid, kv_len=kv_len)
        self._flush_energy()

    def on_token(self, req, token: int, now: float) -> None:
        t = self._trace(req)
        t.tokens += 1
        self.tokens_total.add()
        self.events.emit("token", now, uid=req.uid, token=int(token),
                         n=t.tokens)

    def on_preempt(self, req, slot: int, freed_blocks: int,
                   now: float) -> None:
        t = self._trace(req)
        t.preemptions += 1
        self.preemptions_total.add()
        self.evicted_blocks_total.add(freed_blocks)
        self.events.emit("preempt", now, uid=req.uid, slot=slot,
                         freed_blocks=freed_blocks)

    def on_pool_exhausted(self, req, slot: int, now: float) -> None:
        self.pool_exhaustions_total.add()
        self.events.emit("pool_exhausted", now, uid=req.uid, slot=slot)

    def on_kv_state(self, occupancy: float, fragmentation: float) -> None:
        self.kv_occupancy.series[()] = float(occupancy)
        self.kv_fragmentation.series[()] = float(fragmentation)

    def on_chaos(self, kind: str, now: float, **detail) -> None:
        self.chaos_total.inc(kind=kind)
        self.events.emit("chaos", now, kind=kind, **detail)

    def on_denoise_batch(self, reqs, evals_per_image: int,
                         now: float) -> None:
        """One batched sampler dispatch delivering ``len(reqs)`` images
        of ``evals_per_image`` denoise evaluations each."""
        self.denoise_evals_total.add(evals_per_image * len(reqs))
        self._book_dispatches("dit_step", evals_per_image * len(reqs))
        price = self.attribution.price_dit_eval()
        for req in reqs:
            t = self._trace(req)
            if t.admitted_at is None:
                t.admitted_at = float(now)
                self.queue_wait_hist.observe(t.queue_wait)
            for _ in range(evals_per_image):
                t.decode_steps += 1
                self._book_price(t, price)
        self._flush_energy()
        self.events.emit("denoise_batch", now,
                         uids=[r.uid for r in reqs],
                         evals=evals_per_image, batch=len(reqs))

    def on_finish(self, req, status, error: Optional[str],
                  now: float) -> None:
        """Span close — called by the engines' ``_finish`` right after
        ``LifecycleMixin.finish`` succeeded, so it fires exactly once
        per request on every terminal path."""
        t = self._trace(req)
        t.tokens = len(getattr(req, "generated", ()) or ())
        if getattr(req, "latents", None) is not None:
            self.images_total.inc()
        t.close(status.value, error, float(now))
        self.requests_total.inc(status=status.value)
        if t.tokens:
            self.tokens_hist.observe(t.tokens)
        if t.itl is not None:
            self.itl_hist.observe(t.itl)
        self.events.emit("request_end", now, uid=req.uid,
                         status=status.value, error=error,
                         tokens=t.tokens, joules=t.joules)

    # -- export ---------------------------------------------------------
    def snapshot(self, include_events: bool = False) -> dict:
        out = {
            "metrics": self.registry.snapshot(),
            "requests": [self.traces[u].summary()
                         for u in sorted(self.traces)],
            "dropped_events": self.events.dropped,
        }
        if include_events:
            out["events"] = list(self.events)
        return out

    def reset(self) -> None:
        self.registry.reset()
        self.events.clear()
        self.traces.clear()
        self._e_mxu = self._e_vpu = self._e_mem = self._e_macs = 0.0
