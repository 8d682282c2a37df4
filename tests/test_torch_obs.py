"""The port's observability (``repro_torch.obs``) against ``repro.obs``, on
the CPU.

* Metrics and traces: the same call sequence gives the same
  ``snapshot()``, ``prometheus_text()`` and ``EventLog.to_jsonl()``
  (exact: both are pure Python).
* Prices: ``price_decode``, ``price_prefill`` and ``price_dit_eval``
  bitwise the reference's at the same keys (the simulator is a copy);
  the joules are the paper's CIM-TPU model, never the card's.
* Dispatch counts: the reference's for gemma-2b-smoke, qwen2-moe-smoke
  and dit-test; ``{}`` with no plan and for the archs without a
  full-plan contract.
* Engines with obs on a step clock, the JAX engine on its oracle path
  (``kernel_mode(False)``): the ring engine's ``snapshot(include_events=
  True)`` equals the reference's with the token ids left out of the
  ``token`` events, and the token streams are held by the margin rule of
  tests/test_torch_serving.py (logits differ by up to 0.15, so a near
  tie may part the streams); the paged engine likewise, token ids left
  out, since the reference's stale write index (ROADMAP C.1) can change
  its tokens; DiT on dit-test with guidance, the port's engine handed
  the JAX engine's noise, snapshots exactly equal and latents within
  the sampler tolerance of tests/test_torch_diffusion.py.
* Obs switched off: the same tokens and latents bitwise, and the span
  close contract on every terminal path of the port's engines.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs import reduced_config as jred
from repro.diffusion import DiffusionEngine as JDiffusion
from repro.diffusion import ImageRequest as JImage
from repro.models import build_model
from repro.obs import EnergyAttribution as JAttribution
from repro.obs import EventLog as JEventLog
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Observability as JObs
from repro.obs import RequestTrace as JTrace
from repro.quant import QuantPlan as JPlan
from repro.quant import kernel_mode
from repro.serving import PagedServingEngine as JPaged
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JRing

from repro_torch.configs import get_config, reduced_config
from repro_torch.diffusion import DiffusionEngine, ImageRequest
from repro_torch.models import Model
from repro_torch.obs import (EnergyAttribution, EventLog, MetricsRegistry,
                             Observability, RequestTrace, plan_covers_dit,
                             plan_covers_model)
from repro_torch.quant import QuantPlan
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import (assert_same_tokens, jax_dit, port_dit,
                          port_model, rel_close, smoke, t)

MARGIN = 0.3       # 2 x the logit tolerance, tests/test_torch_serving.py
X_REL = 2e-2               # the sampler's, tests/test_torch_diffusion.py
RING = dict(n_slots=3, max_len=64, prefill_bucket=16)
PAGED = dict(RING, block_size=8, prefill_chunk=8)


# ---------------------------------------------------------------------------
# metrics and traces
# ---------------------------------------------------------------------------
def _metric_calls(reg):
    c = reg.counter("reqs", "requests")
    c.inc(status="ok")
    c.inc(2.5, status="failed")
    c.add(3.0)
    g = reg.gauge("depth", "queue")
    g.set(4)
    g.set(1.5, slot=2)
    h = reg.histogram("lat", "latency", (1.0, 2.0, 8.0))
    for v in (0.5, 1.5, 1.5, 3.0, 99.0):
        h.observe(v)
    reg.histogram("steps", "default buckets").observe(17.0)
    return (h.quantile(0.5), h.quantile(0.99), h.mean(), c.value(),
            c.value(status="ok"))


def test_metrics_same_calls_same_exports():
    a, b = JRegistry(), MetricsRegistry()
    assert _metric_calls(a) == _metric_calls(b)
    assert a.snapshot() == b.snapshot()
    assert a.to_json() == b.to_json()
    assert a.prometheus_text() == b.prometheus_text()
    a.reset()
    b.reset()
    assert a.snapshot() == b.snapshot()


def test_event_log_and_trace_same_records():
    logs = []
    for cls, trace_cls in ((JEventLog, JTrace), (EventLog, RequestTrace)):
        log = cls(max_events=4)
        log.emit("submit", 0, uid=1, queue_depth=0)
        log.emit("decode", 1.0, uid=1, kv_len=4)
        log.emit("token", 1.0, uid=1, token=7, n=1)
        log.emit("request_end", 2, uid=1, status="ok", error=None)
        log.emit("dropped", 3)
        tr = trace_cls(uid=1, submitted_at=0.0)
        tr.admitted_at, tr.first_token_at, tr.tokens = 1.0, 1.5, 3
        tr.add_energy(1.0, 2.0, 3.0, 4.0)
        tr.close("ok", None, 4.0)
        logs.append((log.to_jsonl(), log.dropped,
                     log.select("decode", uid=1), tr.summary()))
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# attribution: prices and manifest-derived dispatch counts
# ---------------------------------------------------------------------------
def _pair(arch: str, reduced: bool = True):
    jcfg, cfg = jget(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jred(jcfg), reduced_config(cfg)
    return build_model(jcfg), Model(cfg)


@pytest.mark.parametrize("arch,reduced", [
    ("gemma-2b", True), ("qwen2-moe-a2.7b", True), ("gemma-2b", False)])
def test_prices_bitwise(arch, reduced):
    jm, m = _pair(arch, reduced)
    ja, a = JAttribution(), EnergyAttribution()
    ja.bind_llm(jm, JPlan.full(), kv_slots=64)
    a.bind_llm(m, QuantPlan.full(), kv_slots=64)
    for kv in (1, 2, 17, 64, 80):
        assert tuple(a.price_decode(kv)) == tuple(ja.price_decode(kv))
    for q, kv in ((8, 8), (16, 40), (3, 64)):
        assert tuple(a.price_prefill(q, kv)) == \
            tuple(ja.price_prefill(q, kv))
    # the decode interpolation is exact against direct simulation
    for kv in (2, 23, 40):
        for x, y in zip(a.price_decode(kv), a._price_llm(1, kv)):
            assert x == pytest.approx(y, rel=1e-9)


def test_dit_price_bitwise_and_coverage():
    jcfg, jm, _, _ = jax_dit()
    from repro_torch.configs import get_dit_config
    from repro_torch.models.dit import DiTModel
    m = DiTModel(get_dit_config(jcfg.name))
    for jplan, plan in ((JPlan.full(), QuantPlan.full()), (None, None)):
        ja, a = JAttribution(), EnergyAttribution()
        ja.bind_dit(jm, jplan)
        a.bind_dit(m, plan)
        assert tuple(a.price_dit_eval()) == tuple(ja.price_dit_eval())
        assert a.dispatch_counts("dit_step") == ja.dispatch_counts(
            "dit_step")
    assert plan_covers_dit(QuantPlan.full()) and not plan_covers_dit(None)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-moe-a2.7b"])
def test_dispatch_counts_match_reference(arch):
    jm, m = _pair(arch)
    for kv_slots in (64, 4096):
        ja, a = JAttribution(), EnergyAttribution()
        ja.bind_llm(jm, JPlan.full(), kv_slots=kv_slots)
        a.bind_llm(m, QuantPlan.full(), kv_slots=kv_slots)
        assert a.dispatches_modeled and plan_covers_model(m,
                                                          QuantPlan.full())
        for phase in ("prefill", "decode"):
            assert a.dispatch_counts(phase) == ja.dispatch_counts(phase)
            assert sum(a.dispatch_counts(phase).values()) > 0


@pytest.mark.parametrize("arch,plan", [
    ("gemma-2b", None), ("gemma-2b", QuantPlan(mlp=False)),
    ("zamba2-1.2b", QuantPlan.full()), ("xlstm-350m", QuantPlan.full()),
    ("deepseek-v3-671b", QuantPlan.full())])
def test_no_contract_books_nothing(arch, plan):
    _, m = _pair(arch)
    a = EnergyAttribution()
    a.bind_llm(m, plan, kv_slots=64)
    assert not a.dispatches_modeled
    assert a.dispatch_counts("decode") == {} == a.dispatch_counts("prefill")


# ---------------------------------------------------------------------------
# instrumented engines against the reference's
# ---------------------------------------------------------------------------
def _prompts(n=4, seed=3, max_prompt=14):
    r = np.random.default_rng(seed)
    return [r.integers(1, 256, int(r.integers(1, max_prompt))
                       ).astype(np.int32) for _ in range(n)]


def _drive(eng, reqs, tick, max_iters=500):
    """Step-clocked drain: submit everything, one clock tick per step."""
    for r in reqs:
        eng.submit(r)
    for _ in range(max_iters):
        if not eng.pending():
            return
        eng.step()
        tick[0] += 1
    raise AssertionError("engine did not drain")


def _serve_jax(cls, kw, prompts, new=4):
    _, jm, params = smoke()
    tick, obs = [0], JObs()
    eng = cls(jm, params, quant_plan=JPlan.full(), obs=obs,
              clock=lambda: float(tick[0]), **kw)
    margins = {}
    sample = eng._sample

    def recording(req, logits, step):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        margins[(req.uid, step)] = top[1] - top[0]
        return sample(req, logits, step)
    eng._sample = recording
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    with kernel_mode(False):
        _drive(eng, reqs, tick)
    return obs, reqs, margins


def _serve_port(cls, kw, prompts, obs, new=4):
    tick = [0]
    eng = cls(port_model(), quant_plan=QuantPlan.full(), obs=obs,
              clock=lambda: float(tick[0]), **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    _drive(eng, reqs, tick)
    return eng, reqs


def _without_token_ids(snap: dict) -> dict:
    snap = dict(snap)
    snap["events"] = [{k: v for k, v in e.items() if k != "token"}
                      for e in snap["events"]]
    return json.loads(json.dumps(snap, sort_keys=True))


@pytest.mark.parametrize("name,jcls,cls,kw", [
    ("ring", JRing, ServingEngine, RING),
    ("paged", JPaged, PagedServingEngine, PAGED)])
def test_engine_snapshot_matches_reference(name, jcls, cls, kw):
    prompts = _prompts()
    jobs, jreqs, margins = _serve_jax(jcls, kw, prompts)
    obs = Observability()
    eng, reqs = _serve_port(cls, kw, prompts, obs)
    assert all(r.status is RequestStatus.OK for r in reqs)
    a = jobs.snapshot(include_events=True)
    b = obs.snapshot(include_events=True)
    assert _without_token_ids(b) == _without_token_ids(a)
    assert [e["event"] for e in b["events"]] == \
        [e["event"] for e in a["events"]]
    if name == "ring":
        assert_same_tokens(jreqs, margins, [r.generated for r in reqs],
                           MARGIN, name)
    # every decode event was booked on some request's span, and the
    # booked dispatches are the manifest's per batched forward
    assert sum(tr.decode_steps for tr in obs.traces.values()) == \
        len(obs.events.select("decode"))
    per = obs.attribution.dispatch_counts("decode")
    booked = b["metrics"]["counters"]["dispatches_total"]["series"]
    n_fwd = eng.stats.decode_steps
    pre = obs.attribution.dispatch_counts("prefill")
    n_pre = eng.stats.prefill_chunks if name == "paged" \
        else eng.stats.prefills
    for site in set(per) | set(pre):
        assert booked[f"site={site}"] == \
            per.get(site, 0) * n_fwd + pre.get(site, 0) * n_pre


def test_dit_engine_snapshot_matches_reference():
    """dit-test with guidance (two evaluations an image a step) and a
    short batch; the port's engine samples from the JAX engine's noise."""
    _, jm, params, _ = jax_dit()
    tick, jobs = [0], JObs()
    jeng = JDiffusion(jm, params, batch_size=2, quant_plan=JPlan.full(),
                      obs=jobs, clock=lambda: float(tick[0]))
    spec = [(4, 2, 2.0), (5, 2, 2.0), (6, 3, 0.0)]
    jreqs = [JImage(uid=i, label=y, num_steps=n, cfg_scale=w, seed=7)
             for i, (y, n, w) in enumerate(spec)]
    _drive(jeng, jreqs, tick)
    noise = {r.uid: t(np.asarray(jeng._noise(r))) for r in jreqs}
    tick2, obs = [0], Observability()
    eng = DiffusionEngine(port_dit(False), batch_size=2,
                          quant_plan=QuantPlan.full(), obs=obs,
                          clock=lambda: float(tick2[0]))
    eng._noise = lambda r: noise[r.uid]
    reqs = [ImageRequest(uid=i, label=y, num_steps=n, cfg_scale=w, seed=7)
            for i, (y, n, w) in enumerate(spec)]
    _drive(eng, reqs, tick2)
    assert obs.snapshot(include_events=True) == \
        jobs.snapshot(include_events=True)
    c = obs.snapshot()["metrics"]["counters"]
    assert c["denoise_evals_total"]["series"][""] == 2 * 2 * 2 + 3
    assert c["images_total"]["series"][""] == 3
    for r, jr in zip(reqs, jreqs):
        rel_close(r.latents, jr.latents, X_REL)


# ---------------------------------------------------------------------------
# obs switched off; the span-close contract on the port's engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls,kw", [(ServingEngine, RING),
                                    (PagedServingEngine, PAGED)])
def test_obs_off_is_bitwise_the_same(cls, kw):
    prompts = _prompts(5, seed=4)
    runs = []
    for obs in (None, Observability(), None):
        eng, reqs = _serve_port(cls, kw, prompts, obs, new=6)
        runs.append(([r.generated for r in reqs],
                     [r.status for r in reqs], eng.stats.decode_steps))
        assert eng.obs is obs
    assert runs[0] == runs[1] == runs[2]


def test_dit_obs_off_is_bitwise_the_same():
    lats = []
    for obs in (None, Observability()):
        eng = DiffusionEngine(port_dit(False), batch_size=2,
                              quant_plan=QuantPlan.full(), obs=obs)
        reqs = [ImageRequest(uid=i, label=i, num_steps=2, cfg_scale=1.5)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        lats.append(np.stack([r.latents for r in reqs]))
    assert np.array_equal(lats[0], lats[1])


def _closed_once(obs, reqs):
    ends = obs.events.select("request_end")
    assert sorted(e["uid"] for e in ends) == sorted(r.uid for r in reqs)
    for r in reqs:
        (e,) = obs.events.select("request_end", uid=r.uid)
        assert e["status"] == r.status.value and obs.traces[r.uid].closed


def test_spans_close_once_on_every_terminal_path():
    m = port_model(QuantPlan.full())
    # deadlines: queued and mid-decode
    now, obs = [0.0], Observability()
    eng = ServingEngine(m, n_slots=1, max_len=32, prefill_bucket=4,
                        clock=lambda: now[0], obs=obs)
    active, queued = (Request(uid=i, prompt=p, max_new_tokens=20,
                              deadline_s=1.0)
                      for i, p in enumerate(_prompts(2)))
    eng.submit(active)
    eng.submit(queued)
    eng.step()
    now[0] = 2.0
    eng.step()
    _closed_once(obs, [active, queued])
    ends = {e["uid"]: e for e in obs.events.select("request_end")}
    assert "mid-decode" in ends[active.uid]["error"]
    assert "queued" in ends[queued.uid]["error"]
    # rejections, a failed slot, a stall timeout
    obs = Observability()
    hits = []

    def poison_first_decode(phase, logits):
        if phase == "decode" and not hits:
            hits.append(1)
            out = np.array(logits, copy=True)
            out[0, 0] = np.nan
            return out
        return None
    eng = ServingEngine(m, n_slots=2, max_len=32, prefill_bucket=4, obs=obs,
                        fault_hook=poison_first_decode)
    bad = Request(uid=90, prompt=np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(bad)
    victim, bystander = (Request(uid=i, prompt=p, max_new_tokens=4)
                         for i, p in enumerate(_prompts(2)))
    eng.submit(victim)
    eng.submit(bystander)
    eng.run_until_done()
    stalled = Request(uid=7, prompt=_prompts(1)[0], max_new_tokens=20)
    eng.submit(stalled)
    eng.run_until_done(max_iters=0, on_stall="timeout")
    eng.shutdown()
    late = Request(uid=91, prompt=_prompts(1)[0])
    assert eng.submit(late) is RequestStatus.REJECTED
    assert victim.status is RequestStatus.FAILED and bystander.ok
    assert stalled.status is RequestStatus.TIMED_OUT
    _closed_once(obs, [bad, victim, bystander, stalled, late])
    c = obs.snapshot()["metrics"]["counters"]["requests_total"]["series"]
    assert c == {"status=rejected": 2.0, "status=failed": 1.0,
                 "status=ok": 1.0, "status=timed_out": 1.0}


def test_paged_preemption_and_pool_exhaustion_book_and_close_once():
    m = port_model(QuantPlan.full())
    tick, obs = [0], Observability()
    eng = PagedServingEngine(m, obs=obs, clock=lambda: float(tick[0]),
                             **dict(PAGED, n_slots=4, num_blocks=9))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts(6, seed=1, max_prompt=20))]
    occ = []
    for r in reqs:
        eng.submit(r)
    while eng.pending():
        eng.step()
        tick[0] += 1
        occ.append(obs.kv_occupancy.value())
        assert 0.0 <= obs.kv_fragmentation.value() < 1.0
    assert all(r.ok for r in reqs) and eng.stats.preemptions >= 1
    _closed_once(obs, reqs)
    assert max(occ) > 0.0 and occ[-1] == 0.0
    c = obs.snapshot()["metrics"]["counters"]
    assert c["preemptions_total"]["series"][""] == eng.stats.preemptions
    assert c["evicted_blocks_total"]["series"][""] == \
        eng.stats.evicted_blocks
    pre = obs.events.select("preempt")
    assert any(e["resumed"] for e in obs.events.select(
        "admit", uid=pre[0]["uid"]))
    # a pool too small for one request: it fails, counted and closed
    obs = Observability()
    eng = PagedServingEngine(m, obs=obs, **dict(PAGED, n_slots=1,
                                                num_blocks=3))
    req = Request(uid=0, prompt=np.ones(12, np.int32), max_new_tokens=32)
    eng.submit(req)
    eng.run_until_done()
    assert req.status is RequestStatus.FAILED
    assert obs.pool_exhaustions_total.value() == 1
    assert len(obs.events.select("pool_exhausted")) == 1
    _closed_once(obs, [req])


def test_chaos_hooks_reach_obs():
    """The port's ChaosMonkey books its injections on the engine's obs
    (``reliability/chaos.py`` calls ``engine.obs.on_chaos``)."""
    from repro_torch.reliability import chaos_soak
    obs = Observability()
    eng = ServingEngine(port_model(QuantPlan.full()), n_slots=2, max_len=32,
                        prefill_bucket=4, obs=obs)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4, deadline_s=60.0)
            for i, p in enumerate(_prompts(4))]
    chaos_soak(eng, reqs, ber=1e-3, seed=3, period=1, logit_nan_rate=0.5)
    _closed_once(obs, reqs)
    booked = obs.snapshot()["metrics"]["counters"][
        "chaos_injections_total"]["series"]
    assert set(booked) == {"kind=weight_injection", "kind=logit_nan"}
    assert sum(booked.values()) == len(obs.events.select("chaos"))
