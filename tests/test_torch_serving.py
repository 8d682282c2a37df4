"""The port's ring-cache ServingEngine against the JAX engine, on the CPU.

Both engines serve the same greedy requests over the same
``gemma-2b-smoke`` weights (the JAX engine on its oracle path).  Logits
differ by up to ``LOGIT_ATOL`` (see tests/test_torch_model.py), so
tokens are compared at every step where the reference's top-2 logit
margin exceeds ``MARGIN = 2 * LOGIT_ATOL``, up to the first step where it
does not (after a near tie the two streams may rightly part).  Every
request must end OK.  The rest pins the engine's lifecycle: typed
rejections, deadlines, health checks, drain and shutdown.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.quant import QuantPlan as JPlan
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch.quant import QuantPlan
from repro_torch.serving import (EngineStallError, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import port_model, rng, smoke

LOGIT_ATOL = 0.15
MARGIN = 2 * LOGIT_ATOL
PROMPT_LENS = (3, 17, 9, 30, 5)


def _prompts():
    r = rng(30)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _serve_jax(jplan):
    _, jm, params = smoke()
    eng = JEngine(jm, params, n_slots=3, max_len=64, prefill_bucket=16,
                  quant_plan=jplan)
    margins = {}
    sample = eng._sample

    def recording(req, logits, step):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        margins[(req.uid, step)] = top[1] - top[0]
        return sample(req, logits, step)
    eng._sample = recording
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return reqs, margins


def _serve_port(plan, **kw):
    eng = ServingEngine(port_model(), n_slots=3, max_len=64,
                        prefill_bucket=16, quant_plan=plan, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs


@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
def test_greedy_tokens_match_jax_engine(name, jplan, plan):
    jreqs, margins = _serve_jax(jplan)
    eng, reqs = _serve_port(plan)
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert all(r.status.value == "ok" for r in jreqs)
    compared = total = 0
    for jr, r in zip(jreqs, reqs):
        assert len(r.generated) == len(jr.generated) == 8
        for step, (a, b) in enumerate(zip(jr.generated, r.generated)):
            total += 1
            if margins[(jr.uid, step)] <= MARGIN:
                break
            assert a == b, (name, jr.uid, step, jr.generated, r.generated)
            compared += 1
    # the rule must leave most tokens compared to mean anything
    assert compared >= total // 2, (compared, total)
    assert eng.stats.completed == 5 and eng.stats.prefills == 5
    assert eng.kv_dtype == ("int8" if plan is not None else None)


def test_sampler_matches_reference():
    """The host sampler is the reference's, line for line: the same
    logits and seed give the same token, greedy or sampled."""
    r = rng(31)
    for k in range(20):
        logits = r.standard_normal(256).astype(np.float32) * 3
        if k % 5 == 0:
            logits[r.integers(0, 256, 4)] = np.nan
        req = Request(uid=k, prompt=np.ones(2, np.int32), temperature=0.8,
                      top_k=(0, 40)[k % 2], seed=7)
        for step in range(3):
            assert ServingEngine._sample(None, req, logits, step) == \
                JEngine._sample(None, req, logits, step)
    req = Request(uid=0, prompt=np.ones(2, np.int32))
    assert ServingEngine._sample(None, req, np.full(4, np.nan), 0) == 0


# ---------------------------------------------------------------------------
# lifecycle of the port's engine
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _engine(**kw):
    kw.setdefault("n_slots", 2)
    return ServingEngine(port_model(), max_len=32, prefill_bucket=8, **kw)


def _req(uid, n=4, **kw):
    return Request(uid=uid, prompt=np.arange(1, n + 1, dtype=np.int32), **kw)


def test_submit_rejects_malformed_prompts():
    eng = _engine()
    empty = Request(uid=0, prompt=np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(empty)
    assert empty.status is RequestStatus.REJECTED
    long = _req(1, n=30)
    with pytest.raises(ValueError, match="wrap"):
        eng.submit(long)
    assert long.status is RequestStatus.REJECTED
    assert eng.stats.rejected == 2


def test_bounded_queue_backpressure():
    eng = _engine(max_queue=1)
    assert eng.submit(_req(0)) is RequestStatus.QUEUED
    second = _req(1)
    assert eng.submit(second) is RequestStatus.REJECTED
    assert "backpressure" in second.error


def test_deadlines_expire_queued_and_active_work():
    clock = _Clock()
    eng = _engine(n_slots=1, clock=clock)
    active = _req(0, max_new_tokens=20, deadline_s=5.0)
    queued = _req(1, deadline_s=1.0)
    eng.submit(active)
    eng.submit(queued)
    eng.step()
    assert active.status is RequestStatus.ACTIVE
    clock.now = 10.0
    eng.step()
    assert active.status is RequestStatus.TIMED_OUT
    assert queued.status is RequestStatus.TIMED_OUT
    assert eng.pending() == 0 and eng.stats.timed_out == 2


def test_health_check_fails_nonfinite_prefill():
    eng = _engine()
    with torch.no_grad():
        eng.model.final_norm.fill_(float("nan"))
    req = _req(0)
    eng.submit(req)
    eng.run_until_done()
    assert req.status is RequestStatus.FAILED
    assert eng.stats.prefill_failures == 1


def test_drain_and_shutdown():
    eng = _engine(n_slots=1)
    a, b = _req(0, max_new_tokens=3), _req(1, max_new_tokens=3)
    eng.submit(a)
    eng.submit(b)
    eng.drain()
    assert a.ok and b.ok
    late = _req(2)
    assert eng.submit(late) is RequestStatus.REJECTED

    eng = _engine(n_slots=1)
    a, b = _req(0, max_new_tokens=10), _req(1)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    eng.shutdown(drain=False)
    assert a.status is RequestStatus.FAILED
    assert b.status is RequestStatus.REJECTED


def test_stall_is_never_silent():
    eng = _engine()
    eng.submit(_req(0, max_new_tokens=10))
    with pytest.raises(EngineStallError):
        eng.run_until_done(max_iters=2)
    eng.run_until_done(max_iters=1, on_stall="timeout")
    assert eng.pending() == 0 and eng.stats.timed_out == 1


def test_prefill_writes_only_its_slot():
    eng = _engine(n_slots=2, quant_plan=QuantPlan.full())
    eng.submit(_req(0, n=5))
    eng.step()                                  # slot 0 prefilled + decode
    before = [{k: v[0].clone() for k, v in c.items()} for c in eng.cache]
    eng._prefill_one(np.arange(8, dtype=np.int32), 1, 6)
    for c, b in zip(eng.cache, before):
        for k, v in c.items():
            assert torch.equal(v[0], b[k]), k
        assert int(c["index"][1]) == 6
        assert int(c["pos"][1, 5]) == 5 and int(c["pos"][1, 6]) == 2 ** 30


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--device", "cpu", "--reduced", "--int8",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--max-len", "32"])
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert all(len(r.generated) == 4 for r in reqs)
    assert "served 3 requests on cpu" in capsys.readouterr().out
