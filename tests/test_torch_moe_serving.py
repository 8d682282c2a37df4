"""The port's engines serving ``qwen2-moe-a2.7b-smoke`` against the JAX
engines, on the CPU.

Greedy tokens must be equal step for step up to the first step where
the two streams part, and that step must be a near tie: the reference's
top-2 logit margin there at most ``MARGIN`` (the logits differ by up to
``LOGIT_ATOL``, see tests/test_torch_model.py).  At least half of all
steps must be compared equal.

* The ring engine against a fresh JAX ``ServingEngine``.
* The paged engine against fresh JAX ``PagedServingEngine``s, never
  against the ring engine: MoE capacity is per row of each forward, so
  a chunked prefill drops other tokens than a whole-bucket prefill.
  Each request runs alone in its own one-slot JAX engine, because the
  reference writes a chunk from the cache's current write index
  (ROADMAP C.1): a slot reused after another sequence writes its first
  chunk past its own blocks, and a decode step that interleaves with a
  chunked prefill leaves the filling row's index at the empty sentinel,
  so its next chunk's KV is dropped.  The port sets the index to the
  chunk's offset first, so it serves all five requests in five slots,
  and again in one slot, with the same tokens.
* The launch schedule of the full plan, counted on the CPU by spying on
  the kernel entry points: 9 launches per MoE layer per decode step and
  8 per prefill forward, whatever the number of experts.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.quant import QuantPlan as JPlan
from repro.serving import PagedServingEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import launch_counts, ops
from repro_torch.quant import QuantPlan
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import port_model, rng, smoke

ARCH = "qwen2-moe-a2.7b"
LOGIT_ATOL = 0.15          # tests/test_torch_model.py
MARGIN = 2 * LOGIT_ATOL
PROMPT_LENS = (3, 17, 9, 30, 5)
RING_KW = dict(n_slots=3, max_len=64, prefill_bucket=16)
PAGED_KW = dict(max_len=64, prefill_bucket=16, block_size=8,
                prefill_chunk=8)
PLANS = [("full", JPlan.full(), QuantPlan.full()), ("none", None, None)]


def _prompts():
    r = rng(30)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _serve_jax(engine_cls, jplan, uids=None, **kw):
    """Serve the prompts ``uids`` (default all) on a fresh JAX engine;
    returns the requests and the top-2 margin of every sampled step."""
    _, jm, params = smoke(ARCH)
    eng = engine_cls(jm, params, quant_plan=jplan, **kw)
    margins = {}
    sample = eng._sample

    def recording(req, logits, step):
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        margins[(req.uid, step)] = top[1] - top[0]
        return sample(req, logits, step)
    eng._sample = recording
    prompts = _prompts()
    reqs = [JRequest(uid=i, prompt=prompts[i], max_new_tokens=8)
            for i in (range(len(prompts)) if uids is None else uids)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.status.value == "ok" for r in reqs)
    return reqs, margins


def _serve_port(engine_cls, plan, **kw):
    eng = engine_cls(port_model(None, ARCH), quant_plan=plan, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.status is RequestStatus.OK for r in reqs)
    return eng, reqs


def _same_tokens(jreqs, margins, reqs, name):
    compared = total = 0
    for jr, r in zip(jreqs, reqs):
        assert len(r.generated) == len(jr.generated) == 8
        total += 8
        for step, (a, b) in enumerate(zip(jr.generated, r.generated)):
            if a != b:
                assert margins[(jr.uid, step)] <= MARGIN, (
                    name, jr.uid, step, jr.generated, r.generated)
                break
            compared += 1
    assert compared >= total // 2, (compared, total)


@pytest.mark.parametrize("name,jplan,plan", PLANS)
def test_ring_greedy_tokens_match_jax_engine(name, jplan, plan):
    jreqs, margins = _serve_jax(JEngine, jplan, **RING_KW)
    eng, reqs = _serve_port(ServingEngine, plan, **RING_KW)
    _same_tokens(jreqs, margins, reqs, name)
    assert eng.stats.completed == 5 and eng.stats.prefills == 5
    assert eng.kv_dtype == ("int8" if plan is not None else None)


@pytest.mark.parametrize("name,jplan,plan", PLANS)
def test_paged_greedy_tokens_match_jax_paged_engine(name, jplan, plan):
    jreqs, margins = [], {}
    for uid in range(len(PROMPT_LENS)):
        one, m = _serve_jax(JPagedEngine, jplan, [uid], n_slots=1,
                            **PAGED_KW)
        jreqs += one
        margins.update(m)
    eng, reqs = _serve_port(PagedServingEngine, plan, n_slots=5,
                            **PAGED_KW)
    _same_tokens(jreqs, margins, reqs, name)
    assert eng.stats.prefill_chunks == sum(-(-n // 8) for n in PROMPT_LENS)
    eng.paged.allocator.check()
    assert eng.paged.allocator.n_used == 0
    _, one = _serve_port(PagedServingEngine, plan, n_slots=1, **PAGED_KW)
    assert [r.generated for r in one] == [r.generated for r in reqs]


class _Spy:
    """Counts calls of the kernel entry points that ``ops`` and the
    attention layer reach (what a launch is on the card)."""

    NAMES = ("quantize_rows_int8", "cim_gemm_int8_fused_qin",
             "cim_gemm_int8_fused", "cim_gated_gemm_int8",
             "cim_grouped_gemm_int8", "cim_grouped_gated_gemm_int8")

    def __init__(self, monkeypatch):
        self.counts = dict.fromkeys(self.NAMES + ("decode_attention",), 0)
        for name in self.NAMES:
            monkeypatch.setattr(ops, name, self._wrap(name,
                                                      getattr(ops, name)))
        monkeypatch.setattr(da, "decode_attention",
                            self._wrap("decode_attention",
                                       da.decode_attention))

    def _wrap(self, name, fn):
        def spy(*a, **kw):
            self.counts[name] += 1
            return fn(*a, **kw)
        return spy


def test_full_plan_launch_schedule(monkeypatch):
    """Per MoE layer and forward: QKV 1, out-proj 1, row quantize 2
    (stacked expert rows, shared input), grouped gated 1 (requant fused),
    grouped down 1, gated 1 (requant fused), fused down 1; plus one
    decode attention per decode step: 9 per decode step, 8 per prefill."""
    spy = _Spy(monkeypatch)
    eng, reqs = _serve_port(ServingEngine, QuantPlan.full(), **RING_KW)
    L = eng.model.cfg.n_layers
    steps, prefills = eng.stats.decode_steps, eng.stats.prefills
    fwd = steps + prefills
    assert spy.counts == dict(
        quantize_rows_int8=2 * L * fwd, cim_gemm_int8_fused_qin=2 * L * fwd,
        cim_gemm_int8_fused=L * fwd, cim_gated_gemm_int8=L * fwd,
        cim_grouped_gemm_int8=L * fwd, cim_grouped_gated_gemm_int8=L * fwd,
        decode_attention=L * steps)
    assert sum(spy.counts.values()) == 9 * L * steps + 8 * L * prefills


def test_cpu_moe_engines_launch_nothing():
    before = launch_counts()
    assert {"cim_grouped_gemm_int8", "cim_grouped_gated_gemm_int8"} <= set(
        before)
    _serve_port(PagedServingEngine, QuantPlan.full(), n_slots=2, **PAGED_KW)
    assert launch_counts() == before


def test_serve_cli_moe_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                       "--int8", "--requests", "3", "--slots", "2",
                       "--max-new", "4", "--max-len", "32"])
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert all(len(r.generated) == 4 for r in reqs)
    assert "served 3 requests on cpu" in capsys.readouterr().out
