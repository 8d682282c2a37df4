"""xlstm-350m through the port's ring engine against the JAX reference's,
on the CPU, on ``xlstm-350m-smoke``.

The ring engine pads a prompt to its bucket by repeating its last token,
and the xLSTM states and conv tail take those pads in, in both packages
(ROADMAP C.11); so the prompts here are bucket multiples (16, 8, 24, 8
at bucket 8), which pad nothing.  The engine's slot reset zeroes every
cache leaf, ``m`` included (ROADMAP C.14), so its function is a direct
loop from a zeroed cache, not from ``init_cache``.  Greedy streams are
compared as ``tests/test_torch_serving.py`` compares them (``MARGIN``:
twice the logits' ``LOGIT_ATOL = 0.15``).  The paged engine and tensor
parallelism refuse xLSTM, as the reference's paged engine does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.serving import PagedServingEngine as JPaged
from repro.serving import ServingEngine as JEngine

from repro_torch.parallel.context import TPGroup
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import QuantPlan
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import (assert_same_tokens, port_model, rng, serve_jax,
                          smoke, t)

ARCH = "xlstm-350m"
LOGIT_ATOL = 0.15          # tests/test_torch_model.py
MARGIN = 2 * LOGIT_ATOL
PROMPT_LENS = (16, 8, 24, 8)       # bucket multiples of 8


def _prompts():
    r = rng(90)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _serve_port(prompts, plan=None, new=8):
    eng = ServingEngine(port_model(arch=ARCH), n_slots=3, max_len=64,
                        prefill_bucket=8, quant_plan=plan)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs


def test_greedy_tokens_match_jax_engine():
    prompts = _prompts()
    jreqs, margins = serve_jax(ARCH, JEngine, None, prompts, n_slots=3,
                               max_len=64, prefill_bucket=8)
    eng, reqs = _serve_port(prompts)
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert eng.stats.prefills == len(prompts)
    assert_same_tokens(jreqs, margins, [r.generated for r in reqs], MARGIN)
    idx = torch.stack([c["index"] for c in eng.cache])
    assert bool((idx == idx[0]).all())


def _direct_loop(m, prompt, n, zero):
    caches = m.init_cache(1, 64)
    if zero:
        for c in caches:
            for v in c.values():
                v.zero_()
    with torch.no_grad():
        logits = m.prefill_padded(t(prompt).long()[None], caches,
                                  torch.tensor([len(prompt)],
                                               dtype=torch.int32))
        out = [logits[0, -1]]
        for _ in range(n - 1):
            nxt = out[-1].argmax().reshape(1, 1)
            out.append(m.decode_step(nxt, caches)[0, -1])
    return torch.stack(out)


def test_engine_is_a_direct_zeroed_cache_loop():
    """A bucket-multiple request's greedy tokens are a direct batch-1
    ``prefill_padded`` then ``decode_step`` loop's from a zeroed cache
    (the engine's slot reset); from ``init_cache`` (``m`` at -1e30) the
    sLSTM layers compute another function (C.14) and the logits move."""
    prompt = _prompts()[0]
    eng, reqs = _serve_port([prompt], plan=QuantPlan.full())
    zeroed = _direct_loop(eng.model, prompt, 8, zero=True)
    assert reqs[0].generated == zeroed.argmax(-1).tolist()
    fresh = _direct_loop(eng.model, prompt, 8, zero=False)
    assert float((fresh - zeroed).abs().max()) > 0


def test_paged_engine_and_tp_refuse_xlstm():
    _, jm, params = smoke(ARCH)
    with pytest.raises(NotImplementedError):
        JPaged(jm, params, n_slots=2, max_len=32, prefill_bucket=8,
               block_size=8)
    m = port_model(arch=ARCH)
    with pytest.raises(NotImplementedError, match="mlstm"):
        PagedServingEngine(m, n_slots=2, max_len=32, prefill_bucket=8,
                           block_size=8, quant_plan=QuantPlan.full())
    with pytest.raises(NotImplementedError, match="mlstm"):
        m.init_paged_cache(2, 9, 8, 4)
    # tensor parallelism shards the mixer by head now
    shard_model(m.quantize(QuantPlan.full()), TPGroup(0, 2, "gloo"))
    assert m.layers[0].mlstm.tp_size == 2
    assert m.layers[0].mlstm.q.shape[1] * 2 == m.cfg.xlstm.n_heads
