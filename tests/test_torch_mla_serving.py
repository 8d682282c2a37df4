"""deepseek-v3 (MLA + MoE) through the port's engines against the JAX
reference, on the CPU, on ``deepseek-v3-671b-smoke``.

The ring engine prefills MLA through the absorbed path over the slot's
whole latent cache (the reference's ``mla_apply`` with a cache); pads sit
at positions at or beyond the prompt's length, which no real query sees,
so prompts on and off the bucket have a pad-free reference.  Greedy
streams are compared as ``tests/test_torch_serving.py`` compares them:
equal at every step up to the first step where the jitted reference's
top-2 margin is within ``MARGIN`` (its fused bf16 roundings can flip a
near tie of the router, ``tests/test_torch_moe.py``).  The paged engine
and tensor parallelism refuse MLA, as the reference's paged engine does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.quant import QuantPlan as JPlan
from repro.serving import PagedServingEngine as JPaged
from repro.serving import ServingEngine as JEngine

from repro_torch.parallel.context import TPGroup
from repro_torch.parallel.sharding import shard_model
from repro_torch.quant import QuantPlan
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import (assert_same_tokens, port_model, rng, serve_jax,
                          smoke, t)

ARCH = "deepseek-v3-671b"
LOGIT_ATOL = 0.15          # tests/test_torch_model.py
MARGIN = 2 * LOGIT_ATOL
# bucket 8: 16 and 8 on the bucket, the others off it
PROMPT_LENS = (16, 5, 11, 8)


def _prompts():
    r = rng(50)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _serve_port(plan, prompts, new=8):
    eng = ServingEngine(port_model(arch=ARCH), n_slots=3, max_len=64,
                        prefill_bucket=8, quant_plan=plan)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return eng, reqs


@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
def test_greedy_tokens_match_jax_engine(name, jplan, plan):
    prompts = _prompts()
    jreqs, margins = serve_jax(ARCH, JEngine, jplan, prompts, n_slots=3,
                               max_len=64, prefill_bucket=8)
    eng, reqs = _serve_port(plan, prompts)
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert eng.stats.prefills == len(prompts)
    assert_same_tokens(jreqs, margins, [r.generated for r in reqs], MARGIN,
                       name)
    # the latent caches stay bf16 and every layer's index moves together
    assert all(c["c_kv"].dtype == torch.bfloat16 for c in eng.cache)
    idx = torch.stack([c["index"] for c in eng.cache])
    assert bool((idx == idx[0]).all())


def test_engine_equals_direct_prefill_and_decode():
    """A request's tokens are a direct batch-1 ``prefill_padded`` then
    ``decode_step`` loop's on the same model, off the bucket too (MLA's
    pads are masked)."""
    prompt = _prompts()[1]
    eng, reqs = _serve_port(QuantPlan.full(), [prompt])
    m = eng.model
    caches = m.init_cache(1, 64, kv_dtype="int8")
    padded = np.concatenate([prompt, np.full(3, prompt[-1])])
    with torch.no_grad():
        logits = m.prefill_padded(t(padded).long()[None], caches,
                                  torch.tensor([len(prompt)],
                                               dtype=torch.int32))
        toks = [int(logits[0, -1].argmax())]
        for _ in range(7):
            logits = m.decode_step(torch.tensor([[toks[-1]]]), caches)
            toks.append(int(logits[0, -1].argmax()))
    assert reqs[0].generated == toks


def test_paged_engine_and_tp_refuse_mla():
    _, jm, params = smoke(ARCH)
    with pytest.raises(NotImplementedError):
        JPaged(jm, params, n_slots=2, max_len=32, prefill_bucket=8,
               block_size=8)
    m = port_model(arch=ARCH)
    with pytest.raises(NotImplementedError, match="mla"):
        PagedServingEngine(m, n_slots=2, max_len=32, prefill_bucket=8,
                           block_size=8, quant_plan=QuantPlan.full())
    # refused before the plan touched the model
    assert m.layers[0].mlp.up.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="mla"):
        m.init_paged_cache(2, 9, 8, 4)
    # tensor parallelism shards the mixer by head now
    shard_model(m.quantize(QuantPlan.full()), TPGroup(0, 2, "gloo"))
    assert m.layers[0].mla.tp_size == 2
    assert m.layers[0].mla.q_up.shape[1] * 2 == m.cfg.n_heads
