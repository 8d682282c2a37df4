"""The port's engines on the attention + dense-FFN family beyond gemma-2b,
against the JAX reference's engines, on the CPU, at the reduced
``*-smoke`` sizes: gemma3-4b (local layers on a ring of the window, 8
slots), deepseek-67b, command-r-plus-104b and paligemma-3b (text prompts
under the ``"prefix"`` mask, prefix_len = frontend_len = 4).  Greedy
streams are compared by the margin rule of ``tests/test_torch_serving.py``
(equal up to the first step where the reference's top-2 margin is within
``MARGIN``).  The paged engine is held against one fresh one-slot JAX
paged engine per request with the same chunking (ROADMAP C.1, C.12) and
against the port's ring engine.  musicgen-medium takes frame embeddings,
so both packages' engines refuse it; its greedy stream is held by a
direct prefill then decode loop.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import QuantPlan as JPlan
from repro.serving import PagedServingEngine as JPagedEngine
from repro.serving import ServingEngine as JEngine

from repro_torch.quant import QuantPlan
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import (assert_same_tokens, port_model, rng, serve_jax,
                          smoke, t, to_np)

LOGIT_ATOL = 0.15          # tests/test_torch_model.py
MARGIN = 2 * LOGIT_ATOL
# gemma3-4b-smoke's window is 8: 17 and 12 are longer, 3 and 9 reach
# past the prefix of paligemma-3b-smoke (4) or sit inside it
PROMPT_LENS = (3, 17, 9, 12)
RING_KW = dict(n_slots=3, max_len=64, prefill_bucket=16)
PAGED_KW = dict(max_len=64, prefill_bucket=16, block_size=8,
                prefill_chunk=8)
TOKEN_ARCHS = ("gemma3-4b", "deepseek-67b", "command-r-plus-104b",
               "paligemma-3b")


def _prompts():
    r = rng(70)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _serve_port(arch, engine_cls, plan, **kw):
    eng = engine_cls(port_model(None, arch), quant_plan=plan, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.status is RequestStatus.OK for r in reqs)
    assert all(len(r.generated) == 8 for r in reqs)
    return eng, reqs


@pytest.mark.parametrize("arch,plan_name", [
    (a, "full") for a in TOKEN_ARCHS] + [("gemma3-4b", "none"),
                                         ("paligemma-3b", "none")])
def test_ring_greedy_tokens_match_jax_engine(arch, plan_name):
    full = plan_name == "full"
    jreqs, margins = serve_jax(arch, JEngine, JPlan.full() if full else None,
                               _prompts(), **RING_KW)
    eng, reqs = _serve_port(arch, ServingEngine,
                            QuantPlan.full() if full else None, **RING_KW)
    assert_same_tokens(jreqs, margins, [r.generated for r in reqs], MARGIN,
                       arch)
    assert eng.stats.prefills == len(PROMPT_LENS)
    if arch == "gemma3-4b":
        # local layers hold the window, global layers the whole ring
        caps = [c["pos"].shape[1] for c in eng.cache]
        assert caps == [8, 64, 8, 64]


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_paged_greedy_tokens_match_fresh_jax_paged_engines(arch):
    """The port's paged engine (4 slots, chunks of 8) against one fresh
    one-slot JAX paged engine per request, then against the port's own
    ring engine: the same tokens."""
    jreqs, margins = [], {}
    for uid in range(len(PROMPT_LENS)):
        one, m = serve_jax(arch, JPagedEngine, JPlan.full(), _prompts(),
                           [uid], n_slots=1, **PAGED_KW)
        jreqs += one
        margins.update(m)
    eng, reqs = _serve_port(arch, PagedServingEngine, QuantPlan.full(),
                            n_slots=4, **PAGED_KW)
    assert_same_tokens(jreqs, margins, [r.generated for r in reqs], MARGIN,
                       arch)
    assert eng.stats.prefill_chunks == sum(-(-n // 8) for n in PROMPT_LENS)
    eng.paged.allocator.check()
    assert eng.paged.allocator.n_used == 0
    _, ring = _serve_port(arch, ServingEngine, QuantPlan.full(), **RING_KW)
    assert [r.generated for r in ring] == [r.generated for r in reqs]


def test_chunked_prefill_under_the_prefix_mask_is_the_references():
    """ROADMAP C.12: a paged chunk cannot see prefix keys that a later
    chunk writes (their slots hold the 2**30 sentinel, not < p), in both
    packages.  paligemma-3b-smoke (prefix 4) prefilled in chunks of 2
    into shuffled 2-slot blocks: each chunk's logits the reference's
    under the same chunking, and the result not the one-shot prefill's."""
    arch = "paligemma-3b"
    cfg, jm, params = smoke(arch)
    jq = jm.quantize(params, JPlan.full())
    m = port_model(QuantPlan.full(), arch)
    S, C, bs = 10, 2, 2
    toks = rng(71).integers(0, 256, (1, S)).astype(np.int32)
    nb = S // bs
    tables = (rng(72).permutation(nb) + 1).astype(np.int32)[None]
    jc = jm.init_paged_cache(1, nb + 1, bs, nb, kv_dtype="int8")
    jc = {g: dict(c, block_tables=jnp.broadcast_to(
        jnp.asarray(tables), c["block_tables"].shape)) for g, c in jc.items()}
    tc = m.init_paged_cache(1, nb + 1, bs, nb, kv_dtype="int8")
    tc[0]["block_tables"].copy_(t(tables))
    n = np.array([C], np.int32)
    for off in range(0, S, C):
        chunk = toks[:, off:off + C]
        jl, jc = jm.prefill_padded(jq, {"inputs": jnp.asarray(chunk)}, jc,
                                   jnp.asarray(n), jnp.asarray([off]))
        tl = m.prefill_padded(t(chunk).long(), tc, t(n),
                              offset=t(np.array([off], np.int32)))
        np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0,
                                   atol=LOGIT_ATOL)
    one = m.prefill_padded(t(toks).long(), m.init_cache(1, 16, "int8"),
                           t(np.array([S], np.int32)))
    assert (one - tl).abs().max().item() > 1e-3


def test_musicgen_greedy_stream_by_direct_prefill_and_decode():
    """musicgen-medium-smoke under the full plan, int8 KV: a prefill of 12
    seeded frame embeddings, then 6 decode steps each fed a seeded frame;
    every step's logits within LOGIT_ATOL of the reference's and the
    greedy codes equal but at near ties."""
    arch = "musicgen-medium"
    cfg, jm, params = smoke(arch)
    jq = jm.quantize(params, JPlan.full())
    m = port_model(QuantPlan.full(), arch)
    r = rng(73)
    frames = r.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    steps = r.standard_normal((6, 2, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([12, 9], np.int32)
    jc = jm.init_cache(2, 32, kv_dtype="int8")
    jl, jc = jm.prefill_padded(jq, {"frame_embeddings": jnp.asarray(frames)},
                               jc, jnp.asarray(lengths))
    tc = m.init_cache(2, 32, kv_dtype="int8")
    tl = m.prefill_padded(None, tc, t(lengths), frame_embeddings=t(frames))
    pairs = [(to_np(jl), to_np(tl))]
    for f in steps:
        jd, jc = jm.decode_step(jq, {"frame_embeddings": jnp.asarray(f)}, jc)
        td = m.decode_step(None, tc, frame_embeddings=t(f))
        pairs.append((to_np(jd), to_np(td)))
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        top = np.sort(want[:, -1], -1)[:, -2:]
        tie = top[:, 1] - top[:, 0] <= MARGIN
        same = want[:, -1].argmax(-1) == got[:, -1].argmax(-1)
        assert bool((same | tie).all())


def test_engines_refuse_an_audio_config():
    m = port_model(None, "musicgen-medium")
    for cls, kw in ((ServingEngine, RING_KW), (PagedServingEngine,
                                               dict(n_slots=2, **PAGED_KW))):
        with pytest.raises(ValueError, match="frame embeddings"):
            cls(m, quant_plan=QuantPlan.full(), **kw)
    # refused before the plan touched the model
    assert m.layers[0].attn.q.dtype == torch.bfloat16


def test_serve_cli_family_on_cpu(capsys):
    from repro_torch.launch import serve
    for arch in ("gemma3-4b", "paligemma-3b"):
        reqs = serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                           "--int8", "--requests", "3", "--slots", "2",
                           "--max-new", "4", "--max-len", "32"])
        assert all(r.status is RequestStatus.OK for r in reqs)
        assert "served 3 requests on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="audio-frontend"):
        serve.main(["--arch", "musicgen-medium", "--device", "cpu",
                    "--reduced"])


def test_cpu_family_engine_launches_nothing():
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    _serve_port("gemma3-4b", PagedServingEngine, QuantPlan.full(),
                n_slots=2, **PAGED_KW)
    assert launch_counts() == before
