"""The port's hybrid zamba2 (Mamba-2 layers and attention + dense-geglu
layers) against the JAX reference, on the CPU, on ``zamba2-1.2b-smoke``
(4 layers: mamba2, attn, mamba2, attn; d 64, SSM heads 8 of 16, state 8,
chunk 8).

Weights come from the reference's ``Model.init`` through
``params_from_jax``; tokens are numpy from a seed.  Logits carry the
dense model's ``LOGIT_ATOL = 0.15`` (``tests/test_torch_model.py``: bf16
and f32 roundings differ between XLA and torch, and can move an int8
code at a tie).  Greedy streams are compared as
``tests/test_torch_serving.py`` compares them: equal at every step up to
the first step where the reference's top-2 margin is within ``MARGIN``.
The ring engine pads a prompt by repeating its last token, and the Mamba-2
state and conv tail take those pads in, in both packages (ROADMAP C.11);
the prompts here are on and off the bucket, and both engines pad alike.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import QuantPlan as JPlan
from repro.serving import PagedServingEngine as JPaged
from repro.serving import ServingEngine as JEngine

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import Model
from repro_torch.quant import QuantPlan
from repro_torch.serving import (PagedServingEngine, Request, RequestStatus,
                                 ServingEngine)
from torch_parity import (assert_same_tokens, port_model, rng, serve_jax,
                          smoke, t, to_np)

ARCH = "zamba2-1.2b"
LOGIT_ATOL = 0.15
MARGIN = 2 * LOGIT_ATOL
# bucket 8: 16 and 8 on the bucket, the others off it
PROMPT_LENS = (16, 5, 11, 8)


def _prompts():
    r = rng(40)
    return [r.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def test_configs_match_reference():
    from repro.configs import get_config as jget
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    assert cfg.layer_specs() == jcfg.layer_specs()
    assert cfg.param_count() == jcfg.param_count() == 1_351_614_464
    specs = cfg.layer_specs()
    assert specs.count(("mamba2", "none")) == 32
    assert specs.count(("attn", "dense")) == 6
    assert len(cfg.layer_groups()) == 13
    small, jsmall = reduced_config(cfg), smoke(ARCH)[0]
    assert small.layer_groups() == jsmall.layer_groups()
    for f in ("state_dim", "head_dim", "expand", "conv_kernel", "n_groups",
              "chunk"):
        assert getattr(small.ssm, f) == getattr(jsmall.ssm, f), f
    assert small.param_count() == jsmall.param_count()


def test_params_from_jax_round_trip():
    """Every leaf of every group crosses over bit for bit: the Mamba-2
    groups' ``mamba`` leaves and mixer norm (no FFN), the attention
    groups' attention, MLP and both norms."""
    _, _, params = smoke(ARCH)
    m = port_model(arch=ARCH)
    for gi, block in enumerate(m.layers):       # one layer a group here
        g = params[f"group_{gi}"]
        np.testing.assert_array_equal(to_np(block.mixer_norm),
                                      to_np(g["mixer_norm"]["scale"][0]))
        if block.spec[0] == "mamba2":
            assert "ffn_norm" not in g and not hasattr(block, "attn")
            for name, leaf in g["mamba"].items():
                got = (block.mamba.norm.scale if name == "norm"
                       else getattr(block.mamba, name))
                want = leaf["scale"] if name == "norm" else leaf
                assert got.dtype == (torch.bfloat16 if want.dtype.name
                                     == "bfloat16" else torch.float32)
                np.testing.assert_array_equal(to_np(got), to_np(want[0]))
        else:
            for name in ("q", "k", "v", "o"):
                np.testing.assert_array_equal(
                    to_np(getattr(block.attn, name)),
                    to_np(g["attn"][name][0]))
            for name in ("up", "down", "gate"):
                np.testing.assert_array_equal(
                    to_np(getattr(block.mlp, name)),
                    to_np(g["mlp"][name][0]))


def test_plan_skips_mamba_blocks():
    """The full plan quantizes the attention blocks and leaves the Mamba-2
    blocks' projections bf16, as the reference's plan does."""
    cfg, jm, params = smoke(ARCH)
    jq = jm.quantize(params, JPlan.full())
    m = port_model(QuantPlan.full(), arch=ARCH)
    for gi, block in enumerate(m.layers):
        if block.spec[0] == "mamba2":
            assert block.mamba.in_proj.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                to_np(block.mamba.in_proj),
                to_np(jq[f"group_{gi}"]["mamba"]["in_proj"][0]))
        else:
            np.testing.assert_array_equal(
                to_np(block.attn.qkv.q),
                to_np(jq[f"group_{gi}"]["attn"]["qkv"].q[0]))


def test_forward_logits_close():
    _, jm, params = smoke(ARCH)
    toks = rng(41).integers(0, 256, (2, 13)).astype(np.int32)
    want = jm.forward(params, {"inputs": jnp.asarray(toks)})[0]
    got = port_model(arch=ARCH)(t(toks).long())
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
def test_prefill_decode_logits_and_index_close(name, jplan, plan):
    """A padded prefill then two decode steps: logits within LOGIT_ATOL,
    and every layer's write index (the Mamba-2 layers' too, which
    ``decode_step`` reads for the positions) at the reference's."""
    _, jm, params = smoke(ARCH)
    p = params if jplan is None else jm.quantize(params, jplan)
    kv = "int8" if plan is not None else None
    toks = rng(42).integers(0, 256, (2, 16)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    jc = jm.init_cache(2, 32, kv_dtype=kv)
    jl, jc = jm.prefill_padded(p, {"inputs": jnp.asarray(toks)}, jc,
                               jnp.asarray(lengths))
    m = port_model(plan, arch=ARCH)
    tc = m.init_cache(2, 32, kv_dtype=kv)
    tl = m.prefill_padded(t(toks).long(), tc, t(lengths))
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0, atol=LOGIT_ATOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(2):
        jd, jc = jm.decode_step(p, {"inputs": jnp.asarray(nxt)[:, None]},
                                jc)
        td = m.decode_step(t(nxt).long()[:, None], tc)
        np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)
    for gi, c in enumerate(tc):
        np.testing.assert_array_equal(
            to_np(c["index"]), np.asarray(jc[f"group_{gi}"]["index"][0]))
    assert to_np(tc[0]["index"]).tolist() == [18, 13]
    assert set(tc[0]) == {"conv", "ssm", "index"}


def _serve_port(plan, prompts, **kw):
    eng = ServingEngine(port_model(arch=ARCH), n_slots=3, max_len=64,
                        prefill_bucket=8, quant_plan=plan, **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
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
    # every layer's index stays with the attention layers'
    idx = torch.stack([c["index"] for c in eng.cache])
    assert bool((idx == idx[0]).all())


def test_engine_equals_direct_prefill_and_decode_on_the_bucket():
    """A prompt that is a bucket multiple needs no pad: the engine's
    tokens are a direct batch-1 ``prefill_padded`` then ``decode_step``
    loop's on the same model."""
    prompt = _prompts()[0]
    eng, reqs = _serve_port(QuantPlan.full(), [prompt])
    m = eng.model
    caches = m.init_cache(1, 64, kv_dtype="int8")
    with torch.no_grad():
        logits = m.prefill_padded(t(prompt).long()[None], caches,
                                  torch.tensor([len(prompt)],
                                               dtype=torch.int32))
        toks = [int(logits[0, -1].argmax())]
        for _ in range(7):
            logits = m.decode_step(torch.tensor([[toks[-1]]]), caches)
            toks.append(int(logits[0, -1].argmax()))
    assert reqs[0].generated == toks


def test_paged_engine_refuses_the_hybrid_as_the_reference_does():
    _, jm, params = smoke(ARCH)
    with pytest.raises(NotImplementedError):
        JPaged(jm, params, n_slots=2, max_len=32, prefill_bucket=8,
               block_size=8)
    m = port_model(arch=ARCH)
    with pytest.raises(NotImplementedError, match="mamba2"):
        PagedServingEngine(m, n_slots=2, max_len=32, prefill_bucket=8,
                           block_size=8, quant_plan=QuantPlan.full())
    # refused before the plan touched the model
    assert m.layers[1].attn.q.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError):
        m.init_paged_cache(2, 9, 8, 4)


def test_port_init_draws_the_hybrid():
    """``Model.init`` fills every leaf of both block kinds (no NaN left
    from ``to_empty``), with the reference's fixed Mamba-2 leaves."""
    cfg = reduced_config(get_config(ARCH))
    m = Model(cfg).init(0, device="cpu")
    for name, p in m.named_parameters():
        assert bool(torch.isfinite(p.float()).all()), name
    mb = m.layers[0].mamba
    H = cfg.ssm.n_heads(cfg.d_model)
    np.testing.assert_allclose(to_np(mb.a_log),
                               np.log(np.arange(1, H + 1)), rtol=1e-6)
    out = m(torch.zeros((1, 3), dtype=torch.long))
    assert out.shape == (1, 3, cfg.vocab)
