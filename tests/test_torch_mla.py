"""The port's MLA (multi-head latent attention) and deepseek-v3's config
and weights against the JAX reference, on the CPU, on
``deepseek-v3-671b-smoke`` (4 layers: mla + dense, then 3 x mla + MoE of
8 experts top-2 with a shared expert; d 64, 4 heads, q_lora 32, kv_lora
16, nope 16, rope 8, v 16).  The blocks and the whole model:
``tests/test_torch_mla_model.py``; the engines:
``tests/test_torch_mla_serving.py``.

Weights come from the reference's ``Model.init`` through
``params_from_jax``; inputs are numpy from a seed.  Tolerances: the MLA
mixer (its projections, both paths, the latent cache) within ``BF16_REL
= 2**-8`` of the largest |value| (one bf16 rounding; bitwise in
practice: the port takes the reference's ops and casts one by one); the
cacheless forward above 2048 tokens (the blockwise path) within ``2**-7``
of the largest |value|, the tolerance of kernel 12's bf16 checks; weight
codes, scales and the chunked quantizer's output exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jmla
from repro.quant import QuantPlan as JPlan

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.quant import QuantizedLinear, QuantPlan
from torch_parity import numpy_tree, port_model, rng, smoke, t, to_np

ARCH = "deepseek-v3-671b"
BF16_REL = 2 ** -8


def within(got, want, rel):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _mla_pair(layer: int = 0):
    """(reference cfg, reference MLA params of ``layer``, port cfg, the
    port's MLA module of that layer)."""
    cfg, _, params = smoke(ARCH)
    m = port_model(arch=ARCH)
    gi, j = (0, 0) if layer == 0 else (1, layer - 1)
    jp = jax.tree.map(lambda a: a[j], params[f"group_{gi}"]["mla"])
    return cfg, jp, m.cfg, m.layers[layer].mla


def _padded_positions(S, lengths):
    ar = np.arange(S)[None]
    return np.where(ar < np.asarray(lengths)[:, None], ar,
                    2 ** 30).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
def test_configs_match_reference():
    from repro.configs import get_config as jget
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "activation", "norm", "rope_theta",
              "tie_embeddings", "family"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.mla) == vars(jcfg.mla)
    assert cfg.moe == tmoe.MoEConfig(**vars(jcfg.moe))
    assert cfg.layer_specs() == jcfg.layer_specs()
    specs = cfg.layer_specs()
    assert specs[:3] == (("mla", "dense"),) * 3
    assert specs[3:] == (("mla", "moe"),) * 58
    assert cfg.param_count() == jcfg.param_count() == 671_025_397_760
    assert cfg.mla.qk_head_dim == 192 and cfg.mla.v_head_dim == 128
    # capacity int(S * 8 / 256 * 1.25) + 1: one row an expert at decode
    mo = cfg.moe
    assert int(1 * mo.top_k / mo.n_routed_experts
               * mo.capacity_factor) + 1 == 1
    small, jsmall = reduced_config(cfg), smoke(ARCH)[0]
    assert vars(small.mla) == vars(jsmall.mla)
    assert small.moe == tmoe.MoEConfig(**vars(jsmall.moe))
    assert small.moe.first_k_dense == 1
    assert small.layer_groups() == jsmall.layer_groups()
    assert small.param_count() == jsmall.param_count()


def test_params_from_jax_round_trip():
    """Every MLA leaf of every layer crosses over bit for bit, ``o`` as
    [H, v, d], the norm scales f32; the dense and MoE FFNs as before."""
    cfg, _, params = smoke(ARCH)
    m = port_model(arch=ARCH)
    i = 0
    for gi, (spec, count) in enumerate(cfg.layer_groups()):
        g = params[f"group_{gi}"]
        for j in range(count):
            mla = m.layers[i].mla
            for name, leaf in g["mla"].items():
                if isinstance(leaf, dict):
                    got, want = getattr(mla, name).scale, leaf["scale"][j]
                    assert got.dtype == torch.float32
                else:
                    got, want = getattr(mla, name), leaf[j]
                    assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(to_np(got), to_np(want))
            assert tuple(mla.o.shape) == (4, 16, 64)
            ffn = m.layers[i].mlp if spec[1] == "dense" else m.layers[i].moe
            for name in ("up", "gate", "down"):
                np.testing.assert_array_equal(
                    to_np(getattr(ffn, name)),
                    to_np(g["mlp" if spec[1] == "dense" else "moe"][name][j]))
            i += 1
    np.testing.assert_array_equal(to_np(m.head),
                                  to_np(params["head"]["kernel"]))


def test_params_from_jax_refuses_what_it_does_not_know():
    cfg, _, params = smoke(ARCH)
    tree = numpy_tree(params)
    g = dict(tree["group_0"])
    g["mla"] = dict(g["mla"], w_extra=g["mla"]["q_down"])
    with pytest.raises(ValueError, match="w_extra"):
        params_from_jax(dict(tree, group_0=g), reduced_config(
            get_config(ARCH)), device="cpu")
    g = {k: v for k, v in tree["group_0"].items() if k != "mla"}
    with pytest.raises(ValueError, match="'mla'"):
        params_from_jax(dict(tree, group_0=g), reduced_config(
            get_config(ARCH)), device="cpu")


def test_plan_leaves_mla_bf16():
    """The full plan quantizes the dense MLP and the experts exactly as
    the reference's (codes and scales bitwise) and leaves every MLA
    projection bf16 (``covered_kinds`` has no MLA kind)."""
    cfg, jm, params = smoke(ARCH)
    jq = jm.quantize(params, JPlan.full())
    m = port_model(QuantPlan.full(), arch=ARCH)
    for i, block in enumerate(m.layers):
        gi, j = (0, 0) if i == 0 else (1, i - 1)
        g = jq[f"group_{gi}"]
        for name, p in block.mla.named_parameters():
            assert p.dtype != torch.int8, name
        np.testing.assert_array_equal(to_np(block.mla.kv_up),
                                      to_np(g["mla"]["kv_up"][j]))
        ffn = block.mlp if block.spec[1] == "dense" else block.moe
        jffn = g["mlp" if block.spec[1] == "dense" else "moe"]
        for name in ("up", "gate", "down"):
            w = getattr(ffn, name)
            assert isinstance(w, QuantizedLinear)
            np.testing.assert_array_equal(to_np(w.q), to_np(jffn[name].q[j]))
            np.testing.assert_array_equal(to_np(w.scale),
                                          to_np(jffn[name].scale[j]))
        if block.spec[1] == "moe":
            assert isinstance(block.moe.shared.up, QuantizedLinear)


@pytest.mark.parametrize("E,chunk_elems", [(9, 2 * 33 * 17), (9, 1),
                                           (4, 10 ** 9)])
def test_chunked_expert_quantization_is_the_whole_stack(monkeypatch, E,
                                                        chunk_elems):
    """A stack quantized over chunks of experts (2 a chunk, 1, or all in
    one) gives the whole-stack codes and scales bit for bit, in bf16 and
    f32."""
    w = rng(7).standard_normal((E, 33, 17)).astype(np.float32)
    monkeypatch.setattr(ops, "QUANT_CHUNK_ELEMS", chunk_elems)
    for dtype in (torch.bfloat16, torch.float32):
        x = t(w, dtype)
        q, s = ops.quantize_weights_int8(x)
        wq, ws = ops._quantize_int8(x)
        assert q.dtype == torch.int8 and s.shape == (E, 17)
        assert torch.equal(q, wq) and torch.equal(s, ws)


# ---------------------------------------------------------------------------
# the MLA mixer
# ---------------------------------------------------------------------------
def test_projections_match_reference():
    cfg, jp, tcfg, mla = _mla_pair()
    x = rng(1).standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.tile(np.arange(3, 12, dtype=np.int32), (2, 1))
    xj, xt = jnp.asarray(x, jnp.bfloat16), t(x, torch.bfloat16)
    for jf, tf in ((jmla._project_q, tmla._project_q),
                   (jmla._project_kv_latent, tmla._project_kv_latent)):
        want = jf(jp, xj, cfg.mla, jnp.asarray(pos), cfg.rope_theta)
        got = tf(mla, xt, tcfg.mla, t(pos), tcfg.rope_theta)
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            within(a, b, BF16_REL)
    _, k_rope = tmla._project_kv_latent(mla, xt, tcfg.mla, t(pos), 1e4)
    assert tuple(k_rope.shape) == (2, 9, 8)        # one head shared


@pytest.mark.parametrize("S", [13, 2080])
def test_materialized_forward_matches_reference(S):
    """No cache: dense attention up to 2048 tokens, the blockwise path
    above (on the CPU; kernel 12 on the card)."""
    cfg, jp, tcfg, mla = _mla_pair(1)
    x = rng(2).standard_normal((1, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want, cache = jmla.mla_apply(jp, jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(pos), cfg.mla)
    assert cache is None
    with torch.no_grad():
        got = tmla.mla_apply(mla, t(x, torch.bfloat16), t(pos), tcfg.mla,
                             aligned_positions=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1, S, 64)
    within(got, want, BF16_REL if S <= 2048 else 2 ** -7)


def test_absorbed_prefill_and_decode_match_reference():
    """With a cache: a padded prefill (rows of 13 and 9 tokens) then two
    decode steps on the absorbed path, each against the reference's
    ``mla_apply`` on the same cache: outputs, the latent cache and the
    index."""
    cfg, jp, tcfg, mla = _mla_pair(2)
    r = rng(3)
    lengths = np.array([13, 9], np.int32)
    x = r.standard_normal((2, 13, 64)).astype(np.float32)
    pos = _padded_positions(13, lengths)
    jc = jmla.init_mla_cache(2, 32, cfg.mla)
    tc = tmla.init_mla_cache(2, 32, tcfg.mla)
    assert tc["c_kv"].dtype == torch.bfloat16
    assert tuple(tc["c_kv"].shape) == (2, 32, 16)
    assert tuple(tc["k_rope"].shape) == (2, 32, 8)
    steps = [(x, pos)]
    for i in range(2):
        steps.append((r.standard_normal((2, 1, 64)).astype(np.float32),
                      (lengths + i)[:, None].astype(np.int32)))
    for n, (xs, ps) in enumerate(steps):
        want, jc = jmla.mla_apply(jp, jnp.asarray(xs, jnp.bfloat16),
                                  jnp.asarray(ps), cfg.mla, cache=jc)
        got = tmla.mla_apply(mla, t(xs, torch.bfloat16), t(ps), tcfg.mla,
                             cache=tc)
        within(got, want, BF16_REL)
        for name in ("c_kv", "k_rope", "index"):
            within(tc[name], jc[name], BF16_REL)
        if n == 0:      # the engine's prefill sets the index to the lengths
            jc = dict(jc, index=jnp.asarray(lengths))
            tc["index"].copy_(t(lengths))
