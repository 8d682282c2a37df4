"""The port's MoE path against the JAX reference, on the CPU.

(a) The grouped GEMMs' plain versions (kernels 7 and 8) against
    ``repro.kernels.cim_gemm``'s grouped kernels in interpret mode
    within ``RTOL = 1e-6`` of the output's largest magnitude (XLA fuses
    the interpreted epilogue, which moves an ulp; its ``exp``/``tanh``
    may differ from torch's by an ulp), and bitwise against the
    reference's epilogue run op by op where there is no activation
    (exact int32 accumulators, the same order); with a ``counts`` skip
    list holding zeros
    equal to the run without it on those experts' zero rows.  The
    ``quantize_out`` path is held against ``quantize_rows_int8_ref`` of
    the f32 output, codes and scales exact, not against the interpreter,
    whose in-kernel requant multiplies by 1/127 (ROADMAP C.2).
(b) The routing of one ``[B, S, d]`` input against the reference's own
    steps in jnp: expert ids, sort order, positions, keep mask and
    capacity exact; gates within ``GATE_ULP = 32`` ulps (measured: 16):
    the f32 router product sums its 64 terms in another order in XLA
    than in torch, which moves a logit, and so the softmax, by a few
    ulps.  One case drives more tokens onto one expert than its
    capacity, so entries drop.
(c) ``moe_apply`` against the reference's on the same input, in bf16
    and under the full plan: at least 99% of the outputs bitwise
    (routing, the in-order combine, XLA's silu expansion and the int8
    pipeline follow the reference step for step), the rest within
    ``2**-7`` of their token's largest output (a gate a few f32 ulps off
    can round to the neighbouring bf16 value before it weights its
    expert's output); the grouped pipeline bitwise against the
    per-expert loop.
(d) The weights: bf16 and int8 expert stacks, scales, router and the
    untied head cross over bit for bit.
(e) ``qwen2-moe-a2.7b-smoke`` prefill + decode logits within
    ``LOGIT_ATOL = 0.15`` of the reference run op by op
    (``jax.disable_jit``).  The jitted reference is not the yardstick
    here: XLA's fusions round bf16 intermediates differently from the
    same ops run one at a time, which flips a near tie of the router on
    a few tokens of this config and moves their logits by several times
    ``LOGIT_ATOL``, while the port follows the reference's ops one by
    one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cim_gemm as jcg
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.quant import QuantPlan as JPlan
from repro.quant.linear import QuantizedLinear as JQL

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import cim_gemm as cg
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.quant import (QuantizedLinear, QuantPlan,
                               quantized_moe_apply,
                               quantized_moe_apply_looped)
from torch_parity import numpy_tree, port_model, rng, smoke, t, to_np

ARCH = "qwen2-moe-a2.7b"
RTOL = 1e-6
GATE_ULP = 32
LOGIT_ATOL = 0.15


def close(a, b, rtol=RTOL):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def exact(a, b):
    np.testing.assert_array_equal(to_np(a), to_np(b))


def _stack(r, E, K, N):
    return (r.integers(-127, 128, (E, K, N)).astype(np.int8),
            r.uniform(1e-3, 2e-2, (E, N)).astype(np.float32))


def _grouped_case(seed, E=4, M=16, K=128, N=256, zero_experts=()):
    """int8 rows [E, M, K] (the rows of ``zero_experts`` all zero, as a
    capacity buffer without tokens), their scales, two weight stacks."""
    r = rng(seed)
    x = r.integers(-127, 128, (E, M, K)).astype(np.int8)
    xs = r.uniform(1e-3, 1e-2, (E, M, 1)).astype(np.float32)
    for e in zero_experts:
        x[e] = 0
        xs[e] = np.float32(1e-12) / np.float32(127)
    return x, xs, _stack(r, E, K, N), _stack(r, E, K, N)


def _counts(E, zero_experts):
    return np.array([0 if e in zero_experts else 3 for e in range(E)],
                    np.int32)


# ---------------------------------------------------------------------------
# (a) kernels 7 and 8: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("skip", [False, True])
def test_grouped_gemm_matches_jax(act, skip):
    zero = (1, 3) if skip else ()
    x, xs, (w, ws), (b, _) = _grouped_case(40, zero_experts=zero)
    bias = b[..., 0, :].astype(np.float32) * 1e-3
    counts = _counts(4, zero) if skip else None
    want = jcg.cim_grouped_gemm_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs),
        jnp.asarray(ws)[:, None, :], bias=jnp.asarray(bias)[:, None, :],
        counts=None if counts is None else jnp.asarray(counts),
        activation=act, interpret=True)
    got = cg.cim_grouped_gemm_int8(t(x), t(w), t(xs), t(ws), bias=t(bias),
                                   counts=None if counts is None
                                   else t(counts), activation=act)
    assert got.dtype == torch.float32 and got.shape == (4, 16, 256)
    close(got, want)
    acc = jax.vmap(jref.cim_gemm_int8_ref)(jnp.asarray(x), jnp.asarray(w))
    exact(tref.cim_gemm_int8_ref(t(x), t(w)), acc)
    if act is None:
        if skip:
            acc = jnp.where(jnp.asarray(counts)[:, None, None] > 0, acc, 0)
        exact(got, acc.astype(jnp.float32) * jnp.asarray(xs)
              * jnp.asarray(ws)[:, None, :] + jnp.asarray(bias)[:, None, :])
    if skip:
        # the skip list gives what the full run gives on the zero rows
        full = cg.cim_grouped_gemm_int8(t(x), t(w), t(xs), t(ws),
                                        bias=t(bias), activation=act)
        exact(got, full)


@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("skip", [False, True])
def test_grouped_gated_gemm_matches_jax(act, skip):
    zero = (0, 2) if skip else ()
    x, xs, (wg, gs), (wu, us) = _grouped_case(41, zero_experts=zero)
    counts = _counts(4, zero) if skip else None
    want = jcg.cim_grouped_gated_gemm_int8(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(xs),
        jnp.asarray(gs)[:, None, :], jnp.asarray(us)[:, None, :],
        counts=None if counts is None else jnp.asarray(counts),
        activation=act, interpret=True)
    got = cg.cim_grouped_gated_gemm_int8(
        t(x), t(wg), t(wu), t(xs), t(gs), t(us),
        counts=None if counts is None else t(counts), activation=act)
    close(got, want)
    if skip:
        exact(got, cg.cim_grouped_gated_gemm_int8(t(x), t(wg), t(wu), t(xs),
                                                  t(gs), t(us),
                                                  activation=act))
        assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("gated", [False, True])
def test_grouped_quantize_out_is_rowquant_of_output(gated):
    """quantize_out returns quantize_rows_int8 of the f32 output, codes
    and scales exact, against the reference's oracle on the same f32
    rows; an empty expert's rows come out q = 0, s = 1e-12/127."""
    x, xs, (wg, gs), (wu, us) = _grouped_case(42, E=3, M=8, K=96, N=40,
                                              zero_experts=(1,))
    counts = t(_counts(3, (1,)))
    if gated:
        def run(**kw):
            return cg.cim_grouped_gated_gemm_int8(
                t(x), t(wg), t(wu), t(xs), t(gs), t(us), counts=counts,
                activation="silu", **kw)
    else:
        def run(**kw):
            return cg.cim_grouped_gemm_int8(t(x), t(wg), t(xs), t(gs),
                                            counts=counts,
                                            activation="silu", **kw)
    h = run()
    q, s = run(quantize_out=True)
    assert q.dtype == torch.int8 and s.shape == (3, 8, 1)
    rq, rs = jref.quantize_rows_int8_ref(jnp.asarray(to_np(h)))
    exact(q, rq)
    exact(s, rs)
    exact(q[1], np.zeros((8, 40), np.int8))
    exact(s[1], np.full((8, 1), np.float32(1e-12) / np.float32(127)))


@pytest.mark.parametrize("gated", [False, True])
def test_grouped_mlp_matches_jax_oracle(gated):
    """ops.cim_quantized_grouped_mlp (row quantize, grouped GEMM with the
    requant, grouped down GEMM) against the reference's
    ``grouped_quantized_mlp_ref``: the f32 outputs within 1e-5 of scale
    (the dense MLP's rule, tests/test_torch_kernels.py), the hidden
    codes exact."""
    r = rng(43)
    E, T, d, F = 4, 8, 64, 40
    x = r.standard_normal((E, T, d)).astype(np.float32)
    x[2] = 0.0                                     # an expert with no rows
    (u, us), (g, gs), (dn, ds) = (_stack(r, E, d, F), _stack(r, E, d, F),
                                  _stack(r, E, F, d))
    qtree = {"up": (jnp.asarray(u), jnp.asarray(us)),
             "down": (jnp.asarray(dn), jnp.asarray(ds))}
    if gated:
        qtree["gate"] = (jnp.asarray(g), jnp.asarray(gs))
    want = jref.grouped_quantized_mlp_ref(jnp.asarray(x), qtree, "silu")
    counts = t(np.array([T, T, 0, T], np.int32))
    got = ops.cim_quantized_grouped_mlp(
        t(x), t(u), t(us), t(dn), t(ds), gate_q=t(g) if gated else None,
        gate_scale=t(gs) if gated else None, expert_counts=counts,
        activation="silu")
    close(got, want, rtol=1e-5)
    exact(got[2], np.zeros((T, d), np.float32))
    ttree = {k: (t(np.asarray(a)), t(np.asarray(b)))
             for k, (a, b) in qtree.items()}
    exact(got, tref.grouped_quantized_mlp_ref(t(x), ttree, "silu"))


# ---------------------------------------------------------------------------
# (b) routing
# ---------------------------------------------------------------------------
def _jax_route(x, router, cfg):
    """The reference's routing steps (``repro/models/moe.py:85``–``:109``)
    on the same input, step for step."""
    B, S, _ = x.shape
    E, K = cfg.n_routed_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    capacity = int(S * K / E * cfg.capacity_factor) + 1
    n = S * K
    flat_e = expert_ids.reshape(B, n)
    tok_of = jnp.broadcast_to(jnp.arange(n) // K, (B, n))
    order = jnp.argsort(flat_e, axis=1)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    st = jnp.take_along_axis(tok_of, order, axis=1)
    sg = jnp.take_along_axis(gate_vals.reshape(B, n), order, axis=1)
    first = jax.vmap(lambda a: jnp.searchsorted(a, a, side="left"))(se)
    pos = jnp.arange(n)[None, :] - first
    return dict(expert_ids=expert_ids, gates=gate_vals, order=order, se=se,
                st=st, sg=sg, pos=pos, keep=pos < capacity,
                capacity=capacity)


@pytest.mark.parametrize("case", ["random", "overflow"])
def test_routing_matches_reference(case):
    jcfg = smoke(ARCH)[0]
    cfg = reduced_config(get_config(ARCH))
    assert cfg.moe == tmoe.MoEConfig(**vars(jcfg.moe))
    r = rng(44)
    x = r.standard_normal((3, 16, 64)).astype(np.float32)
    router = r.standard_normal((64, 8)).astype(np.float32) / 8
    if case == "overflow":
        # expert 5 is every token's first choice: 16 tokens > capacity 6
        router[:, 5] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 4.0
        router[0, 5] = 2.0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = _jax_route(jx, jnp.asarray(router), cfg.moe)
    got = tmoe.route(t(router), t(x, torch.bfloat16), cfg.moe)
    assert got.capacity == want["capacity"] == 6
    for name in ("expert_ids", "order", "se", "st", "pos", "keep"):
        exact(getattr(got, name), want[name])
    for name in ("gates", "sg"):
        np.testing.assert_array_max_ulp(to_np(getattr(got, name)),
                                        np.asarray(want[name]), GATE_ULP)
    keep = to_np(got.keep)
    if case == "overflow":
        assert (to_np(got.expert_ids)[..., 0] == 5).all()
        assert (~keep).sum() == 3 * (16 - 6)
    counts = to_np(tmoe.expert_counts(got, 8))
    assert counts.dtype == np.int32 and counts.sum() == 3 * 16 * 2
    np.testing.assert_array_equal(
        counts, np.bincount(to_np(got.expert_ids).ravel(), minlength=8))


# ---------------------------------------------------------------------------
# (c) moe_apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
@pytest.mark.parametrize("S", [1, 16])
def test_moe_apply_matches_reference(name, jplan, plan, S):
    jcfg, jm, params = smoke(ARCH)
    p = params if jplan is None else jm.quantize(params, jplan)
    lp = jax.tree.map(lambda a: a[1], p["group_0"]["moe"])
    x = rng(45).standard_normal((3, S, 64)).astype(np.float32)
    want, _ = jmoe.moe_apply(lp, jnp.asarray(x).astype(jnp.bfloat16),
                             jcfg.moe, jcfg.activation)
    m = port_model(plan, ARCH)
    got = tmoe.moe_apply(m.layers[1].moe, t(x, torch.bfloat16), m.cfg.moe,
                         m.cfg.activation)
    assert got.dtype == torch.bfloat16 and got.shape == (3, S, 64)
    got, want = to_np(got), to_np(want)
    assert (got == want).mean() >= 0.99
    limit = 2 ** -7 * np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= limit).all()


def test_grouped_equals_looped_bitwise():
    m = port_model(QuantPlan.full(), ARCH)
    moe = m.layers[0].moe
    x = t(rng(46).standard_normal((8, 6, 64)).astype(np.float32),
          torch.bfloat16)
    x[3] = 0                                          # an empty expert
    counts = torch.tensor([6, 6, 6, 0, 6, 6, 6, 6], dtype=torch.int32)
    grouped = quantized_moe_apply(moe, x, "swiglu", use_kernel=True,
                                  expert_counts=counts)
    assert grouped.dtype == torch.bfloat16
    exact(grouped, quantized_moe_apply_looped(moe, x, "swiglu",
                                              use_kernel=True))
    exact(grouped, quantized_moe_apply(moe, x, "swiglu", use_kernel=False))


# ---------------------------------------------------------------------------
# (d) weights
# ---------------------------------------------------------------------------
def test_moe_weights_cross_bitwise():
    _, jm, params = smoke(ARCH)
    m = port_model(None, ARCH)
    exact(m.head, params["head"]["kernel"])
    assert m.head.dtype == torch.bfloat16
    g = params["group_0"]["moe"]
    for i, block in enumerate(m.layers):
        assert block.spec == ("attn", "moe") and not hasattr(block, "mlp")
        exact(block.moe.router, g["router"][i])
        assert block.moe.router.dtype == torch.float32
        for name in ("up", "gate", "down"):
            exact(getattr(block.moe, name), g[name][i])
            exact(getattr(block.moe.shared, name), g["shared"][name][i])

    jq = jm.quantize(params, JPlan.full())
    ours = port_model(QuantPlan.full(), ARCH)
    theirs = params_from_jax(numpy_tree(jq), ours.cfg, device="cpu")
    gq = jq["group_0"]["moe"]
    for i, (a, b) in enumerate(zip(ours.layers, theirs.layers)):
        for mod_a, mod_b, tree in ((a.moe, b.moe, gq),
                                   (a.moe.shared, b.moe.shared,
                                    gq["shared"])):
            for name in ("up", "gate", "down"):
                qa, qb = getattr(mod_a, name), getattr(mod_b, name)
                assert isinstance(qa, QuantizedLinear)
                assert isinstance(qb, QuantizedLinear)
                assert isinstance(tree[name], JQL)
                for leaf in ("q", "scale"):
                    exact(getattr(qa, leaf), getattr(qb, leaf))
                    exact(getattr(qa, leaf), getattr(tree[name], leaf)[i])
        exact(a.moe.router, b.moe.router)
    assert ours.layers[0].moe.up.q.shape == (8, 64, 32)
    assert ours.layers[0].moe.up.scale.shape == (8, 32)


def test_convert_refuses_shape_mismatch():
    _, _, params = smoke(ARCH)
    tree = numpy_tree(params)
    tree["group_0"]["moe"]["up"] = tree["group_0"]["moe"]["up"][:, :4]
    with pytest.raises(ValueError, match="up"):
        params_from_jax(tree, reduced_config(get_config(ARCH)),
                        device="cpu")


def test_configs_match_reference():
    from repro.configs import get_config as jget
    for reduce in (False, True):
        cfg, jcfg = get_config(ARCH), jget(ARCH)
        if reduce:
            cfg, jcfg = reduced_config(cfg), smoke(ARCH)[0]
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "activation", "rope_theta",
                  "tie_embeddings", "family"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.moe == tmoe.MoEConfig(**vars(jcfg.moe))
        assert cfg.layer_specs() == jcfg.layer_specs()
        assert cfg.param_count() == jcfg.param_count()
    assert get_config(ARCH).param_count() == 14_315_487_232


# ---------------------------------------------------------------------------
# (e) the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
def test_prefill_decode_logits_close(name, jplan, plan):
    jcfg, jm, params = smoke(ARCH)
    p = params if jplan is None else jm.quantize(params, jplan)
    kv = "int8" if plan is not None else None
    toks = rng(24).integers(0, 256, (2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    with jax.disable_jit():
        jc = jm.init_cache(2, 32, kv_dtype=kv)
        jl, jc = jm.prefill_padded(p, {"inputs": jnp.asarray(toks)}, jc,
                                   jnp.asarray(lengths))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        jd, jc = jm.decode_step(p, {"inputs": jnp.asarray(nxt)[:, None]},
                                jc)
    m = port_model(plan, ARCH)
    tc = m.init_cache(2, 32, kv_dtype=kv)
    with torch.no_grad():
        tl = m.prefill_padded(t(toks).long(), tc, t(lengths))
        td = m.decode_step(t(nxt).long()[:, None], tc)
    assert tl.shape == (2, 1, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0,
                               atol=LOGIT_ATOL)
