"""deepseek-v3's blocks and whole model in the port against the JAX
reference, on the CPU, on ``deepseek-v3-671b-smoke`` (see
``tests/test_torch_mla.py`` for the config and the mixer's tests).

Tolerances: a bf16 block and the logits run op by op (``jax.disable_jit``)
within ``BF16_REL = 2**-8`` of the largest |value| (bitwise in
practice); under the full plan at least 99% of a block's outputs bitwise
and the rest within ``2**-7`` of their token's largest output, as
``tests/test_torch_moe.py`` holds ``moe_apply``; the integer stages
exact.  The reference is run op by op because its jitted scan bodies
round bf16 intermediates in XLA's fused order, which flips near ties of
the router on a few tokens (logits then move by up to 1.1 at this size).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro.quant import QuantPlan as JPlan

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ref as tref
from repro_torch.models import mla as tmla
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.quant import QuantPlan
from test_torch_mla import ARCH, BF16_REL, _padded_positions, within
from torch_parity import port_model, rng, smoke, t, to_np


# ---------------------------------------------------------------------------
# blocks and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("name,jplan,plan", [
    ("full", JPlan.full(), QuantPlan.full()), ("none", None, None)])
def test_block_matches_reference(layer, name, jplan, plan):
    """``block_apply`` of the dense (layer 0) and the MoE (layer 1) block
    with a cache, op by op: bf16 within BF16_REL; under the full plan at
    least 99% bitwise, the rest within 2**-7 of their token's largest
    output."""
    cfg, jm, params = smoke(ARCH)
    p = params if jplan is None else jm.quantize(params, jplan)
    spec = cfg.layer_specs()[layer]
    gi, j = (0, 0) if layer == 0 else (1, 0)
    lp = jax.tree.map(lambda a: a[j], p[f"group_{gi}"])
    x = rng(4).standard_normal((2, 8, 64)).astype(np.float32)
    pos = _padded_positions(8, [8, 5])
    with jax.disable_jit():
        want, jc, _ = jmodel.block_apply(
            lp, spec, cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
            jmla.init_mla_cache(2, 32, cfg.mla), None)
    m = port_model(plan, arch=ARCH)
    tc = tmla.init_mla_cache(2, 32, m.cfg.mla)
    with torch.no_grad():
        got = tmodel.block_apply(m.layers[layer], m.cfg,
                                 t(x, torch.bfloat16), t(pos), tc)
    assert got.dtype == torch.bfloat16
    within(tc["c_kv"], jc["c_kv"], BF16_REL)
    if plan is None:
        within(got, want, BF16_REL)
        return
    got, want = to_np(got), to_np(want)
    assert (got == want).mean() >= 0.99
    limit = 2 ** -7 * np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= limit).all()


def test_expert_integer_stages_exact(monkeypatch):
    """Under the full plan, at the MoE block's own routed expert rows: the
    row codes and scales are the reference oracle's and each expert's
    int32 accumulators the exact integer product of the reference's
    weight codes."""
    cfg, jm, params = smoke(ARCH)
    jq = jax.tree.map(lambda a: a[0], jm.quantize(
        params, JPlan.full())["group_1"]["moe"])
    m = port_model(QuantPlan.full(), arch=ARCH)
    seen = []
    real = tmoe.quantized_moe_apply

    def spy(moe, xg, *a, **kw):
        seen.append(xg.clone())
        return real(moe, xg, *a, **kw)
    monkeypatch.setattr(tmoe, "quantized_moe_apply", spy)
    x = rng(5).standard_normal((2, 9, 64)).astype(np.float32)
    with torch.no_grad():
        tmoe.moe_apply(m.layers[1].moe, t(x, torch.bfloat16), m.cfg.moe,
                       m.cfg.activation)
    (xg,) = seen
    E, T, d = xg.shape
    codes, scales = tref.quantize_rows_int8_ref(xg.reshape(E * T, d))
    jcodes, jscales = jref.quantize_rows_int8_ref(
        jnp.asarray(to_np(xg).reshape(E * T, d), jnp.bfloat16))
    np.testing.assert_array_equal(to_np(codes), np.asarray(jcodes))
    np.testing.assert_array_equal(to_np(scales), np.asarray(jscales))
    codes = codes.reshape(E, T, d)
    for e in range(E):
        for name in ("gate", "up"):
            wq = np.asarray(jq[name].q[e]).astype(np.int64)
            acc = tref.cim_gemm_int8_ref(codes[e], t(np.asarray(
                jq[name].q[e])))
            assert acc.dtype == torch.int32
            np.testing.assert_array_equal(
                to_np(acc), to_np(codes[e]).astype(np.int64) @ wq)


def test_prefill_decode_logits_match_reference():
    """A padded ring prefill then a decode step against the reference run
    op by op (``jax.disable_jit``: jitted, XLA's fusions round the bf16
    intermediates otherwise and flip a near tie of the router, as
    ``tests/test_torch_moe.py`` notes), within BF16_REL of the largest
    logit; every layer's index at the reference's.  The MLA caches stay
    bf16 under an int8 KV dtype, as the reference's.  The full plan is
    held per block above and by the engine's streams
    (``tests/test_torch_mla_serving.py``)."""
    _, jm, params = smoke(ARCH)
    toks = rng(8).integers(0, 256, (2, 8)).astype(np.int32)
    lengths = np.array([8, 5], np.int32)
    m = port_model(arch=ARCH)
    tc = m.init_cache(2, 32, kv_dtype="int8")
    assert all(c["c_kv"].dtype == torch.bfloat16 for c in tc)
    with jax.disable_jit():
        jc = jm.init_cache(2, 32, kv_dtype="int8")
        jl, jc = jm.prefill_padded(params, {"inputs": jnp.asarray(toks)},
                                   jc, jnp.asarray(lengths))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        jd, jc = jm.decode_step(params,
                                {"inputs": jnp.asarray(nxt)[:, None]}, jc)
    with torch.no_grad():
        tl = m.prefill_padded(t(toks).long(), tc, t(lengths))
        td = m.decode_step(t(nxt).long()[:, None], tc)
    within(tl, jl, BF16_REL)
    within(td, jd, BF16_REL)
    i = 0
    for gi, (_, count) in enumerate(m.cfg.layer_groups()):
        for j in range(count):
            np.testing.assert_array_equal(
                to_np(tc[i]["index"]),
                np.asarray(jc[f"group_{gi}"]["index"][j]))
            i += 1
    assert to_np(tc[0]["index"]).tolist() == [9, 6]


def test_forward_logits_match_reference():
    """The cacheless forward's logits against the reference run op by op,
    within BF16_REL of the largest logit (the shapes of the test above,
    so the op-by-op reference reuses its compiled ops)."""
    _, jm, params = smoke(ARCH)
    toks = rng(8).integers(0, 256, (2, 8)).astype(np.int32)
    with jax.disable_jit():
        want = jm.forward(params, {"inputs": jnp.asarray(toks)})[0]
    with torch.no_grad():
        got = port_model(arch=ARCH)(t(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 8, 256)
    within(got, want, BF16_REL)


def test_port_init_draws_mla():
    """``Model.init`` fills every leaf (no NaN left from ``to_empty``);
    a forward and a ring prefill run."""
    cfg = reduced_config(get_config(ARCH))
    m = tmodel.Model(cfg).init(0, device="cpu")
    for name, p in m.named_parameters():
        assert bool(torch.isfinite(p.float()).all()), name
    assert float(m.layers[0].mla.q_norm.scale.min()) == 1.0
    with torch.no_grad():
        out = m(torch.zeros((1, 3), dtype=torch.long))
        caches = m.init_cache(1, 8)
        m.prefill_padded(torch.zeros((1, 4), dtype=torch.long), caches,
                         torch.tensor([3], dtype=torch.int32))
    assert out.shape == (1, 3, cfg.vocab)
    assert caches[0]["index"].tolist() == [3]
