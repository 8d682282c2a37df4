"""The port's xLSTM (mLSTM and sLSTM blocks) against the JAX reference, on
the CPU, on ``xlstm-350m-smoke`` (4 layers: mlstm, slstm, mlstm, slstm;
d 64, 4 heads, chunk 8, conv 4; the mLSTM's inner width 128, heads of 32;
the sLSTM's heads of 16 and a geglu FFN of 85).

Weights come from the reference's ``Model.init`` through
``params_from_jax``; inputs are numpy from a seed.  Tolerances:

* the f32 recurrences (``mlstm_scan``, ``mlstm_decode_step``, the sLSTM
  step and scan) within ``F32_REL = 1e-5`` of the largest |value|: XLA
  and torch sum the cumulative forget logs and the contractions in other
  orders;
* the bf16 blocks within ``BF16_REL = 2**-7`` of the largest |value|
  (their f32 states within F32_REL), the logits within ``LOGIT_ATOL =
  0.15`` (``tests/test_torch_model.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxl

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import Model
from repro_torch.models import xlstm as txl
from repro_torch.quant import QuantPlan
from torch_parity import port_model, rng, smoke, t, to_np

ARCH = "xlstm-350m"
F32_REL = 1e-5
BF16_REL = 2 ** -7
LOGIT_ATOL = 0.15


def within(got, want, rel):
    got, want = to_np(got), np.asarray(to_np(want), np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _qkv_gates(seed, B, S, H=4, D=32):
    r = rng(seed)
    q, k, v = (r.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    ig = r.standard_normal((B, S, H)).astype(np.float32)
    fg = (r.standard_normal((B, S, H)) + 3.0).astype(np.float32)
    return q, k, v, ig, fg


def _state(seed, B, H=4, D=32):
    """A carried mLSTM state: C and n from a short scan, m finite."""
    q, k, v, ig, fg = _qkv_gates(seed, B, 6, H, D)
    _, st = jxl.mlstm_scan(*map(jnp.asarray, (q, k, v, ig, fg)), 8)
    return tuple(np.asarray(a) for a in st)


def _pair(layer):
    """(reference cfg, the reference block params of ``layer``, port cfg,
    the port's block module)."""
    cfg, _, params = smoke(ARCH)
    m = port_model(arch=ARCH)
    kind = cfg.layer_specs()[layer][0]
    jp = jax.tree.map(lambda a: a[0], params[f"group_{layer}"][kind])
    return cfg, jp, m.cfg, getattr(m.layers[layer], kind)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
def test_configs_match_reference():
    from repro.configs import get_config as jget
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "vocab", "activation",
              "norm", "tie_embeddings", "d_ff"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.xlstm) == vars(jcfg.xlstm)
    assert cfg.layer_specs() == jcfg.layer_specs()
    specs = cfg.layer_specs()
    assert specs.count(("slstm", "none")) == 3
    assert specs.count(("mlstm", "none")) == 21
    assert [i for i, s in enumerate(specs) if s[0] == "slstm"] == [7, 15, 23]
    assert cfg.param_count() == jcfg.param_count() == 524_547_072
    small, jsmall = reduced_config(cfg), smoke(ARCH)[0]
    assert vars(small.xlstm) == vars(jsmall.xlstm)
    assert small.layer_groups() == jsmall.layer_groups()
    assert small.param_count() == jsmall.param_count()


def test_params_from_jax_round_trip():
    """Every leaf of both block kinds crosses over bit for bit in its own
    dtype: bf16 projections, f32 gates, ``r``, ``b`` and norm scales; the
    sLSTM's geglu FFN."""
    _, _, params = smoke(ARCH)
    m = port_model(arch=ARCH)

    def walk(mod, leaves):
        for name, leaf in leaves.items():
            if isinstance(leaf, dict):
                walk(getattr(mod, name), leaf)
                continue
            got = getattr(mod, name)
            want = leaf[0]
            assert got.dtype == (torch.bfloat16 if want.dtype.name
                                 == "bfloat16" else torch.float32), name
            np.testing.assert_array_equal(to_np(got), to_np(want))
    for gi, block in enumerate(m.layers):
        g = params[f"group_{gi}"]
        kind = block.spec[0]
        assert set(g) == {"mixer_norm", kind}
        assert not hasattr(block, "ffn_norm")
        walk(getattr(block, kind), g[kind])
        np.testing.assert_array_equal(to_np(block.mixer_norm),
                                      to_np(g["mixer_norm"]["scale"][0]))
    assert m.layers[0].mlstm.igate.dtype == torch.float32
    assert m.layers[1].slstm.r.dtype == torch.float32


def test_plan_leaves_xlstm_bf16():
    """Nothing in an xLSTM stack is covered by the plan (its ``ffn`` is
    ``"none"``; the sLSTM's own FFN too), as in the reference."""
    m = port_model(QuantPlan.full(), arch=ARCH)
    for name, p in m.named_parameters():
        assert p.dtype in (torch.bfloat16, torch.float32), name
    assert isinstance(m.layers[1].slstm.ffn.up, torch.nn.Parameter)


# ---------------------------------------------------------------------------
# the mLSTM cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,carried", [(16, False), (13, True), (5, True),
                                       (24, True)])
def test_mlstm_scan_matches_reference(S, carried):
    """Whole chunks, a ragged last chunk (13), one short chunk (5), from
    the initial state or a carried one."""
    q, k, v, ig, fg = _qkv_gates(10 + S, 2, S)
    st = _state(3, 2) if carried else None
    want_h, want_st = jxl.mlstm_scan(
        *map(jnp.asarray, (q, k, v, ig, fg)), 8,
        None if st is None else tuple(map(jnp.asarray, st)))
    got_h, got_st = txl.mlstm_scan(
        *map(t, (q, k, v, ig, fg)), 8,
        None if st is None else tuple(map(t, st)))
    within(got_h, want_h, F32_REL)
    for a, b in zip(got_st, want_st):
        within(a, b, F32_REL)


def test_mlstm_decode_step_matches_reference():
    q, k, v, ig, fg = _qkv_gates(20, 3, 1)
    st = _state(4, 3)
    want_h, want_st = jxl.mlstm_decode_step(
        *map(jnp.asarray, (q, k, v, ig, fg)), tuple(map(jnp.asarray, st)))
    got_h, got_st = txl.mlstm_decode_step(*map(t, (q, k, v, ig, fg)),
                                          tuple(map(t, st)))
    within(got_h, want_h, F32_REL)
    for a, b in zip(got_st, want_st):
        within(a, b, F32_REL)


def test_mlstm_scan_then_steps_equal_a_longer_scan():
    """A prompt scanned then fed a token at a time ends in the state of
    one scan over all of it (the decode step is the scan's recurrence)."""
    q, k, v, ig, fg = (t(a) for a in _qkv_gates(30, 2, 12))
    _, st = txl.mlstm_scan(q[:, :9], k[:, :9], v[:, :9], ig[:, :9],
                           fg[:, :9], 8)
    hs = []
    for s in range(9, 12):
        sl = slice(s, s + 1)
        h, st = txl.mlstm_decode_step(q[:, sl], k[:, sl], v[:, sl],
                                      ig[:, sl], fg[:, sl], st)
        hs.append(h)
    h_all, st_all = txl.mlstm_scan(q, k, v, ig, fg, 8)
    within(torch.cat(hs, 1), h_all[:, 9:], F32_REL)
    within(st[0], st_all[0], F32_REL)


# ---------------------------------------------------------------------------
# the sLSTM cell
# ---------------------------------------------------------------------------
def _slstm_carry(seed, B, H=4, dh=16, m0=-1e30):
    r = rng(seed)
    c, n, h = (r.standard_normal((B, H, dh)).astype(np.float32)
               for _ in range(3))
    return c, np.abs(n) + 1, h, np.full((B, H, dh), m0, np.float32)


def test_slstm_step_and_scan_match_reference():
    cfg, jp, tcfg, blk = _pair(1)
    r = rng(40)
    wx = r.standard_normal((2, 7, 4, 4, 16)).astype(np.float32)
    carry = _slstm_carry(41, 2, m0=0.5)
    want_c, want_h = jxl._slstm_step(jp, tuple(map(jnp.asarray, carry)),
                                     jnp.asarray(wx[:, 0]))
    got_c = txl._slstm_step(blk, tuple(map(t, carry)), t(wx[:, 0]))
    within(got_c[2], want_h, F32_REL)
    for a, b in zip(got_c, want_c):
        within(a, b, F32_REL)
    want_c, want_hs = jax.lax.scan(
        lambda c, x: jxl._slstm_step(jp, c, x),
        tuple(map(jnp.asarray, carry)), jnp.asarray(wx).swapaxes(0, 1))
    got_hs, got_c = txl.slstm_scan(blk, t(wx), tuple(map(t, carry)))
    within(got_hs, np.asarray(want_hs).swapaxes(0, 1), F32_REL)
    for a, b in zip(got_c, want_c):
        within(a, b, F32_REL)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
def _block_caches(cfg, tcfg, kind, B, zero):
    if kind == "mlstm":
        jc = jxl.init_mlstm_cache(B, 64, cfg.xlstm)
        tc = txl.init_mlstm_cache(B, 64, tcfg.xlstm)
    else:
        jc = jxl.init_slstm_cache(B, 64, cfg.xlstm)
        tc = txl.init_slstm_cache(B, 64, tcfg.xlstm)
    if zero:
        jc = jax.tree.map(jnp.zeros_like, jc)
        for v in tc.values():
            v.zero_()
    return jc, tc


@pytest.mark.parametrize("layer", [0, 1])
def test_block_with_cache_matches_reference(layer):
    """A prefill of 11 tokens (a ragged chunk) then two decode steps
    through the block with a cache: outputs, every cache leaf and the
    index against the reference's."""
    cfg, jp, tcfg, blk = _pair(layer)
    kind = cfg.layer_specs()[layer][0]
    apply_j = getattr(jxl, f"{kind}_block_apply")
    apply_t = getattr(txl, f"{kind}_block_apply")
    jc, tc = _block_caches(cfg, tcfg, kind, 2, zero=False)
    r = rng(50 + layer)
    for S in (11, 1, 1):
        x = r.standard_normal((2, S, 64)).astype(np.float32)
        want, jc = apply_j(jp, jnp.asarray(x, jnp.bfloat16), cfg.xlstm,
                           cache=jc)
        with torch.no_grad():
            got = apply_t(blk, t(x, torch.bfloat16), tcfg.xlstm, cache=tc)
        assert got.dtype == torch.bfloat16
        within(got, want, BF16_REL)
        for name in tc:
            within(tc[name], jc[name], F32_REL if tc[name].dtype
                   == torch.float32 else BF16_REL)
    assert tc["index"].tolist() == [13, 13]


@pytest.mark.parametrize("layer", [0, 1])
def test_block_without_cache_matches_reference(layer):
    cfg, jp, tcfg, blk = _pair(layer)
    kind = cfg.layer_specs()[layer][0]
    x = rng(60).standard_normal((2, 13, 64)).astype(np.float32)
    want, cache = getattr(jxl, f"{kind}_block_apply")(
        jp, jnp.asarray(x, jnp.bfloat16), cfg.xlstm)
    assert cache is None
    with torch.no_grad():
        got = getattr(txl, f"{kind}_block_apply")(
            blk, t(x, torch.bfloat16), tcfg.xlstm)
    within(got, want, BF16_REL)


def test_zeroed_cache_fact_c14():
    """ROADMAP C.14, pinned against the reference: the ring engine's slot
    reset zeroes every cache leaf, so ``m`` starts at 0, not at
    ``init_*_cache``'s -1e30.  The mLSTM's output does not move with that
    start beyond rounding (num and den scale together); the sLSTM's does
    (``n = exp(i - max(lf, i))`` can fall below 1, so ``h = o·c /
    max(n, 1)`` changes).  The port computes the reference's function
    from both starts."""
    cfg, _, params = smoke(ARCH)
    m = port_model(arch=ARCH)
    x = rng(70).standard_normal((2, 9, 64)).astype(np.float32)
    outs = {}
    for layer in (0, 1):
        kind = cfg.layer_specs()[layer][0]
        jp = jax.tree.map(lambda a: a[0], params[f"group_{layer}"][kind])
        blk = getattr(m.layers[layer], kind)
        for zero in (False, True):
            jc, tc = _block_caches(cfg, m.cfg, kind, 2, zero)
            want, _ = getattr(jxl, f"{kind}_block_apply")(
                jp, jnp.asarray(x, jnp.bfloat16), cfg.xlstm, cache=jc)
            with torch.no_grad():
                got = getattr(txl, f"{kind}_block_apply")(
                    blk, t(x, torch.bfloat16), m.cfg.xlstm, cache=tc)
            within(got, want, BF16_REL)
            outs[kind, zero] = to_np(want)
    mlstm = np.abs(outs["mlstm", True] - outs["mlstm", False]).max()
    slstm = np.abs(outs["slstm", True] - outs["slstm", False]).max()
    assert mlstm <= BF16_REL * np.abs(outs["mlstm", False]).max(), mlstm
    assert slstm > 0.1 * np.abs(outs["slstm", False]).max(), slstm


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_forward_logits_close():
    _, jm, params = smoke(ARCH)
    toks = rng(80).integers(0, 256, (2, 13)).astype(np.int32)
    want = jm.forward(params, {"inputs": jnp.asarray(toks)})[0]
    with torch.no_grad():
        got = port_model(arch=ARCH)(t(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 13, 256)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0,
                               atol=LOGIT_ATOL)


def test_prefill_decode_logits_and_index_close():
    """A padded prefill (rows of 16 and 11 tokens: the pads enter the
    state in both packages, ROADMAP C.11) then two decode steps: logits
    within LOGIT_ATOL and every layer's index at the reference's."""
    _, jm, params = smoke(ARCH)
    toks = rng(81).integers(0, 256, (2, 16)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    jc = jm.init_cache(2, 32)
    jl, jc = jm.prefill_padded(params, {"inputs": jnp.asarray(toks)}, jc,
                               jnp.asarray(lengths))
    m = port_model(arch=ARCH)
    tc = m.init_cache(2, 32)
    with torch.no_grad():
        tl = m.prefill_padded(t(toks).long(), tc, t(lengths))
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0, atol=LOGIT_ATOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for _ in range(2):
        jd, jc = jm.decode_step(params, {"inputs": jnp.asarray(nxt)[:, None]},
                                jc)
        with torch.no_grad():
            td = m.decode_step(t(nxt).long()[:, None], tc)
        np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0,
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)
    for gi, c in enumerate(tc):
        np.testing.assert_array_equal(
            to_np(c["index"]), np.asarray(jc[f"group_{gi}"]["index"][0]))
    assert to_np(tc[0]["index"]).tolist() == [18, 13]
    assert set(tc[0]) == {"conv", "C", "n", "m", "index"}
    assert set(tc[1]) == {"c", "n", "h", "m", "index"}


def test_port_init_draws_xlstm():
    """``Model.init`` fills every leaf (no NaN left from ``to_empty``),
    with the reference's fixed leaves (``fgate`` 0, ``fgate_b`` 3, ``b``
    0)."""
    cfg = reduced_config(get_config(ARCH))
    m = Model(cfg).init(0, device="cpu")
    for name, p in m.named_parameters():
        assert bool(torch.isfinite(p.float()).all()), name
    ml, sl = m.layers[0].mlstm, m.layers[1].slstm
    assert float(ml.fgate.abs().max()) == 0.0
    assert ml.fgate_b.tolist() == [3.0] * 4
    assert float(sl.b.abs().max()) == 0.0
    with torch.no_grad():
        out = m(torch.zeros((1, 3), dtype=torch.long))
    assert out.shape == (1, 3, cfg.vocab)
